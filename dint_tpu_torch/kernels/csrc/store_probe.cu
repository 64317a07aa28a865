// K5: write-only tile of the store-bandwidth probe (Hopper, sm_90a).
//
// Replaces dint_tpu/kernels/store_probe.py:_probe_fns (the pallas_call at
// :48, body `kernel` at :37).  It computes, over an (R, 256) int32 output
// cut into tiles of `row_tile` rows,
//
//   out[r, l] = l + 7 * (r % row_tile) + salt + r / row_tile
//
// in wrapping int32: `r % row_tile` is the row inside its tile and
// `r / row_tile` the tile's index (the Pallas body's `row` iota and
// program_id).  The kernel reads nothing but the salt, a 1-element int32
// device tensor, so a chain of runs never syncs with the host.
//
// Bound: bytes, and write-only: R * 1024 B written over the card's memory
// rate; three integer adds and one multiply a lane are nothing next to the
// card's integer rate.  Design: one thread writes 16 bytes (four lanes), 64
// threads a row, neighbouring threads on neighbouring addresses; no shared
// memory and no loop, so any R above 528 rows gives every SM a block.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintprobe.so store_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_LANES = 256;
constexpr int VEC_PER_ROW = ROW_LANES / 4;  // 16-byte vectors a row: 64
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
store_tile_kernel(const int32_t* __restrict__ salt_p, int4* __restrict__ out,
                  int64_t rows, int row_tile) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= rows * VEC_PER_ROW) return;
  const int64_t r = g / VEC_PER_ROW;
  const uint32_t lane = (uint32_t)(g - r * VEC_PER_ROW) * 4u;
  const uint32_t tile = (uint32_t)(r / row_tile);
  const uint32_t row = (uint32_t)(r - (int64_t)tile * row_tile);
  // unsigned arithmetic wraps as the reference's int32 does
  const uint32_t v = lane + row * 7u + (uint32_t)__ldg(salt_p) + tile;
  int4 o;
  o.x = (int)v;
  o.y = (int)(v + 1u);
  o.z = (int)(v + 2u);
  o.w = (int)(v + 3u);
  out[g] = o;
}

}  // namespace

// C interface.  `salt` and `out` are device pointers from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes, the (rows, 256) shape, contiguity, 16-byte alignment,
// rows > 0 and row_tile > 0.  Returns cudaGetLastError().
extern "C" {

int dint_store_tile(const void* salt, void* out, int64_t rows, int row_tile,
                    void* stream) {
  const int64_t vecs = rows * VEC_PER_ROW;
  store_tile_kernel<<<(unsigned)((vecs + THREADS - 1) / THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)salt, (int4*)out, rows, row_tile);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
