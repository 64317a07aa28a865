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
// card's integer rate.  What decides the time is the card's write path, not
// how the stores are sent: on an NVIDIA H100 80GB HBM3 (700 W) this kernel
// writes the bench's 66 MB in 23.5 us, 2.8 TB/s, its predecessor (one
// default store a thread, a block a 4 KiB) in 23.5 to 23.7 and torch's
// fill_ in 23.1 to 23.3, and no store pattern tried (1 to 8 stores in
// flight a thread, 1 to 16 blocks an SM, default or streaming stores, TMA
// bulk stores from shared memory, the salt as an argument) came nearer; the
// patterns that write as one narrow front come first.  Design: a persistent grid of one
// 1024-thread block an SM walks the output in chunks of 16 rows (16 KiB, one
// 16-byte store a thread, neighbouring threads on neighbouring addresses)
// with the grid as its stride, so the card writes one front of 132 chunks at
// a time.  The stores are streaming stores (st.global.cs, evict-first): the
// output is larger than the L2 and nobody reads it back soon.  A thread's
// lane never changes and its row and tile advance by increments (one
// division a thread, before the loop), so the loop holds no division.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintprobe.so store_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_LANES = 256;
constexpr int VEC_PER_ROW = ROW_LANES / 4;  // 16-byte vectors a row: 64
constexpr int THREADS = 1024;
constexpr int CHUNK_ROWS = THREADS / VEC_PER_ROW;  // rows a block pass: 16
constexpr int BLOCKS_PER_SM = 1;

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
store_tile_kernel(const int32_t* __restrict__ salt_p, int4* __restrict__ out,
                  int64_t rows, int row_tile) {
  const uint32_t rt = (uint32_t)row_tile;
  // unsigned arithmetic wraps as the reference's int32 does
  const uint32_t base = (uint32_t)(threadIdx.x % VEC_PER_ROW) * 4u +
                        (uint32_t)__ldg(salt_p);
  // this thread's first row, and what one grid stride adds to (tile, row)
  int64_t r = (int64_t)blockIdx.x * CHUNK_ROWS + threadIdx.x / VEC_PER_ROW;
  const int64_t stride = (int64_t)gridDim.x * CHUNK_ROWS;
  uint32_t tile = (uint32_t)(r / rt);
  uint32_t row = (uint32_t)(r % rt);
  const uint32_t stride_tile = (uint32_t)(stride / rt);
  const uint32_t stride_row = (uint32_t)(stride % rt);
  int4* p = out + r * VEC_PER_ROW + threadIdx.x % VEC_PER_ROW;
  for (; r < rows; r += stride, p += stride * VEC_PER_ROW) {
    const uint32_t v = base + row * 7u + tile;
    __stcs(p, make_int4((int)v, (int)(v + 1u), (int)(v + 2u), (int)(v + 3u)));
    tile += stride_tile;
    row += stride_row;
    if (row >= rt) {
      row -= rt;
      ++tile;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

}  // namespace

// C interface.  `salt` and `out` are device pointers from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes, the (rows, 256) shape, contiguity, 16-byte alignment,
// rows > 0 and row_tile > 0.  Returns cudaGetLastError().
extern "C" {

int dint_store_tile(const void* salt, void* out, int64_t rows, int row_tile,
                    void* stream) {
  const int64_t chunks = (rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int64_t grid_max = (int64_t)sm_count() * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(chunks < grid_max ? chunks : grid_max);
  store_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)salt, (int4*)out, rows, row_tile);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
