// K4: block copy of the fused ranked-serving store (Hopper, sm_90a).
//
// Replaces dint_tpu/query/device_serve.py:_gather_fn (the pallas_call at
// :124, body copy_kernel at :90).  It computes, for every tile g of a query
// batch,
//
//   d[g, :] = dstore[blk[g], :]                 (int32 docids, PAD_DOC padded)
//   s[g, :] = __fmul_rn(wstore[blk[g], :], qw[g])   (float32 BM25 partials)
//
// where dstore/wstore are the (NB, 256) device-resident posting store and
// row NB-1 is the all-PAD row that padding tiles point at (with qw 0).  The
// score is one round-to-nearest f32 product, the same value as
// take(wstore) * qw in the reference and index_select(wstore) * qw in the
// plain PyTorch version.
//
// Bound: bytes.  Each tile reads one 1 KiB docid row and one 1 KiB weight
// row and writes one row of each, plus 8 B of metadata (block id, qw):
// at most G * (2*1024 + 2*1024) + 8*G bytes over 3.35 TB/s, and fewer
// where ids repeat (a padded bucket's tiles all name the PAD row, which
// is read once): distinct ids * 2 KiB + G * 2 KiB + 8*G.  One multiply
// per score, nothing next to the card's float rate.
//
// Design.  The Pallas kernel's shape was TPU form and is not carried over:
// its (NB, 1, 256) store (the 8-sublane block rule), 8 rows a grid step (to
// amortise grid-step overhead), the 16384-tile chunking (an SMEM limit) and
// one dispatch for all buckets (a runtime round trip).  Here the stores are
// contiguous (NB, 256) rows; each thread block loads its own block ids and
// copies whole rows with 16-byte loads and stores: 64 threads x 16 B = one
// 1 KiB row of each store, 4 rows a 256-thread block, so any G above 528
// tiles gives every one of the 132 SMs a block.  Store rows are read through
// the read-only path; a block id outside [0, NB) reads the PAD row NB-1, as
// in the plain version, so that no thread touches memory outside the store.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintserve.so serve_gather.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 256;                         // postings per store row
constexpr int VEC_PER_ROW = ROW / 4;             // 16-byte vectors a row: 64
constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / VEC_PER_ROW;  // 4

__global__ void __launch_bounds__(THREADS)
block_copy_kernel(const int32_t* __restrict__ blk,
                  const float* __restrict__ qw,
                  const int4* __restrict__ dstore,
                  const float4* __restrict__ wstore,
                  int4* __restrict__ dout, float4* __restrict__ sout,
                  int64_t G, int64_t NB) {
  const int64_t g =
      (int64_t)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / VEC_PER_ROW;
  if (g >= G) return;
  const int lane = threadIdx.x % VEC_PER_ROW;
  int64_t b = __ldg(blk + g);
  if (b < 0 || b >= NB) b = NB - 1;
  const float q = __ldg(qw + g);
  const int64_t src = b * VEC_PER_ROW + lane;
  const int64_t dst = g * VEC_PER_ROW + lane;
  dout[dst] = __ldg(dstore + src);
  float4 w = __ldg(wstore + src);
  w.x = __fmul_rn(w.x, q);
  w.y = __fmul_rn(w.y, q);
  w.z = __fmul_rn(w.z, q);
  w.w = __fmul_rn(w.w, q);
  sout[dst] = w;
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes, shapes ((G,), (G,), (NB, 256) x2, (G, 256) x2),
// contiguity, 16-byte alignment of the stores and G > 0.  Returns
// cudaGetLastError().
extern "C" {

int dint_block_copy(const void* blk, const void* qw, const void* dstore,
                    const void* wstore, void* dout, void* sout, int64_t G,
                    int64_t NB, void* stream) {
  const int64_t blocks = (G + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  block_copy_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)blk, (const float*)qw, (const int4*)dstore,
      (const float4*)wstore, (int4*)dout, (float4*)sout, G, NB);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
