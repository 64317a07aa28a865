// X2: the whole-list Elias-Fano decode (Hopper, sm_90a).
//
// Replaces the reference's XLA decode dint_tpu/codecs/ef_device.py
// `_decode_fn` (:37-79; bit expansion, then a sort-based select_1 a shape
// group).  Decode semantics of compact_elias_fano (materialized whole-list
// like codecs/ef.py::compact_elias_fano.decode_all): value i of a list is
//
//   ((select_1(i) - i - 1) << w) | low[i]
//
// where select_1 counts bits of the list's high region (bit offset hbo,
// length hbl, exactly n ones) and low[i] is the w-bit field at bit
// lbo + i * w of the u32 word array.  Every list's values are written in list
// order into one int32 tensor holding u32 bits, out_start[list] + i.
//
// The host (ef_device.prepare) cuts each list's high region into chunks of at
// most CHUNK_WORDS whole words; a chunk never spans two lists.  Two passes:
//
//   pass 1 (ef_count_kernel): one block a chunk, one thread a word; the word
//     masked to the region, popcounted, summed over the block: the chunk's
//     ones.  An inclusive scan of those counts (a small torch cumsum over one
//     int a chunk) gives each chunk's first output, incl - count: the ones of
//     all earlier chunks, which is out_start[list] plus the chunk's rank in
//     its list, since a list's region holds exactly its n ones.
//   pass 2 (ef_decode_kernel): one block a chunk, one thread a word again;
//     the thread's rank offset is an exclusive scan of the popcounts in
//     shared memory (warp shuffles, then the warps' sums).  The thread then
//     walks its word's set bits with __ffs: for the t-th one, at global bit
//     b, i = rank + t, high = (b - hbo) - i - 1, and the low field is a
//     funnel shift of the two u32 words that hold it (the guard word that
//     prepare appends covers the last).  Values go to a staging buffer in
//     shared memory at the thread's offset, and the block then writes its
//     contiguous run of outputs with neighbouring threads on neighbouring
//     addresses.
//
// No searchsorted, no per-output binary select, no int64 pass over the
// outputs: the work is a chunk's words, and chunks, not lists, are the unit
// of work, so one very long list beside many short ones still spreads over
// the whole card.
//
// Bound: bytes.  The high words are read twice (once a pass), the low words
// once, 4 B an output written once; a value costs a few integer operations.
// The bound counts the word array once and the outputs once.  What holds it
// back is latency, not bytes: on the bench collection's `ef` index (6,000
// lists, 10,679 chunks, most of them a short list's few words) a block's
// life is a chain of dependent loads (chunk, geometry, word, low fields),
// and the chunks pass through the card in some thirteen waves; chip_smoke.py
// measured 90 us against a 22.3 us bound on an NVIDIA H100 80GB HBM3 (700
// W), the count pass 16 us and the scan's launches 6 us of it.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintef.so ef_decode.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_WORDS = 256;  // words of a chunk, a thread each
constexpr int THREADS = CHUNK_WORDS;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = CHUNK_WORDS * 32;  // the most ones a chunk holds

// Geometry of a list, from the (5, L) int64 table: n, w, lbo, hbo, hbl.
struct Chunk {
  int64_t list, w, lbo, hbo, w0, nwords;
};

__device__ __forceinline__ Chunk load_chunk(const int64_t* __restrict__ geo,
                                            const int64_t* __restrict__ chunks,
                                            int64_t L) {
  Chunk c;
  c.list = chunks[2 * blockIdx.x];
  c.w0 = chunks[2 * blockIdx.x + 1];
  c.w = geo[1 * L + c.list];
  c.lbo = geo[2 * L + c.list];
  c.hbo = geo[3 * L + c.list];
  const int64_t last = (c.hbo + geo[4 * L + c.list] - 1) >> 5;
  c.nwords = min((int64_t)CHUNK_WORDS, last - c.w0 + 1);
  return c;
}

// Word j of the chunk (this thread's) masked to the list's high region
// [hbo, hbo + hbl); 0 past the chunk's end.
__device__ __forceinline__ uint32_t region_word(
    const uint32_t* __restrict__ words, const int64_t* __restrict__ geo,
    int64_t L, const Chunk& c) {
  if (threadIdx.x >= c.nwords) return 0;
  const int64_t j = c.w0 + threadIdx.x;
  const int64_t bit0 = j << 5;
  const int64_t lo = c.hbo - bit0;                       // < 32
  const int64_t hi = c.hbo + geo[4 * L + c.list] - bit0;  // > 0
  uint32_t m = 0xFFFFFFFFu;
  if (lo > 0) m &= ~((1u << lo) - 1u);
  if (hi < 32) m &= (1u << hi) - 1u;
  return __ldg(words + j) & m;
}

// Exclusive scan of v over the block; *total receives the block's sum.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* total) {
  __shared__ uint32_t warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const uint32_t s = warp_sums[k];
    if (k < warp) before += s;
    all += s;
  }
  *total = all;
  return before + inc - v;
}

__global__ void __launch_bounds__(THREADS)
ef_count_kernel(const uint32_t* __restrict__ words,
                const int64_t* __restrict__ geo,
                const int64_t* __restrict__ chunks,
                int32_t* __restrict__ counts, int64_t L) {
  const Chunk c = load_chunk(geo, chunks, L);
  uint32_t total;
  block_exclusive_scan(__popc(region_word(words, geo, L, c)), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int32_t)total;
}

__global__ void __launch_bounds__(THREADS)
ef_decode_kernel(const uint32_t* __restrict__ words,
                 const int64_t* __restrict__ geo,
                 const int64_t* __restrict__ chunks,
                 const int64_t* __restrict__ incl,
                 const int32_t* __restrict__ counts,
                 const int64_t* __restrict__ out_start,
                 uint32_t* __restrict__ out, int64_t L) {
  __shared__ uint32_t stage[STAGE];
  const Chunk c = load_chunk(geo, chunks, L);
  uint32_t x = region_word(words, geo, L, c);
  uint32_t total;
  const uint32_t off = block_exclusive_scan(__popc(x), &total);
  const int64_t g0 = incl[blockIdx.x] - counts[blockIdx.x];
  // rank in the list of this thread's first one
  int64_t i = g0 - out_start[c.list] + off;
  const int64_t b0 = ((c.w0 + threadIdx.x) << 5) - c.hbo;
  const uint32_t w = (uint32_t)c.w;  // < 32: universes below 2^32
  const uint32_t low_mask = (1u << w) - 1u;
  uint32_t t = off;
  while (x) {
    const int b = __ffs(x) - 1;
    x &= x - 1u;
    const uint32_t high = (uint32_t)(b0 + b - i - 1);
    uint32_t low = 0;
    if (w) {
      const int64_t p = c.lbo + i * (int64_t)w;
      const int64_t k = p >> 5;
      low = __funnelshift_r(__ldg(words + k), __ldg(words + k + 1),
                            (uint32_t)(p & 31)) & low_mask;
    }
    stage[t++] = (high << w) | low;
    ++i;
  }
  __syncthreads();
  for (uint32_t k = threadIdx.x; k < total; k += THREADS)
    out[g0 + k] = stage[k];
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  words: the u32 word
// array with its guard word; geo: (5, L) int64; chunks: (C, 2) int64 (list,
// first word); counts: (C,) int32; incl: (C,) int64, the inclusive scan of
// counts; out_start: (L,) int64; out: the int32 outputs.  The wrapper has
// checked dtypes, shapes and contiguity, and C > 0.  Each returns
// cudaGetLastError().
extern "C" {

int dint_ef_count(const void* words, const void* geo, const void* chunks,
                  void* counts, int64_t C, int64_t L, void* stream) {
  ef_count_kernel<<<(unsigned)C, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int64_t*)geo, (const int64_t*)chunks,
      (int32_t*)counts, L);
  return (int)cudaGetLastError();
}

int dint_ef_decode(const void* words, const void* geo, const void* chunks,
                   const void* incl, const void* counts,
                   const void* out_start, void* out, int64_t C, int64_t L,
                   void* stream) {
  ef_decode_kernel<<<(unsigned)C, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int64_t*)geo, (const int64_t*)chunks,
      (const int64_t*)incl, (const int32_t*)counts, (const int64_t*)out_start,
      (uint32_t*)out, L);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
