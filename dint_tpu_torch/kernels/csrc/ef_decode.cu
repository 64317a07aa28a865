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
// The design.  The lists' high regions, in list order, form one sequence of
// NW words (a word shared by two regions appears once for each, masked to
// it).  Counted in that order, the sequence's ones ARE the output indices:
// each region holds exactly its list's n ones, and out_start = cumsum(n) - n.
// So the kernels cut the sequence, not the lists: block t takes words
// [t * BLOCK_WORDS, (t + 1) * BLOCK_WORDS), whatever the list boundaries.
// ef_device.prepare lays the sequence out (`high`, each word masked to its
// region), with one bit a word where a list with values starts (`starts`),
// a row a list with values (`lists`) and the row of each block's first word
// (`block_list`).  Two launches:
//
//   * pass 1 (ef_count_kernel): each block's ones, from ROUNDS coalesced
//     words a thread; a torch cumsum of one int64 a block gives each
//     block's first output (incl - count);
//   * pass 2 (ef_decode_kernel): a block asks for its words, their start
//     flags, its first row and its first output at once; one pair of block
//     scans gives each word its offset among the block's ones and its list
//     (the first row plus the flags before it: the 32 words of a warp share
//     one flag word); then, round by round (THREADS words, at most STAGE
//     ones), each thread walks its word's set bits with __ffs: value i is
//     ((bit - i - 1) << w) | low, the high part one u32 that drops by one a
//     value, the low fields read in order through a window of four u32
//     words in registers, each next word asked for three words ahead (the
//     three guard words that prepare appends cover the last); values go to
//     a staging buffer in shared memory (one slot skipped every 32, so that
//     lanes whose runs start some 16 apart write to distinct banks), and the
//     block writes the round's run of outputs with neighbouring threads on
//     neighbouring addresses.
//
// Bound: bytes.  The high words and the low words are read once, 4 B an
// output written once; a value costs a dozen 32-bit integer operations.  The
// bound counts the word array once and the outputs once: 22.26 us for the
// bench collection's `ef` index (6,000 lists, 16.7M values) on an NVIDIA
// H100 80GB HBM3 (700 W).  There chip_smoke.py measured, cold, 53.6 us for
// this design against 89.2 us for the earlier one (a block a chunk of at
// most 256 words of one list: 10,679 chunks, most of them a short list's few
// words, mostly idle threads), each timed in turns.  What holds it back is
// latency, not bytes: a block's life is a few dependent trips to device
// memory (its words, flags and first output; its list row; its low words)
// and a walk whose length is the most ones a lane's word holds, and about
// five blocks of 256 threads fit an SM at once, so the 2,379 blocks run in
// some four waves of mostly waiting.  One launch with a decoupled look-back
// over the same blocks (a block's ticket from an atomic, its prefix from its
// predecessors' published sums) did no better, timed in turns with this one
// in another call (55.8 against 53.6 us): its blocks wait on their
// predecessors' prefixes in the same waves.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintef.so ef_decode.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 2;  // high words a thread
constexpr int BLOCK_WORDS = THREADS * ROUNDS;  // ef_device.BLOCK_WORDS
constexpr int STAGE = THREADS * 32;  // the most ones a round's words hold

// Stage slot of a round's one k: a word holds some 16 ones, so the lanes of
// a warp write slots about 16 apart, which in k's own slots would mostly
// share two banks; one skipped slot every 32 spreads them, and keeps k and
// k + 1 .. k + 31 on distinct banks for the write-out.
__device__ __forceinline__ uint32_t slot(uint32_t k) { return k + (k >> 5); }

// A row of the table of the lists that hold values (prepare's `lists`):
// their first word in the sequence, their first output, the bit offset of
// their low fields, and w | (hbo & 31) << 8.
struct List {
  int64_t wstart, out_start, lbo, w_hbo;
};

// Block t's words of the sequence (each already masked to its region):
// word r * THREADS + threadIdx.x of the block in round r.
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ high,
                                           int64_t base, int64_t NW,
                                           uint32_t (&x)[ROUNDS]) {
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t gw = base + r * THREADS + threadIdx.x;
    x[r] = gw < NW ? __ldg(high + gw) : 0u;
  }
}

// Pass 1: the ones of each block's words.
__global__ void __launch_bounds__(THREADS)
ef_count_kernel(const uint32_t* __restrict__ high, int64_t* __restrict__ counts,
                int64_t NW) {
  __shared__ uint32_t warp_sum[WARPS];
  uint32_t x[ROUNDS];
  load_words(high, (int64_t)blockIdx.x * BLOCK_WORDS, NW, x);
  uint32_t c = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) c += __popc(x[r]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(0xFFFFFFFFu, c, d);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t all = 0;
    for (int k = 0; k < WARPS; ++k) all += warp_sum[k];
    counts[blockIdx.x] = all;
  }
}

// Pass 2: block t's values, from output incl[t] - counts[t] on.
__global__ void __launch_bounds__(THREADS)
ef_decode_kernel(const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ high,
                 const uint32_t* __restrict__ starts,
                 const int64_t* __restrict__ block_list,
                 const List* __restrict__ lists,
                 const int64_t* __restrict__ incl,
                 const int64_t* __restrict__ counts,
                 uint32_t* __restrict__ out, int64_t NW) {
  __shared__ uint32_t stage[STAGE + STAGE / 32];
  __shared__ uint32_t warp_sum[ROUNDS][WARPS];
  __shared__ uint32_t warp_lists[ROUNDS][WARPS];
  __shared__ uint32_t own;  // the start flag of the block's first word
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t upto = 0xFFFFFFFFu >> (31 - lane);  // lanes 0 .. lane
  const int64_t t = blockIdx.x;
  const int64_t base = t * BLOCK_WORDS;

  // the block's words, the start flags of their lists, the list of its
  // first word and its first output, all in flight together
  uint32_t x[ROUNDS], flags[ROUNDS];
  load_words(high, base, NW, x);
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int64_t gw = base + r * THREADS + threadIdx.x;
    flags[r] = gw < NW ? __ldg(starts + (gw >> 5)) : 0u;
  }
  const int64_t first = block_list[t];
  const int64_t g0 = incl[t] - counts[t];

  // offsets among the block's ones and each word's list: two scans in word
  // order (round-major, then thread), the popcounts and the start flags
  uint32_t off[ROUNDS], lst[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const uint32_t c = __popc(x[r]);
    uint32_t inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += o;
    }
    // the warp's 32 words share one flag word: lanes 0 .. lane's flags
    lst[r] = __popc(flags[r] & upto);
    if (lane == 31) {
      warp_sum[r][warp] = inc;
      warp_lists[r][warp] = lst[r];
    }
    off[r] = inc - c;
  }
  if (threadIdx.x == 0) own = flags[0] & 1u;
  __syncthreads();
  uint32_t round_start[ROUNDS + 1];
  round_start[0] = 0;
  uint32_t starts_before = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    uint32_t before = 0, all = 0, lb = 0, la = 0;
    for (int k = 0; k < WARPS; ++k) {
      const uint32_t v = warp_sum[r][k], m = warp_lists[r][k];
      if (k < warp) {
        before += v;
        lb += m;
      }
      all += v;
      la += m;
    }
    off[r] += round_start[r] + before;
    round_start[r + 1] = round_start[r] + all;
    lst[r] += starts_before + lb;
    starts_before += la;
  }

  // round by round: every word's ones into the stage, then the round's
  // outputs written in order.  A thread walks its word's ones with __ffs;
  // value i of the list is ((bit - i - 1) << w) | low, the high part kept
  // as one u32 that drops by one a value, the low fields read in order
  // through a window of four u32 words in registers (the next word is asked
  // for three words ahead of the field that needs it).  A word's list is
  // the list of the block's first word plus the lists that start after it
  // up to the word (the first word's own flag aside).
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    uint32_t v = x[r];
    if (v) {
      const List e = lists[first + lst[r] - own];
      const uint32_t w = (uint32_t)(e.w_hbo & 0xFF);  // < 32
      const int64_t k = base + r * THREADS + threadIdx.x - e.wstart;
      const int64_t i = g0 + off[r] - e.out_start;  // the first one's rank
      // bit 0 of the word, counted from the region's first bit
      const int64_t bit0 = (k << 5) - (e.w_hbo >> 8);
      uint32_t hi = (uint32_t)(bit0 - i - 1);  // + the one's bit in the word
      const int64_t p = e.lbo + i * (int64_t)w;
      const uint32_t* q = words + (p >> 5);
      uint32_t sh = (uint32_t)(p & 31);
      uint32_t a0 = __ldg(q), a1 = __ldg(q + 1), a2 = __ldg(q + 2),
               a3 = __ldg(q + 3);
      const uint32_t low_mask = (1u << w) - 1u;
      uint32_t s = off[r] - round_start[r];
      while (v) {
        if (sh >= 32) {
          sh -= 32;
          a0 = a1;
          a1 = a2;
          a2 = a3;
          a3 = __ldg(++q + 3);
        }
        const uint32_t b = __ffs(v) - 1;
        v &= v - 1u;
        stage[slot(s++)] =
            ((hi + b) << w) | (__funnelshift_r(a0, a1, sh) & low_mask);
        --hi;
        sh += w;
      }
    }
    __syncthreads();
    const uint32_t n_here = round_start[r + 1] - round_start[r];
    uint32_t* dst = out + g0 + round_start[r];
    for (uint32_t k = threadIdx.x; k < n_here; k += THREADS)
      dst[k] = stage[slot(k)];
    __syncthreads();
  }
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  words: the u32 word
// array with its three guard words; high: the NW words of the sequence of
// high regions, each masked to its region; counts: (B,) int64, each block's
// ones; incl: (B,) int64, their inclusive running sum; starts: one bit a
// sequence word, set where a list with values starts; block_list: (B,)
// int64, the row of `lists` that holds each block's first word; lists:
// (Lv, 4) int64, a row (struct List) a list with values; out: the int32
// outputs.  The wrapper has checked dtypes, shapes and contiguity, and
// B > 0.  Each returns cudaGetLastError().
extern "C" {

int dint_ef_count(const void* high, void* counts, int64_t B, int64_t NW,
                  void* stream) {
  ef_count_kernel<<<(unsigned)B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)high, (int64_t*)counts, NW);
  return (int)cudaGetLastError();
}

int dint_ef_decode(const void* words, const void* high, const void* starts,
                   const void* block_list, const void* lists,
                   const void* incl, const void* counts, void* out, int64_t B,
                   int64_t NW, void* stream) {
  ef_decode_kernel<<<(unsigned)B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)high, (const uint32_t*)starts,
      (const int64_t*)block_list, (const List*)lists, (const int64_t*)incl,
      (const int64_t*)counts, (uint32_t*)out, NW);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
