// X3: the raw DINT decode of one tile (Hopper, sm_90a).
//
// Replaces the reference's XLA step dint_tpu/kernels/decode_xla.py:121
// `decode_units` (run a tile at a time by kernels/pipeline.py:183), whose
// port as torch ops is `decode_units_plain` in kernels/decode_xla.py.  The
// kernel returns what that function returns, bit for bit: for every row of
// cw (B, W) int32 tokens (u16 at b = 16, u8 at b = 8) with w_valid tokens,
// n ints wanted and dictionary context ctx, the (B, n_out) int32 values
// holding u32 bits, the ints produced and the tokens consumed.
//
// The walk is the reference's sequential pointer walk
// (vroom_env/dint_codecs.hpp:37-107): a codeword >= EXCEPTIONS copies its
// dictionary entry (table[offsets[ctx, cw] + k] for k < 16, zeros for
// 16 <= k < lengths[ctx, cw]: the runs of 16-256 zeros) and steps one token;
// cw == 0 is a small exception (its value in the next token at b = 16, the
// next 2 at b = 8), cw == 1 a large one (the next 2 tokens, or 4); so the
// steps are 1, 2, 3 tokens at b = 16 and 1, 3, 5 at b = 8.  The plain
// version's edge rules hold here too: tokens at q >= w_valid read as
// EXCEPTIONS and are never visited; payload reads are clamped at W - 1; the
// table index is clamped and wraps when negative; slots in [produced, n) take
// the last codeword's entry read on at k = j - start (or its exception value
// again; with no codeword at all, the entry of token EXCEPTIONS at q = 0);
// slots >= n are 0; consumed is the position of the codeword covering slot
// clamp(n - 1, 0, n_out - 1) plus its step.
//
// The design.  One block of WARPS warps decodes one row, a step of WARPS
// windows of WINDOW = 32 tokens at a time, a window a warp, a token a lane.
//   * The chain.  Which positions the walk visits is a linear recurrence over
//     the boolean semiring: with the walk's pending positions as D bits
//     (bit i: position q + i is next; D = 3 at b = 16, 5 at b = 8), token q
//     maps them on by a D x D matrix T_q that shifts them down one and, when
//     q walks (a codeword or a marker), sends bit 0 to bit step(q) - 1.  Each
//     lane packs its T_q into D * D bits (row i at bits i * D ..); a 5-step
//     inclusive scan of matrix products by __shfl_up_sync gives every lane
//     the product of its window up to it, and lane 31 the window's product,
//     which goes to shared memory.  The state entering a window is the
//     step's state carried through the products of the windows before it;
//     applied to it, a lane's exclusive product says whether its token is
//     visited.  A product is D terms of two multiplies each (a column of Y
//     spread over its rows times a row of X copied to every row).  Tiles
//     with assume_clean skip the scan: every token in range is visited.  A
//     walk that stops (a visited token that is no codeword nor marker) ends
//     the row's steps early.
//   * The output starts.  __ballot_sync of the visited lanes and a warp
//     prefix sum of their output lengths give each codeword its first slot
//     within the window; the windows' totals, in shared memory, give each
//     window its first slot.  A window's codewords go in order to shared
//     memory.
//   * The slots.  Each slot of a window's output range finds its codeword
//     by a binary search of the window's starts (the last start <= j, so a
//     zero-length entry gives way to the codeword after it), so a run of
//     256 zeros spreads over the lanes and the writes are coalesced; four
//     slots a lane are in flight together.  The tail [produced, n_out) reads
//     the row's last codeword, spread over the block.
//   * The next step's tokens are asked for a step ahead, and a window's
//     lengths and offsets before its scan, so the dependent trips overlap
//     it.  Three block barriers a step (two for clean tiles) order the
//     shared products, totals and codewords.
//
// Bound: bytes.  The in-range tokens (4 B each), 12 B of row metadata, the
// dictionary entries the tokens name (lengths, offsets and up to 16 table
// words an entry), and the outputs (4 B a slot, 8 B a row of produced and
// consumed) each once; chip_smoke.py counts them from the tile's data.  The
// dictionary arrays (C x 65,536 x 8 B and the table) are read through __ldg
// and stay in the L2.  What sets the time is latency: a row is a chain of
// dependent steps, each some trips to the L2 and a few block barriers long,
// so long rows (thousands of tokens) set a tile's time; a step of WARPS
// windows cuts that chain WARPS-fold against a warp a row.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintraw.so raw_decode.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 32;  // tokens a window, one a lane
constexpr int WARPS = 4;    // windows of a block step, one a warp
constexpr int THREADS = WARPS * WINDOW;
constexpr int SLOTS_IN_FLIGHT = 4;  // output slots a lane computes at once
constexpr int EXCEPTIONS = 2;
constexpr int MAX_ENTRY_SIZE = 16;
constexpr unsigned FULL = 0xFFFFFFFFu;

// (small, large) exception steps in tokens; D, the state depth, is the
// largest step.
template <int BITS>
struct Steps;
template <>
struct Steps<16> {
  static constexpr int SMALL = 2, LARGE = 3, D = 3;
};
template <>
struct Steps<8> {
  static constexpr int SMALL = 3, LARGE = 5, D = 5;
};

// D x D boolean matrices in D * D bits, row i at bits [i * D, i * D + D).
constexpr uint32_t col0_bits(int d) {  // bit 0 of every row
  uint32_t m = 0;
  for (int i = 0; i < d; ++i) m |= 1u << (i * d);
  return m;
}
constexpr uint32_t ident_bits(int d) {
  uint32_t m = 0;
  for (int i = 0; i < d; ++i) m |= 1u << (i * d + i);
  return m;
}
constexpr uint32_t shift_bits(int d) {  // row i takes bit i + 1
  uint32_t m = 0;
  for (int i = 0; i + 1 < d; ++i) m |= 1u << (i * d + i + 1);
  return m;
}

template <int D>
struct Mat {
  static constexpr uint32_t ROW = (1u << D) - 1;
  static constexpr uint32_t COL0 = col0_bits(D);
  static constexpr uint32_t IDENT = ident_bits(D);
  static constexpr uint32_t SHIFT = shift_bits(D);

  // R = Y . X: row i of R is the OR of the rows k of X with Y[i][k] set
  static __device__ __forceinline__ uint32_t compose(uint32_t y, uint32_t x) {
    uint32_t r = 0;
#pragma unroll
    for (int k = 0; k < D; ++k)
      r |= (((y >> k) & COL0) * ROW) & (((x >> (k * D)) & ROW) * COL0);
    return r;
  }

  // M . p for a state p of D bits
  static __device__ __forceinline__ uint32_t apply(uint32_t m, uint32_t p) {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < D; ++i)
      r |= (((m >> (i * D)) & ROW & p) != 0 ? 1u : 0u) << i;
    return r;
  }
};

template <int BITS>
__device__ __forceinline__ int step_of(int c) {
  return c >= EXCEPTIONS ? 1 : (c == 1 ? Steps<BITS>::LARGE
                                       : Steps<BITS>::SMALL);
}

struct Row {
  const int* tok;     // the row's W tokens
  const int* len_c;   // lengths[ctx]
  const int* off_c;   // offsets[ctx]
  const int* table;
  int64_t T;
  int W, wv;
};

// cw_safe at position p, payload reads clamped at W - 1, as u32
__device__ __forceinline__ uint32_t token_at(const Row& r, int p) {
  const int pc = p < r.W - 1 ? p : r.W - 1;
  return pc < r.wv ? (uint32_t)__ldg(r.tok + pc) : (uint32_t)EXCEPTIONS;
}

// slot value of the codeword (q, c, start, off) at slot j, before the n mask
template <int BITS>
__device__ __forceinline__ uint32_t slot_value(const Row& r, int j, int q,
                                               int c, int start, int off) {
  if (c >= EXCEPTIONS) {
    const int k = j - start;
    if (k >= MAX_ENTRY_SIZE) return 0u;
    int64_t t = (int64_t)off + k;
    if (t < 0) t += r.T;
    t = t < 0 ? 0 : (t > r.T - 1 ? r.T - 1 : t);
    return (uint32_t)__ldg(r.table + t);
  }
  const uint32_t t1 = token_at(r, q + 1);
  if (BITS == 16) {
    return c == 1 ? (t1 | (token_at(r, q + 2) << 16)) : t1;
  }
  const uint32_t t2 = token_at(r, q + 2);
  if (c != 1) return t1 | (t2 << 8);
  return t1 | (t2 << 8) | (token_at(r, q + 3) << 16) |
         (token_at(r, q + 4) << 24);
}

template <int BITS, bool CLEAN>
__global__ void __launch_bounds__(THREADS)
raw_decode_kernel(const int* __restrict__ cw, const int* __restrict__ w_valid,
                  const int* __restrict__ n_p, const int* __restrict__ ctx,
                  const int* __restrict__ lengths,
                  const int* __restrict__ offsets,
                  const int* __restrict__ table, int* __restrict__ val,
                  int* __restrict__ produced, int* __restrict__ consumed,
                  int W, int E, int64_t T, int n_out) {
  using M = Mat<Steps<BITS>::D>;
  constexpr int D = Steps<BITS>::D;
  constexpr int STEP = WARPS * WINDOW;  // tokens a block step
  // a warp's window: its codewords in order
  __shared__ int sh_start[WARPS][WINDOW];
  __shared__ int sh_q[WARPS][WINDOW];
  __shared__ int sh_c[WARPS][WINDOW];
  __shared__ int sh_off[WARPS][WINDOW];
  // a warp's window as the block sees it: its product, slots, codewords
  __shared__ uint32_t sh_mat[WARPS];
  __shared__ int sh_total[WARPS];
  __shared__ int sh_nvis[WARPS];

  const int warp = threadIdx.x / WINDOW;
  const int lane = threadIdx.x % WINDOW;
  const int64_t row = blockIdx.x;

  Row r;
  r.tok = cw + row * W;
  const int64_t c0 = (int64_t)__ldg(ctx + row) * E;
  r.len_c = lengths + c0;
  r.off_c = offsets + c0;
  r.table = table;
  r.T = T;
  r.W = W;
  r.wv = __ldg(w_valid + row);
  const int n = __ldg(n_p + row);
  const int w_eff = r.wv < 0 ? 0 : (r.wv < W ? r.wv : W);
  const int last_j = n - 1 < 0 ? 0 : (n - 1 > n_out - 1 ? n_out - 1 : n - 1);
  int* out = val + row * (int64_t)n_out;
  int* s_start = sh_start[warp];
  int* s_q = sh_q[warp];
  int* s_c = sh_c[warp];
  int* s_off = sh_off[warp];

  // the row's last visited codeword (q, c, start, off); with none, the
  // plain version's wrap reads token EXCEPTIONS at q = 0 from slot 0 on
  int lq = 0, lc = EXCEPTIONS, ls = 0;
  int loff = __ldg(r.off_c + (EXCEPTIONS < E - 1 ? EXCEPTIONS : E - 1));
  uint32_t pend = 1;  // the walk's state at the step's first token
  int out_base = 0;   // the step's first slot

  const int q0 = warp * WINDOW + lane;
  int tok_next = q0 < w_eff ? __ldg(r.tok + q0) : EXCEPTIONS;
  for (int base = 0; base < w_eff; base += STEP) {
    const int q = base + q0;
    const bool in = q < w_eff;
    const int tok = tok_next;  // EXCEPTIONS where out of range
    tok_next = q + STEP < w_eff ? __ldg(r.tok + q + STEP) : EXCEPTIONS;
    const bool dict = tok >= EXCEPTIONS;
    int len = 1, off = 0;
    if (in && dict) {
      const int e = tok < E - 1 ? tok : E - 1;
      len = __ldg(r.len_c + e);
      off = __ldg(r.off_c + e);
    }
    uint32_t before = M::IDENT;
    if (!CLEAN) {
      const bool walks = in && (dict || tok == 0 || tok == 1);
      uint32_t s = M::SHIFT |
                   (walks ? 1u << ((step_of<BITS>(tok) - 1) * D) : 0u);
#pragma unroll
      for (int d = 1; d < WINDOW; d *= 2) {
        const uint32_t o = __shfl_up_sync(FULL, s, d);
        if (lane >= d) s = M::compose(s, o);
      }
      before = __shfl_up_sync(FULL, s, 1);
      if (lane == 0) before = M::IDENT;
      if (lane == WINDOW - 1) sh_mat[warp] = s;
    }
    // the state entering this warp's window (the step's through the
    // windows before it) and the next step's; every thread reads the
    // products before the next sync, so the next step may rewrite them
    uint32_t p = pend, pend_next = pend;
    if (!CLEAN) {
      __syncthreads();
      for (int w = 0; w < WARPS; ++w) {
        if (w == warp) p = pend_next;
        pend_next = M::apply(sh_mat[w], pend_next);
      }
    }
    const bool vis = in && (CLEAN || ((before & M::ROW & p) != 0));
    const int ol = vis ? (dict ? len : 1) : 0;
    int incl = ol;
#pragma unroll
    for (int d = 1; d < WINDOW; d *= 2) {
      const int o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += o;
    }
    const unsigned vm = __ballot_sync(FULL, vis);
    const int nvis = __popc(vm);
    if (lane == WINDOW - 1) {
      sh_total[warp] = incl;
      sh_nvis[warp] = nvis;
    }
    __syncthreads();
    int wbase = out_base;  // this window's first slot
    int step_total = 0;
    int last_w = -1;  // the step's last window with a codeword
    for (int w = 0; w < WARPS; ++w) {
      const int t = sh_total[w];
      if (w < warp) wbase += t;
      step_total += t;
      if (sh_nvis[w] > 0) last_w = w;
    }
    const int wend = wbase + sh_total[warp];
    const int last_k = last_w >= 0 ? sh_nvis[last_w] - 1 : 0;
    if (vis) {
      const int k = __popc(vm & ((1u << lane) - 1u));
      s_start[k] = wbase + incl - ol;
      s_q[k] = q;
      s_c[k] = tok;
      s_off[k] = off;
    }
    __syncthreads();
    if (last_w >= 0) {
      lq = sh_q[last_w][last_k];
      lc = sh_c[last_w][last_k];
      ls = sh_start[last_w][last_k];
      loff = sh_off[last_w][last_k];
    }
    const int hi = wend < n_out ? wend : n_out;
    for (int j0 = wbase + lane; j0 < hi; j0 += WINDOW * SLOTS_IN_FLIGHT) {
      uint32_t v[SLOTS_IN_FLIGHT];
      int cq[SLOTS_IN_FLIGHT], cc[SLOTS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < SLOTS_IN_FLIGHT; ++u) {
        const int j = j0 + u * WINDOW;
        cq[u] = 0;
        cc[u] = EXCEPTIONS;
        v[u] = 0;
        if (j < hi) {
          int lo = 0, up = nvis;  // s_start[lo] <= j < s_start[up]
          while (up - lo > 1) {
            const int mid = (lo + up) >> 1;
            if (s_start[mid] <= j) lo = mid;
            else up = mid;
          }
          cq[u] = s_q[lo];
          cc[u] = s_c[lo];
          v[u] = slot_value<BITS>(r, j, cq[u], cc[u], s_start[lo], s_off[lo]);
        }
      }
#pragma unroll
      for (int u = 0; u < SLOTS_IN_FLIGHT; ++u) {
        const int j = j0 + u * WINDOW;
        if (j < hi) {
          out[j] = j < n ? (int)v[u] : 0;
          if (j == last_j) consumed[row] = cq[u] + step_of<BITS>(cc[u]);
        }
      }
    }
    out_base += step_total;
    pend = pend_next;
    if (!CLEAN && pend == 0) break;  // the walk stopped: nothing more visited
  }
  // the tail [produced, n_out): the last codeword read on
  for (int j = (out_base > 0 ? out_base : 0) + threadIdx.x; j < n_out;
       j += THREADS) {
    const uint32_t v = slot_value<BITS>(r, j, lq, lc, ls, loff);
    out[j] = j < n ? (int)v : 0;
    if (j == last_j) consumed[row] = lq + step_of<BITS>(lc);
  }
  if (threadIdx.x == 0) produced[row] = out_base;
}

template <int BITS, bool CLEAN>
void launch(const void* cw, const void* w_valid, const void* n,
            const void* ctx, const void* lengths, const void* offsets,
            const void* table, void* val, void* produced, void* consumed,
            int64_t rows, int W, int E, int64_t T, int n_out,
            cudaStream_t stream) {
  raw_decode_kernel<BITS, CLEAN><<<(unsigned)rows, THREADS, 0, stream>>>(
      (const int*)cw, (const int*)w_valid, (const int*)n, (const int*)ctx,
      (const int*)lengths, (const int*)offsets, (const int*)table, (int*)val,
      (int*)produced, (int*)consumed, W, E, T, n_out);
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr() of
// a contiguous int32 tensor: cw (rows, W), w_valid, n, ctx, produced and
// consumed (rows,), lengths and offsets (C, E), table (T,), val (rows,
// n_out); `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper
// (kernels/decode_xla.py decode_units) has checked dtypes, devices, shapes
// and contiguity; ctx must lie in [0, C).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width other than 8 and 16 or an empty
// dimension.
extern "C" {

int dint_raw_decode(const void* cw, const void* w_valid, const void* n,
                    const void* ctx, const void* lengths, const void* offsets,
                    const void* table, void* val, void* produced,
                    void* consumed, int64_t rows, int W, int E, int64_t T,
                    int n_out, int b, int assume_clean, void* stream) {
  if ((b != 8 && b != 16) || rows < 1 || W < 1 || E <= EXCEPTIONS ||
      T < 1 || n_out < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (b == 16) {
    if (assume_clean)
      launch<16, true>(cw, w_valid, n, ctx, lengths, offsets, table, val,
                       produced, consumed, rows, W, E, T, n_out, s);
    else
      launch<16, false>(cw, w_valid, n, ctx, lengths, offsets, table, val,
                        produced, consumed, rows, W, E, T, n_out, s);
  } else {
    if (assume_clean)
      launch<8, true>(cw, w_valid, n, ctx, lengths, offsets, table, val,
                      produced, consumed, rows, W, E, T, n_out, s);
    else
      launch<8, false>(cw, w_valid, n, ctx, lengths, offsets, table, val,
                       produced, consumed, rows, W, E, T, n_out, s);
  }
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
