// X3: the raw DINT decode of a whole pass (Hopper, sm_90a).
//
// Replaces the reference's XLA step dint_tpu/kernels/decode_xla.py:121
// `decode_units` (whose chain is `_chain_visited`, :54), run a tile at a time
// by kernels/pipeline.py:178-190; its port as torch ops is
// `decode_units_plain` in kernels/decode_xla.py.  The kernel returns what
// that function returns, bit for bit, for every row of every tile of a pass:
// for a row of W int32 tokens (u16 at b = 16, u8 at b = 8) with w_valid
// tokens, n ints wanted and dictionary context ctx, n_out int32 values
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
// table index offset + k is summed in wrapping int32, wraps once more when
// negative and is clamped; slots in [produced, n) take the last codeword's
// entry read on at k = j - start (or its exception value again; with no
// codeword at all, the entry of token EXCEPTIONS at q = 0: the o_j = -1
// wrap); slots >= n are 0; consumed is the position of the codeword covering
// slot clamp(n - 1, 0, n_out - 1) plus its step.  A visited token that is no
// codeword nor marker (a negative int32) reads as a small exception and ends
// the walk.
//
// What bounds it on this card.  Bytes, in the yardstick: each in-range
// token, 12 B a row, each dictionary entry its visited codewords name once
// and every output (chip_smoke.x3_tile_bytes), 55 us a pass of both bench
// streams at 3.35 TB/s.  What holds it is latency: a row is a chain, where
// the walk goes next depends on the token it stands on, and each slot's
// value is a dependent trip to the table in L2.  The first design walked a
// block over a row's windows step by step (some L2 trips and block
// barriers a step) and took a launch a tile of the host's Python.
//
// The design.  ONE launch decodes every row of every tile of a pass.
//   * The row table.  The host (decode_xla.plan_rows) lists every row once,
//     when the engine is built: where its tokens and its outputs lie, W,
//     w_valid, n, ctx, n_out, and the index of its produced and consumed.
//     Rows of at most 256 tokens in range and 2,048 slots take a warp each,
//     WARPS rows of one (b, clean) group a block; longer rows a block each.
//     The blocks' items go longest first, so the long rows start first and
//     the short ones fill the tail.  A block's (b, clean) group is uniform:
//     one switch picks the template body.
//   * The chain, cut by a scan.  The walk's pending positions are D bits
//     (bit i: position q + i is next; D = 3 at b = 16, 5 at b = 8), and token
//     q maps them on by a D x D boolean matrix T_q that shifts them down one
//     and, when q walks (a codeword or a marker), sends bit 0 to bit
//     step(q) - 1; packed in D * D bits, row i at bits i * D.  A team (a
//     block, or a warp for a short row) takes CHUNK = team * run tokens a
//     round, each thread a run of RUN = 4 consecutive tokens in a block and
//     WARP_RUN = 2 in a warp (on the card, runs of 8 held more registers,
//     so fewer blocks an SM, and left a short row's tokens on fewer lanes).
//     Each thread composes its run's matrices serially in registers (T_q . P
//     is a shift and one masked OR); a warp scan of the products by
//     __shfl_up_sync and, in a block, one pass over the warps' products in
//     shared memory give each thread the state entering its run; it walks
//     its run again from that state to mark the visited tokens and sum
//     their output lengths.  The chunk's outgoing state is carried to the
//     next round.  Clean rows skip the matrices: every token in range is
//     visited.  A walk that stops ends the row's rounds.
//   * The starts.  A team-wide exclusive sum of (visited codewords, output
//     lengths) gives each codeword its ordinal and its first slot; the
//     chunk's codewords go in order to shared memory (start, position and
//     kind, table offset).
//   * The slots, by marks.  The chunk's output range is cut into windows of
//     STAGE slots (a warp row: STAGE / WARPS), each 32-slot groups.  A
//     codeword that starts inside a window marks its first slot with its
//     ordinal (atomicMax, so that the last of the codewords at one slot,
//     past zero-length entries, wins) and its group's last mark; one warp
//     scans the groups' last marks, giving each group the codeword that
//     covers its first slot; then a warp takes a group, a lane a slot: the
//     highest mark at or below the lane (a ballot and a shuffle), or the
//     group's carry, is its codeword.  A warp maps GROUPS_IN_FLIGHT groups
//     before it asks for their table words, so their L2 trips overlap.  So
//     a run of 256 zeros spreads over the lanes and the writes are
//     coalesced, without a search a slot (a binary search of the starts a
//     slot, and slots staged by their codewords in turn, were tried on the
//     card first and were slower).  The tail [produced, n_out) reads the
//     row's last codeword, spread over the team.
//   * Ahead of need: the next chunk's tokens are asked for when a chunk
//     starts, a chunk's lengths and offsets before its scan, and the first
//     table line of each visited codeword (prefetch to L1) before the
//     barrier that precedes the slots.  Three barriers a block round (two
//     for clean rows) and three a window; a warp row has none but
//     __syncwarp.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintraw.so raw_decode.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a block: one long row, or WARPS short ones
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
// consecutive tokens a thread composes: in a block row, and in a warp row
// (short rows: more of a warp's lanes hold tokens)
constexpr int RUN = 4;
constexpr int WARP_RUN = 2;
// output slots a block row maps to their codewords at once (a window), and
// a warp row (the block's window split over its warps); 32-slot groups
constexpr int STAGE = 4096;
constexpr int WARP_STAGE = STAGE / WARPS;
constexpr int GROUPS = STAGE / WARP;
constexpr int GROUPS_IN_FLIGHT = 4;  // groups a warp maps and loads at once
constexpr int EXCEPTIONS = 2;
constexpr int MAX_ENTRY_SIZE = 16;
constexpr int KIND_SHIFT = 29;  // a listed codeword's kind above its position
constexpr int POS_MASK = (1 << KIND_SHIFT) - 1;
constexpr unsigned FULL = 0xFFFFFFFFu;

// a codeword's kind: a dictionary entry, a small or a large exception
constexpr int DICT = 0, SMALL_EXC = 1, LARGE_EXC = 2;

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

template <int D>
struct Mat {
  static constexpr uint32_t ROW = (1u << D) - 1;
  static constexpr uint32_t COL0 = col0_bits(D);
  static constexpr uint32_t IDENT = ident_bits(D);

  // R = Y . X: row i of R is the OR of the rows k of X with Y[i][k] set
  static __device__ __forceinline__ uint32_t compose(uint32_t y, uint32_t x) {
    uint32_t r = 0;
#pragma unroll
    for (int k = 0; k < D; ++k)
      r |= (((y >> k) & COL0) * ROW) & (((x >> (k * D)) & ROW) * COL0);
    return r;
  }

  // T_q . P: T_q's rows shift down one (row i takes row i + 1 of P) and, for
  // a walking token, row step - 1 also takes row 0
  static __device__ __forceinline__ uint32_t push(uint32_t p, bool walks,
                                                  int step) {
    return (p >> D) | (walks ? (p & ROW) << ((step - 1) * D) : 0u);
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

__device__ __forceinline__ int kind_of(int c) {
  return c >= EXCEPTIONS ? DICT : (c == 1 ? LARGE_EXC : SMALL_EXC);
}

template <int BITS>
__device__ __forceinline__ int step_of(int kind) {
  return kind == DICT ? 1
                      : (kind == LARGE_EXC ? Steps<BITS>::LARGE
                                           : Steps<BITS>::SMALL);
}

__device__ __forceinline__ bool walks_on(int c) {
  return c >= EXCEPTIONS || c == 0 || c == 1;
}

// A row of the row table, as decode_xla.ROW_DTYPE lays it out (40 bytes).
struct RowDesc {
  int64_t tok;  // its first token in the pass's token buffer
  int64_t out;  // its first slot in the pass's value buffer
  int32_t W, wv, n, ctx, n_out;
  int32_t idx;  // its produced and consumed entry
};

// A block's work: `rows` rows of the table from `row0`, of one group
// (bit 0: b = 8, else 16; bit 1: clean), a warp each if `warp_rows`.
struct Item {
  int32_t group, warp_rows, row0, rows;
};

struct Args {
  const int* tokens;
  const RowDesc* rows;
  const Item* items;
  const int* lengths;  // (C, E)
  const int* offsets;  // (C, E)
  const int* table;    // (T,)
  int* val;
  int* produced;
  int* consumed;
  int64_t T;
  int E;
};

struct Shared {
  // the round's codewords in order: first slot, position | kind <<
  // KIND_SHIFT, table offset; a block row uses all, a warp row its
  // WARP * WARP_RUN
  int start[THREADS * RUN];  // >= WARPS * WARP * WARP_RUN
  int qk[THREADS * RUN];
  int off[THREADS * RUN];
  // a window's marks (k + 1 at the first slot of codeword k; zero between
  // windows), each 32-slot group's last mark (zero between windows) and the
  // last mark before it
  int mark[STAGE];
  int gmax[GROUPS];
  int gpre[GROUPS];
  // a block row's warps: product of their runs, codewords and slots
  uint32_t mat[WARPS];
  int cnt[WARPS];
  uint32_t len[WARPS];
};

// the last k < n with s[k] <= x, for s[0] <= x and s non-decreasing
__device__ __forceinline__ int last_le(const int* s, int n, int x) {
  int lo = 0, up = n;  // s[lo] <= x < s[up]
  while (up - lo > 1) {
    const int mid = (lo + up) >> 1;
    if (s[mid] <= x)
      lo = mid;
    else
      up = mid;
  }
  return lo;
}

struct RowView {
  const int* tok;  // the row's W tokens
  const int* table;
  int T;  // < 2^31
  int W, wv;
};

// cw_safe at position p, payload reads clamped at W - 1, as u32
__device__ __forceinline__ uint32_t token_at(const RowView& r, int p) {
  const int pc = p < r.W - 1 ? p : r.W - 1;
  return pc < r.wv ? (uint32_t)__ldg(r.tok + pc) : (uint32_t)EXCEPTIONS;
}

// the plain version's table index of entry word k: offset + k in wrapping
// int32, wrapped once more when negative (in range: T < 2^31), clamped
__device__ __forceinline__ int table_index(const RowView& r, int off, int k) {
  int t = (int)((uint32_t)off + (uint32_t)k);
  if (t < 0) t += r.T;
  return t < 0 ? 0 : (t > r.T - 1 ? r.T - 1 : t);
}

// slot value of the codeword (q, kind, start, off) at slot j, before the n
// mask
template <int BITS>
__device__ __forceinline__ uint32_t slot_value(const RowView& r, int j, int q,
                                               int kind, int start, int off) {
  if (kind == DICT) {
    const int k = j - start;
    if (k >= MAX_ENTRY_SIZE) return 0u;
    return (uint32_t)__ldg(r.table + table_index(r, off, k));
  }
  const uint32_t t1 = token_at(r, q + 1);
  if (BITS == 16) {
    return kind == LARGE_EXC ? (t1 | (token_at(r, q + 2) << 16)) : t1;
  }
  const uint32_t t2 = token_at(r, q + 2);
  if (kind != LARGE_EXC) return t1 | (t2 << 8);
  return t1 | (t2 << 8) | (token_at(r, q + 3) << 16) |
         (token_at(r, q + 4) << 24);
}

template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if (TEAM == WARP)
    __syncwarp();
  else
    __syncthreads();
}

// One row decoded by a team of TEAM threads (a warp or the block); `t` is the
// thread's rank in the team, `s_*` the team's codeword lists, `mark`,
// `gmax`, `gpre` its window.
template <int BITS, bool CLEAN, int TEAM>
__device__ void decode_row(const Args& a, const RowDesc rd, const int t,
                           int* s_start, int* s_qk, int* s_off, int* mark,
                           int* gmax, int* gpre, Shared& sh) {
  using M = Mat<Steps<BITS>::D>;
  constexpr int TRUN = TEAM == WARP ? WARP_RUN : RUN;  // tokens a thread
  constexpr int CHUNK = TEAM * TRUN;
  constexpr int WS = TEAM == WARP ? WARP_STAGE : STAGE;
  constexpr int G = WS / WARP;                  // a window's groups
  constexpr int PER = (G + WARP - 1) / WARP;    // groups a lane scans
  const int lane = t % WARP;
  const int warp = t / WARP;  // in the team

  RowView r;
  r.tok = a.tokens + rd.tok;
  r.table = a.table;
  r.T = (int)a.T;
  r.W = rd.W;
  r.wv = rd.wv;
  const int E = a.E;
  const int* len_c = a.lengths + (int64_t)rd.ctx * E;
  const int* off_c = a.offsets + (int64_t)rd.ctx * E;
  const int n = rd.n;
  const int n_out = rd.n_out;
  const int w_eff = rd.wv < 0 ? 0 : (rd.wv < rd.W ? rd.wv : rd.W);
  const int last_j = n - 1 < 0 ? 0 : (n - 1 > n_out - 1 ? n_out - 1 : n - 1);
  int* out = a.val + rd.out;
  int* consumed = a.consumed + rd.idx;

  // the row's last visited codeword (q, kind, start, off); with none, the
  // plain version's wrap reads token EXCEPTIONS at q = 0 from slot 0 on
  int lq = 0, lk = DICT, ls = 0;
  int loff = __ldg(off_c + (EXCEPTIONS < E - 1 ? EXCEPTIONS : E - 1));
  uint32_t pend = 1;  // the walk's state at the chunk's first token
  int out_base = 0;   // the chunk's first slot

  int tok[TRUN];
#pragma unroll
  for (int i = 0; i < TRUN; ++i) {
    const int q = t * TRUN + i;
    tok[i] = q < w_eff ? __ldg(r.tok + q) : EXCEPTIONS;
  }
  for (int base = 0; base < w_eff; base += CHUNK) {
    const int q0 = base + t * TRUN;
    // the next chunk's tokens, asked for now
    int nxt[TRUN];
#pragma unroll
    for (int i = 0; i < TRUN; ++i) {
      const int q = q0 + CHUNK + i;
      nxt[i] = q < w_eff ? __ldg(r.tok + q) : EXCEPTIONS;
    }
    // the entries' lengths and offsets, before the scan
    int len[TRUN], off[TRUN];
#pragma unroll
    for (int i = 0; i < TRUN; ++i) {
      const int c = tok[i];
      const bool dict = q0 + i < w_eff && c >= EXCEPTIONS;
      const int e = c < E - 1 ? c : E - 1;
      len[i] = dict ? __ldg(len_c + e) : 1;
      off[i] = dict ? __ldg(off_c + e) : 0;
    }
    // the state entering this thread's run, and the next chunk's
    uint32_t s = pend, pend_next = pend;
    if (!CLEAN) {
      uint32_t p = M::IDENT;
#pragma unroll
      for (int i = 0; i < TRUN; ++i) {
        const int c = tok[i];
        p = M::push(p, q0 + i < w_eff && walks_on(c),
                    step_of<BITS>(kind_of(c)));
      }
#pragma unroll
      for (int d = 1; d < WARP; d *= 2) {
        const uint32_t o = __shfl_up_sync(FULL, p, d);
        if (lane >= d) p = M::compose(p, o);
      }
      uint32_t before = __shfl_up_sync(FULL, p, 1);
      if (lane == 0) before = M::IDENT;
      if (TEAM == WARP) {
        pend_next = M::apply(__shfl_sync(FULL, p, WARP - 1), pend);
      } else {
        if (lane == WARP - 1) sh.mat[warp] = p;
        __syncthreads();
#pragma unroll
        for (int w = 0; w < TEAM / WARP; ++w) {
          if (w == warp) s = pend_next;
          pend_next = M::apply(sh.mat[w], pend_next);
        }
      }
      s = M::apply(before, s);
    }
    // walk the run again from its state: visited tokens, their lengths
    uint32_t vis = 0;
    int cnt = 0;
    uint32_t lsum = 0;
#pragma unroll
    for (int i = 0; i < TRUN; ++i) {
      const int c = tok[i];
      const bool v = q0 + i < w_eff && (CLEAN || (s & 1u));
      if (!CLEAN)
        s = (s >> 1) |
            (v && walks_on(c) ? 1u << (step_of<BITS>(kind_of(c)) - 1) : 0u);
      vis |= (v ? 1u : 0u) << i;
      cnt += v ? 1 : 0;
      lsum += v ? (uint32_t)len[i] : 0u;
    }
    // the team's exclusive sums of codewords and slots
    int c_in = cnt;
    uint32_t l_in = lsum;
#pragma unroll
    for (int d = 1; d < WARP; d *= 2) {
      const int oc = __shfl_up_sync(FULL, c_in, d);
      const uint32_t ol = __shfl_up_sync(FULL, l_in, d);
      if (lane >= d) {
        c_in += oc;
        l_in += ol;
      }
    }
    int k = c_in - cnt;
    uint32_t st = (uint32_t)out_base + (l_in - lsum);
    int nvis;
    uint32_t total;
    if (TEAM == WARP) {
      nvis = __shfl_sync(FULL, c_in, WARP - 1);
      total = __shfl_sync(FULL, l_in, WARP - 1);
    } else {
      if (lane == WARP - 1) {
        sh.cnt[warp] = c_in;
        sh.len[warp] = l_in;
      }
      __syncthreads();
      nvis = 0;
      total = 0;
#pragma unroll
      for (int w = 0; w < TEAM / WARP; ++w) {
        const int cw = sh.cnt[w];
        const uint32_t lw = sh.len[w];
        if (w < warp) {
          k += cw;
          st += lw;
        }
        nvis += cw;
        total += lw;
      }
    }
    // the chunk's codewords in order (a warp row: after every lane has read
    // the last chunk's); their first table lines to L1
    if (TEAM == WARP) __syncwarp();
#pragma unroll
    for (int i = 0; i < TRUN; ++i) {
      if (vis & (1u << i)) {
        const int kind = kind_of(tok[i]);
        s_start[k] = (int)st;
        s_qk[k] = (q0 + i) | (kind << KIND_SHIFT);
        s_off[k] = off[i];
        if (kind == DICT) {
          const int* line = r.table + table_index(r, off[i], 0);
          asm volatile("prefetch.global.L1 [%0];" ::"l"(line));
        }
        ++k;
        st += (uint32_t)len[i];
      }
    }
    team_sync<TEAM>();
    if (nvis > 0) {
      const int qk = s_qk[nvis - 1];
      lq = qk & POS_MASK;
      lk = qk >> KIND_SHIFT;
      ls = s_start[nvis - 1];
      loff = s_off[nvis - 1];
    }
    const int end = (int)((uint32_t)out_base + total);
    const int hi = end < n_out ? end : n_out;
    // the slots [out_base, hi), a window of WS at a time: each codeword that
    // starts inside the window marks its first slot with k + 1 (the last of
    // those at one slot wins) and its group's last mark; a scan of the
    // groups' last marks gives each group the last mark before it (k0 + 1,
    // the codeword over the window's first slot, before the first); then
    // each slot's codeword is the highest mark at or below it in its group
    // (a ballot and a shuffle), or the group's carry
    for (int w0 = out_base; w0 < hi; w0 += WS) {
      const int nw = hi - w0 > WS ? WS : hi - w0;
      const int k0 = last_le(s_start, nvis, w0);
      const int k1 = last_le(s_start, nvis, w0 + nw - 1);
      for (int k = k0 + 1 + t; k <= k1; k += TEAM) {
        const int i = s_start[k] - w0;
        atomicMax(mark + i, k + 1);
        atomicMax(gmax + i / WARP, k + 1);
      }
      team_sync<TEAM>();
      if (warp == 0) {
        int m[PER], run = 0;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int g = lane * PER + p;
          m[p] = g < G ? gmax[g] : 0;
          if (g < G) gmax[g] = 0;
          run = m[p] > run ? m[p] : run;
        }
#pragma unroll
        for (int d = 1; d < WARP; d *= 2) {
          const int o = __shfl_up_sync(FULL, run, d);
          if (lane >= d) run = o > run ? o : run;
        }
        int carry = __shfl_up_sync(FULL, run, 1);
        carry = lane == 0 || carry < k0 + 1 ? k0 + 1 : carry;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int g = lane * PER + p;
          if (g < G) gpre[g] = carry;
          carry = m[p] > carry ? m[p] : carry;
        }
      }
      team_sync<TEAM>();
      constexpr int TW = TEAM / WARP;  // warps in the team
      for (int g0 = warp; g0 * WARP < nw; g0 += TW * GROUPS_IN_FLIGHT) {
        int kk[GROUPS_IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < GROUPS_IN_FLIGHT; ++u) {
          const int g = g0 + u * TW;
          const bool live = g * WARP < nw;  // the same for the warp
          const int i = g * WARP + lane;
          int m = 0;
          if (live) {
            m = mark[i];
            mark[i] = 0;
          }
          const unsigned below =
              __ballot_sync(FULL, m != 0) & ((2u << lane) - 1u);
          const int mk =
              __shfl_sync(FULL, m, below ? 31 - __clz(below) : lane);
          kk[u] = live && i < nw ? (below ? mk : gpre[g]) - 1 : -1;
        }
        uint32_t v[GROUPS_IN_FLIGHT];
        int cq[GROUPS_IN_FLIGHT], ck[GROUPS_IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < GROUPS_IN_FLIGHT; ++u) {
          v[u] = 0;
          cq[u] = 0;
          ck[u] = DICT;
          const int k = kk[u];
          const int j = w0 + (g0 + u * TW) * WARP + lane;
          if (k >= 0) {
            const int qk = s_qk[k];
            cq[u] = qk & POS_MASK;
            ck[u] = qk >> KIND_SHIFT;
            if (j < n)
              v[u] = slot_value<BITS>(r, j, cq[u], ck[u], s_start[k],
                                      s_off[k]);
          }
        }
#pragma unroll
        for (int u = 0; u < GROUPS_IN_FLIGHT; ++u) {
          const int j = w0 + (g0 + u * TW) * WARP + lane;
          if (kk[u] >= 0) {
            out[j] = (int)v[u];
            if (j == last_j) *consumed = cq[u] + step_of<BITS>(ck[u]);
          }
        }
      }
      team_sync<TEAM>();
    }
    out_base = end;
    pend = pend_next;
#pragma unroll
    for (int i = 0; i < TRUN; ++i) tok[i] = nxt[i];
    if (!CLEAN && pend == 0) break;  // the walk stopped: nothing more visited
  }
  // the tail [produced, n_out): the last codeword read on
  for (int j = (out_base > 0 ? out_base : 0) + t; j < n_out; j += TEAM) {
    out[j] = j < n ? (int)slot_value<BITS>(r, j, lq, lk, ls, loff) : 0;
    if (j == last_j) *consumed = lq + step_of<BITS>(lk);
  }
  if (t == 0) a.produced[rd.idx] = out_base;
}

template <int BITS, bool CLEAN>
__device__ __forceinline__ void run_item(const Args& a, const Item& it,
                                         Shared& sh) {
  if (it.warp_rows) {
    const int warp = threadIdx.x / WARP;
    if (warp < it.rows) {
      const int o = warp * WARP * WARP_RUN;
      const int g = warp * (WARP_STAGE / WARP);
      decode_row<BITS, CLEAN, WARP>(a, a.rows[it.row0 + warp],
                                    threadIdx.x % WARP, sh.start + o,
                                    sh.qk + o, sh.off + o,
                                    sh.mark + warp * WARP_STAGE, sh.gmax + g,
                                    sh.gpre + g, sh);
    }
  } else {
    decode_row<BITS, CLEAN, THREADS>(a, a.rows[it.row0], threadIdx.x,
                                     sh.start, sh.qk, sh.off, sh.mark,
                                     sh.gmax, sh.gpre, sh);
  }
}

__global__ void __launch_bounds__(THREADS) raw_pass_kernel(const Args a) {
  __shared__ Shared sh;
  for (int i = threadIdx.x; i < STAGE; i += THREADS) sh.mark[i] = 0;
  for (int i = threadIdx.x; i < GROUPS; i += THREADS) sh.gmax[i] = 0;
  __syncthreads();
  const Item it = a.items[blockIdx.x];
  switch (it.group) {
    case 0: run_item<16, false>(a, it, sh); break;
    case 1: run_item<8, false>(a, it, sh); break;
    case 2: run_item<16, true>(a, it, sh); break;
    case 3: run_item<8, true>(a, it, sh); break;
    default: break;
  }
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr():
// tokens (int32, every row's W tokens from its `tok`), rows (n_rows RowDesc,
// 40 bytes each), items (n_items Item, 16 bytes each, every row of the table
// in exactly one), lengths and offsets (C, E) int32, table (T,) int32, val
// (int32, every row's n_out slots from its `out`), produced and consumed
// (int32, one a row at its `idx`); `stream` is
// torch.cuda.current_stream().cuda_stream.  The wrapper
// (kernels/decode_xla.py PassTable) has checked dtypes, devices, shapes and
// contiguity, and every ctx in [0, C).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an item count past the grid, E <= EXCEPTIONS,
// or T outside [1, 2^31); no items launch nothing.
extern "C" {

int dint_raw_pass(const void* tokens, const void* rows, const void* items,
                  int64_t n_items, const void* lengths, const void* offsets,
                  const void* table, int E, int64_t T, void* val,
                  void* produced, void* consumed, void* stream) {
  if (n_items < 0 || n_items > 0x7FFFFFFF || E <= EXCEPTIONS || T < 1 ||
      T > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (n_items == 0) return (int)cudaSuccess;
  Args a;
  a.tokens = (const int*)tokens;
  a.rows = (const RowDesc*)rows;
  a.items = (const Item*)items;
  a.lengths = (const int*)lengths;
  a.offsets = (const int*)offsets;
  a.table = (const int*)table;
  a.val = (int*)val;
  a.produced = (int*)produced;
  a.consumed = (int*)consumed;
  a.T = T;
  a.E = E;
  raw_pass_kernel<<<(unsigned)n_items, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
