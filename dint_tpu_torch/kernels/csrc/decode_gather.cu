// Width-class gather kernels of the DINT serving-image decode (Hopper, sm_90a).
//
// The serving image holds, per row r of 256 (N_OUT) output ints, a byte
// index vidx[r, j] into a per-row local table and the row's int count n[r].
// Rows are split into three width classes by their table's contents; each
// class has one body here.  All three keep the raw-output contract of the
// Pallas kernels they replace, bit for bit:
//
//   K1 gather32: out[r,j] = tab[r, vidx[r,j]]                  (exact)
//   K2 gather16: out[r,j] = u16(tab[r, idx>>1] >>> 16*(idx&1)) + salt
//   K3 zero:     out[r,j] = salt
//
// on valid lanes (j < n[r]) and 0 elsewhere, with u32 wrap arithmetic.  A
// caller of the raw contract folds the salt of K2/K3 into its chained-run
// sum; the fused launch below can also leave it out (its `exact` flag), so
// that no pass over the output is needed to remove it.  The salt is read from
// a 1-element int64 device tensor holding the u32 value (its low 32 bits are
// used), so a chain of runs never syncs with the host.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintgather.so decode_gather.cu
//
// What bounds these kernels on this card, and what the design does about it.
// K2 and K3 move tens of megabytes a call and are bound by bytes.  K1 is not:
// on the decode paths its class is a few hundred real rows padded to the row
// tile, under a microsecond of bytes, and a grid of its own pays the launch
// and drain of a grid and, inside each block, its trips to device memory one
// after the other: latency, several times the bytes' time.  So
//
//  * the engine's run is ONE launch (decode_classes_kernel) over the tiles
//    of all three classes, each tile run by its class's body; K1's few tiles
//    ride among the thousands of K2's and K3's, which hide their latency;
//  * the stand-alone gather body (gather_rows, one template for K1 and K2)
//    makes ONE trip to device memory: it starts the table's asynchronous
//    copies (cp.async.cg, 16 bytes a thread, one commit and one wait) and at
//    once asks for its vidx word and n, so all three are in flight together
//    and nothing waits for n.  Reading n first, to let blocks of empty rows
//    (the padding) return without their tables, saves under 2% of a run's
//    bytes and puts a second, dependent trip into every live block, which
//    cost K2 some 8% on the bench image.
//
// The fused launch is bound by its own bytes, which are more than a decode's
// least bytes: it reads the gather image (vidx, tables, n: 2.35 B an int
// padded) and writes 4 B a lane, padding lanes too.  On the benchmark's
// 90,855,447-posting Gov2-shaped image (403,456 rows: 264,192 u16, 40,960
// i32, 98,304 zero) a launch read 256.9 MB and wrote 413.1 MB: 670.1 MB,
// 200.0 us at 3.35 TB/s (trimmed classes, below, read 207.2 MB).  On an NVIDIA H100 80GB HBM3 (700 W) torch's copy_
// moves as many bytes in 222 us (90%), fill_ writes 413 MB at 96%.  The
// launch's first design gave each block one tile of 1024 lanes and one trip
// to memory (loads, wait, gather and store, exit): 82,432 blocks in some 78
// waves, no block with loads in flight while it stores, at most 24 KiB of
// reads in flight an SM, and only while every resident block was loading.
// It took 240-243 us there, 82-83% of its bytes' time.  The launch is now
// a persistent walk over row tiles:
//
//  * the grid is min(tiles, resident blocks), the resident count found once
//    a device and width from the SM count and the kernel's occupancy;
//  * block b walks tiles b, b + grid, ... (u16 tiles, then i32, then zero)
//    through a ring of WALK_STAGES tiles in shared memory, each stage filled
//    by bulk copies (cp.async.bulk, one thread) that complete on its
//    mbarrier, and refilled with the tile WALK_STAGES ahead as soon as the
//    block has read it: the next tiles' loads stay in flight while the
//    block gathers and stores;
//  * a walking tile is WALK_ROWS = 32 rows (24 KiB read and 32 KiB written
//    a u16 tile at n_out 256), two stages, two blocks an SM.  Larger tiles
//    measured faster than deeper rings of smaller ones (8 rows and four
//    stages 244 us, 16 rows and three 233, 32 rows and two 228-230; 32 rows
//    and one stage still 234): what the walk buys is long copies and stores
//    and few turns of the loop more than the depth of the ring;
//  * the stores stream (st.global.cs, evict first).  Timed alone, each
//    launch behind a pass that leaves the L2 cache clean, the walk with
//    plain stores gained 5%; back to back, as the engines run it, each
//    launch also writes back the dirty output the one before left in L2,
//    and it gained nothing (266.6-267.6 against 268.4 us a run with the
//    benchmark's checksum between launches).  With evict-first stores it
//    gains there too (257.7-258.4); the first design's body gains nothing
//    from them (268.3);
//  * a launch whose tiles fit the grid at once takes the fewest rows a tile
//    that fit (4 for a serving call), one tile a block, one trip, so that a
//    small launch spreads over as many blocks as the first design's.
//
// In the benchmark's chained runs on an NVIDIA H100 80GB HBM3 (700 W) the
// launch takes 228.8 us a run against the first design's 242.1 (2.93 TB/s
// of its own bytes); alone it took 228.8 against 240.6 us, 40.7 against
// 44.0 on the 6,000-list bench image's shape, and serving-sized launches
// are level (6.3-6.7 us either way).  Tried and left: a bulk store of
// each tile from shared memory (1% faster alone, level back to back,
// slower on middling launches), evict-first loads, zero tiles spread among
// the gather tiles, the last warp to leave a stage refilling it in place
// of a block barrier (each as fast or slower).
//
// The launch reads the engines' u16 and i32 classes trimmed (see Classes):
// of a row only the vidx lanes below n and the table entries its valid
// lanes read past the planner's zero region, which is 0 and which a lane
// below `skip` reads as 0 without a load.  A padded row copies 256 lanes
// and 256 entries whatever it uses.  On the benchmark's image the reads
// fall from 256.9 to 207.2 MB a run (vidx 78.1 -> 68.0, tables 177.2 ->
// 135.1, row starts 2.4 MB added), 620.3 MB in all with the 413.1 MB
// written.  A trimmed tile's bytes are one range of each class tensor, so
// the walk still fills a stage with one bulk copy of each part; the range
// needs the tile's first row's starts, a read the copies depend on, which
// the thread that issues them makes a stage before it issues them (at a
// block's start, before the mbarriers are set up).  Padded classes (the
// stand-alone entry's triples) take the same walk at the fixed stride.  In
// the benchmark's chained runs on an NVIDIA H100 80GB HBM3 (700 W) the
// launch takes 217.0 us a run against 228.8 padded (2.86 TB/s of its own
// bytes).  Where a launch's tiles fit the grid at once (a serving call: one
// 4-row tile a block), the dependent read is not hidden and a trimmed
// launch takes some 0.3-0.5 us more than a padded one (7.0-7.1 against
// 6.7 us); passing the tiles' starts as a kernel parameter instead cost as
// much in launch latency as it saved.  On the 6,000-list bench image,
// whose rows are nearly full, trimming saves 4% of the bytes and the
// launch is 2-4% slower (42.7 against 41.0 us).  __launch_bounds__ asks for
// two blocks an SM, which the shared memory allows anyway: it let the
// compiler keep more in registers, 3% faster on trimmed classes.
//
// Launch shape of the stand-alone gather bodies: one block of 256 threads
// covers ROWS_PER_BLOCK = 1024 / n_out rows (4 at n_out = 256); thread t of a row
// owns output lanes 4t..4t+3, so it reads one uchar4 of vidx and writes one
// int4 of output (16 B, coalesced across the warp).  The rows' tables sit in
// shared memory, so each table byte is read from device memory exactly once
// and the data-dependent gather hits shared memory rather than L1/L2.
//
// K3 is write-only: 4 B of n a row in, 4 * n_out B a row out, a compare a
// lane.  Its block is the fill's shape, not the rows': ZERO_VEC int4 stores
// a thread, ZERO_VEC * 4 KiB a block (16 rows at n_out 256), the stores THREADS
// int4 apart so that each is coalesced across the warp.  A thread asks for
// the n of its ZERO_VEC rows at once, together with the salt, and then
// issues its stores back to back, so a block waits for one trip to device
// memory; the lanes of a warp read the same n word (one request a warp and
// row).  The exact output (salt left out) is 0 on every lane whatever n
// says: it reads no n and no salt.
// On the bench image's zero class (15,632 rows, 16.0 MB) chip_smoke.py
// measured, in turns on an NVIDIA H100 80GB HBM3 (700 W), this body alone
// level with the earlier one (4 KiB a block, one int4 a thread, each thread
// loading its n before its one store): 9.36 against 9.55 us in one call,
// 9.42 against 9.57 in another, 9.63-9.78 against 9.61-9.72 in three
// others; and slower than fill_ (8.99 us), against a 5.03 us bound: a
// kernel that must read its fill value from device memory pays one trip
// that fill_, whose value is a launch argument, does not.  Inside the fused
// launch as it was before the walk (one block a tile), where K3 ran on every
// path, it won in every call: the zero class alone took 9.90 us against the
// earlier body's 11.60, and the whole launch 43.78 against 45.79 (216.99
// against 222.67 at 90,855,447 postings).  The walk's zero tiles take K3's
// arithmetic and the gather tiles' shape and pipeline.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TABLE_CLS = 256;        // local table entries per row
constexpr int LANES_PER_BLOCK = 1024;  // n_out * rows per block
constexpr int MAX_ROWS_PER_BLOCK = 8;  // n_out >= 128
constexpr int TAB_S_WORDS = MAX_ROWS_PER_BLOCK * TABLE_CLS;
constexpr int ZERO_VEC = 4;  // K3: int4 stores a thread
constexpr int ZERO_INT4_PER_BLOCK = THREADS * ZERO_VEC;

// Start the copy of `rows_here` consecutive rows of a (R, words) u32 table
// into shared memory: 16 bytes a thread and step, asynchronous, one group.
__device__ __forceinline__ void stage_table_async(uint32_t* tab_s,
                                                  const uint32_t* __restrict__ tab,
                                                  int64_t row0, int rows_here,
                                                  int words) {
  const uint4* src = reinterpret_cast<const uint4*>(tab + row0 * words);
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(tab_s);
  const int n4 = rows_here * words / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i),
                 "l"(src + i));
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ uint32_t u16_entry(const uint32_t* t, uint32_t idx) {
  const uint32_t w = t[idx >> 1];
  return ((idx & 1u) ? (w >> 16) : w) & 0xFFFFu;  // logical shift on u32
}

// One table entry of a row: the full word (MODE 32; the salt is wrap-added
// and subtracted as in the Pallas body and cancels exactly) or one u16 half
// of a packed word plus `add` (MODE 16; `add` is the salt, or 0 for the exact
// output).
template <int MODE>
__device__ __forceinline__ int entry(const uint32_t* t, uint32_t idx,
                                     uint32_t salt, uint32_t add) {
  if (MODE == 32) return (int)((t[idx] + salt) - salt);
  return (int)(u16_entry(t, idx) + add);
}

// K1 (MODE 32) — replaces dint_tpu/kernels/decode_local.py:_gather32_body
// (launched by _pallas_gather_kernel through _pallas_split_fns, mode 32).
// K2 (MODE 16) — replaces :_gather16_body (_pallas_gather16_kernel, mode 16).
// Rows of block `block` of one class.  Per row the body moves n_out B of
// vidx, 1 KiB (K1) or 512 B (K2: two u16 entries a word) of table, 4 B of n
// and 4*n_out B of output, and does a select (K1) or a shift, mask and add
// (K2) per output: far below the card's integer rate.  TPU: two 128-lane
// table halves selected by index bit 7; here one shared array indexed
// directly.
// Every thread of the block must enter (block-wide barriers inside).
template <int MODE>
__device__ __forceinline__ void gather_rows(
    const uint8_t* __restrict__ vidx, const uint32_t* __restrict__ tab,
    const int32_t* __restrict__ n, uint32_t salt, bool exact,
    int32_t* __restrict__ out, int64_t rows, int n_out, int64_t block,
    uint32_t* tab_s) {
  constexpr int WORDS = MODE == 32 ? TABLE_CLS : TABLE_CLS / 2;
  const int rpb = LANES_PER_BLOCK / n_out;
  const int64_t row0 = block * rpb;
  const int64_t left = rows - row0;
  const int rows_here = left < rpb ? (int)left : rpb;
  const int per_row = n_out / 4;
  const int lr = threadIdx.x / per_row;
  const bool mine = lr < rows_here;
  const int64_t r = row0 + lr;
  const int j = (threadIdx.x - lr * per_row) * 4;
  stage_table_async(tab_s, tab, row0, rows_here, WORDS);
  uchar4 ix = make_uchar4(0, 0, 0, 0);
  int nr = 0;
  if (mine) {
    ix = __ldg(reinterpret_cast<const uchar4*>(vidx + r * n_out + j));
    nr = __ldg(n + r);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (!mine) return;
  const uint32_t* t = tab_s + lr * WORDS;
  const uint32_t add = exact ? 0u : salt;
  int4 o;
  o.x = j + 0 < nr ? entry<MODE>(t, ix.x, salt, add) : 0;
  o.y = j + 1 < nr ? entry<MODE>(t, ix.y, salt, add) : 0;
  o.z = j + 2 < nr ? entry<MODE>(t, ix.z, salt, add) : 0;
  o.w = j + 3 < nr ? entry<MODE>(t, ix.w, salt, add) : 0;
  reinterpret_cast<int4*>(out + r * n_out)[j / 4] = o;
}

// K3 — replaces dint_tpu/kernels/decode_local.py:_zero_body (launched by
// _pallas_zero_kernel through _pallas_split_fns, mode 0).
// Block `block` of the class writes int4 g = block * ZERO_INT4_PER_BLOCK +
// k * THREADS + threadIdx.x of the class's rows, k < ZERO_VEC; an int4 past
// the class (a last block only partly filled) is not written.  `fill` is the
// salt, still in flight from its load when the n loads are issued, so both
// trips overlap; `exact` (a launch argument) writes 0 everywhere and reads
// no n.  `row_shift` is log2(n_out / 4).
__device__ __forceinline__ void zero_rows(const int32_t* __restrict__ n,
                                          int32_t fill, bool exact,
                                          int32_t* __restrict__ out,
                                          int64_t rows, int n_out,
                                          int64_t block) {
  const int row_shift = __ffs(n_out / 4) - 1;
  const int64_t end = rows << row_shift;
  const int64_t g0 = block * ZERO_INT4_PER_BLOCK + threadIdx.x;
  int4* o = reinterpret_cast<int4*>(out);
  if (exact) {
    const int4 v = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < ZERO_VEC; ++k) {
      const int64_t g = g0 + k * THREADS;
      if (g < end) o[g] = v;
    }
    return;
  }
  int nr[ZERO_VEC];
#pragma unroll
  for (int k = 0; k < ZERO_VEC; ++k) {
    const int64_t g = g0 + k * THREADS;
    nr[k] = g < end ? __ldg(n + (g >> row_shift)) : 0;
  }
#pragma unroll
  for (int k = 0; k < ZERO_VEC; ++k) {
    const int64_t g = g0 + k * THREADS;
    if (g >= end) continue;
    const int j = (int)(g & ((1 << row_shift) - 1)) * 4;
    const int4 v = make_int4(j + 0 < nr[k] ? fill : 0, j + 1 < nr[k] ? fill : 0,
                             j + 2 < nr[k] ? fill : 0, j + 3 < nr[k] ? fill : 0);
    o[g] = v;
  }
}

// Blocks a class of `rows` rows takes in the gather bodies (K1, K2).
__host__ __device__ __forceinline__ int64_t class_blocks(int64_t rows, int n_out) {
  const int rpb = LANES_PER_BLOCK / n_out;
  return (rows + rpb - 1) / rpb;
}

// Blocks the zero class of `rows` rows takes in K3's body.
__host__ __device__ __forceinline__ int64_t zero_blocks(int64_t rows, int n_out) {
  const int64_t int4s = rows * (n_out / 4);
  return (int4s + ZERO_INT4_PER_BLOCK - 1) / ZERO_INT4_PER_BLOCK;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const uint8_t* __restrict__ vidx, const uint32_t* __restrict__ tab,
              const int32_t* __restrict__ n, const long long* __restrict__ salt_p,
              int32_t* __restrict__ out, int64_t rows, int n_out) {
  __shared__ __align__(16) uint32_t tab_s[TAB_S_WORDS];
  gather_rows<MODE>(vidx, tab, n, (uint32_t)__ldg(salt_p), false, out, rows,
                    n_out, blockIdx.x, tab_s);
}

__global__ void __launch_bounds__(THREADS)
zero_kernel(const int32_t* __restrict__ n, const long long* __restrict__ salt_p,
            int32_t* __restrict__ out, int64_t rows, int n_out) {
  zero_rows(n, (int32_t)(uint32_t)__ldg(salt_p), false, out, rows, n_out,
            blockIdx.x);
}

// The three classes of one engine run.  Output rows are class-major in the
// engine's order (zero, u16, i32); a class may be empty.  A gather class
// comes padded (starts null: row r's vidx at r * n_out, its table at
// r * words) or trimmed: row r keeps vidx lanes [0, n_r) and table entries
// [skip, used_r), used_r one past the highest index its valid lanes read,
// each part rounded up to 16 bytes, the rows end to end; starts[r] holds
// the first 16-byte word of row r's vidx (.x) and table (.y), and
// starts[rows] the ends.  `skip` is 16 where every row's first 16 entries
// (the planner's zero region) are 0, which a trimmed row then leaves out
// and a lane whose index is below it reads as 0, and 0 otherwise.
struct Classes {
  const int32_t* n0;
  const uint8_t* vidx16;
  const uint32_t* tab16;
  const int32_t* n16;
  const int2* starts16;
  const uint8_t* vidx32;
  const uint32_t* tab32;
  const int32_t* n32;
  const int2* starts32;
  int skip16, skip32;
  int64_t rows0, rows16, rows32;
};

// ---------------------------------------------------------------------------
// The fused class launch: a persistent walk over row tiles.
// ---------------------------------------------------------------------------

// The walk's shape, chosen on the card (PERF.md §6): a tile is at most
// WALK_ROWS rows of one class, and each block keeps the loads of WALK_STAGES
// tiles in flight.  A tile's rows are a multiple of 4, so that a whole
// tile's n is a run of 16-byte words that one bulk copy can take.
constexpr int WALK_ROWS = 32;
constexpr int WALK_STAGES = 2;
constexpr int WALK_THREADS = 256;
constexpr int WALK_BAR_BYTES = 128;  // the stages' mbarriers, before the stages
static_assert(WALK_ROWS % 4 == 0, "a whole tile's n must be 16-byte words");
static_assert(8 * WALK_STAGES <= WALK_BAR_BYTES, "mbarriers outgrow their room");

// One stage of the ring holds a tile's vidx (WALK_ROWS * n_out bytes), its
// table (room for the i32 class's, the wider), its n and a trimmed tile's
// row starts, each part 16-byte aligned.  A trimmed tile's rows take no
// more: none keeps more than n_out vidx lanes or TABLE_CLS table words.
__host__ __device__ constexpr int walk_tab_off(int n_out) {
  return WALK_ROWS * n_out;
}
__host__ __device__ constexpr int walk_n_off(int n_out) {
  return WALK_ROWS * (n_out + TABLE_CLS * 4);
}
__host__ __device__ constexpr int walk_starts_off(int n_out) {
  return WALK_ROWS * (n_out + TABLE_CLS * 4 + 4);
}
__host__ __device__ constexpr int walk_stage_bytes(int n_out) {
  return WALK_ROWS * (n_out + TABLE_CLS * 4 + 12);
}
__host__ __device__ constexpr int walk_smem_bytes(int n_out) {
  return WALK_BAR_BYTES + WALK_STAGES * walk_stage_bytes(n_out);
}
static_assert(walk_smem_bytes(1024) <= 232448, "a block's shared memory");

__host__ __device__ __forceinline__ int64_t walk_tiles(int64_t rows,
                                                      int tile_rows) {
  return (rows + tile_rows - 1) / tile_rows;
}

// A launch's tiling: the rows of its tiles, the tiles of the u16 and i32
// classes, and all its tiles.
struct Walk {
  int rows;
  int64_t t16, t32, tiles;
};

// The tiling of a launch: the fewest rows a tile (a multiple of 4, up to
// WALK_ROWS) whose tiles the resident blocks take at once, so that a small
// launch spreads over as many blocks as it has tiles; WALK_ROWS, and a walk,
// where even those tiles outnumber the resident blocks.
Walk walk_of(int64_t rows0, int64_t rows16, int64_t rows32, int64_t resident) {
  Walk w;
  for (w.rows = 4;; w.rows += 4) {
    w.t16 = walk_tiles(rows16, w.rows);
    w.t32 = walk_tiles(rows32, w.rows);
    w.tiles = w.t16 + w.t32 + walk_tiles(rows0, w.rows);
    if (w.tiles <= resident || w.rows >= WALK_ROWS) return w;
  }
}

// Tile t of a launch: the u16 class's tiles first, then the i32 class's,
// then the zero class's, each class tiled on its own, so that no tile
// straddles two bodies.
struct Tile {
  int mode;      // 16, 32, or 0 for the zero class
  int rows;      // the walk's rows, or fewer in a class's last tile
  int64_t row0;  // the tile's first row in its class
  int64_t out0;  // and in the output
};

__device__ __forceinline__ Tile walk_tile(const Classes& c, const Walk& w,
                                          int64_t t) {
  Tile k;
  int64_t rows, base;
  if (t < w.t16) {
    k.mode = 16, rows = c.rows16, base = c.rows0;
  } else if (t < w.t16 + w.t32) {
    t -= w.t16;
    k.mode = 32, rows = c.rows32, base = c.rows0 + c.rows16;
  } else {
    t -= w.t16 + w.t32;
    k.mode = 0, rows = c.rows0, base = 0;
  }
  k.row0 = t * w.rows;
  const int64_t left = rows - k.row0;
  k.rows = left < w.rows ? (int)left : w.rows;
  k.out0 = base + k.row0;
  return k;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// The one arrival of a stage's phase, with the bytes its copies will bring.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, completed on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Where a trimmed tile's bytes lie: the starts of its first row (lo) and
// those past its last row (hi), read by the one thread that issues its
// copies, a stage before it issues them; zeros for any other tile.
struct Span {
  int2 lo, hi;
};

__device__ __forceinline__ Span walk_span(const Classes& c, const Tile& k) {
  Span sp = {make_int2(0, 0), make_int2(0, 0)};
  const int2* st = k.mode == 16 ? c.starts16 : k.mode == 32 ? c.starts32
                                                            : nullptr;
  if (st) {
    sp.lo = __ldg(st + k.row0);
    sp.hi = __ldg(st + k.row0 + k.rows);
  }
  return sp;
}

// Start tile t's loads into the stage at `stage` (one thread): a gather
// tile's vidx and table bytes (a padded tile's whole rows, a trimmed tile's
// range `sp` of each, none where its rows keep none), and every tile's n,
// and a trimmed tile's row starts, where the tile is whole and the body
// reads them (the exact zero output reads none).  A class's short last
// tile's n and starts need not be whole 16-byte words: its threads read
// them themselves.  Nothing past a class's tensors is read.
__device__ __forceinline__ void walk_issue(const Classes& c, const Walk& w,
                                           const Tile& k, const Span& sp,
                                           int n_out, bool exact,
                                           uint32_t stage, uint32_t bar) {
  const int32_t* n = k.mode == 16 ? c.n16 : k.mode == 32 ? c.n32 : c.n0;
  const bool whole = k.rows == w.rows;
  const uint32_t nb = whole && !(k.mode == 0 && exact) ? w.rows * 4 : 0;
  if (k.mode == 0) {
    bar_expect(bar, nb);
  } else {
    const int words = k.mode == 16 ? TABLE_CLS / 2 : TABLE_CLS;
    const uint8_t* vidx = k.mode == 16 ? c.vidx16 : c.vidx32;
    const uint8_t* tab = reinterpret_cast<const uint8_t*>(
        k.mode == 16 ? c.tab16 : c.tab32);
    const int2* st = k.mode == 16 ? c.starts16 : c.starts32;
    uint32_t vb, tb, sb = 0;
    if (st) {
      vidx += (int64_t)sp.lo.x * 16, tab += (int64_t)sp.lo.y * 16;
      vb = (uint32_t)(sp.hi.x - sp.lo.x) * 16;
      tb = (uint32_t)(sp.hi.y - sp.lo.y) * 16;
      if (whole) sb = w.rows * 8;
    } else {
      vidx += k.row0 * n_out, tab += k.row0 * words * 4;
      vb = k.rows * n_out, tb = k.rows * words * 4;
    }
    bar_expect(bar, vb + tb + nb + sb);
    if (vb) bulk_load(stage, vidx, vb, bar);
    if (tb) bulk_load(stage + walk_tab_off(n_out), tab, tb, bar);
    if (sb) bulk_load(stage + walk_starts_off(n_out), st + k.row0, sb, bar);
  }
  if (nb) bulk_load(stage + walk_n_off(n_out), n + k.row0, nb, bar);
}

// Table entry `idx` of a row whose table the stage holds from entry `skip`
// on: 0 below it (the zero region, which a trimmed row leaves out), plus
// `add` at MODE 16 as entry() adds it.
template <int MODE>
__device__ __forceinline__ int entry_from(const uint32_t* t, uint32_t idx,
                                          int skip, uint32_t salt,
                                          uint32_t add) {
  if ((int)idx < skip) return MODE == 32 ? 0 : (int)add;
  return entry<MODE>(t, idx - skip, salt, add);
}

// A gather tile (K2's body at MODE 16, K1's at MODE 32) from its stage `s`,
// whose n (and a trimmed tile's starts) the stage holds where the tile is
// `whole` (the walk's rows): int4 q of the tile (row q / (n_out / 4)) goes
// to thread q % WALK_THREADS, so each store is 16 bytes and coalesced
// across the warp.  Row lr's vidx and table lie at lr * n_out and
// lr * WORDS in the stage for a padded tile, at its starts less the
// tile's first row's for a trimmed one; a lane at or past n reads
// neither.  The stores stream (st.global.cs, evict first): nothing in the
// launch reads the output again.
template <int MODE, bool TRIM>
__device__ __forceinline__ void walk_gather(const uint8_t* s, const Tile& k,
                                            bool whole,
                                            const int32_t* __restrict__ n,
                                            const int2* __restrict__ starts,
                                            int skip, uint32_t salt,
                                            uint32_t add,
                                            int32_t* __restrict__ out,
                                            int n_out) {
  constexpr int WORDS = MODE == 32 ? TABLE_CLS : TABLE_CLS / 2;
  const int row_shift = __ffs(n_out / 4) - 1;
  const uint32_t* tab_s =
      reinterpret_cast<const uint32_t*>(s + walk_tab_off(n_out));
  const int32_t* n_s = reinterpret_cast<const int32_t*>(s + walk_n_off(n_out));
  const int2* st_s = reinterpret_cast<const int2*>(s + walk_starts_off(n_out));
  int2 first = make_int2(0, 0);
  if (TRIM) first = whole ? st_s[0] : __ldg(starts + k.row0);
  int4* o = reinterpret_cast<int4*>(out + k.out0 * n_out);
  for (int q = threadIdx.x; q < k.rows << row_shift; q += WALK_THREADS) {
    const int lr = q >> row_shift;
    const int j = (q & ((1 << row_shift) - 1)) * 4;
    const int nr = whole ? n_s[lr] : __ldg(n + k.row0 + lr);
    int4 v;
    if (TRIM) {
      const int2 a = whole ? st_s[lr] : __ldg(starts + k.row0 + lr);
      const uchar4 ix =
          *reinterpret_cast<const uchar4*>(s + (a.x - first.x) * 16 + j);
      const uint32_t* t = tab_s + (a.y - first.y) * 4;
      v.x = j + 0 < nr ? entry_from<MODE>(t, ix.x, skip, salt, add) : 0;
      v.y = j + 1 < nr ? entry_from<MODE>(t, ix.y, skip, salt, add) : 0;
      v.z = j + 2 < nr ? entry_from<MODE>(t, ix.z, skip, salt, add) : 0;
      v.w = j + 3 < nr ? entry_from<MODE>(t, ix.w, skip, salt, add) : 0;
    } else {
      const uchar4 ix = reinterpret_cast<const uchar4*>(s)[q];
      const uint32_t* t = tab_s + lr * WORDS;
      v.x = j + 0 < nr ? entry<MODE>(t, ix.x, salt, add) : 0;
      v.y = j + 1 < nr ? entry<MODE>(t, ix.y, salt, add) : 0;
      v.z = j + 2 < nr ? entry<MODE>(t, ix.z, salt, add) : 0;
      v.w = j + 3 < nr ? entry<MODE>(t, ix.w, salt, add) : 0;
    }
    __stcs(o + q, v);
  }
}

// A zero-class tile (K3's body): the fill on valid lanes, 0 elsewhere, in
// the gather tiles' store order; the exact output is 0 and reads no n.
__device__ __forceinline__ void walk_zero(const uint8_t* s, const Tile& k,
                                          bool whole,
                                          const int32_t* __restrict__ n,
                                          int32_t fill, bool exact,
                                          int32_t* __restrict__ out,
                                          int n_out) {
  const int row_shift = __ffs(n_out / 4) - 1;
  const int32_t* n_s = reinterpret_cast<const int32_t*>(s + walk_n_off(n_out));
  int4* o = reinterpret_cast<int4*>(out + k.out0 * n_out);
  for (int q = threadIdx.x; q < k.rows << row_shift; q += WALK_THREADS) {
    const int lr = q >> row_shift;
    const int j = (q & ((1 << row_shift) - 1)) * 4;
    const int nr = exact ? 0 : whole ? n_s[lr] : __ldg(n + k.row0 + lr);
    __stcs(o + q, make_int4(j + 0 < nr ? fill : 0, j + 1 < nr ? fill : 0,
                            j + 2 < nr ? fill : 0, j + 3 < nr ? fill : 0));
  }
}

// The fused class launch.  Block b walks tiles b, b + gridDim.x, ...; its
// k-th tile lands in stage k % WALK_STAGES, whose mbarrier completes once a
// round (parity k / WALK_STAGES % 2).  Thread 0 starts the first stages'
// loads, and refills a stage with the block's tile WALK_STAGES ahead as
// soon as every thread has read it, so that the next tiles' loads are in
// flight while the block gathers and stores this one.  With no more tiles
// than the grid holds, each block takes one tile.
__global__ void __launch_bounds__(WALK_THREADS, 2)
decode_classes_kernel(Classes c, Walk w, const long long* __restrict__ salt_p,
                      int32_t* __restrict__ out, int n_out, int exact) {
  extern __shared__ __align__(128) uint8_t walk_s[];
  const int64_t tiles = w.tiles;
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(walk_s);
  const uint32_t stages = bars + WALK_BAR_BYTES;
  const int stage_bytes = walk_stage_bytes(n_out);
  const bool ex = exact != 0;
  if (threadIdx.x == 0) {
    // the first tiles' row starts are asked for before the mbarriers are
    // set up, so that the two overlap
    Tile k[WALK_STAGES];
    Span sp[WALK_STAGES];
    int64_t t = blockIdx.x;
    for (int s = 0; s < WALK_STAGES && t < tiles; ++s, t += gridDim.x) {
      k[s] = walk_tile(c, w, t);
      sp[s] = walk_span(c, k[s]);
    }
    for (int s = 0; s < WALK_STAGES; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    t = blockIdx.x;
    for (int s = 0; s < WALK_STAGES && t < tiles; ++s, t += gridDim.x)
      walk_issue(c, w, k[s], sp[s], n_out, ex, stages + s * stage_bytes,
                 bars + 8 * s);
  }
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  const uint32_t add = ex ? 0u : salt;
  __syncthreads();
  int s = 0;
  uint32_t parity = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    // the tile this stage takes next: thread 0 asks where its bytes lie
    // now, so that the answer is in by the time it issues the copies
    const int64_t next = t + (int64_t)WALK_STAGES * gridDim.x;
    Tile nk = {};
    Span nsp = {};
    if (threadIdx.x == 0 && next < tiles) {
      nk = walk_tile(c, w, next);
      nsp = walk_span(c, nk);
    }
    bar_wait(bars + 8 * s, parity);
    const Tile k = walk_tile(c, w, t);
    const bool whole = k.rows == w.rows;
    const uint8_t* st = walk_s + WALK_BAR_BYTES + s * stage_bytes;
    if (k.mode == 16 && c.starts16)
      walk_gather<16, true>(st, k, whole, c.n16, c.starts16, c.skip16, salt,
                            add, out, n_out);
    else if (k.mode == 16)
      walk_gather<16, false>(st, k, whole, c.n16, c.starts16, c.skip16, salt,
                             add, out, n_out);
    else if (k.mode == 32 && c.starts32)
      walk_gather<32, true>(st, k, whole, c.n32, c.starts32, c.skip32, salt,
                            add, out, n_out);
    else if (k.mode == 32)
      walk_gather<32, false>(st, k, whole, c.n32, c.starts32, c.skip32, salt,
                             add, out, n_out);
    else
      walk_zero(st, k, whole, c.n0, (int32_t)salt, ex, out, n_out);
    __syncthreads();  // every thread is done with the stage
    if (threadIdx.x == 0 && next < tiles) {
      // the stage's reads came through the generic proxy, its refill comes
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      walk_issue(c, w, nk, nsp, n_out, ex, stages + s * stage_bytes,
                 bars + 8 * s);
    }
    if (++s == WALK_STAGES) s = 0, parity ^= 1;
  }
}

// The walk's resident blocks on the current device at n_out: the SMs times
// the blocks an SM holds at the launch's shared memory, found once a device
// and width and kept.  The first call on a device also lets the kernel take
// the shared memory of the widest rows, past 48 KB.
constexpr int WALK_DEVICES = 64;  // devices whose counts are kept

int walk_resident(int n_out, int64_t* resident) {
  static int64_t kept[WALK_DEVICES][4];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int w = __builtin_ctz(n_out / 128);  // 128, 256, 512, 1024: 0-3
  if (dev < WALK_DEVICES && kept[dev][w]) {
    *resident = kept[dev][w];
    return 0;
  }
  e = cudaFuncSetAttribute(decode_classes_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           walk_smem_bytes(1024));
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_classes_kernel, WALK_THREADS, walk_smem_bytes(n_out));
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t r = (int64_t)sms * per_sm;
  if (dev < WALK_DEVICES) kept[dev][w] = r;
  *resident = r;
  return 0;
}

// Nothing: the floor that any launch of its own pays, for the measurements.
__global__ void empty_kernel() {}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes, shapes, contiguity, 16-byte alignment, rows > 0 and
// n_out in {128, 256, 512, 1024}.  Each returns cudaGetLastError().
extern "C" {

int dint_gather32(const void* vidx, const void* tab, const void* n,
                  const void* salt, void* out, int64_t rows, int n_out,
                  void* stream) {
  gather_kernel<32><<<(unsigned)class_blocks(rows, n_out), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows, n_out);
  return (int)cudaGetLastError();
}

int dint_gather16(const void* vidx, const void* tab, const void* n,
                  const void* salt, void* out, int64_t rows, int n_out,
                  void* stream) {
  gather_kernel<16><<<(unsigned)class_blocks(rows, n_out), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows, n_out);
  return (int)cudaGetLastError();
}

int dint_zero(const void* n, const void* salt, void* out, int64_t rows,
              int n_out, void* stream) {
  zero_kernel<<<(unsigned)zero_blocks(rows, n_out), THREADS, 0,
                (cudaStream_t)stream>>>(
      (const int32_t*)n, (const long long*)salt, (int32_t*)out, rows, n_out);
  return (int)cudaGetLastError();
}

// One launch for the three classes of an engine run, written into the one
// (rows0 + rows16 + rows32, n_out) buffer `out`.  A class with 0 rows may
// pass null pointers; at least one class has rows.  A gather class passes
// null `starts` and `skip` 0 padded, its (rows + 1, 2) int32 start table and
// skip (0 or 16) trimmed (see Classes; the wrapper has checked every row's
// range against its n and the data).  `exact` 0 keeps the raw contract
// above, 1 leaves the salt of K2 and K3 out.
int dint_decode_classes(const void* n0, int64_t rows0, const void* vidx16,
                        const void* tab16, const void* n16,
                        const void* starts16, int skip16, int64_t rows16,
                        const void* vidx32, const void* tab32, const void* n32,
                        const void* starts32, int skip32, int64_t rows32,
                        const void* salt, void* out, int n_out, int exact,
                        void* stream) {
  Classes c;
  c.n0 = (const int32_t*)n0;
  c.vidx16 = (const uint8_t*)vidx16;
  c.tab16 = (const uint32_t*)tab16;
  c.n16 = (const int32_t*)n16;
  c.starts16 = (const int2*)starts16;
  c.skip16 = skip16;
  c.vidx32 = (const uint8_t*)vidx32;
  c.tab32 = (const uint32_t*)tab32;
  c.n32 = (const int32_t*)n32;
  c.starts32 = (const int2*)starts32;
  c.skip32 = skip32;
  c.rows0 = rows0;
  c.rows16 = rows16;
  c.rows32 = rows32;
  int64_t resident = 0;
  const int rc = walk_resident(n_out, &resident);
  if (rc) return rc;
  const Walk w = walk_of(rows0, rows16, rows32, resident);
  decode_classes_kernel<<<(unsigned)(w.tiles < resident ? w.tiles : resident),
                          WALK_THREADS, walk_smem_bytes(n_out),
                          (cudaStream_t)stream>>>(
      c, w, (const long long*)salt, (int32_t*)out, n_out, exact);
  return (int)cudaGetLastError();
}

// The fused launch's walk at n_out on the current device: shape[0] the
// resident blocks (the largest grid a launch takes), shape[1] the most rows
// a tile has.  A launch of more tiles of those rows than resident blocks
// walks: its blocks take more than one tile each.
int dint_decode_classes_walk(int n_out, int64_t* shape) {
  int64_t resident = 0;
  const int rc = walk_resident(n_out, &resident);
  if (rc) return rc;
  shape[0] = resident;
  shape[1] = WALK_ROWS;
  return 0;
}

// `blocks` blocks of THREADS threads that do nothing.
int dint_empty_launch(int64_t blocks, void* stream) {
  empty_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
