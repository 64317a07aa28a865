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
//  * the engine's run is ONE launch (decode_classes_kernel): the grid covers
//    the blocks of all three classes, a block finds its class from its index
//    and runs that class's body; K1's few blocks ride among the thousands of
//    K2's and K3's, which hide their latency;
//  * the gather body (one template for K1 and K2) makes ONE trip to device
//    memory: it starts the table's asynchronous copies (cp.async.cg, 16
//    bytes a thread, one commit and one wait) and at once asks for its vidx
//    word and n, so all three are in flight together and nothing waits for
//    n.  Reading n first, to let blocks of empty rows (the padding) return
//    without their tables, saves under 2% of a run's bytes and puts a second,
//    dependent trip into every live block, which cost K2 some 8% on the
//    bench image.
//
// Launch shape of the gather bodies: one block of 256 threads covers
// ROWS_PER_BLOCK = 1024 / n_out rows (4 at n_out = 256); thread t of a row
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
// launch, where K3 runs on every path, it wins in every call: the zero class
// alone took 9.90 us against the earlier body's 11.60, and the whole launch
// 43.78 against 45.79 (216.99 against 222.67 at 90,855,447 postings).
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
// engine's order (zero, u16, i32); a class may be empty.
struct Classes {
  const int32_t* n0;
  const uint8_t* vidx16;
  const uint32_t* tab16;
  const int32_t* n16;
  const uint8_t* vidx32;
  const uint32_t* tab32;
  const int32_t* n32;
  int64_t rows0, rows16, rows32;
};

// The fused class launch: blocks [0, b16) run K2's body, [b16, b16 + b32)
// K1's, the rest (zero_blocks of the zero class) K3's (the heaviest blocks
// first).  Each class's block count is rounded up on its own, so no block
// straddles two classes and a block is uniform in its body, barriers
// included.
__global__ void __launch_bounds__(THREADS)
decode_classes_kernel(Classes c, const long long* __restrict__ salt_p,
                      int32_t* __restrict__ out, int n_out, int exact) {
  __shared__ __align__(16) uint32_t tab_s[TAB_S_WORDS];
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  const int64_t b16 = class_blocks(c.rows16, n_out);
  const int64_t b32 = class_blocks(c.rows32, n_out);
  int64_t b = blockIdx.x;
  if (b < b16) {
    gather_rows<16>(c.vidx16, c.tab16, c.n16, salt, exact != 0,
                    out + c.rows0 * n_out, c.rows16, n_out, b, tab_s);
    return;
  }
  b -= b16;
  if (b < b32) {
    gather_rows<32>(c.vidx32, c.tab32, c.n32, salt, exact != 0,
                    out + (c.rows0 + c.rows16) * n_out, c.rows32, n_out, b,
                    tab_s);
    return;
  }
  zero_rows(c.n0, (int32_t)salt, exact != 0, out, c.rows0, n_out, b - b32);
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
// pass null pointers; at least one class has rows.  `exact` 0 keeps the raw
// contract above, 1 leaves the salt of K2 and K3 out.
int dint_decode_classes(const void* n0, int64_t rows0, const void* vidx16,
                        const void* tab16, const void* n16, int64_t rows16,
                        const void* vidx32, const void* tab32, const void* n32,
                        int64_t rows32, const void* salt, void* out, int n_out,
                        int exact, void* stream) {
  Classes c;
  c.n0 = (const int32_t*)n0;
  c.vidx16 = (const uint8_t*)vidx16;
  c.tab16 = (const uint32_t*)tab16;
  c.n16 = (const int32_t*)n16;
  c.vidx32 = (const uint8_t*)vidx32;
  c.tab32 = (const uint32_t*)tab32;
  c.n32 = (const int32_t*)n32;
  c.rows0 = rows0;
  c.rows16 = rows16;
  c.rows32 = rows32;
  const int64_t blocks = zero_blocks(rows0, n_out) +
                         class_blocks(rows16, n_out) +
                         class_blocks(rows32, n_out);
  decode_classes_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      c, (const long long*)salt, (int32_t*)out, n_out, exact);
  return (int)cudaGetLastError();
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
