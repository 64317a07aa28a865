// Width-class gather kernels of the DINT serving-image decode (Hopper, sm_90a).
//
// The serving image holds, per row r of 256 (N_OUT) output ints, a byte
// index vidx[r, j] into a per-row local table and the row's int count n[r].
// Rows are split into three width classes by their table's contents; each
// class has one kernel here.  All three keep the raw-output contract of the
// Pallas kernels they replace, bit for bit:
//
//   K1 gather32: out[r,j] = tab[r, vidx[r,j]]                  (exact)
//   K2 gather16: out[r,j] = u16(tab[r, idx>>1] >>> 16*(idx&1)) + salt
//   K3 zero:     out[r,j] = salt
//
// on valid lanes (j < n[r]) and 0 elsewhere, with u32 wrap arithmetic.  The
// caller subtracts the salt of K2/K3 again (the engine's decode) or folds it
// into the chained-run sum.  The salt is read from a 1-element int64 device
// tensor holding the u32 value (its low 32 bits are used), so a chain of runs
// never syncs with the host.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintgather.so decode_gather.cu
//
// Launch shape shared by K1/K2: one block of 256 threads covers
// ROWS_PER_BLOCK = 1024 / n_out rows (4 at n_out = 256); thread t of a row
// owns output lanes 4t..4t+3, so it reads one uchar4 of vidx and writes one
// int4 of output (16 B, coalesced across the warp).  The rows' tables are
// first staged in shared memory with 16-byte loads, so each table byte is
// read from device memory exactly once, and the data-dependent gather then
// hits shared memory rather than L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TABLE_CLS = 256;        // local table entries per row
constexpr int LANES_PER_BLOCK = 1024;  // n_out * rows per block
constexpr int MAX_ROWS_PER_BLOCK = 8;  // n_out >= 128

// Stage `rows_here` consecutive rows of a (R, words) u32 table into smem.
__device__ __forceinline__ void stage_table(uint32_t* tab_s,
                                            const uint32_t* __restrict__ tab,
                                            int64_t row0, int rows_here,
                                            int words) {
  const uint4* src = reinterpret_cast<const uint4*>(tab + row0 * words);
  uint4* dst = reinterpret_cast<uint4*>(tab_s);
  const int n4 = rows_here * words / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = __ldg(src + i);
}

// K1 — replaces dint_tpu/kernels/decode_local.py:_gather32_body (launched by
// _pallas_gather_kernel through _pallas_split_fns, mode 32).
// Bound: bytes.  Per row it moves n_out B of vidx, 1 KiB of table, 4 B of n
// and 4*n_out B of output, and does one integer select per output: far below
// the card's integer rate, so the time is those bytes over memory bandwidth.
// Design: the 1 KiB row table sits in shared memory (TPU: two 128-lane halves
// selected by index bit 7; here one 256-word array indexed directly), vidx is
// read 4 bytes a thread and the output written 16 bytes a thread.  The salt
// is wrap-added and subtracted as in the Pallas body; it cancels exactly.
__global__ void __launch_bounds__(THREADS)
gather32_kernel(const uint8_t* __restrict__ vidx,
                const uint32_t* __restrict__ tab,
                const int32_t* __restrict__ n,
                const long long* __restrict__ salt_p,
                int32_t* __restrict__ out, int64_t rows, int n_out) {
  __shared__ __align__(16) uint32_t tab_s[MAX_ROWS_PER_BLOCK * TABLE_CLS];
  const int rpb = LANES_PER_BLOCK / n_out;
  const int64_t row0 = (int64_t)blockIdx.x * rpb;
  const int64_t left = rows - row0;
  const int rows_here = left < rpb ? (int)left : rpb;
  stage_table(tab_s, tab, row0, rows_here, TABLE_CLS);
  __syncthreads();
  const int per_row = n_out / 4;
  const int lr = threadIdx.x / per_row;
  if (lr >= rows_here) return;
  const int64_t r = row0 + lr;
  const int j = (threadIdx.x - lr * per_row) * 4;
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  const int nr = __ldg(n + r);
  const uchar4 ix = __ldg(reinterpret_cast<const uchar4*>(vidx + r * n_out + j));
  const uint32_t* t = tab_s + lr * TABLE_CLS;
  int4 o;
  o.x = j + 0 < nr ? (int)((t[ix.x] + salt) - salt) : 0;
  o.y = j + 1 < nr ? (int)((t[ix.y] + salt) - salt) : 0;
  o.z = j + 2 < nr ? (int)((t[ix.z] + salt) - salt) : 0;
  o.w = j + 3 < nr ? (int)((t[ix.w] + salt) - salt) : 0;
  reinterpret_cast<int4*>(out + r * n_out)[j / 4] = o;
}

__device__ __forceinline__ uint32_t u16_entry(const uint32_t* t, uint32_t idx) {
  const uint32_t w = t[idx >> 1];
  return ((idx & 1u) ? (w >> 16) : w) & 0xFFFFu;  // logical shift on u32
}

// K2 — replaces dint_tpu/kernels/decode_local.py:_gather16_body (launched by
// _pallas_gather16_kernel through _pallas_split_fns, mode 16).
// Bound: bytes.  Per row: n_out B of vidx, 512 B of packed table (two u16
// entries a word), 4 B of n, 4*n_out B of output; a shift, mask and add per
// output.  Design: as K1, with the 512 B packed table staged in shared
// memory; the raw output is val + salt on valid lanes (the Pallas contract).
__global__ void __launch_bounds__(THREADS)
gather16_kernel(const uint8_t* __restrict__ vidx,
                const uint32_t* __restrict__ tab,
                const int32_t* __restrict__ n,
                const long long* __restrict__ salt_p,
                int32_t* __restrict__ out, int64_t rows, int n_out) {
  constexpr int WORDS = TABLE_CLS / 2;
  __shared__ __align__(16) uint32_t tab_s[MAX_ROWS_PER_BLOCK * WORDS];
  const int rpb = LANES_PER_BLOCK / n_out;
  const int64_t row0 = (int64_t)blockIdx.x * rpb;
  const int64_t left = rows - row0;
  const int rows_here = left < rpb ? (int)left : rpb;
  stage_table(tab_s, tab, row0, rows_here, WORDS);
  __syncthreads();
  const int per_row = n_out / 4;
  const int lr = threadIdx.x / per_row;
  if (lr >= rows_here) return;
  const int64_t r = row0 + lr;
  const int j = (threadIdx.x - lr * per_row) * 4;
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  const int nr = __ldg(n + r);
  const uchar4 ix = __ldg(reinterpret_cast<const uchar4*>(vidx + r * n_out + j));
  const uint32_t* t = tab_s + lr * WORDS;
  int4 o;
  o.x = j + 0 < nr ? (int)(u16_entry(t, ix.x) + salt) : 0;
  o.y = j + 1 < nr ? (int)(u16_entry(t, ix.y) + salt) : 0;
  o.z = j + 2 < nr ? (int)(u16_entry(t, ix.z) + salt) : 0;
  o.w = j + 3 < nr ? (int)(u16_entry(t, ix.w) + salt) : 0;
  reinterpret_cast<int4*>(out + r * n_out)[j / 4] = o;
}

// K3 — replaces dint_tpu/kernels/decode_local.py:_zero_body (launched by
// _pallas_zero_kernel through _pallas_split_fns, mode 0).
// Bound: bytes, and write-only: 4 B of n per row read, 4*n_out B per row
// written.  Design: one thread per 16 B of output, no table and no vidx.
__global__ void __launch_bounds__(THREADS)
zero_kernel(const int32_t* __restrict__ n, const long long* __restrict__ salt_p,
            int32_t* __restrict__ out, int64_t rows, int n_out) {
  const int per_row = n_out / 4;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows * per_row) return;
  const int64_t r = g / per_row;
  const int j = (int)(g - r * per_row) * 4;
  const int32_t s = (int32_t)(uint32_t)__ldg(salt_p);
  const int nr = __ldg(n + r);
  int4 o;
  o.x = j + 0 < nr ? s : 0;
  o.y = j + 1 < nr ? s : 0;
  o.z = j + 2 < nr ? s : 0;
  o.w = j + 3 < nr ? s : 0;
  reinterpret_cast<int4*>(out)[g] = o;
}

int64_t gather_blocks(int64_t rows, int n_out) {
  const int rpb = LANES_PER_BLOCK / n_out;
  return (rows + rpb - 1) / rpb;
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes, shapes, contiguity, 16-byte alignment, rows > 0 and
// n_out in {128, 256, 512, 1024}.  Each returns cudaGetLastError().
extern "C" {

int dint_gather32(const void* vidx, const void* tab, const void* n,
                  const void* salt, void* out, int64_t rows, int n_out,
                  void* stream) {
  gather32_kernel<<<(unsigned)gather_blocks(rows, n_out), THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows, n_out);
  return (int)cudaGetLastError();
}

int dint_gather16(const void* vidx, const void* tab, const void* n,
                  const void* salt, void* out, int64_t rows, int n_out,
                  void* stream) {
  gather16_kernel<<<(unsigned)gather_blocks(rows, n_out), THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows, n_out);
  return (int)cudaGetLastError();
}

int dint_zero(const void* n, const void* salt, void* out, int64_t rows,
              int n_out, void* stream) {
  const int64_t groups = rows * (n_out / 4);
  zero_kernel<<<(unsigned)((groups + THREADS - 1) / THREADS), THREADS, 0,
                (cudaStream_t)stream>>>(
      (const int32_t*)n, (const long long*)salt, (int32_t*)out, rows, n_out);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
