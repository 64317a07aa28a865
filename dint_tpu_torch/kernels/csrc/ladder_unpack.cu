// X1: the fused ladder unpack (Hopper, sm_90a).
//
// Replaces the reference's per-width-class XLA ops of the ladder image:
// dint_tpu/kernels/unpack_device.py `_fns` (:952) and `_fns_base` (:983),
// chained in one jit by `UnpackEngine.timed_chain` (:1154).  Every value of
// the ladder image lives whole inside one u32 word at shift r * w (w one of
// 1, 2, 3, 4, 5, 6, 8, 10, 16, 32; vpw = 32 / w values a word), so a width
// class's words wT (W', M, 128), lane-major, decode as
//
//   pfor:  out[k, r, m, l] = ((wT[k, m, l] >> (r * w)) & mask_w) + salt
//   pforb: out[k, r, m, l] = ((wT[k, m, l] >> (r * w)) & mask_w) + bT[m, l]
//                            + salt
//
// into (W', vpw, M, 128), the layout of `_fns`, in wrapping u32 arithmetic:
// the right shift is logical and w = 32 takes no mask.  The salt is read from
// a 1-element int64 device tensor holding the u32 value (its low 32 bits), so
// a chain of runs never syncs with the host.
//
// dint_ladder_unpack decodes EVERY class of an engine run in ONE launch: the
// class table (word, base and output pointers, plane size, word count, first
// block, width) is built once by the engine and passed by value as a
// __grid_constant__ parameter; a block finds its class from the per-block
// prefix (`block0`) and runs that width's body, a template whose shifts and
// mask are constants.  A thread reads four consecutive lane-major words (one
// 16-byte load; the plane M * 128 is a multiple of four, so the four share
// k) and writes their vpw values as vpw 16-byte stores, one per (k, r)
// plane: for fixed (k, r) the plane is contiguous, so each store of a warp
// covers 512 contiguous bytes.
//
// dint_ladder_rows is the same unpack for the sharded step's row-major layout
// (dint_tpu/parallel/steps.py:319 ladder_sharded_decode_step, "the same
// broadcast shift/mask"): a width class is (NBw, words_w) u32, block i's
// value j in word j / vpw at shift (j % vpw) * w, decoded to (NBw, 256) with
// no salt.  A thread writes four consecutive values of a row (one 16-byte
// store) and reads their words through the read-only cache (neighbouring
// threads share words).
//
// Bound: bytes.  Each input word is read once and each output u32 written
// once; a value costs a shift, a mask and an add, nothing next to the card's
// integer rate.  The outputs (4 B an int) are 8x to 32x the words, so the
// time is the output's writes: the stores are streaming (st.global.cs), the
// outputs are larger than the L2 and the chain reads back a sample only.
// chip_smoke.py measured 30.1 us against a 23.2 us bound for the bench
// stream's ladder image (67 MB of outputs) and 33.8 against 22.8 for its
// sharded rows, on an NVIDIA H100 80GB HBM3 (700 W).
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintladder.so ladder_unpack.cu

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WORDS_PER_BLOCK = THREADS * 4;  // unpack: four words a thread
constexpr int ROW_INTS = 256;                  // rows: values a block row
constexpr int ROWS_PER_BLOCK = THREADS * 4 / ROW_INTS;
constexpr int MAX_CLASSES = 32;

// One class of the table, eight int64 a row as the wrapper builds it.
// unpack: src = wT, base = bT or 0, a = M * 128 (lanes of a plane),
//         b = W' * M * 128 (words).
// rows:   src = (NBw, words_w), base = 0, a = NBw, b = words_w.
struct ClassRow {
  int64_t src, base, out, a, b, block0, w, pad;
};

struct Table {
  ClassRow c[MAX_CLASSES];
  int n;
};

__device__ __forceinline__ const ClassRow& find_class(const Table& t) {
  int c = 0;
  while (c + 1 < t.n && (int64_t)blockIdx.x >= t.c[c + 1].block0) ++c;
  return t.c[c];
}

template <int W>
__device__ __forceinline__ uint32_t field(uint32_t x, int s) {
  constexpr uint32_t MASK = W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u;
  return (x >> s) & MASK;
}

template <int W>
__device__ __forceinline__ void unpack_words(const ClassRow& c, int64_t q,
                                             uint32_t salt) {
  constexpr int VPW = 32 / W;
  const int64_t P = c.a;
  const int64_t k = q / P;
  const int64_t p = q - k * P;
  const uint4 x = __ldcs((const uint4*)((const uint32_t*)c.src + q));
  uint4 add = make_uint4(salt, salt, salt, salt);
  if (c.base) {
    const uint4 b = __ldg((const uint4*)((const uint32_t*)c.base + p));
    add.x += b.x;
    add.y += b.y;
    add.z += b.z;
    add.w += b.w;
  }
  uint32_t* out = (uint32_t*)c.out + k * VPW * P + p;
#pragma unroll
  for (int r = 0; r < VPW; ++r) {
    const int s = r * W;
    const uint4 v = make_uint4(field<W>(x.x, s) + add.x,
                               field<W>(x.y, s) + add.y,
                               field<W>(x.z, s) + add.z,
                               field<W>(x.w, s) + add.w);
    __stcs((uint4*)(out + r * P), v);
  }
}

__global__ void __launch_bounds__(THREADS)
ladder_unpack_kernel(const __grid_constant__ Table t,
                     const long long* __restrict__ salt_p) {
  const ClassRow& c = find_class(t);
  const int64_t q =
      ((int64_t)blockIdx.x - c.block0) * WORDS_PER_BLOCK + threadIdx.x * 4;
  if (q >= c.b) return;
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  switch (c.w) {
    case 1: unpack_words<1>(c, q, salt); break;
    case 2: unpack_words<2>(c, q, salt); break;
    case 3: unpack_words<3>(c, q, salt); break;
    case 4: unpack_words<4>(c, q, salt); break;
    case 5: unpack_words<5>(c, q, salt); break;
    case 6: unpack_words<6>(c, q, salt); break;
    case 8: unpack_words<8>(c, q, salt); break;
    case 10: unpack_words<10>(c, q, salt); break;
    case 16: unpack_words<16>(c, q, salt); break;
    case 32: unpack_words<32>(c, q, salt); break;
    default: break;  // the wrapper admits ladder widths only
  }
}

template <int W>
__device__ __forceinline__ void unpack_row4(const ClassRow& c, int64_t row,
                                            int j0) {
  constexpr int VPW = 32 / W;
  const uint32_t* in = (const uint32_t*)c.src + row * c.b;
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    v[e] = field<W>(__ldg(in + j / VPW), (j % VPW) * W);
  }
  __stcs((uint4*)((uint32_t*)c.out + row * ROW_INTS + j0),
         make_uint4(v[0], v[1], v[2], v[3]));
}

__global__ void __launch_bounds__(THREADS)
ladder_rows_kernel(const __grid_constant__ Table t) {
  const ClassRow& c = find_class(t);
  const int64_t row = ((int64_t)blockIdx.x - c.block0) * ROWS_PER_BLOCK +
                      threadIdx.x / (ROW_INTS / 4);
  if (row >= c.a) return;
  const int j0 = (threadIdx.x % (ROW_INTS / 4)) * 4;
  switch (c.w) {
    case 1: unpack_row4<1>(c, row, j0); break;
    case 2: unpack_row4<2>(c, row, j0); break;
    case 3: unpack_row4<3>(c, row, j0); break;
    case 4: unpack_row4<4>(c, row, j0); break;
    case 5: unpack_row4<5>(c, row, j0); break;
    case 6: unpack_row4<6>(c, row, j0); break;
    case 8: unpack_row4<8>(c, row, j0); break;
    case 10: unpack_row4<10>(c, row, j0); break;
    case 16: unpack_row4<16>(c, row, j0); break;
    case 32: unpack_row4<32>(c, row, j0); break;
    default: break;
  }
}

bool load_table(const int64_t* rows, int n, Table* t) {
  if (n <= 0 || n > MAX_CLASSES) return false;
  memset(t, 0, sizeof(Table));
  memcpy(t->c, rows, sizeof(ClassRow) * (size_t)n);
  t->n = n;
  return true;
}

}  // namespace

// C interface.  `table` is a host array of n rows of eight int64 (ClassRow),
// built by the wrapper with every class's first block; the pointers in it
// are device pointers from tensor.data_ptr(), `stream` is
// torch.cuda.current_stream().cuda_stream.  The wrapper has checked dtypes,
// shapes, contiguity, 16-byte alignment and the widths.  Each returns
// cudaGetLastError() (cudaErrorInvalidValue for a table of no class or of
// more than MAX_CLASSES).
extern "C" {

int dint_ladder_unpack(const int64_t* table, int n, const void* salt,
                       void* stream) {
  Table t;
  if (!load_table(table, n, &t)) return (int)cudaErrorInvalidValue;
  const ClassRow& last = t.c[n - 1];
  const int64_t blocks =
      last.block0 + (last.b + WORDS_PER_BLOCK - 1) / WORDS_PER_BLOCK;
  ladder_unpack_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      t, (const long long*)salt);
  return (int)cudaGetLastError();
}

int dint_ladder_rows(const int64_t* table, int n, void* stream) {
  Table t;
  if (!load_table(table, n, &t)) return (int)cudaErrorInvalidValue;
  const ClassRow& last = t.c[n - 1];
  const int64_t blocks =
      last.block0 + (last.a + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  ladder_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
