// X4: the byte-class wire unpack (Hopper, sm_90a).
//
// Replaces the reference's per-class XLA ops of the byte-class wire engine:
// dint_tpu/kernels/unpack_device.py:766 `ByteClassEngine`, whose unpack is
// `_byteclass_unpack` (:841), one fused shift/or a length class, chained by
// `ByteClassEngine.timed_chain`.  It serves five of the zoo's wire codecs
// (vbyte, maskedvbyte, streamvbyte, varintgb, varintg8iu): the planner
// (`plan_byteclass`) excises every value's 1..5 bytes into the dense (N, L)
// uint8 array of its byte length L, so value i of a class is
//
//   v = sum_g (b[i, g] & mask) << (group_bits * g)   (wrapped to u32) + salt
//
// with mask 0x7F and group_bits 7 for the vbyte family (the marker bit off;
// a fifth group keeps only its low 4 bits) and 0xFF, 8 for the plain byte
// codecs (a fifth byte falls off the u32).  The salt is read from a
// 1-element int64 device tensor holding the u32 value, so a chain of runs
// never syncs with the host.
//
// dint_byteclass_unpack decodes EVERY class of an engine run in ONE launch,
// into one output buffer the engine allocates once (class c from its offset,
// a multiple of four values): the class table (bytes and output pointers, N,
// L, first block) is built once by the engine and passed by value as a
// __grid_constant__ parameter, and a block finds its class from the
// per-block prefix (`block0`), as X1's table does (csrc/ladder_unpack.cu).  A
// thread takes four consecutive values: their 4 * L bytes start on a 4-byte
// boundary, so it reads them as L coalesced u32 words, picks the bytes out
// with shifts whose counts are constants of the class's template body (L and
// group_bits), and writes the four values as one 16-byte store; the last
// thread of a class reads byte by byte and stores value by value.
//
// Bound: bytes.  Each class byte is read once and each output u32 written
// once; a value costs a few shifts, masks and ors.  For the bench
// collection's vbyte stream that is 150.8 MB of class bytes and 66.9 MB of
// outputs, 65 us at 3.35 TB/s.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintbyte.so byteclass_unpack.cu

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int VALUES_PER_THREAD = 4;
constexpr int VALUES_PER_BLOCK = THREADS * VALUES_PER_THREAD;
constexpr int MAX_CLASSES = 32;

// One class of the table, eight int64 a row as the wrapper builds it:
// bytes (n, len) uint8, out (n,) u32 (16-byte aligned), n values, len bytes
// a value, the class's first block.
struct ClassRow {
  int64_t src, out, n, len, block0, pad0, pad1, pad2;
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

// the value of bytes b[0 .. len): groups past bit 31 fall off the u32
template <int GB>
__device__ __forceinline__ uint32_t add_group(uint32_t v, uint32_t byte,
                                              int g) {
  constexpr uint32_t MASK = GB == 8 ? 0xFFu : 0x7Fu;
  return GB * g < 32 ? v | ((byte & MASK) << (GB * g)) : v;
}

template <int L, int GB>
__device__ __forceinline__ void unpack4(const ClassRow& c, int64_t i,
                                        uint32_t salt) {
  const uint8_t* src = (const uint8_t*)c.src;
  uint32_t* out = (uint32_t*)c.out;
  if (i + VALUES_PER_THREAD <= c.n) {
    // 4 * L bytes from byte 4 * i * L: L aligned words
    const uint32_t* w = (const uint32_t*)(src + i * L);
    uint32_t words[L];
#pragma unroll
    for (int k = 0; k < L; ++k) words[k] = __ldcs(w + k);
    uint32_t v[VALUES_PER_THREAD];
#pragma unroll
    for (int e = 0; e < VALUES_PER_THREAD; ++e) {
      uint32_t x = 0;
#pragma unroll
      for (int g = 0; g < L; ++g) {
        const int k = e * L + g;  // byte k of the four values' bytes
        x = add_group<GB>(x, (words[k / 4] >> (8 * (k % 4))) & 0xFFu, g);
      }
      v[e] = x + salt;
    }
    __stcs((uint4*)(out + i), make_uint4(v[0], v[1], v[2], v[3]));
    return;
  }
  for (int64_t j = i; j < c.n; ++j) {
    uint32_t x = 0;
#pragma unroll
    for (int g = 0; g < L; ++g)
      x = add_group<GB>(x, __ldg(src + j * L + g), g);
    out[j] = x + salt;
  }
}

// any other length: the groups one by one, never more than reach bit 31
template <int GB>
__device__ __forceinline__ void unpack_any(const ClassRow& c, int64_t i,
                                           uint32_t salt) {
  const uint8_t* src = (const uint8_t*)c.src;
  uint32_t* out = (uint32_t*)c.out;
  const int64_t end = i + VALUES_PER_THREAD < c.n ? i + VALUES_PER_THREAD
                                                  : c.n;
  for (int64_t j = i; j < end; ++j) {
    uint32_t x = 0;
    for (int g = 0; g < c.len && GB * g < 32; ++g)
      x = add_group<GB>(x, __ldg(src + j * c.len + g), g);
    out[j] = x + salt;
  }
}

template <int GB>
__device__ __forceinline__ void unpack_class(const ClassRow& c, int64_t i,
                                             uint32_t salt) {
  switch (c.len) {
    case 1: unpack4<1, GB>(c, i, salt); break;
    case 2: unpack4<2, GB>(c, i, salt); break;
    case 3: unpack4<3, GB>(c, i, salt); break;
    case 4: unpack4<4, GB>(c, i, salt); break;
    case 5: unpack4<5, GB>(c, i, salt); break;
    default: unpack_any<GB>(c, i, salt); break;
  }
}

template <int GB>
__global__ void __launch_bounds__(THREADS)
byteclass_kernel(const __grid_constant__ Table t,
                 const long long* __restrict__ salt_p) {
  const ClassRow& c = find_class(t);
  const int64_t i = ((int64_t)blockIdx.x - c.block0) * VALUES_PER_BLOCK +
                    (int64_t)threadIdx.x * VALUES_PER_THREAD;
  if (i >= c.n) return;
  unpack_class<GB>(c, i, (uint32_t)__ldg(salt_p));
}

}  // namespace

// C interface.  `table` is a host array of n rows of eight int64
// (ClassRow), built by the wrapper (kernels/unpack_device.py ByteClasses)
// with every class's first block; the pointers in it are device pointers
// from tensor.data_ptr(): contiguous (N, L) uint8 bytes on a 4-byte
// boundary, and the class's view of the output buffer, 16-byte aligned.
// `group_bits` is 7 or 8, `salt` a 1-element int64 device tensor, `stream`
// torch.cuda.current_stream().cuda_stream.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a table of no class or of more than
// MAX_CLASSES, or another group width); a table of no values launches
// nothing.
extern "C" {

int dint_byteclass_unpack(const int64_t* table, int n, int group_bits,
                          const void* salt, void* stream) {
  if (n <= 0 || n > MAX_CLASSES || (group_bits != 7 && group_bits != 8))
    return (int)cudaErrorInvalidValue;
  Table t;
  memset(&t, 0, sizeof(Table));
  memcpy(t.c, table, sizeof(ClassRow) * (size_t)n);
  t.n = n;
  const ClassRow& last = t.c[n - 1];
  const int64_t blocks =
      last.block0 + (last.n + VALUES_PER_BLOCK - 1) / VALUES_PER_BLOCK;
  if (blocks == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (group_bits == 8)
    byteclass_kernel<8><<<(unsigned)blocks, THREADS, 0, s>>>(
        t, (const long long*)salt);
  else
    byteclass_kernel<7><<<(unsigned)blocks, THREADS, 0, s>>>(
        t, (const long long*)salt);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
