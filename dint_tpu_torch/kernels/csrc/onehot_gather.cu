// K6, K7: the table gather as an int8 one-hot matrix product (Hopper, sm_90a).
//
// Replace dint_tpu/kernels/decode_pallas.py:_gather_block_kernel (K6, the
// pallas_call at :176) and :_gather_group_kernel (K7, the pallas_call at
// :150).  Both compute K1's function,
//
//   out[r, j] = tab[r, vidx[r, j]]  for j < n[r], else 0,
//
// NOT by indexing the table but as a matrix product on the tensor cores, the
// form the ablation (tools/kernel_ablate.py) measures against the gather:
// per row, the four byte planes of (tab + salt), biased by -128 into int8,
//
//   P[v, d] = int8(((tab[r, d] + salt) >> 8v & 255) - 128)        (4 x 256)
//
// times the one-hot selector built from vidx,
//
//   A[j, d] = [vidx[r, j] == d]                                  (256 x 256)
//
// accumulated in int32; each row of A holds at most one 1, so the product is
// the selected byte - 128, and + 128, the four bytes reassembled and the salt
// subtracted give the table word back exactly (u32 wrap arithmetic).  A vidx
// outside [0, 256) selects nothing and yields 0x80808080 - salt, as in the
// Pallas kernels and the plain version.
//
// The product, transposed for this card.  The selector is the M operand and
// the planes the N operand:
//
//   out^T (256 outputs x 8) = A (256 outputs x 256 entries)
//                             . B (256 entries x 8: four planes, four zeros)
//
// on wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8: 4 M-tiles of 64
// outputs by 8 k-steps of 32 entries, 32 wgmma a row, both operands read
// from shared memory through descriptors (integer wgmma takes both K-major,
// which is how both lie: A[j][d] contiguous in d, each plane contiguous in
// d).  Half of N is padding.  The TPU kernels' block-diagonal
// (32 x 2048) layout, which fused 8 rows into one product to fill the TPU's
// int8 sublane tile, is not carried over: 7/8 of its products are zeros.
//
// The selector keeps its zeros.  A row's selector is 64 KiB of which at most
// 256 bytes are 1.  Each warpgroup holds one in shared memory, in wgmma's
// canonical K-major layout without swizzle (core matrices of 8 outputs x 16
// entries, 128 contiguous bytes; see sel_offset), zeroed once per block; per
// row it only sets its 256 one-bytes before the product and clears the same
// 256 after it.  An out-of-range vidx skips both stores.  No zero is ever
// rebuilt.
//
// Bound.  By bytes of device memory a row moves 1 KiB of vidx (int32), 1 KiB
// of table, 4 B of n and 1 KiB of output: 3 KiB + 4 B over the card's memory
// rate.  The int8 work (2 * 8 * 256 * 256 operations a row with the padding)
// is far below the tensor cores' roof.  What the kernel's time is made of is the
// product's operand traffic: each of the 32 wgmma of a row reads its 2 KiB
// selector tile and 256 B plane tile from shared memory, 72 KiB a row, and a
// multiprocessor's shared memory gives 128 B a clock: some 0.3 us a row and
// multiprocessor, 2.4 times the device-memory bound over the whole card
// (chip_smoke.py prints it as smem_bound_ms).  It is the cost of keeping the
// gather a dense product; with m64 n8 k32 tiles no shape reads fewer bytes.
// A third warpgroup adds little to two, and leaving the product out removes
// about half of the time: the rate at which a multiprocessor takes the
// product's wgmma, not the latency of a row's other steps, is what the time
// follows.
//
// Design: a thread block is three warpgroups of 128 threads, each with its
// own selector, plane tile and output row (3 x 67 KiB of dynamic shared
// memory), each walking its own rows with warpgroup-wide named barriers only,
// so one warpgroup's scatter and epilogue overlap another's product.  Of a
// warpgroup, threads 0..63 own the selector (outputs wt, wt + 64, wt + 128,
// wt + 192 each: set, clear), threads 64..127 build the plane tile (four
// table entries each) and write the finished row, 16 bytes a thread.  The
// next row's vidx and table words are loaded into registers before the
// product of this one.  K6 is a persistent grid, one block a multiprocessor,
// each block taking an equal contiguous span of the rows (whole 8-row
// groups), so no wave is left part empty; K7 gives a block one 8-row group
// and pays the selector's zero-fill once per group.  Both run the same
// kernel.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintonehot.so onehot_gather.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_OUT = 256;      // outputs a row
constexpr int TABLE_CLS = 256;  // table entries a row
constexpr int WG_THREADS = 128;
constexpr int WGS = 3;  // warpgroups a block, one selector each
constexpr int THREADS = WGS * WG_THREADS;
constexpr int GROUP = 8;  // rows a K7 thread block; K6 spans are whole groups
constexpr int M_TILES = N_OUT / 64;
constexpr int K_STEPS = TABLE_CLS / 32;

// Shared-memory layout of the operands: K-major, no swizzle.  A core matrix
// is 8 rows (outputs, or B columns) x 16 bytes (entries), stored as 8
// consecutive 16-byte rows.  LBO is the byte distance between the core
// matrices of consecutive 16-entry chunks, SBO between those of consecutive
// 8-row groups.  kernels/decode_pallas.py keeps the same constants and
// sel_offset (SEL_LBO, SEL_SBO), and the CPU tests walk the layout as the
// descriptors below do.
constexpr int SEL_LBO = 128;
constexpr int SEL_SBO = 2048;  // 16 chunks of entries x 128 B
constexpr int SEL_BYTES = N_OUT * TABLE_CLS;
constexpr int PLANE_LBO = 128;
constexpr int PLANE_SBO = 2048;  // one 8-column group only: never stepped
constexpr int PLANE_BYTES = 8 * TABLE_CLS;

__device__ __forceinline__ int sel_offset(int j, int d) {
  return (j >> 3) * SEL_SBO + (d >> 4) * SEL_LBO + (j & 7) * 16 + (d & 15);
}

__device__ __forceinline__ int plane_offset(int v, int d) {
  return (d >> 4) * PLANE_LBO + v * 16 + (d & 15);
}

struct __align__(128) WgScratch {
  uint8_t sel[SEL_BYTES];
  uint8_t planes[PLANE_BYTES];  // columns 4..7 stay zero
  uint32_t out[N_OUT];          // biased-back plane bytes, one word an output
};
constexpr int SMEM_BYTES = WGS * (int)sizeof(WgScratch);

// wgmma matrix descriptor: address, LBO and SBO in 16-byte units, layout
// type 0 (no swizzle), base offset 0.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// C (64x8, s32) += A (64x32, s8, shared) * B (32x8, s8, shared).
__device__ __forceinline__ void wgmma_m64n8k32(int (&c)[4], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n"
      "}\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving uses of the accumulators across the
// asynchronous product's fence and wait.
__device__ __forceinline__ void pin(int (&c)[M_TILES][4]) {
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(c[mt][i])::"memory");
  }
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(WG_THREADS) : "memory");
}

// Byte plane `v` of four salted table words as four int8 lanes, biased by
// -128 (x - 128 in int8 is x ^ 0x80).
__device__ __forceinline__ uint32_t plane4(uint4 w, int v) {
  const uint32_t sel = (uint32_t)v | ((uint32_t)(4 + v) << 4);
  const uint32_t lo = __byte_perm(w.x, w.y, sel);
  const uint32_t hi = __byte_perm(w.z, w.w, sel);
  return __byte_perm(lo, hi, 0x5410) ^ 0x80808080u;
}

// Set (one = 1) or clear (one = 0) the selector bytes of outputs j, j + 64,
// j + 128 and j + 192.  A warp's 32 threads hold 32 consecutive outputs, all
// eight rows of the core matrices, so that rows which repeat one index (real
// plans are full of them) spread their byte stores over the banks: with four
// consecutive outputs a thread, such a row's stores met in two bank groups.
__device__ __forceinline__ void mark(uint8_t* sel, int j, uint4 v,
                                     uint8_t one) {
  if (v.x < 256u) sel[sel_offset(j, (int)v.x)] = one;
  if (v.y < 256u) sel[sel_offset(j + 64, (int)v.y)] = one;
  if (v.z < 256u) sel[sel_offset(j + 128, (int)v.z)] = one;
  if (v.w < 256u) sel[sel_offset(j + 192, (int)v.w)] = one;
}

// The 16 bytes thread `wt` of a warpgroup brings for row r: the vidx values
// of outputs wt, wt + 64, wt + 128, wt + 192 (threads 0..63) or table words
// 4 (wt - 64) .. + 3 (threads 64..127).
__device__ __forceinline__ uint4 load_part(const int32_t* __restrict__ vidx,
                                           const uint32_t* __restrict__ tab,
                                           int64_t r, int wt) {
  if (wt < 64) {
    const int32_t* v = vidx + r * N_OUT + wt;
    return make_uint4((uint32_t)__ldg(v), (uint32_t)__ldg(v + 64),
                      (uint32_t)__ldg(v + 128), (uint32_t)__ldg(v + 192));
  }
  return __ldg(reinterpret_cast<const uint4*>(tab + r * TABLE_CLS) + (wt - 64));
}

// Block b takes rows [b * span, (b + 1) * span); its warpgroup w rows w,
// w + WGS, ... of them.
__global__ void __launch_bounds__(THREADS, 1)
onehot_kernel(const int32_t* __restrict__ vidx, const uint32_t* __restrict__ tab,
              const int32_t* __restrict__ n, const long long* __restrict__ salt_p,
              int32_t* __restrict__ out, int64_t rows, int64_t span) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int wg = threadIdx.x / WG_THREADS;
  const int wt = threadIdx.x - wg * WG_THREADS;
  WgScratch& sm = reinterpret_cast<WgScratch*>(smem)[wg];
  const int64_t first = (int64_t)blockIdx.x * span;
  const int64_t end = first + span < rows ? first + span : rows;
  int64_t r = first + wg;
  if (r >= end) return;  // the whole warpgroup: no block-wide barrier follows
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  uint4 x = load_part(vidx, tab, r, wt);
  int nr = __ldg(n + r);

  {  // zero the selector and the plane tile once
    uint4* z = reinterpret_cast<uint4*>(&sm);
    for (int i = wt; i < (SEL_BYTES + PLANE_BYTES) / 16; i += WG_THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  wg_barrier(wg);

  const uint64_t desc_a = smem_desc(sm.sel, SEL_LBO, SEL_SBO);
  const uint64_t desc_b = smem_desc(sm.planes, PLANE_LBO, PLANE_SBO);
  const int lane = wt & 31;
  const int g = lane >> 2;  // accumulator row within 8
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1
  const int jw = 16 * (wt >> 5) + g;  // this thread's output within an M-tile

  while (true) {
    if (wt < 64) {
      mark(sm.sel, wt, x, 1);
    } else {
      uint4 w = x;
      w.x += salt;
      w.y += salt;
      w.z += salt;
      w.w += salt;
      const int d0 = 4 * (wt - 64);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<uint32_t*>(sm.planes + plane_offset(v, d0)) =
            plane4(w, v);
    }
    // the stores above are read by wgmma through the asynchronous proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int64_t next = r + WGS;
    uint4 nx = make_uint4(0u, 0u, 0u, 0u);
    int nn = 0;
    if (next < end) {
      nx = load_part(vidx, tab, next, wt);
      nn = __ldg(n + next);
    }
    wg_barrier(wg);

    int c[M_TILES][4];
#pragma unroll
    for (int mt = 0; mt < M_TILES; ++mt)
      c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0;
    pin(c);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int mt = 0; mt < M_TILES; ++mt) {
#pragma unroll
      for (int ks = 0; ks < K_STEPS; ++ks)
        wgmma_m64n8k32(c[mt],
                       desc_a + ((mt * 8 * SEL_SBO + ks * 2 * SEL_LBO) >> 4),
                       desc_b + ((ks * 2 * PLANE_LBO) >> 4));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(c);

    // columns 0..3 are the planes: thread t = 0 holds planes 0, 1 and t = 1
    // planes 2, 3 of outputs jw and jw + 8 of every M-tile; the bytes go into
    // the shared output row little-endian, the reference's shifts and adds
    if (t < 2) {
      uint16_t* oh = reinterpret_cast<uint16_t*>(sm.out);
#pragma unroll
      for (int mt = 0; mt < M_TILES; ++mt) {
        const int j = 64 * mt + jw;
        oh[2 * j + t] = (uint16_t)(((c[mt][0] + 128) & 255) |
                                   (((c[mt][1] + 128) & 255) << 8));
        oh[2 * (j + 8) + t] = (uint16_t)(((c[mt][2] + 128) & 255) |
                                         (((c[mt][3] + 128) & 255) << 8));
      }
    }
    // the product has been waited for: its selector bytes may go
    if (wt < 64) mark(sm.sel, wt, x, 0);
    wg_barrier(wg);

    if (wt >= 64) {
      const int i = wt - 64;
      const uint4 w = reinterpret_cast<const uint4*>(sm.out)[i];
      const int j = 4 * i;
      int4 o;
      o.x = j + 0 < nr ? (int)(w.x - salt) : 0;
      o.y = j + 1 < nr ? (int)(w.y - salt) : 0;
      o.z = j + 2 < nr ? (int)(w.z - salt) : 0;
      o.w = j + 3 < nr ? (int)(w.w - salt) : 0;
      reinterpret_cast<int4*>(out + r * N_OUT)[i] = o;
    }
    if (next >= end) break;
    r = next;
    x = nx;
    nr = nn;
  }
}

int launch(const void* vidx, const void* tab, const void* n, const void* salt,
           void* out, int64_t rows, int64_t blocks, int64_t span,
           void* stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  onehot_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                  (cudaStream_t)stream>>>(
      (const int32_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows, span);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes (vidx, tab, n, out int32; salt int64), the (rows, 256)
// shapes, contiguity, 16-byte alignment and rows > 0, a multiple of 256
// (block) or 8 (group).  Each returns the first CUDA error, or 0.
extern "C" {

// K6: a persistent grid of one block a multiprocessor, equal spans.
int dint_onehot_block(const void* vidx, const void* tab, const void* n,
                      const void* salt, void* out, int64_t rows,
                      void* stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t groups = (rows + GROUP - 1) / GROUP;
  const int64_t blocks = groups < sms ? groups : sms;
  const int64_t span = (groups + blocks - 1) / blocks * GROUP;
  return launch(vidx, tab, n, salt, out, rows, blocks, span, stream);
}

// K7: one 8-row group a thread block.
int dint_onehot_group(const void* vidx, const void* tab, const void* n,
                      const void* salt, void* out, int64_t rows,
                      void* stream) {
  return launch(vidx, tab, n, salt, out, rows, (rows + GROUP - 1) / GROUP,
                GROUP, stream);
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
