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
//   A[d, j] = [vidx[r, j] == d]                                  (256 x 256)
//
// accumulated in int32; each column of A holds at most one 1, so the product
// is the selected byte - 128, and + 128, the four bytes reassembled and the
// salt subtracted give the table word back exactly (u32 wrap arithmetic).  A
// vidx outside [0, 256) selects nothing and yields 0x80808080 - salt, as in
// the Pallas kernels and the plain version.
//
// The product runs in this kernel's own body on
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: the planes occupy rows
// 0..3 of the 16-row A operand (rows 4..15 are zero), the one-hot tile is
// built in registers from vidx (no selector ever touches memory), 8 k-steps
// of 32 table entries by 32 n-tiles of 8 outputs a row.  The TPU kernels'
// block-diagonal (32 x 2048) layout, which fused 8 rows into one product to
// fill the TPU's int8 sublane tile, is not carried over: 7/8 of its products
// are zeros.
//
// Bound: bytes.  A row moves 1 KiB of vidx (int32), 1 KiB of table, 4 B of n
// and 1 KiB of output: 3 KiB + 4 B over the card's memory rate.  The int8
// work (2 * 4 * 256 * 256 operations a row; four times that as issued, since
// 12 of the 16 operand rows are padding) stays far below the tensor cores'
// roof, but issuing 256 mma a row plus building their one-hot operands is
// what the kernel's time is made of: the measured point of the ablation.
//
// Design: one warp a row.  The warp stages the salted table row and the vidx
// row in shared memory with 16-byte loads, packs the plane fragments of all 8
// k-steps into 16 registers once, then walks the 32 n-tiles; the plane bytes
// of each result land in a shared output row as bytes (little-endian, so the
// byte placement is the reference's shifts and adds), which the warp finally
// masks, unsalts and writes with 16-byte stores.  K6 gives a thread block 256
// rows and each of its 8 warps loops over 32 of them; K7 gives a block one
// 8-row group, one row a warp.  Both call the same row body.
//
// Build (plain C interface, bound with ctypes by kernels/cuda_ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdintonehot.so onehot_gather.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_OUT = 256;      // outputs a row
constexpr int TABLE_CLS = 256;  // table entries a row
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROW_BLOCK = 256;  // rows a K6 thread block
constexpr int GROUP = 8;        // rows a K7 thread block
constexpr int K_STEPS = TABLE_CLS / 32;
constexpr int N_TILES = N_OUT / 8;

struct RowScratch {
  uint32_t tab[TABLE_CLS];  // tab + salt
  int32_t vidx[N_OUT];
  uint32_t out[N_OUT];      // biased-back plane bytes, one word an output
};

// Byte plane `v` of four salted table words as four int8 lanes, biased by
// -128 (x - 128 in int8 is x ^ 0x80).
__device__ __forceinline__ uint32_t plane4(uint4 w, int v) {
  const uint32_t sel = (uint32_t)v | ((uint32_t)(4 + v) << 4);
  const uint32_t lo = __byte_perm(w.x, w.y, sel);
  const uint32_t hi = __byte_perm(w.z, w.w, sel);
  return __byte_perm(lo, hi, 0x5410) ^ 0x80808080u;
}

// Four consecutive k entries of one one-hot column: byte e is 1 where the
// column's index is k0 + e.
__device__ __forceinline__ uint32_t onehot4(int e) {
  return (uint32_t)e < 4u ? 1u << (8 * e) : 0u;
}

// C (16x8, s32) += A (16x32, s8, rows 8..15 zero) * B (32x8, s8).
__device__ __forceinline__ void mma_planes(int (&c)[4], uint32_t a0,
                                           uint32_t a2, uint32_t b0,
                                           uint32_t b1) {
  const uint32_t zero = 0u;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(zero), "r"(a2), "r"(zero), "r"(b0), "r"(b1));
}

// One row, one warp (all 32 lanes enter together).
__device__ __forceinline__ void onehot_row(const int32_t* __restrict__ vidx_row,
                                           const uint32_t* __restrict__ tab_row,
                                           int n, uint32_t salt,
                                           int32_t* __restrict__ out_row,
                                           RowScratch& sm) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma group: A/C row, B column
  const int t = lane & 3;   // thread in group

  for (int i = lane; i < TABLE_CLS / 4; i += 32) {
    uint4 w = __ldg(reinterpret_cast<const uint4*>(tab_row) + i);
    w.x += salt;
    w.y += salt;
    w.z += salt;
    w.w += salt;
    reinterpret_cast<uint4*>(sm.tab)[i] = w;
    reinterpret_cast<int4*>(sm.vidx)[i] =
        __ldg(reinterpret_cast<const int4*>(vidx_row) + i);
  }
  __syncwarp();

  // A fragments of every k-step: lane (g, t) holds plane g of entries
  // 32ks + 4t .. +3 (a0) and 32ks + 16 + 4t .. +3 (a2); groups 4..7 hold the
  // zero rows.
  uint32_t a0[K_STEPS], a2[K_STEPS];
#pragma unroll
  for (int ks = 0; ks < K_STEPS; ++ks) {
    a0[ks] = a2[ks] = 0u;
    if (g < 4) {
      const uint4* tv = reinterpret_cast<const uint4*>(sm.tab);
      a0[ks] = plane4(tv[8 * ks + t], g);
      a2[ks] = plane4(tv[8 * ks + 4 + t], g);
    }
  }
  __syncwarp();

  uint8_t* ob = reinterpret_cast<uint8_t*>(sm.out);
  for (int nt = 0; nt < N_TILES; ++nt) {
    // B column g of this tile is output j = 8nt + g; lane (g, t) builds its
    // k rows 4t .. 4t+3 (b0) and 16 + 4t .. +3 (b1) of every k-step
    const int e = sm.vidx[8 * nt + g] - 4 * t;
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < K_STEPS; ++ks) {
      const int e0 = e - 32 * ks;
      mma_planes(c, a0[ks], a2[ks], onehot4(e0), onehot4(e0 - 16));
    }
    // C row g (plane g), columns 2t and 2t+1 of the tile
    if (g < 4) {
      const int j = 8 * nt + 2 * t;
      ob[4 * j + g] = (uint8_t)(c[0] + 128);
      ob[4 * (j + 1) + g] = (uint8_t)(c[1] + 128);
    }
    __syncwarp();
  }

  for (int i = lane; i < N_OUT / 4; i += 32) {
    const uint4 w = reinterpret_cast<const uint4*>(sm.out)[i];
    const int j = 4 * i;
    int4 o;
    o.x = j + 0 < n ? (int)(w.x - salt) : 0;
    o.y = j + 1 < n ? (int)(w.y - salt) : 0;
    o.z = j + 2 < n ? (int)(w.z - salt) : 0;
    o.w = j + 3 < n ? (int)(w.w - salt) : 0;
    reinterpret_cast<int4*>(out_row)[i] = o;
  }
  __syncwarp();  // the scratch is free for the warp's next row
}

// K6: a thread block owns ROW_BLOCK rows; warp w takes rows w, w + 8, ...
__global__ void __launch_bounds__(THREADS)
onehot_block_kernel(const int32_t* __restrict__ vidx,
                    const uint32_t* __restrict__ tab,
                    const int32_t* __restrict__ n,
                    const long long* __restrict__ salt_p,
                    int32_t* __restrict__ out, int64_t rows) {
  __shared__ __align__(16) RowScratch sm[WARPS];
  const int warp = threadIdx.x >> 5;
  const uint32_t salt = (uint32_t)__ldg(salt_p);
  const int64_t row0 = (int64_t)blockIdx.x * ROW_BLOCK;
  for (int i = warp; i < ROW_BLOCK; i += WARPS) {
    const int64_t r = row0 + i;
    if (r >= rows) break;
    onehot_row(vidx + r * N_OUT, tab + r * TABLE_CLS, __ldg(n + r), salt,
               out + r * N_OUT, sm[warp]);
  }
}

// K7: a thread block owns one GROUP-row group, one row a warp.
__global__ void __launch_bounds__(THREADS)
onehot_group_kernel(const int32_t* __restrict__ vidx,
                    const uint32_t* __restrict__ tab,
                    const int32_t* __restrict__ n,
                    const long long* __restrict__ salt_p,
                    int32_t* __restrict__ out, int64_t rows) {
  static_assert(GROUP == WARPS, "one row a warp");
  __shared__ __align__(16) RowScratch sm[WARPS];
  const int warp = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * GROUP + warp;
  if (r >= rows) return;
  onehot_row(vidx + r * N_OUT, tab + r * TABLE_CLS, __ldg(n + r),
             (uint32_t)__ldg(salt_p), out + r * N_OUT, sm[warp]);
}

}  // namespace

// C interface.  Every pointer is a device pointer from tensor.data_ptr();
// `stream` is torch.cuda.current_stream().cuda_stream.  The wrapper has
// checked dtypes (vidx, tab, n, out int32; salt int64), the (rows, 256)
// shapes, contiguity, 16-byte alignment and rows > 0, a multiple of 256
// (block) or 8 (group).  Each returns cudaGetLastError().
extern "C" {

int dint_onehot_block(const void* vidx, const void* tab, const void* n,
                      const void* salt, void* out, int64_t rows,
                      void* stream) {
  const int64_t blocks = (rows + ROW_BLOCK - 1) / ROW_BLOCK;
  onehot_block_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows);
  return (int)cudaGetLastError();
}

int dint_onehot_group(const void* vidx, const void* tab, const void* n,
                      const void* salt, void* out, int64_t rows,
                      void* stream) {
  const int64_t blocks = (rows + GROUP - 1) / GROUP;
  onehot_group_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vidx, (const uint32_t*)tab, (const int32_t*)n,
      (const long long*)salt, (int32_t*)out, rows);
  return (int)cudaGetLastError();
}

const char* dint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
