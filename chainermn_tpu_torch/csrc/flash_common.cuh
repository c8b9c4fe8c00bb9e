// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layouts are the reference's kernel boundary: q/k/v/o/dO are (BH, S, D)
// row-major, k/v may carry BH/G rows (GQA: q row b reads kv row b / G),
// lse and delta are (BH, S, 1) fp32, segment ids are (BH, S, 1) int32.
//
// The mask of one (query, key) pair is the reference's _block_mask: the
// causal triangle, the sliding-window band (q - k < window), and
// segment-id equality, plus the ragged edge (k >= Sk or q >= Sq) that the
// reference never needed because its blocks always divide S.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FLASH_NEG_INF (-1e30f)

// The one rule that picks a kernel for a call.  bf16 at D = 64 or 128 runs
// on the tensor cores: the forward and dK/dV on the Hopper (wgmma, TMA,
// warp-specialised) kernels, dQ on its mma.sync kernel.  Every other call
// runs the SIMT kernels.
enum FlashKernel { FLASH_FWD = 0, FLASH_DQ = 1, FLASH_DKV = 2 };
enum FlashRoute { FLASH_SIMT = 0, FLASH_MMA = 1, FLASH_WGMMA = 2 };

static inline int flash_route(int kernel, int bf16, int D) {
  if (!bf16 || (D != 64 && D != 128)) return FLASH_SIMT;
  return kernel == FLASH_DQ ? FLASH_MMA : FLASH_WGMMA;
}

struct MaskArgs {
  int Sq, Sk, causal, window;   // window < 0: none
  const int* qseg;              // (BH, Sq) or nullptr
  const int* kseg;              // (BHk, Sk) or nullptr
};

__device__ __forceinline__ bool flash_live(const MaskArgs& m, int bh, int kvrow,
                                           int qp, int kp) {
  if (qp >= m.Sq || kp >= m.Sk) return false;
  if (m.causal && kp > qp) return false;
  if (m.window >= 0 && qp - kp >= m.window) return false;
  if (m.qseg != nullptr &&
      m.qseg[(size_t)bh * m.Sq + qp] != m.kseg[(size_t)kvrow * m.Sk + kp])
    return false;
  return true;
}

// Key tiles [*kt_begin, *kt_end) that intersect the band of query rows
// [q0, q0 + BQ): the reference's _band_live whole-tile skip.
__device__ __forceinline__ void flash_k_range(const MaskArgs& m, int q0, int BQ,
                                              int BK, int* kt_begin,
                                              int* kt_end) {
  int nk = (m.Sk + BK - 1) / BK;
  int hi = nk;
  if (m.causal) {
    int last = (q0 + BQ - 1) / BK + 1;
    hi = last < hi ? last : hi;
  }
  int lo = 0;
  if (m.window >= 0) {
    int first = q0 - m.window + 2 - BK;   // k0 >= first keeps the tile
    lo = first <= 0 ? 0 : (first + BK - 1) / BK;
  }
  *kt_begin = lo;
  *kt_end = hi;
}

// Query tiles [*qt_begin, *qt_end) that reach key rows [k0, k0 + BK).
__device__ __forceinline__ void flash_q_range(const MaskArgs& m, int k0, int BK,
                                              int BQ, int* qt_begin,
                                              int* qt_end) {
  int nq = (m.Sq + BQ - 1) / BQ;
  int lo = m.causal ? k0 / BQ : 0;
  int hi = nq;
  if (m.window >= 0) {
    int last = (k0 + BK + m.window - 2) / BQ + 1;
    hi = last < hi ? last : hi;
  }
  *qt_begin = lo;
  *qt_end = hi;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value a float takes once cast to T and back: the reference casts P
// and dS to the operand dtype before each product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// ---------------------------------------------------------------------------
// mma.sync helpers (the bf16 dQ kernel): m16n8k16, fp32 accumulate.
//
// With g = lane / 4 and t = lane % 4, the fragments hold
//   A (16x16 row-major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                        a[2] = A[g][2t+8..+9],   a[3] = A[g+8][2t+8..+9]
//   B (16x8, k-major):   b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
//   C (16x8 fp32):       c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// so two adjacent C tiles of one 16-row strip are exactly the A fragment of
// the next product (the FlashAttention-2 register reuse of P and dS).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive bf16 of shared memory as one register.
__device__ __forceinline__ uint32_t lds_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r0, r0+16), columns [c0, c0+16) of a row-major tile.
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile, int ld,
                                            int r0, int c0, int g, int t) {
  a[0] = lds_pair(tile + (r0 + g) * ld + c0 + 2 * t);
  a[1] = lds_pair(tile + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = lds_pair(tile + (r0 + g) * ld + c0 + 2 * t + 8);
  a[3] = lds_pair(tile + (r0 + g + 8) * ld + c0 + 2 * t + 8);
}

// B fragment of B = X^T where X is a row-major tile: B[k][n] = X[n0+n][k0+k].
// The pair runs along X's row, so each register is one 32-bit load.
__device__ __forceinline__ void load_bt_frag(uint32_t b[2],
                                             const __nv_bfloat16* tile, int ld,
                                             int n0, int k0, int g, int t) {
  b[0] = lds_pair(tile + (n0 + g) * ld + k0 + 2 * t);
  b[1] = lds_pair(tile + (n0 + g) * ld + k0 + 2 * t + 8);
}

// B fragment of B = X itself: B[k][n] = X[k0+k][n0+n].  The pair runs down
// a column of X, so each register takes two 16-bit loads.
__device__ __forceinline__ void load_b_frag(uint32_t b[2],
                                            const __nv_bfloat16* tile, int ld,
                                            int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = tile + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack_bf16_raw(p[0], p[ld]);
  b[1] = pack_bf16_raw(p[8 * ld], p[9 * ld]);
}

// Copy rows [row0, row0 + R) of a (rows, D) bf16 matrix into a shared tile
// with leading dimension ld, 16 bytes per thread and step; rows at or past
// n_rows are zero.  Needs D % 8 == 0 and 16-byte aligned bases.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile, int ld,
                                               const __nv_bfloat16* src,
                                               int row0, int R, int n_rows,
                                               int tid, int n_threads) {
  constexpr int CH = D / 8;
  for (int i = tid; i < R * CH; i += n_threads) {
    int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(tile + r * ld + c * 8) = v;
  }
}

// Scalar tile copy for the SIMT kernels: any D, converted to fp32.
template <typename T>
__device__ __forceinline__ void load_tile_f32(float* tile, const T* src,
                                              int row0, int R, int n_rows,
                                              int D, int tid, int n_threads) {
  for (int i = tid; i < R * D; i += n_threads) {
    int r = i / D, d = i % D;
    tile[i] = (row0 + r < n_rows) ? to_f32<T>(src[(size_t)(row0 + r) * D + d])
                                  : 0.f;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
template <typename K>
static inline cudaError_t flash_set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
