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
// the forward, dQ and dK/dV on the Hopper kernels (wgmma, TMA,
// warp-specialised); every other call runs the SIMT kernels.
enum FlashKernel { FLASH_FWD = 0, FLASH_DQ = 1, FLASH_DKV = 2 };
enum FlashRoute { FLASH_SIMT = 0, FLASH_WGMMA = 1 };

static inline int flash_route(int /* kernel: one rule for all three */,
                              int bf16, int D) {
  return bf16 && (D == 64 || D == 128) ? FLASH_WGMMA : FLASH_SIMT;
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

// Two floats as a bf16 pair in one register (round to nearest even): the
// register A operand of a wgmma, and the 4-byte store of the epilogues.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
