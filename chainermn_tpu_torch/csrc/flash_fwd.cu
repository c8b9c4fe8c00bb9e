// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: chainermn_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _flash_bh_fwd through pl.pallas_call).  Computes, for each query row, the
// masked softmax of S = Q K^T * scale over its key row and O = P V, with an
// online softmax (running max m, denominator l, fp32 accumulator), P cast
// to V's dtype before the PV product, O in the input dtype and the fp32 row
// log-sum-exp lse = m + log(max(l, 1e-30)).  Masked scores are -1e30, not
// -inf, and masked probabilities are zero, so a fully masked row gives
// o = 0 and lse ~ -1e30.  GQA: q row b reads kv row b / G, no repeat.
//
// What bounds it on this card: at the training shapes (S = 4096, D = 128,
// causal) the work is ~2.7e11 FLOP per call against ~0.2 GB of traffic, far
// above the H100's ~295 FLOP/byte balance point, so the bound is the
// tensor-core rate.  Design: the bf16 kernel is FlashAttention-2 on
// mma.sync m16n8k16 (fp32 accumulate).  One block of 4 warps owns 64 query
// rows (16 per warp) and walks the live key tiles (the TPU grid's
// sequential axis becomes this loop); S, P and the O accumulator stay in
// registers, and P feeds the PV product straight from the S accumulator
// layout.  Key/value tiles pass through padded shared memory.  The tiles
// are loaded synchronously: TMA, wgmma and warp specialisation are the
// next step.  Blocks start with the longest causal rows first.
//
// The fp32 path, and bf16 at head sizes without a tensor-core instance,
// use a plain SIMT kernel with the same semantics (fp32 FMA).

#include "flash_common.cuh"

// ---------------------------------------------------------------------------
// SIMT kernel: any D <= 256, float or bf16.
// ---------------------------------------------------------------------------

constexpr int SIMT_BQ = 32;
constexpr int SIMT_BK = 32;
constexpr int SIMT_THREADS = 128;

static size_t fwd_simt_smem(int D) {
  return sizeof(float) *
         (4 * SIMT_BQ * D + SIMT_BQ * (SIMT_BK + 1) + 3 * SIMT_BQ);
}

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, MaskArgs m, int G, int D,
                   float scale) {
  constexpr int BQ = SIMT_BQ, BK = SIMT_BK, NT = SIMT_THREADS;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * D;
  float* Vs = Ks + BK * D;
  float* Acc = Vs + BK * D;
  float* Ss = Acc + BQ * D;           // BQ x (BK + 1)
  float* mrow = Ss + BQ * (BK + 1);
  float* lrow = mrow + BQ;
  float* arow = lrow + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvrow = bh / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (size_t)bh * m.Sq * D;
  const T* kb = k + (size_t)kvrow * m.Sk * D;
  const T* vb = v + (size_t)kvrow * m.Sk * D;

  load_tile_f32<T>(Qs, qb, q0, BQ, m.Sq, D, tid, NT);
  for (int i = tid; i < BQ * D; i += NT) Acc[i] = 0.f;
  if (tid < BQ) {
    mrow[tid] = FLASH_NEG_INF;
    lrow[tid] = 0.f;
  }
  int kt0, kt1;
  flash_k_range(m, q0, BQ, BK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_f32<T>(Ks, kb, k0, BK, m.Sk, D, tid, NT);
    load_tile_f32<T>(Vs, vb, k0, BK, m.Sk, D, tid, NT);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      float s = FLASH_NEG_INF;
      if (flash_live(m, bh, kvrow, q0 + r, k0 + c)) {
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc += Qs[r * D + d] * Ks[c * D + d];
        s = acc * scale;
      }
      Ss[r * (BK + 1) + c] = s;
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += NT / 32) {
      const float s = Ss[r * (BK + 1) + lane];
      const bool live = flash_live(m, bh, kvrow, q0 + r, k0 + lane);
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      Ss[r * (BK + 1) + lane] = round_to<T>(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        arow[r] = alpha;
        lrow[r] = lrow[r] * alpha + psum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = i / D, d = i % D;
      float acc = Acc[i] * arow[r];
      for (int c = 0; c < BK; ++c) acc += Ss[r * (BK + 1) + c] * Vs[c * D + d];
      Acc[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    if (q0 + r < m.Sq) {
      const float den = fmaxf(lrow[r], 1e-30f);
      o[((size_t)bh * m.Sq + q0 + r) * D + d] = from_f32<T>(Acc[i] / den);
    }
  }
  if (tid < BQ && q0 + tid < m.Sq)
    lse[(size_t)bh * m.Sq + q0 + tid] =
        mrow[tid] + logf(fmaxf(lrow[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, D in {64, 128}.
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = 128;

template <int D>
static size_t fwd_mma_smem() {
  return sizeof(__nv_bfloat16) * (MMA_BQ + 2 * MMA_BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  MaskArgs m, int G, float scale) {
  constexpr int BQ = MMA_BQ, BK = MMA_BK, LD = D + 8;
  constexpr int ND = D / 8, NK = BK / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvrow = bh / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const __nv_bfloat16* kb = k + (size_t)kvrow * m.Sk * D;
  const __nv_bfloat16* vb = v + (size_t)kvrow * m.Sk * D;

  load_tile_bf16<D>(Qs, LD, q + (size_t)bh * m.Sq * D, q0, BQ, m.Sq, tid,
                    MMA_THREADS);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag(qa[kk], Qs, LD, r0, kk * 16, g, t);

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float mi[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
  float li[2] = {0.f, 0.f};
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  int kt0, kt1;
  flash_k_range(m, q0, BQ, BK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_bf16<D>(Ks, LD, kb, k0, BK, m.Sk, tid, MMA_THREADS);
    load_tile_bf16<D>(Vs, LD, vb, k0, BK, m.Sk, tid, MMA_THREADS);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        uint32_t b[2];
        load_bt_frag(b, Ks, LD, nt * 8, kk * 16, g, t);
        mma_16816(s[nt], qa[kk], b);
      }

    uint32_t live = 0;
    float mx[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        const bool L = flash_live(m, bh, kvrow, qrow[h], kp);
        const float x = L ? s[nt][e] * scale : FLASH_NEG_INF;
        s[nt][e] = x;
        if (L) live |= 1u << (nt * 4 + e);
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(mi[h], quad_max(mx[h]));
      alpha[h] = expf(mi[h] - mn);
      mi[h] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            ((live >> (nt * 4 + e)) & 1u) ? expf(s[nt][e] - mi[h]) : 0.f;
        s[nt][e] = p;
        rs[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) li[h] = li[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b[2];
        load_b_frag(b, Vs, LD, kk * 16, nd * 8, g, t);
        mma_16816(acc[nd], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = qrow[h];
    if (qp < m.Sq) {
      const float den = fmaxf(li[h], 1e-30f);
      __nv_bfloat16* orow = o + ((size_t)bh * m.Sq + qp) * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) =
            pack_bf16(acc[nd][2 * h] / den, acc[nd][2 * h + 1] / den);
      if (t == 0) lse[(size_t)bh * m.Sq + qp] = mi[h] + logf(den);
    }
  }
}

// ---------------------------------------------------------------------------
// C entry point
// ---------------------------------------------------------------------------

template <int D>
static cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                                  void* o, float* lse, MaskArgs m, int BH,
                                  int G, float scale, cudaStream_t st) {
  const size_t smem = fwd_mma_smem<D>();
  cudaError_t err = flash_set_smem(flash_fwd_mma<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m.Sq + MMA_BQ - 1) / MMA_BQ, BH);
  flash_fwd_mma<D><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      m, G, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_fwd_simt(const void* q, const void* k, const void* v,
                                   void* o, float* lse, MaskArgs m, int BH,
                                   int G, int D, float scale, cudaStream_t st) {
  const size_t smem = fwd_simt_smem(D);
  cudaError_t err = flash_set_smem(flash_fwd_simt<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m.Sq + SIMT_BQ - 1) / SIMT_BQ, BH);
  flash_fwd_simt<T><<<grid, SIMT_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, m, G, D, scale);
  return cudaGetLastError();
}

// Dynamic shared memory one block of the kernel for (dtype, D) requests.
extern "C" long long chainermn_flash_fwd_smem(int bf16, int D) {
  if (!flash_use_mma(bf16, D)) return (long long)fwd_simt_smem(D);
  return (long long)(D == 64 ? fwd_mma_smem<64>() : fwd_mma_smem<128>());
}

extern "C" int chainermn_flash_uses_mma(int bf16, int D) {
  return flash_use_mma(bf16, D);
}

extern "C" int chainermn_flash_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* qseg,
                                   const void* kseg, int bf16, int BH, int BHk,
                                   int Sq, int Sk, int D, float scale,
                                   int causal, int window, void* stream) {
  MaskArgs m{Sq, Sk, causal, window, static_cast<const int*>(qseg),
             static_cast<const int*>(kseg)};
  const int G = BH / BHk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (flash_use_mma(bf16, D))
    err = D == 64 ? launch_fwd_mma<64>(q, k, v, o, l, m, BH, G, scale, st)
                  : launch_fwd_mma<128>(q, k, v, o, l, m, BH, G, scale, st);
  else if (bf16)
    err = launch_fwd_simt<__nv_bfloat16>(q, k, v, o, l, m, BH, G, D, scale, st);
  else
    err = launch_fwd_simt<float>(q, k, v, o, l, m, BH, G, D, scale, st);
  return (int)err;
}
