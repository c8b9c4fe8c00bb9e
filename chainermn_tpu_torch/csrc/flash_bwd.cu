// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV.
//
// Replaces: chainermn_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (launched by _flash_bh_bwd through pl.pallas_call).  Both
// recompute P = exp(S * scale - lse) from the forward's saved fp32 row
// log-sum-exp, with dP = dO V^T and dS = P * (dP - delta) * scale, where
// delta = rowsum(dO * O) - dlse is computed outside the kernels (a plain
// torch op, as it is plain XLA outside Pallas in the reference).
//   dQ  = sum_k dS K                       one pass per query tile
//   dV  = sum_q P^T dO,  dK = sum_q dS^T Q  one pass per key tile
// P and dS are cast to the operand dtype before each product, as the
// reference does; accumulation is fp32.
//
// What bounds them on this card: at S = 4096, D = 128, causal, dQ does
// ~4.1e11 FLOP and dK/dV ~5.5e11 FLOP per call against ~0.3 GB of traffic,
// so both are bound by the tensor-core rate.  Design (bf16): mma.sync
// m16n8k16 with fp32 accumulators in registers, 4 warps of 16 rows each.
// The TPU kernels carried their accumulators across sequential grid steps;
// here a loop inside the block replaces that axis.  The dK/dV block owns
// one kv row's key tile and loops over every query head of its GQA group
// and every live query tile, so the group's reduction needs no atomics and
// no second pass.  S^T and dP^T are computed transposed (keys on the
// accumulator rows) so P^T and dS^T feed the dV/dK products straight from
// registers.  Loads are synchronous through padded shared memory; TMA and
// wgmma are the next step.
//
// The fp32 path, and bf16 at head sizes without a tensor-core instance,
// use plain SIMT kernels with the same semantics (fp32 FMA).

#include "flash_common.cuh"

constexpr int SIMT_BQ = 32;
constexpr int SIMT_BK = 32;
constexpr int SIMT_THREADS = 128;

static size_t dq_simt_smem(int D) {
  return sizeof(float) *
         (5 * SIMT_BQ * D + SIMT_BQ * (SIMT_BK + 1) + 2 * SIMT_BQ);
}

static size_t dkv_simt_smem(int D) {
  return sizeof(float) *
         (6 * SIMT_BQ * D + 2 * SIMT_BQ * (SIMT_BK + 1) + 2 * SIMT_BQ);
}

// ---------------------------------------------------------------------------
// SIMT kernels: any D <= 256, float or bf16.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  MaskArgs m, int G, int D, float scale) {
  constexpr int BQ = SIMT_BQ, BK = SIMT_BK, NT = SIMT_THREADS;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * D;
  float* Ks = dOs + BQ * D;
  float* Vs = Ks + BK * D;
  float* dQ = Vs + BK * D;
  float* dS = dQ + BQ * D;            // BQ x (BK + 1)
  float* Lr = dS + BQ * (BK + 1);
  float* Dr = Lr + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvrow = bh / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const T* kb = k + (size_t)kvrow * m.Sk * D;
  const T* vb = v + (size_t)kvrow * m.Sk * D;

  load_tile_f32<T>(Qs, q + (size_t)bh * m.Sq * D, q0, BQ, m.Sq, D, tid, NT);
  load_tile_f32<T>(dOs, dout + (size_t)bh * m.Sq * D, q0, BQ, m.Sq, D, tid, NT);
  for (int i = tid; i < BQ * D; i += NT) dQ[i] = 0.f;
  if (tid < BQ) {
    const bool in = q0 + tid < m.Sq;
    Lr[tid] = in ? lse[(size_t)bh * m.Sq + q0 + tid] : 0.f;
    Dr[tid] = in ? delta[(size_t)bh * m.Sq + q0 + tid] : 0.f;
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
      float ds = 0.f;
      if (flash_live(m, bh, kvrow, q0 + r, k0 + c)) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s += Qs[r * D + d] * Ks[c * D + d];
          dp += dOs[r * D + d] * Vs[c * D + d];
        }
        const float p = expf(s * scale - Lr[r]);
        ds = round_to<T>(p * (dp - Dr[r]) * scale);
      }
      dS[r * (BK + 1) + c] = ds;
    }
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = i / D, d = i % D;
      float acc = dQ[i];
      for (int c = 0; c < BK; ++c) acc += dS[r * (BK + 1) + c] * Ks[c * D + d];
      dQ[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    if (q0 + r < m.Sq) dq[((size_t)bh * m.Sq + q0 + r) * D + d] = from_f32<T>(dQ[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_dkv_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, MaskArgs m, int G, int D, float scale) {
  constexpr int BQ = SIMT_BQ, BK = SIMT_BK, NT = SIMT_THREADS;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * D;
  float* dK = Vs + BK * D;
  float* dV = dK + BK * D;
  float* Qs = dV + BK * D;
  float* dOs = Qs + BQ * D;
  float* Ps = dOs + BQ * D;           // BQ x (BK + 1)
  float* dSs = Ps + BQ * (BK + 1);    // BQ x (BK + 1)
  float* Lr = dSs + BQ * (BK + 1);
  float* Dr = Lr + BQ;

  const int kt = blockIdx.x;
  const int kvrow = blockIdx.y;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;

  load_tile_f32<T>(Ks, k + (size_t)kvrow * m.Sk * D, k0, BK, m.Sk, D, tid, NT);
  load_tile_f32<T>(Vs, v + (size_t)kvrow * m.Sk * D, k0, BK, m.Sk, D, tid, NT);
  for (int i = tid; i < BK * D; i += NT) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  int qt0, qt1;
  flash_q_range(m, k0, BK, BQ, &qt0, &qt1);
  for (int gq = 0; gq < G; ++gq) {
    const int bh = kvrow * G + gq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile_f32<T>(Qs, q + (size_t)bh * m.Sq * D, q0, BQ, m.Sq, D, tid, NT);
      load_tile_f32<T>(dOs, dout + (size_t)bh * m.Sq * D, q0, BQ, m.Sq, D, tid,
                       NT);
      if (tid < BQ) {
        const bool in = q0 + tid < m.Sq;
        Lr[tid] = in ? lse[(size_t)bh * m.Sq + q0 + tid] : 0.f;
        Dr[tid] = in ? delta[(size_t)bh * m.Sq + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        float p = 0.f, ds = 0.f;
        if (flash_live(m, bh, kvrow, q0 + r, k0 + c)) {
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s += Qs[r * D + d] * Ks[c * D + d];
            dp += dOs[r * D + d] * Vs[c * D + d];
          }
          p = expf(s * scale - Lr[r]);
          ds = p * (dp - Dr[r]) * scale;
        }
        Ps[r * (BK + 1) + c] = round_to<T>(p);
        dSs[r * (BK + 1) + c] = round_to<T>(ds);
      }
      __syncthreads();
      for (int i = tid; i < BK * D; i += NT) {
        const int c = i / D, d = i % D;
        float av = dV[i], ak = dK[i];
        for (int r = 0; r < BQ; ++r) {
          av += Ps[r * (BK + 1) + c] * dOs[r * D + d];
          ak += dSs[r * (BK + 1) + c] * Qs[r * D + d];
        }
        dV[i] = av;
        dK[i] = ak;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BK * D; i += NT) {
    const int c = i / D, d = i % D;
    if (k0 + c < m.Sk) {
      const size_t off = ((size_t)kvrow * m.Sk + k0 + c) * D + d;
      dk[off] = from_f32<T>(dK[i]);
      dv[off] = from_f32<T>(dV[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16, D in {64, 128}.
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;
constexpr int DQ_BQ = 64, DQ_BK = 64;     // dQ: 16 query rows per warp
constexpr int DKV_BK = 64, DKV_BQ = 32;   // dK/dV: 16 key rows per warp

template <int D>
static size_t dq_mma_smem() {
  return sizeof(__nv_bfloat16) * (2 * DQ_BQ + 2 * DQ_BK) * (D + 8);
}

template <int D>
static size_t dkv_mma_smem() {
  return sizeof(__nv_bfloat16) * (2 * DKV_BK + 2 * DKV_BQ) * (D + 8) +
         sizeof(float) * 2 * DKV_BQ;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_dq_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, MaskArgs m, int G,
                 float scale) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK, LD = D + 8;
  constexpr int ND = D / 8, NK = BK / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks = dOs + BQ * LD;
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
  load_tile_bf16<D>(dOs, LD, dout + (size_t)bh * m.Sq * D, q0, BQ, m.Sq, tid,
                    MMA_THREADS);
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float Lr[2], Dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qrow[h] < m.Sq;
    Lr[h] = in ? lse[(size_t)bh * m.Sq + qrow[h]] : 0.f;
    Dr[h] = in ? delta[(size_t)bh * m.Sq + qrow[h]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  int kt0, kt1;
  flash_k_range(m, q0, BQ, BK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_bf16<D>(Ks, LD, kb, k0, BK, m.Sk, tid, MMA_THREADS);
    load_tile_bf16<D>(Vs, LD, vb, k0, BK, m.Sk, tid, MMA_THREADS);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.f;
        dp[nt][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ado[4];
      load_a_frag(aq, Qs, LD, r0, kk * 16, g, t);
      load_a_frag(ado, dOs, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        uint32_t b[2];
        load_bt_frag(b, Ks, LD, nt * 8, kk * 16, g, t);
        mma_16816(s[nt], aq, b);
        load_bt_frag(b, Vs, LD, nt * 8, kk * 16, g, t);
        mma_16816(dp[nt], ado, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (flash_live(m, bh, kvrow, qrow[h], kp)) {
          const float p = expf(s[nt][e] * scale - Lr[h]);
          ds = p * (dp[nt][e] - Dr[h]) * scale;
        }
        s[nt][e] = ds;
      }
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
        load_b_frag(b, Ks, LD, kk * 16, nd * 8, g, t);
        mma_16816(acc[nd], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = qrow[h];
    if (qp < m.Sq) {
      __nv_bfloat16* row = dq + ((size_t)bh * m.Sq + qp) * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<uint32_t*>(row + nd * 8 + 2 * t) =
            pack_bf16(acc[nd][2 * h], acc[nd][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_dkv_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, MaskArgs m, int G,
                  float scale) {
  constexpr int BK = DKV_BK, BQ = DKV_BQ, LD = D + 8;
  constexpr int ND = D / 8, NQ = BQ / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* dOs = Qs + BQ * LD;
  float* Ls = reinterpret_cast<float*>(dOs + BQ * LD);
  float* Ds = Ls + BQ;

  const int kt = blockIdx.x;
  const int kvrow = blockIdx.y;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_tile_bf16<D>(Ks, LD, k + (size_t)kvrow * m.Sk * D, k0, BK, m.Sk, tid,
                    MMA_THREADS);
  load_tile_bf16<D>(Vs, LD, v + (size_t)kvrow * m.Sk * D, k0, BK, m.Sk, tid,
                    MMA_THREADS);
  const int krow[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[nd][e] = 0.f;
      adv[nd][e] = 0.f;
    }

  int qt0, qt1;
  flash_q_range(m, k0, BK, BQ, &qt0, &qt1);
  for (int gq = 0; gq < G; ++gq) {
    const int bh = kvrow * G + gq;
    const __nv_bfloat16* qb = q + (size_t)bh * m.Sq * D;
    const __nv_bfloat16* ob = dout + (size_t)bh * m.Sq * D;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile_bf16<D>(Qs, LD, qb, q0, BQ, m.Sq, tid, MMA_THREADS);
      load_tile_bf16<D>(dOs, LD, ob, q0, BQ, m.Sq, tid, MMA_THREADS);
      if (tid < BQ) {
        const bool in = q0 + tid < m.Sq;
        Ls[tid] = in ? lse[(size_t)bh * m.Sq + q0 + tid] : 0.f;
        Ds[tid] = in ? delta[(size_t)bh * m.Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys on the accumulator rows.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[nt][e] = 0.f;
          dpt[nt][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        load_a_frag(ak, Ks, LD, r0, kk * 16, g, t);
        load_a_frag(av, Vs, LD, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          uint32_t b[2];
          load_bt_frag(b, Qs, LD, nt * 8, kk * 16, g, t);
          mma_16816(st[nt], ak, b);
          load_bt_frag(b, dOs, LD, nt * 8, kk * 16, g, t);
          mma_16816(dpt[nt], av, b);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qi = nt * 8 + 2 * t + (e & 1);
          float p = 0.f, ds = 0.f;
          if (flash_live(m, bh, kvrow, q0 + qi, krow[h])) {
            p = expf(st[nt][e] * scale - Ls[qi]);
            ds = p * (dpt[nt][e] - Ds[qi]) * scale;
          }
          st[nt][e] = p;
          dpt[nt][e] = ds;
        }
      // dV += P^T dO, dK += dS^T Q (query axis is the reduction).
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ads[4];
        ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        ads[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        ads[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        ads[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        ads[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t b[2];
          load_b_frag(b, dOs, LD, kk * 16, nd * 8, g, t);
          mma_16816(adv[nd], ap, b);
          load_b_frag(b, Qs, LD, kk * 16, nd * 8, g, t);
          mma_16816(adk[nd], ads, b);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = krow[h];
    if (kp < m.Sk) {
      const size_t off = ((size_t)kvrow * m.Sk + kp) * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        *reinterpret_cast<uint32_t*>(dk + off + nd * 8 + 2 * t) =
            pack_bf16(adk[nd][2 * h], adk[nd][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + nd * 8 + 2 * t) =
            pack_bf16(adv[nd][2 * h], adv[nd][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

template <int D>
static cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, MaskArgs m,
                                 int BH, int G, float scale, cudaStream_t st) {
  const size_t smem = dq_mma_smem<D>();
  cudaError_t err = flash_set_smem(flash_dq_mma<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m.Sq + DQ_BQ - 1) / DQ_BQ, BH);
  flash_dq_mma<D><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), m, G, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dq_simt(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, MaskArgs m,
                                  int BH, int G, int D, float scale,
                                  cudaStream_t st) {
  const size_t smem = dq_simt_smem(D);
  cudaError_t err = flash_set_smem(flash_dq_simt<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m.Sq + SIMT_BQ - 1) / SIMT_BQ, BH);
  flash_dq_simt<T><<<grid, SIMT_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), m, G, D, scale);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  MaskArgs m, int BHk, int G, float scale,
                                  cudaStream_t st) {
  const size_t smem = dkv_mma_smem<D>();
  cudaError_t err = flash_set_smem(flash_dkv_mma<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m.Sk + DKV_BK - 1) / DKV_BK, BHk);
  flash_dkv_mma<D><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), m, G,
      scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dkv_simt(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   MaskArgs m, int BHk, int G, int D,
                                   float scale, cudaStream_t st) {
  const size_t smem = dkv_simt_smem(D);
  cudaError_t err = flash_set_smem(flash_dkv_simt<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m.Sk + SIMT_BK - 1) / SIMT_BK, BHk);
  flash_dkv_simt<T><<<grid, SIMT_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), m, G, D, scale);
  return cudaGetLastError();
}

// Dynamic shared memory one block of each kernel for (dtype, D) requests.
extern "C" long long chainermn_flash_dq_smem(int bf16, int D) {
  if (!flash_use_mma(bf16, D)) return (long long)dq_simt_smem(D);
  return (long long)(D == 64 ? dq_mma_smem<64>() : dq_mma_smem<128>());
}

extern "C" long long chainermn_flash_dkv_smem(int bf16, int D) {
  if (!flash_use_mma(bf16, D)) return (long long)dkv_simt_smem(D);
  return (long long)(D == 64 ? dkv_mma_smem<64>() : dkv_mma_smem<128>());
}

extern "C" int chainermn_flash_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* qseg,
                                  const void* kseg, void* dq, int bf16, int BH,
                                  int BHk, int Sq, int Sk, int D, float scale,
                                  int causal, int window, void* stream) {
  MaskArgs m{Sq, Sk, causal, window, static_cast<const int*>(qseg),
             static_cast<const int*>(kseg)};
  const int G = BH / BHk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (flash_use_mma(bf16, D))
    err = D == 64
              ? launch_dq_mma<64>(q, k, v, dout, L, Dl, dq, m, BH, G, scale, st)
              : launch_dq_mma<128>(q, k, v, dout, L, Dl, dq, m, BH, G, scale,
                                   st);
  else if (bf16)
    err = launch_dq_simt<__nv_bfloat16>(q, k, v, dout, L, Dl, dq, m, BH, G, D,
                                        scale, st);
  else
    err = launch_dq_simt<float>(q, k, v, dout, L, Dl, dq, m, BH, G, D, scale,
                                st);
  return (int)err;
}

extern "C" int chainermn_flash_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* qseg,
                                   const void* kseg, void* dk, void* dv,
                                   int bf16, int BH, int BHk, int Sq, int Sk,
                                   int D, float scale, int causal, int window,
                                   void* stream) {
  MaskArgs m{Sq, Sk, causal, window, static_cast<const int*>(qseg),
             static_cast<const int*>(kseg)};
  const int G = BH / BHk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (flash_use_mma(bf16, D))
    err = D == 64 ? launch_dkv_mma<64>(q, k, v, dout, L, Dl, dk, dv, m, BHk, G,
                                       scale, st)
                  : launch_dkv_mma<128>(q, k, v, dout, L, Dl, dk, dv, m, BHk,
                                        G, scale, st);
  else if (bf16)
    err = launch_dkv_simt<__nv_bfloat16>(q, k, v, dout, L, Dl, dk, dv, m, BHk,
                                         G, D, scale, st);
  else
    err = launch_dkv_simt<float>(q, k, v, dout, L, Dl, dk, dv, m, BHk, G, D,
                                 scale, st);
  return (int)err;
}
