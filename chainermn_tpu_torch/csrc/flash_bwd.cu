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
// so both are bound by the tensor-core rate.  The TPU kernels carried their
// accumulators across sequential grid steps; here a loop inside the block
// replaces that axis.  Both Hopper kernels (bf16, D in {64, 128}) are three
// warpgroups: a producer warpgroup that gives its registers away
// (setmaxnreg) and drives TMA from one thread, and two consumer warpgroups
// that run wgmma on 128-byte-swizzled tiles.  Each block writes only its
// own rows: no atomics, bit-identical results run to run.
//
// dQ: one block owns 128 query rows of one (batch, head) row.  The producer
// loads the block's Q and dO tiles with their lse and delta rows (and query
// segment ids) once, then streams 64-key (K, V) tiles of the kv row, with
// their key segment ids, through a three-stage mbarrier ring over the live
// key tiles.  Each consumer owns 64 query rows and keeps its dQ accumulator
// (64 x D fp32) in registers for the whole block.  Per key tile it computes
// S = Q K^T and dP = dO V^T with wgmma from shared memory, P and dS in
// registers (exp2 of pre-scaled scores, the mask tested only on tiles the
// diagonal, the window band, the ragged edge or segment ids cut), and
// dQ += dS K as wgmma with dS, cast to bf16, as the register A operand and
// K read MN-major.  dQ leaves through the block's Q tile in 16-byte stores.
// Blocks start with the longest causal rows first.
//
// dK/dV: one block owns 128 keys of one kv row.  The producer loads the
// block's K and V tiles once and then streams 64-row (Q, dO) tiles with
// their lse and delta rows (and query segment ids) through a two-stage
// mbarrier ring, over every query head of the GQA group and every live
// query tile, so the group's reduction happens in the block, with no second
// pass.  Each consumer owns 64 keys and keeps its dK and dV accumulators
// (64 x D fp32) in registers for the whole block.  Per query tile it
// computes S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory
// (keys on the accumulator rows), P^T and dS^T in registers, masked as in
// dQ, and dV += P^T dO, dK += dS^T Q as wgmma with P^T and dS^T, cast to
// bf16, as the register A operand and dO, Q read MN-major (the transpose
// flag).  dK and dV leave through shared memory in 16-byte stores.
//
// The fp32 path, and bf16 at other head sizes, use plain SIMT kernels with
// the same semantics (fp32 FMA).

#include "flash_common.cuh"
#include "sm90.cuh"

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
// dQ Hopper kernel: bf16, D in {64, 128}, wgmma + TMA ring.
// ---------------------------------------------------------------------------

template <int D>
struct DqTiles {
  static constexpr int BQ = 128;           // query rows; 64 per consumer
  static constexpr int BK = 64;            // keys per ring stage
  static constexpr int STAGES = 3;
  static constexpr int QT_BYTES = BQ * D * 2;   // Q or dO tile
  static constexpr int KV_BYTES = BK * D * 2;   // K or V tile
  static constexpr int ROW_BYTES = BQ * 4;      // lse, delta or segment ids
  static constexpr int SEG_BYTES = BK * 4;      // key segment ids
  // Loaded once: Q, dO, then lse, delta, query segment ids.
  static constexpr int OFF_Q = 0, OFF_DO = QT_BYTES, OFF_LSE = 2 * QT_BYTES;
  static constexpr int OFF_DELTA = OFF_LSE + ROW_BYTES;
  static constexpr int OFF_QSEG = OFF_DELTA + ROW_BYTES;
  // One ring stage: K, V, key segment ids.
  static constexpr int ST_K = 0, ST_V = KV_BYTES, ST_SEG = 2 * KV_BYTES;
  static constexpr int STAGE_BYTES = (ST_SEG + SEG_BYTES + 1023) / 1024 * 1024;
  static constexpr int OFF_STAGE = (OFF_QSEG + ROW_BYTES + 1023) / 1024 * 1024;
  static constexpr int OFF_BAR = OFF_STAGE + STAGES * STAGE_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tlse,
                   const __grid_constant__ CUtensorMap tdelta,
                   const __grid_constant__ CUtensorMap tqseg,
                   const __grid_constant__ CUtensorMap tkseg,
                   __nv_bfloat16* __restrict__ dq, MaskArgs m, int G,
                   float scale, float scale_log2) {
  using T = DqTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::STAGES, NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm + T::OFF_Q);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(sm + T::OFF_DO);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + T::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  auto stage = [&](int s) { return sm + T::OFF_STAGE + s * T::STAGE_BYTES; };

  const int bh = blockIdx.x;
  const int kvrow = bh / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const bool seg = m.qseg != nullptr;
  int kt0, kt1;
  flash_k_range(m, q0, BQ, BK, &kt0, &kt1);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);                     // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar,
                     2 * T::QT_BYTES + (2 + (seg ? 1 : 0)) * T::ROW_BYTES);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(Qs + b * BQ * 64, &tq, qbar, b * 64, q0, bh);
        tma_load_3d(dOs + b * BQ * 64, &tdo, qbar, b * 64, q0, bh);
      }
      tma_load_1d(sm + T::OFF_LSE, &tlse, qbar, bh * m.Sq + q0);
      tma_load_1d(sm + T::OFF_DELTA, &tdelta, qbar, bh * m.Sq + q0);
      if (seg) tma_load_1d(sm + T::OFF_QSEG, &tqseg, qbar, bh * m.Sq + q0);
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        unsigned char* st = stage(s);
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * T::KV_BYTES + (seg ? T::SEG_BYTES : 0));
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + T::ST_K + b * BK * 128, &tk, &full[s], b * 64,
                      kt * BK, kvrow);
          tma_load_3d(st + T::ST_V + b * BK * 128, &tv, &full[s], b * 64,
                      kt * BK, kvrow);
        }
        if (seg)
          tma_load_1d(st + T::ST_SEG, &tkseg, &full[s],
                      kvrow * m.Sk + kt * BK);
      }
    }
    return;
  }

  // Consumer warpgroup c owns query rows qc0 .. qc0 + 63.
  regs_alloc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  const int qc0 = q0 + 64 * c;
  const int qlast = min(qc0 + 63, m.Sq - 1);
  const int rloc[2] = {64 * c + 16 * warp + g, 64 * c + 16 * warp + g + 8};
  const __nv_bfloat16* Qc = Qs + c * 64 * 64;   // this warpgroup's rows
  const __nv_bfloat16* dOc = dOs + c * 64 * 64;
  mbar_wait(qbar, 0);
  // This thread's two query rows: lse (pre-scaled to base 2), delta and
  // segment id.
  const float* Ls = reinterpret_cast<const float*>(sm + T::OFF_LSE);
  const float* Ds = reinterpret_cast<const float*>(sm + T::OFF_DELTA);
  const int* Sg = reinterpret_cast<const int*>(sm + T::OFF_QSEG);
  float lse2[2], dlt[2];
  int qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = Ls[rloc[h]] * LOG2E;
    dlt[h] = Ds[rloc[h]];
    qseg[h] = Sg[rloc[h]];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // Every consumer walks every key tile of the block, so the issue path has
  // no branch (a branch around wgmma makes the compiler serialise them): a
  // tile with no live pair for this warpgroup goes through the masked path
  // and gives dS = 0.  A stage is released once the dQ product that reads
  // its K has been waited on.
  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % STAGES;
    const int k0 = kt * BK;
    const unsigned char* st = stage(s);
    const __nv_bfloat16* Kt =
        reinterpret_cast<const __nv_bfloat16*>(st + T::ST_K);
    const __nv_bfloat16* Vt =
        reinterpret_cast<const __nv_bfloat16*>(st + T::ST_V);
    const int* ks = reinterpret_cast<const int*>(st + T::ST_SEG);
    // Tile classes: interior (every pair live: no mask test) or cut.
    const bool interior = !seg && qc0 + 64 <= m.Sq && k0 + BK <= m.Sk &&
                          (!m.causal || k0 + BK - 1 <= qc0) &&
                          (m.window < 0 || qlast - k0 < m.window);
    mbar_wait(&full[s], (i / STAGES) & 1);
    // S = Q K^T and dP = dO V^T: queries on the accumulator rows.
    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int b = kk / 4, ko = (kk % 4) * 16;
      wgmma_ss(sc, gmma_desc_kmajor(Qc + b * BQ * 64 + ko),
               gmma_desc_kmajor(Kt + b * BK * 64 + ko), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int b = kk / 4, ko = (kk % 4) * 16;
      wgmma_ss(dp, gmma_desc_kmajor(dOc + b * BQ * 64 + ko),
               gmma_desc_kmajor(Vt + b * BK * 64 + ko), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    keep(sc);
    keep(dp);

    // P = exp2(S scale log2e - lse log2e), dS = P (dP - delta) scale; a
    // masked pair gives P = dS = 0.
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int h = (e >> 1) & 1;
      const int kc = (e >> 2) * 8 + 2 * t + (e & 1);
      bool live = true;
      if (!interior) {
        const int qp = qc0 + 16 * warp + g + 8 * h, kp = k0 + kc;
        live = qp < m.Sq && kp < m.Sk && (!m.causal || kp <= qp) &&
               (m.window < 0 || qp - kp < m.window) &&
               (!seg || qseg[h] == ks[kc]);
      }
      const float p = live ? ex2(sc[e] * scale_log2 - lse2[h]) : 0.f;
      dp[e] = p * (dp[e] - dlt[h]) * scale;
    }
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    // dQ += dS K: the key axis is the reduction, so K is read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, da[kk], gmma_desc_mnmajor(Kt + kk * 16 * 64, BK * 128));
    wgmma_commit();
    wgmma_wait();
    keep(acc);
    keep(da);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: dQ through this warpgroup's own Q rows, then 16-byte stores.
  unsigned char* dQs = reinterpret_cast<unsigned char*>(Qs) + c * 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h, col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dQs + (col / 64) * BQ * 128 +
                                   swz_offset(r, col % 64)) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  named_bar_sync(1 + c, 128);
  for (int idx = tw; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), ch = idx % (D / 8);
    if (qc0 + r < m.Sq) {
      const size_t go = ((size_t)bh * m.Sq + qc0 + r) * D + ch * 8;
      *reinterpret_cast<uint4*>(dq + go) = *reinterpret_cast<const uint4*>(
          dQs + (ch / 8) * BQ * 128 + swz_offset(r, (ch % 8) * 8));
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV Hopper kernel: bf16, D in {64, 128}, wgmma + TMA ring.
// ---------------------------------------------------------------------------

template <int D>
struct DkvTiles {
  static constexpr int BK = 128;           // keys; 64 per consumer
  static constexpr int BQ = 64;            // query rows per ring stage
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BK * D * 2;   // K or V tile
  static constexpr int QT_BYTES = BQ * D * 2;   // Q or dO tile
  static constexpr int ROW_BYTES = BQ * 4;      // lse, delta or segment ids
  // One stage: Q, dO, then lse, delta, query segment ids.
  static constexpr int ST_Q = 0, ST_DO = QT_BYTES, ST_LSE = 2 * QT_BYTES;
  static constexpr int ST_DELTA = ST_LSE + ROW_BYTES;
  static constexpr int ST_SEG = ST_DELTA + ROW_BYTES;
  static constexpr int STAGE_BYTES = (ST_SEG + ROW_BYTES + 1023) / 1024 * 1024;
  static constexpr int OFF_K = 0, OFF_V = KV_BYTES;
  static constexpr int OFF_STAGE = 2 * KV_BYTES;
  static constexpr int OFF_BAR = OFF_STAGE + STAGES * STAGE_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tdelta,
                    const __grid_constant__ CUtensorMap tqseg,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, MaskArgs m, int G,
                    float scale, float scale_log2) {
  using T = DkvTiles<D>;
  constexpr int BK = T::BK, BQ = T::BQ, STAGES = T::STAGES, NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(sm + T::OFF_K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(sm + T::OFF_V);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + T::OFF_BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;
  auto stage = [&](int s) { return sm + T::OFF_STAGE + s * T::STAGE_BYTES; };

  const int kvrow = blockIdx.x;
  const int k0 = blockIdx.y * BK;          // the most causal work first
  const bool seg = m.qseg != nullptr;
  int qt0, qt1;
  flash_q_range(m, k0, BK, BQ, &qt0, &qt1);
  const int nq = qt1 > qt0 ? qt1 - qt0 : 0;
  const int n_items = G * nq;              // (query head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);                     // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * T::KV_BYTES);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(Ks + b * BK * 64, &tk, kvbar, b * 64, k0, kvrow);
        tma_load_3d(Vs + b * BK * 64, &tv, kvbar, b * 64, k0, kvrow);
      }
      for (int i = 0; i < n_items; ++i) {
        const int s = i % STAGES;
        const int bh = kvrow * G + i / nq, q0 = (qt0 + i % nq) * BQ;
        unsigned char* st = stage(s);
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * T::QT_BYTES +
                                     (2 + (seg ? 1 : 0)) * T::ROW_BYTES);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + T::ST_Q + b * BQ * 128, &tq, &full[s], b * 64, q0,
                      bh);
          tma_load_3d(st + T::ST_DO + b * BQ * 128, &tdo, &full[s], b * 64, q0,
                      bh);
        }
        tma_load_1d(st + T::ST_LSE, &tlse, &full[s], bh * m.Sq + q0);
        tma_load_1d(st + T::ST_DELTA, &tdelta, &full[s], bh * m.Sq + q0);
        if (seg) tma_load_1d(st + T::ST_SEG, &tqseg, &full[s], bh * m.Sq + q0);
      }
    }
    return;
  }

  // Consumer warpgroup c owns keys kc0 .. kc0 + 63.
  regs_alloc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  const int kc0 = k0 + 64 * c;
  const int klast = min(kc0 + 63, m.Sk - 1);
  const int krow[2] = {kc0 + 16 * warp + g, kc0 + 16 * warp + g + 8};
  int kseg[2] = {0, 0};
  if (seg)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (krow[h] < m.Sk) kseg[h] = m.kseg[(size_t)kvrow * m.Sk + krow[h]];

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    adk[i] = 0.f;
    adv[i] = 0.f;
  }
  const __nv_bfloat16* Kc = Ks + c * 64 * 64;   // this warpgroup's keys
  const __nv_bfloat16* Vc = Vs + c * 64 * 64;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n_items; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i % nq) * BQ;
    const unsigned char* st = stage(s);
    const __nv_bfloat16* Qt = reinterpret_cast<const __nv_bfloat16*>(st + T::ST_Q);
    const __nv_bfloat16* dOt =
        reinterpret_cast<const __nv_bfloat16*>(st + T::ST_DO);
    const float* Lt = reinterpret_cast<const float*>(st + T::ST_LSE);
    const float* Dt = reinterpret_cast<const float*>(st + T::ST_DELTA);
    const int* Sg = reinterpret_cast<const int*>(st + T::ST_SEG);
    // Tile classes, as in the forward: dead, interior, or cut.
    const bool dead = kc0 >= m.Sk || (m.causal && q0 + BQ - 1 < kc0) ||
                      (m.window >= 0 && q0 - klast >= m.window);
    const bool interior = !seg && q0 + BQ <= m.Sq && kc0 + 64 <= m.Sk &&
                          (!m.causal || q0 >= kc0 + 63) &&
                          (m.window < 0 || q0 + BQ - 1 - kc0 < m.window);
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (!dead) {
      // S^T = K Q^T and dP^T = V dO^T: keys on the accumulator rows.
      float sT[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk / 4, ko = (kk % 4) * 16;
        wgmma_ss(sT, gmma_desc_kmajor(Kc + b * BK * 64 + ko),
                 gmma_desc_kmajor(Qt + b * BQ * 64 + ko), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk / 4, ko = (kk % 4) * 16;
        wgmma_ss(dpt, gmma_desc_kmajor(Vc + b * BK * 64 + ko),
                 gmma_desc_kmajor(dOt + b * BQ * 64 + ko), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      keep(sT);
      keep(dpt);

      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta)
      // scale; a masked pair gives P = dS = 0.
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int h = (e >> 1) & 1;
        const int qc = (e >> 2) * 8 + 2 * t + (e & 1);
        bool live = true;
        if (!interior) {
          const int qp = q0 + qc, kp = krow[h];
          live = qp < m.Sq && kp < m.Sk && (!m.causal || kp <= qp) &&
                 (m.window < 0 || qp - kp < m.window) &&
                 (!seg || Sg[qc] == kseg[h]);
        }
        const float p = live ? ex2(sT[e] * scale_log2 - Lt[qc] * LOG2E) : 0.f;
        sT[e] = p;
        dpt[e] = p * (dpt[e] - Dt[qc]) * scale;
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sT[8 * kk + 2 * r], sT[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      // dV += P^T dO, dK += dS^T Q: the query axis is the reduction.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adv, pa[kk], gmma_desc_mnmajor(dOt + kk * 16 * 64, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(adk, da[kk], gmma_desc_mnmajor(Qt + kk * 16 * 64, BQ * 128));
      wgmma_commit();
      wgmma_wait();
      keep(adv);
      keep(adk);
      keep(pa);
      keep(da);
    }
    mbar_arrive(&empty[s]);
  }

  // Epilogue: dK and dV through this warpgroup's own K and V rows, then
  // 16-byte stores.
  unsigned char* dKs = reinterpret_cast<unsigned char*>(Ks) + c * 64 * 128;
  unsigned char* dVs = reinterpret_cast<unsigned char*>(Vs) + c * 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h, col = 8 * j + 2 * t;
      const uint32_t off = (col / 64) * BK * 128 + swz_offset(r, col % 64);
      *reinterpret_cast<uint32_t*>(dKs + off) =
          pack_bf16(adk[4 * j + 2 * h], adk[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dVs + off) =
          pack_bf16(adv[4 * j + 2 * h], adv[4 * j + 2 * h + 1]);
    }
  named_bar_sync(1 + c, 128);
  for (int idx = tw; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), ch = idx % (D / 8);
    if (kc0 + r < m.Sk) {
      const size_t go = ((size_t)kvrow * m.Sk + kc0 + r) * D + ch * 8;
      const uint32_t off = (ch / 8) * BK * 128 + swz_offset(r, (ch % 8) * 8);
      *reinterpret_cast<uint4*>(dk + go) =
          *reinterpret_cast<const uint4*>(dKs + off);
      *reinterpret_cast<uint4*>(dv + go) =
          *reinterpret_cast<const uint4*>(dVs + off);
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

template <int D>
static cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, MaskArgs m,
                                   int BH, int BHk, float scale,
                                   cudaStream_t st) {
  using T = DqTiles<D>;
  const long long rows = (long long)BH * m.Sq;
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta, tqseg, tkseg;
  memset(&tqseg, 0, sizeof(tqseg));
  memset(&tkseg, 0, sizeof(tkseg));
  cudaError_t err = make_map_tiles(&tq, q, D, m.Sq, BH, T::BQ);
  if (err == cudaSuccess) err = make_map_tiles(&tdo, dout, D, m.Sq, BH, T::BQ);
  if (err == cudaSuccess) err = make_map_tiles(&tk, k, D, m.Sk, BHk, T::BK);
  if (err == cudaSuccess) err = make_map_tiles(&tv, v, D, m.Sk, BHk, T::BK);
  if (err == cudaSuccess)
    err = make_map_flat(&tlse, lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows, T::BQ);
  if (err == cudaSuccess)
    err = make_map_flat(&tdelta, delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows,
                        T::BQ);
  if (err == cudaSuccess && m.qseg != nullptr)
    err = make_map_flat(&tqseg, m.qseg, CU_TENSOR_MAP_DATA_TYPE_INT32, rows,
                        T::BQ);
  if (err == cudaSuccess && m.kseg != nullptr)
    err = make_map_flat(&tkseg, m.kseg, CU_TENSOR_MAP_DATA_TYPE_INT32,
                        (long long)BHk * m.Sk, T::BK);
  if (err == cudaSuccess) err = flash_set_smem(flash_dq_wgmma<D>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (m.Sq + T::BQ - 1) / T::BQ);
  flash_dq_wgmma<D><<<grid, WS_THREADS, T::SMEM, st>>>(
      tq, tdo, tk, tv, tlse, tdelta, tqseg, tkseg,
      static_cast<__nv_bfloat16*>(dq), m, BH / BHk, scale, scale * LOG2E);
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
static cudaError_t launch_dkv_wgmma(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, MaskArgs m, int BH,
                                    int BHk, float scale, cudaStream_t st) {
  using T = DkvTiles<D>;
  const long long rows = (long long)BH * m.Sq;
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta, tqseg;
  memset(&tqseg, 0, sizeof(tqseg));
  cudaError_t err = make_map_tiles(&tq, q, D, m.Sq, BH, T::BQ);
  if (err == cudaSuccess) err = make_map_tiles(&tdo, dout, D, m.Sq, BH, T::BQ);
  if (err == cudaSuccess) err = make_map_tiles(&tk, k, D, m.Sk, BHk, T::BK);
  if (err == cudaSuccess) err = make_map_tiles(&tv, v, D, m.Sk, BHk, T::BK);
  if (err == cudaSuccess)
    err = make_map_flat(&tlse, lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows, T::BQ);
  if (err == cudaSuccess)
    err = make_map_flat(&tdelta, delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows,
                        T::BQ);
  if (err == cudaSuccess && m.qseg != nullptr)
    err = make_map_flat(&tqseg, m.qseg, CU_TENSOR_MAP_DATA_TYPE_INT32, rows,
                        T::BQ);
  if (err == cudaSuccess) err = flash_set_smem(flash_dkv_wgmma<D>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(BHk, (m.Sk + T::BK - 1) / T::BK);
  flash_dkv_wgmma<D><<<grid, WS_THREADS, T::SMEM, st>>>(
      tq, tdo, tk, tv, tlse, tdelta, tqseg, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), m, BH / BHk, scale, scale * LOG2E);
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
  if (flash_route(FLASH_DQ, bf16, D) != FLASH_WGMMA)
    return (long long)dq_simt_smem(D);
  return (long long)(D == 64 ? DqTiles<64>::SMEM : DqTiles<128>::SMEM);
}

extern "C" long long chainermn_flash_dkv_smem(int bf16, int D) {
  if (flash_route(FLASH_DKV, bf16, D) != FLASH_WGMMA)
    return (long long)dkv_simt_smem(D);
  return (long long)(D == 64 ? DkvTiles<64>::SMEM : DkvTiles<128>::SMEM);
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
  if (flash_route(FLASH_DQ, bf16, D) == FLASH_WGMMA)
    err = D == 64 ? launch_dq_wgmma<64>(q, k, v, dout, L, Dl, dq, m, BH, BHk,
                                        scale, st)
                  : launch_dq_wgmma<128>(q, k, v, dout, L, Dl, dq, m, BH, BHk,
                                         scale, st);
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
  if (flash_route(FLASH_DKV, bf16, D) == FLASH_WGMMA)
    err = D == 64 ? launch_dkv_wgmma<64>(q, k, v, dout, L, Dl, dk, dv, m, BH,
                                         BHk, scale, st)
                  : launch_dkv_wgmma<128>(q, k, v, dout, L, Dl, dk, dv, m, BH,
                                          BHk, scale, st);
  else if (bf16)
    err = launch_dkv_simt<__nv_bfloat16>(q, k, v, dout, L, Dl, dk, dv, m, BHk,
                                         G, D, scale, st);
  else
    err = launch_dkv_simt<float>(q, k, v, dout, L, Dl, dk, dv, m, BHk, G, D,
                                 scale, st);
  return (int)err;
}
