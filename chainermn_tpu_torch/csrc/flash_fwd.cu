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
// tensor-core rate, which only wgmma reaches.  Design (bf16, D in {64,
// 128}): one block owns 128 query rows of one head and is three
// warpgroups.  The producer warpgroup gives its registers away
// (setmaxnreg) and one of its threads drives TMA: the Q tile once, then
// the live K/V tiles (BK = 128 keys at D = 128, 192 at D = 64) through a
// three-stage shared-memory ring with one full and one empty mbarrier per
// stage.  Each of the two consumer warpgroups owns 64 query rows: S = Q K^T
// is a wgmma with both operands in shared memory (K is K-major), the
// online softmax runs in exp2 on the accumulator registers, and P, cast to
// bf16 in place, is the register A operand of O += P V (V read MN-major,
// the transpose flag).  The consumers ping-pong (FlashAttention-3): a
// warpgroup's turn at the tensor cores issues S for this tile and P V for
// the previous one, so its softmax runs under its own P V and the other
// warpgroup's turn.  Tiles are 128-byte swizzled, so neither TMA nor wgmma
// meets bank conflicts.  Only tiles that the causal diagonal, the window
// band, the ragged edge or segment ids cut pay a per-score mask test;
// segment ids of a key tile ride the ring with it.  O leaves through
// shared memory (the warpgroup's own Q rows) in 16-byte stores.  Blocks
// start with the longest causal rows first.
//
// The fp32 path, and bf16 at other head sizes, use a plain SIMT kernel with
// the same semantics (fp32 FMA).

#include "flash_common.cuh"
#include "sm90.cuh"

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
// Hopper kernel: bf16, D in {64, 128}.
// ---------------------------------------------------------------------------

constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdTiles {
  static constexpr int BQ = 128;           // query rows; 64 per consumer
  static constexpr int BK = D == 64 ? 192 : 128;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or one V tile
  static constexpr int SEG_BYTES = BK * 4;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_SEG = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_SEG + STAGES * SEG_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tkseg,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    MaskArgs m, int G, float scale_log2) {
  using T = FwdTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::STAGES, NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + T::OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  auto Ks = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(sm + T::OFF_K + s * T::KV_BYTES);
  };
  auto Vs = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(sm + T::OFF_V + s * T::KV_BYTES);
  };
  auto Segs = [&](int s) {
    return reinterpret_cast<int*>(sm + T::OFF_SEG + s * T::SEG_BYTES);
  };

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
      mbar_expect_tx(qbar, T::Q_BYTES);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(Qs + b * BQ * 64, &tq, qbar, b * 64, q0, bh);
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * T::KV_BYTES + (seg ? T::SEG_BYTES : 0));
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(Ks(s) + b * BK * 64, &tk, &full[s], b * 64, kt * BK,
                      kvrow);
          tma_load_3d(Vs(s) + b * BK * 64, &tv, &full[s], b * 64, kt * BK,
                      kvrow);
        }
        if (seg) tma_load_1d(Segs(s), &tkseg, &full[s], kvrow * m.Sk + kt * BK);
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
  const int qrow[2] = {qc0 + 16 * warp + g, qc0 + 16 * warp + g + 8};
  int qseg[2] = {0, 0};
  if (seg)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qrow[h] < m.Sq) qseg[h] = m.qseg[(size_t)bh * m.Sq + qrow[h]];

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float mi[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
  float li[2] = {0.f, 0.f};
  const __nv_bfloat16* Qc = Qs + c * 64 * 64;   // this warpgroup's rows
  mbar_wait(qbar, 0);

  // Ping-pong: the two warpgroups take turns at the tensor cores (named
  // barriers 3 and 4).  A turn issues S = Q K^T for this tile, then
  // O += P V for the previous one, as two groups: the softmax of this tile
  // starts when S is in and runs under the P V product and under the other
  // warpgroup's turn.  The issue path has no branch (a branch around wgmma
  // makes the compiler serialise them): the first turn multiplies a zero P
  // by this stage's V.  A stage is released once its V has been used.
  const int my_turn = 3 + c, their_turn = 4 - c;
  if (c == 1) named_bar_arrive(3, 256);       // warpgroup 0 goes first
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = 0u;
  int prev_s = 0;                             // stage of the V that pa meets
  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % STAGES;
    const int k0 = kt * BK;
    // Tile classes: interior (every pair live: no mask test) or cut (test
    // every score; a tile with no live pair gives P = 0).
    const bool interior = !seg && k0 + BK <= m.Sk &&
                          (!m.causal || k0 + BK - 1 <= qc0) &&
                          (m.window < 0 || qlast - k0 < m.window);
    float sc[BK / 2];
    mbar_wait(&full[s], (i / STAGES) & 1);
    named_bar_sync(my_turn, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int b = kk / 4, ko = (kk % 4) * 16;
      wgmma_ss(sc, gmma_desc_kmajor(Qc + b * BQ * 64 + ko),
               gmma_desc_kmajor(Ks(s) + b * BK * 64 + ko), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               gmma_desc_mnmajor(Vs(prev_s) + kk * 16 * 64, BK * 128));
    wgmma_commit();
    named_bar_arrive(their_turn, 256);
    wgmma_wait<1>();                          // S is in; P V may still run
    keep(sc);

    float mx[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
    if (interior) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        sc[e] *= scale_log2;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
    } else {
      const int* ks = Segs(s);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int h = (e >> 1) & 1;
        const int kc = (e >> 2) * 8 + 2 * t + (e & 1);
        const int kp = k0 + kc, qp = qrow[h];
        const bool live = qp < m.Sq && kp < m.Sk && (!m.causal || kp <= qp) &&
                          (m.window < 0 || qp - kp < m.window) &&
                          (!seg || qseg[h] == ks[kc]);
        sc[e] = live ? sc[e] * scale_log2 : FLASH_NEG_INF;
        mx[h] = fmaxf(mx[h], sc[e]);
      }
    }
    // Online softmax in base 2.  A row with no live score so far keeps
    // m = -1e30 and subtracts 0, so its masked scores give exp2(-1e30) = 0.
    float alpha[2], base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(mi[h], quad_max(mx[h]));
      alpha[h] = ex2(mi[h] - mn);
      mi[h] = mn;
      base[h] = mn == FLASH_NEG_INF ? 0.f : mn;
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int h = (e >> 1) & 1;
      sc[e] = ex2(sc[e] - base[h]);
      rs[h] += sc[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) li[h] = li[h] * alpha[h] + quad_sum(rs[h]);
    wgmma_wait();                             // the previous P V is in
    keep(acc);
    keep(pa);
    if (i > 0) mbar_arrive(&empty[prev_s]);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    prev_s = s;
  }
  if (c == 0) named_bar_sync(my_turn, 256);   // warpgroup 1's last turn
  if (kt1 > kt0) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               gmma_desc_mnmajor(Vs(prev_s) + kk * 16 * 64, BK * 128));
    wgmma_commit();
    wgmma_wait();
    keep(acc);
    keep(pa);
    mbar_arrive(&empty[prev_s]);
  }

  // Epilogue: O through this warpgroup's own Q rows, then 16-byte stores.
  float den[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] = fmaxf(li[h], 1e-30f);
    inv[h] = 1.f / den[h];
  }
  unsigned char* Oc = reinterpret_cast<unsigned char*>(Qs) + c * 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h, col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(Oc + (col / 64) * BQ * 128 +
                                   swz_offset(r, col % 64)) =
          pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
    }
  named_bar_sync(1 + c, 128);
  for (int idx = tw; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), ch = idx % (D / 8);
    if (qc0 + r < m.Sq)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * m.Sq + qc0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(Oc + (ch / 8) * BQ * 128 +
                                          swz_offset(r, (ch % 8) * 8));
  }
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qrow[h] < m.Sq)
        lse[(size_t)bh * m.Sq + qrow[h]] =
            mi[h] == FLASH_NEG_INF ? FLASH_NEG_INF
                                   : mi[h] * LN2 + logf(den[h]);
}

// ---------------------------------------------------------------------------
// C entry point
// ---------------------------------------------------------------------------

template <int D>
static cudaError_t launch_fwd_wgmma(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    MaskArgs m, int BH, int BHk, float scale,
                                    cudaStream_t st) {
  using T = FwdTiles<D>;
  CUtensorMap tq, tk, tv, tkseg;
  memset(&tkseg, 0, sizeof(tkseg));
  cudaError_t err = make_map_tiles(&tq, q, D, m.Sq, BH, T::BQ);
  if (err == cudaSuccess) err = make_map_tiles(&tk, k, D, m.Sk, BHk, T::BK);
  if (err == cudaSuccess) err = make_map_tiles(&tv, v, D, m.Sk, BHk, T::BK);
  if (err == cudaSuccess && m.kseg != nullptr)
    err = make_map_flat(&tkseg, m.kseg, CU_TENSOR_MAP_DATA_TYPE_INT32,
                        (long long)BHk * m.Sk, T::BK);
  if (err == cudaSuccess) err = flash_set_smem(flash_fwd_wgmma<D>, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (m.Sq + T::BQ - 1) / T::BQ);
  flash_fwd_wgmma<D><<<grid, WS_THREADS, T::SMEM, st>>>(
      tq, tk, tv, tkseg, static_cast<__nv_bfloat16*>(o), lse, m, BH / BHk,
      scale * LOG2E);
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
  if (flash_route(FLASH_FWD, bf16, D) != FLASH_WGMMA)
    return (long long)fwd_simt_smem(D);
  return (long long)(D == 64 ? FwdTiles<64>::SMEM : FwdTiles<128>::SMEM);
}

// The route (FLASH_SIMT, FLASH_WGMMA) of `kernel` (FLASH_FWD,
// FLASH_DQ, FLASH_DKV) at this dtype and head size.
extern "C" int chainermn_flash_route(int kernel, int bf16, int D) {
  return flash_route(kernel, bf16, D);
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
  if (flash_route(FLASH_FWD, bf16, D) == FLASH_WGMMA)
    err = D == 64 ? launch_fwd_wgmma<64>(q, k, v, o, l, m, BH, BHk, scale, st)
                  : launch_fwd_wgmma<128>(q, k, v, o, l, m, BH, BHk, scale,
                                          st);
  else if (bf16)
    err = launch_fwd_simt<__nv_bfloat16>(q, k, v, o, l, m, BH, G, D, scale, st);
  else
    err = launch_fwd_simt<float>(q, k, v, o, l, m, BH, G, D, scale, st);
  return (int)err;
}
