// B5-bwd for bf16 on Hopper: dQ, dK and dV of causal / sliding-window /
// GQA / logit-capped attention with wgmma fed by TMA.  flash_attn_bwd.cu
// holds the library's entry point, the delta kernel and the f32 SIMT
// kernels, and routes every bf16 call here.
//
// Replaces no TPU kernel.  It is the gradient of the function of
// src/repro/kernels/flash_attn/kernel.py:31 (B5), which the JAX package
// differentiates at src/repro/models/attention.py:113 (attend_ref) with
// XLA's autodiff; the port routes attention through B5, whose
// autograd.Function needs this backward.
//
// Bound on an H100: operations.  The gradient needs 10 * D flops per valid
// (q, k) pair and query head (S = QK^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), far above the bytes of q, k, v, O, dO and the
// three gradients at the training shape (4, 2048, 24 / 8 heads, 128): the
// bf16 tensor-core rate (989 TFLOP/s) bounds it.  This design does 14 * D:
// the dQ kernel recomputes S and dP rather than meet the dK/dV kernel
// through float atomics, so that every output element has one writer and
// two launches give the same bits (the training path's bitwise restart
// rests on it).  What the design does about the rest:
//
//  * No statistics pass.  P = exp(y - lse) takes the log-sum-exp that B5's
//    forward wrote (flash_attn_sm90.cu, a non-null lse); delta = sum_d
//    dO * O comes from a small bytes-bound kernel (flash_attn_bwd.cu)
//    launched first, which also lays out, per 64-row query tile, the
//    tile's lse in log2 units and its delta in one 512-byte row of its
//    scratch (0 past Sq), so that one TMA copy stages both.  Both enter as
//    the start values of the products: S starts at -lse sqrt(D) (without
//    a cap), so P = 2^(S log2 e / sqrt(D)) is one FMUL and one ex2.approx
//    a pair, and dP starts at -delta, so the accumulator holds dP - delta;
//    no statistic stays live in registers across a product.
//  * Two kernels of three warpgroups each, in the forward's idiom: a
//    producer warpgroup (setmaxnreg 24) whose one thread issues the tiles'
//    copies with TMA over 4-D tensor maps of the model layout (B, S, H, D),
//    read in place (in dK/dV a thread of its second warp issues the
//    statistics' copies, on a 2-D map of the scratch); mbarrier rings of
//    two stages; two consumer warpgroups (setmaxnreg 240) on wgmma with f32
//    accumulators.
//  * dK/dV: one block per (128-key tile, KV head, batch row), the grid's
//    slowest dimension the key tile, so the causal tiles with the most
//    query tiles start first.  K and V are loaded once; Q and dO tiles of
//    64 rows stream through the ring over the group's query heads in order
//    and over the query tiles that can see the key tile.  Each consumer
//    holds 64 keys: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//    operands K-major in shared memory, the start values read from the
//    staged statistics), then in registers P^T = exp(y - lse) and dS^T =
//    P^T (dP^T - delta), times the cap's derivative 1 - tanh^2 where there
//    is a cap; dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16
//    register A operands and dO, Q as B operands read MN-major through the
//    transpose bit (as the forward reads V).  dK / sqrt(D) and dV are
//    written once.
//  * dQ: one block per (128-query tile, query head, batch row), the query
//    tiles in reverse.  Q, dO and the rows' lse and delta stay put; K and V
//    tiles of 64 rows stream through the ring over the key tiles the tile
//    can see.  S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K (K
//    MN-major); dQ / sqrt(D) is written once.  The steps of a tile run in
//    order: a software pipeline that computed tile i's dS under tile
//    i - 1's dQ product (three stages) ran slower on the card; the two
//    consumers already overlap each other's products and element work.
//  * Registers: a dK/dV consumer holds dK and dV (2 x 64 f32 at D = 128),
//    S^T and dP^T (2 x 32) and the packed P^T and dS^T (2 x 16); S^T and
//    dP^T are rewritten with their start values before their products, so
//    they are dead while the packed operands live, and P^T and dS^T are
//    packed two elements at a time.  ptxas reports no spill or stack for
//    any of the six kernels (chip_smoke.py phase 1 checks it).  Staging
//    the statistics with loads from a producer warp spilled at its 24
//    registers, and reading them from global memory in the consumers was
//    slower: hence the tiled scratch and its copy.
//  * At the training shape the two kernels take ~0.57 (dK/dV, 8 * D flops a
//    pair) and ~0.54 ms (dQ, 6 * D), the whole call ~1.2 ms, ~215 TFLOP/s
//    at the bound's 10 * D (chip_smoke.py's [B5b] on an H100 80GB HBM3 at
//    700 W; PERF.md).
//  * Tiles that no pair can use are skipped (above the causal diagonal,
//    left of every row's window); the element mask (q < Sq, k < Sk, q >= k
//    if causal, q - k < window) runs only on tiles that cross a bound, and
//    a masked element is set to 0 by a select, so nothing from a padded row
//    or column (zeros from TMA's fill) reaches a stored value.  D = 80 is
//    padded to 128 by the fill, as in the forward; only 80 columns are
//    stored.
//  * Every sum has one fixed order (the wgmma k-steps, the query heads and
//    tiles in order), no atomics.
//
// Instantiated for D in {64, 80, 128}.
#include "flash_sm90.cuh"

#include <cmath>

namespace {

constexpr int NT = 384;        // producer + two consumer warpgroups
constexpr int STAGES = 2;      // ring stages
constexpr int BIG = 128;       // rows a block holds: dK/dV keys, dQ queries
constexpr int SMALL = 64;      // rows a ring stage streams
constexpr uint32_t BIG_BOX = box_bytes(BIG);
constexpr uint32_t SMALL_BOX = box_bytes(SMALL);
constexpr uint32_t STAT_BYTES = 2 * SMALL * 4;  // a query tile's statistics

struct Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* stats;  // (B, H, ceil(Sq / 64)): 64 lse2, then 64 delta
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int H, KV, Sq, Sk, causal, window;
  float cap;          // <= 0: none
  float inv_sqrt_d;   // 1 / sqrt(D), D unpadded
};

// Both kernels: two 128-row tiles, STAGES pairs of 64-row tiles and (dK/dV)
// their statistics, 1 + 2 * STAGES mbarriers, slack to align the tiles to
// 1024 bytes.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int nb = padded<D>() / BOX_COLS;
  return 2 * nb * (int)BIG_BOX +
         STAGES * (2 * nb * (int)SMALL_BOX + (int)STAT_BYTES) +
         (1 + 2 * STAGES) * 8 + 1024;
}

// A float from shared memory at a 32-bit shared address (a generic pointer
// would hold two registers).
__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

// One box of a 2-D map at (column, row) into shared memory, completing on
// ``bar``.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// P and dS of one pair.  The products start from init() instead of 0, so
// that without a cap S arrives as x - lse sqrt(D) (x the dot product) and
// P = 2^(S log2 e / sqrt(D)); with a cap S arrives as x and P = 2^(cap
// log2 e tanh(x / (sqrt(D) cap)) - lse2), lse2 the row's lse in log2
// units.  dP arrives as dO.V - delta, and dS = P dP (1 - tanh^2).
struct Softmax {
  float scale2;     // log2 e / sqrt(D)
  float sqrt_d_ln2; // sqrt(D) ln 2
  float cap_in;     // 1 / (sqrt(D) cap)
  float cap_out;    // cap log2 e
  bool capped;

  // S's start value from lse2: -lse sqrt(D), or 0 with a cap
  __device__ __forceinline__ float init(float lse2) const {
    return capped ? 0.0f : -lse2 * sqrt_d_ln2;
  }
  __device__ __forceinline__ float p_ds(float s, float dpd, float lse2,
                                        float& ds) const {
    if (capped) {
      const float t = tanhf(s * cap_in);
      const float pr = exp2_ftz(fmaf(cap_out, t, -lse2));
      ds = pr * dpd * fmaf(-t, t, 1.0f);
      return pr;
    }
    const float pr = exp2_ftz(s * scale2);
    ds = pr * dpd;
    return pr;
  }
};

__device__ __forceinline__ bool valid_pair(const Params& p, int qp, int kp) {
  return qp < p.Sq && kp < p.Sk && (!p.causal || qp >= kp) &&
         (p.window <= 0 || qp - kp < p.window);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// D fragment -> bf16 A fragments: the D fragment of columns 16kk .. 16kk +
// 15 is the A fragment of k-step kk.
__device__ __forceinline__ void pack_a(uint32_t (&a)[16],
                                       const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// acc (64 rows x DP) += A (64 x 64, register fragments) * B (64 x DP): B is
// a 64-row tile in shared memory read MN-major, 16 rows a k-step.
template <int DP>
__device__ __forceinline__ void mma_rs(float (&acc)[DP / 2],
                                       const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < SMALL / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    const uint64_t db = sw128_desc(b + kk * 2048, SMALL_BOX, 1024);
    if constexpr (DP == 128) wgmma_rs_n128(acc, ak, db);
    else wgmma_rs_n64(acc, ak, db);
  }
}

// d (64 x 64) += A (64 rows of a tile of ``a_box`` bytes a box) * B^T (B a
// 64-row tile of SMALL_BOX bytes a box), both K-major over DP columns.
template <int DP>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a,
                                       uint32_t a_box, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t in_box = (kk & 3) * 32;
    wgmma_ss_n64(d, sw128_desc(a + (kk >> 2) * a_box + in_box, 0, 1024),
                 sw128_desc(b + (kk >> 2) * SMALL_BOX + in_box, 0, 1024), 1);
  }
}

// Store a consumer's 64 x D accumulator rows (rows[0], rows[1] per the
// wgmma D fragment) times ``scale`` as bf16; rows at or past ``lim`` and
// columns past D are not stored.
template <int D, int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[DP / 2],
                                           const int (&rows)[2], int lim,
                                           int c2, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= lim) continue;
    __nv_bfloat16* row = base + rows[r] * rs;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// The items a dK/dV block walks: the query tiles [begin, end) that can see
// some key of the 128-key tile at k0, for each query head of the group in
// order (n items in all).
struct Items {
  int begin, end, n;
  __device__ __forceinline__ Items(const Params& p, int k0) {
    begin = p.causal ? k0 / SMALL : 0;
    end = (p.Sq + SMALL - 1) / SMALL;
    if (p.window > 0)
      end = min(end, (min(k0 + BIG, p.Sk) - 1 + p.window - 1) / SMALL + 1);
    n = max(0, end - begin) * (p.H / p.KV);
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tst,
                     const Params p) {
  constexpr int DP = padded<D>();
  constexpr int NB = DP / BOX_COLS;
  constexpr uint32_t KTILE = NB * BIG_BOX;    // 128 keys
  constexpr uint32_t QTILE = NB * SMALL_BOX;  // 64 queries
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base;                        // K, 128 rows
  const uint32_t s_v = s_k + KTILE;                 // V, 128 rows
  const uint32_t s_q = s_v + KTILE;                 // Q stages
  const uint32_t s_do = s_q + STAGES * QTILE;       // dO stages
  const uint32_t s_st = s_do + STAGES * QTILE;      // lse2, delta stages
  const uint32_t bar_kv = s_st + STAGES * STAT_BYTES;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 2);          // tiles, statistics
      mbar_init(bar_empty + 8 * s, 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each branch derives what it walks after its setmaxnreg, so that no
  // value crosses into the producer's 24 registers from above (ptxas
  // spilled such a value).
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BIG;
  if (threadIdx.x < 128) {
    // ---- producer: one thread issues the tiles' copies, one of the second
    // warp the statistics'
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const Items it(p, k0);
    const int rep = p.H / p.KV;
    if (threadIdx.x == 0 && it.n > 0) {
      mbar_expect_tx(bar_kv, 2 * KTILE);
      for (int j = 0; j < NB; ++j) {
        tma_load(s_k + j * BIG_BOX, &tk, bar_kv, j * BOX_COLS, k0, kvh, b);
        tma_load(s_v + j * BIG_BOX, &tv, bar_kv, j * BOX_COLS, k0, kvh, b);
      }
      int i = 0;
      for (int h = kvh * rep; h < (kvh + 1) * rep; ++h)
        for (int qt = it.begin; qt < it.end; ++qt, ++i) {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(bar_empty + 8 * s, (i / STAGES - 1) & 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * QTILE);
          for (int j = 0; j < NB; ++j) {
            tma_load(s_q + s * QTILE + j * SMALL_BOX, &tq, bar_full + 8 * s,
                     j * BOX_COLS, qt * SMALL, h, b);
            tma_load(s_do + s * QTILE + j * SMALL_BOX, &tdo, bar_full + 8 * s,
                     j * BOX_COLS, qt * SMALL, h, b);
          }
        }
    } else if (threadIdx.x == 32 && it.n > 0) {
      // the items' statistics: row (b H + h) nqt + query tile of the scratch
      const int nqt = (p.Sq + SMALL - 1) / SMALL;
      int i = 0;
      for (int h = kvh * rep; h < (kvh + 1) * rep; ++h)
        for (int qt = it.begin; qt < it.end; ++qt, ++i) {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(bar_empty + 8 * s, (i / STAGES - 1) & 1);
          mbar_expect_tx(bar_full + 8 * s, STAT_BYTES);
          tma_load_2d(s_st + s * STAT_BYTES, &tst, bar_full + 8 * s, 0,
                      (b * p.H + h) * nqt + qt);
        }
    }
  } else {
    // ---- consumers: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const Items it(p, k0);
    const int cw = (threadIdx.x >> 7) - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int kw0 = k0 + 64 * cw;                        // first key
    const int krow = kw0 + 16 * (t >> 5) + (lane >> 2);  // and krow + 8
    const int c2 = 2 * (lane & 3);
    const uint32_t a_k = s_k + cw * 64 * 128;   // this consumer's K rows
    const uint32_t a_v = s_v + cw * 64 * 128;
    const bool capped = p.cap > 0.0f;
    const Softmax sm{p.inv_sqrt_d * LOG2E, LN2 / p.inv_sqrt_d,
                     capped ? p.inv_sqrt_d / p.cap : 0.0f, p.cap * LOG2E,
                     capped};

    float dk[DP / 2], dv[DP / 2];
    float st[32], dpt[32];   // S^T, dP^T
    uint32_t pa[16], dsa[16];
    zero(dk);
    zero(dv);
    if (it.n > 0) mbar_wait(bar_kv, 0);
    int s = 0, q0 = it.begin * SMALL;   // item i's stage and query tile
    uint32_t phase = 0;
    for (int i = 0; i < it.n; ++i) {
      const uint32_t q_s = s_q + s * QTILE, do_s = s_do + s * QTILE;
      const uint32_t stg = s_st + s * STAT_BYTES + 4 * c2;  // lse2, delta
      mbar_wait(bar_full + 8 * s, phase);
      // the sums start from init(lse2) and -delta of each column's query
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t at = stg + 4 * (8 * j + e);
          st[4 * j + e] = st[4 * j + 2 + e] = sm.init(lds(at));
          dpt[4 * j + e] = dpt[4 * j + 2 + e] = -lds(at + 4 * SMALL);
        }
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      mma_ss<DP>(st, a_k, BIG_BOX, q_s);
      mma_ss<DP>(dpt, a_v, BIG_BOX, do_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T on the accumulators: row = key, column = query; the
      // element mask only where the tile crosses a bound
      const bool masked = kw0 + 64 > p.Sk || q0 + SMALL > p.Sq ||
                          (p.causal && q0 < kw0 + 63) ||
                          (p.window > 0 && q0 + SMALL - 1 - kw0 >= p.window);
      // two elements at a time, packed at once into the bf16 operands, so
      // that S^T and dP^T die as P^T and dS^T grow
#pragma unroll
      for (int i2 = 0; i2 < 16; ++i2) {
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * i2 + e;                 // element 4 j + e'
          const int col = 8 * (x >> 2) + e;         // past c2
          pr[e] = sm.p_ds(st[x], dpt[x], sm.capped ? lds(stg + 4 * col) : 0.0f,
                          ds[e]);
          if (masked &&
              !valid_pair(p, q0 + c2 + col, krow + 8 * ((x >> 1) & 1))) {
            pr[e] = 0.0f;
            ds[e] = 0.0f;
          }
        }
        pa[i2] = pack_bf16(pr[0], pr[1]);
        dsa[i2] = pack_bf16(ds[0], ds[1]);
      }

      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
      mma_rs<DP>(dv, pa, do_s);
      mma_rs<DP>(dk, dsa, q_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(bar_empty + 8 * s);
      q0 += SMALL;
      if (q0 == it.end * SMALL) q0 = it.begin * SMALL;   // next query head
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }

    const int kr[2] = {krow, krow + 8};   // the thread's keys
    store_rows<D, DP>(p.dk + b * p.dk_sb + kvh * p.dk_sh, p.dk_ss, dk, kr,
                      p.Sk, c2, p.inv_sqrt_d);
    store_rows<D, DP>(p.dv + b * p.dv_sb + kvh * p.dv_sh, p.dv_ss, dv, kr,
                      p.Sk, c2, 1.0f);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const Params p) {
  constexpr int DP = padded<D>();
  constexpr int NB = DP / BOX_COLS;
  constexpr uint32_t QTILE = NB * BIG_BOX;     // 128 queries
  constexpr uint32_t KTILE = NB * SMALL_BOX;   // 64 keys
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;                   // Q, 128 rows
  const uint32_t s_do = s_q + QTILE;           // dO, 128 rows
  const uint32_t s_k = s_do + QTILE;           // K stages
  const uint32_t s_v = s_k + STAGES * KTILE;   // V stages
  const uint32_t bar_q = s_v + STAGES * KTILE;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BIG;  // heaviest tiles first
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  // the key tiles some query row of this tile sees
  int kt_end = (p.Sk + SMALL - 1) / SMALL;
  if (p.causal) kt_end = min(kt_end, (min(q0 + BIG, p.Sq) - 1) / SMALL + 1);
  int kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0)
    kt_begin = (q0 - p.window + 1) / SMALL;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * QTILE);
      for (int j = 0; j < NB; ++j) {
        tma_load(s_q + j * BIG_BOX, &tq, bar_q, j * BOX_COLS, q0, h, b);
        tma_load(s_do + j * BIG_BOX, &tdo, bar_q, j * BOX_COLS, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (kt_begin + i) * SMALL;
        if (i >= STAGES) mbar_wait(bar_empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * KTILE);
        for (int j = 0; j < NB; ++j) {
          tma_load(s_k + s * KTILE + j * SMALL_BOX, &tk, bar_full + 8 * s,
                   j * BOX_COLS, k0, kvh, b);
          tma_load(s_v + s * KTILE + j * SMALL_BOX, &tv, bar_full + 8 * s,
                   j * BOX_COLS, k0, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = (threadIdx.x >> 7) - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int q_first = q0 + 64 * cw;
    const int qrow = q_first + 16 * (t >> 5) + (lane >> 2);
    const int qr[2] = {qrow, qrow + 8};        // the thread's two rows
    const int c2 = 2 * (lane & 3);
    const uint32_t a_q = s_q + cw * 64 * 128;  // this consumer's Q rows
    const uint32_t a_do = s_do + cw * 64 * 128;
    const bool capped = p.cap > 0.0f;
    const Softmax sm{p.inv_sqrt_d * LOG2E, LN2 / p.inv_sqrt_d,
                     capped ? p.inv_sqrt_d / p.cap : 0.0f, p.cap * LOG2E,
                     capped};
    // each row's lse2, and where the sums start: init(lse2) and -delta
    // (0 past Sq: those rows are not stored)
    const float* st = p.stats + ((long long)b * p.H + h) *
                                    ((p.Sq + SMALL - 1) / SMALL) * 2 * SMALL;
    float lse2[2], x0[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = qr[r] / SMALL * 2 * SMALL + qr[r] % SMALL;
      lse2[r] = qr[r] < p.Sq ? st[at] : 0.0f;
      x0[r] = sm.init(lse2[r]);
      dl[r] = qr[r] < p.Sq ? -st[at + SMALL] : 0.0f;
    }

    float dq[DP / 2];
    float sc[32], dp[32];   // S; dP, then dS
    uint32_t dsa[16];
    zero(dq);
    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt_begin + i) * SMALL;
      const uint32_t k_s = s_k + s * KTILE, v_s = s_v + s * KTILE;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sc[e] = x0[(e >> 1) & 1];
        dp[e] = dl[(e >> 1) & 1];
      }
      mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_ss<DP>(sc, a_q, BIG_BOX, k_s);
      mma_ss<DP>(dp, a_do, BIG_BOX, v_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS on the accumulators: row = query, column = key
      const bool masked = k0 + SMALL > p.Sk ||
                          (p.causal && k0 + SMALL - 1 > q_first) ||
                          (p.window > 0 && q_first + 63 - k0 >= p.window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds;
          sm.p_ds(sc[4 * j + e], dp[4 * j + e], lse2[e >> 1], ds);
          if (masked && !valid_pair(p, qr[e >> 1], k0 + 8 * j + c2 + (e & 1)))
            ds = 0.0f;
          dp[4 * j + e] = ds;
        }
      pack_a(dsa, dp);

      fence_regs(dq);
      fence_regs(dsa);
      wgmma_fence();
      mma_rs<DP>(dq, dsa, k_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      mbar_arrive(bar_empty + 8 * s);
    }

    store_rows<D, DP>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, dq, qr,
                      p.Sq, c2, p.inv_sqrt_d);
  }
}

// A 2-D f32 map over the statistics scratch: ``tiles`` rows of 128 floats,
// one box a row, no swizzle.
bool make_stats_map(CUtensorMap* map, const float* ptr, long long tiles) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {2 * SMALL, (cuuint64_t)tiles};
  const cuuint64_t strides[1] = {STAT_BYTES};
  const cuuint32_t box[2] = {2 * SMALL, 1};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const CUtensorMap (&kv_maps)[5], const CUtensorMap (&q_maps)[4],
           const Params& p, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dq_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  bwd_dkdv_sm90_kernel<D><<<dim3(p.KV, B, (p.Sk + BIG - 1) / BIG), NT,
                            smem_bytes<D>(), stream>>>(
      kv_maps[0], kv_maps[1], kv_maps[2], kv_maps[3], kv_maps[4], p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_sm90_kernel<D><<<dim3(p.H, (p.Sq + BIG - 1) / BIG, B), NT,
                          smem_bytes<D>(), stream>>>(
      q_maps[0], q_maps[1], q_maps[2], q_maps[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

// delta = sum_d dO * O per row, in flash_attn_bwd.cu (both types).
int flash_attn_bwd_delta(int dtype, int d, const void* o, const void* dO,
                         const float* lse, float* out, long long o_sb,
                         long long o_ss, long long o_sh, long long do_sb,
                         long long do_ss, long long do_sh, int B, int H,
                         int Sq, cudaStream_t stream);

// The bf16 instantiation of flash_attn_bwd (flash_attn_bwd.cu), same
// arguments without the dtype: the delta kernel (its tiled layout: each
// 64-row query tile's lse2 and delta in one 512-byte row of the scratch),
// then dK/dV, then dQ.  q, k, v, o and dO need a 16-byte-aligned base and
// strides on S, head and batch that are positive multiples of 8 elements
// (-1 otherwise, before any launch).
int flash_attn_bwd_sm90(
    int d, const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, const float* lse,
    float* delta, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int B, int H, int KV, int Sq, int Sk, int causal,
    int window, float cap, cudaStream_t stream) {
  if (!tma_ok(q, q_ss, q_sh, q_sb) || !tma_ok(k, k_ss, k_sh, k_sb) ||
      !tma_ok(v, v_ss, v_sh, v_sb) || !tma_ok(o, o_ss, o_sh, o_sb) ||
      !tma_ok(dO, do_ss, do_sh, do_sb))
    return -1;
  if ((Sq + BIG - 1) / BIG > 65535 || (Sk + BIG - 1) / BIG > 65535)
    return (int)cudaErrorInvalidValue;
  if (!bind_device()) return (int)cudaErrorInvalidDevice;
  // dK/dV streams 64-row Q and dO tiles past 128-row K and V; dQ the
  // other way round
  CUtensorMap kv_maps[5], q_maps[4];
  for (int big = 0; big < 2; ++big) {
    const int qr = big ? SMALL : BIG, kr = big ? BIG : SMALL;
    CUtensorMap* m = big ? kv_maps : q_maps;
    if (!make_map(&m[0], q, d, Sq, H, B, q_ss, q_sh, q_sb, qr) ||
        !make_map(&m[1], k, d, Sk, KV, B, k_ss, k_sh, k_sb, kr) ||
        !make_map(&m[2], v, d, Sk, KV, B, v_ss, v_sh, v_sb, kr) ||
        !make_map(&m[3], dO, d, Sq, H, B, do_ss, do_sh, do_sb, qr))
      return (int)cudaErrorInvalidValue;
  }
  // the statistics in delta's scratch, one 512-byte row per query tile
  const long long tiles = (long long)B * H * ((Sq + SMALL - 1) / SMALL);
  if (tiles > 0x7fffffffLL || !make_stats_map(&kv_maps[4], delta, tiles))
    return (int)cudaErrorInvalidValue;
  const int rc = flash_attn_bwd_delta(1, d, o, dO, lse, delta, o_sb, o_ss,
                                      o_sh, do_sb, do_ss, do_sh, B, H, Sq,
                                      stream);
  if (rc != 0) return rc;
  const Params p{static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 delta, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb,
                 dv_ss, dv_sh, H, KV, Sq, Sk, causal, window, cap,
                 1.0f / sqrtf((float)d)};
  switch (d) {
    case 64: return launch<64>(kv_maps, q_maps, p, B, stream);
    case 80: return launch<80>(kv_maps, q_maps, p, B, stream);
    case 128: return launch<128>(kv_maps, q_maps, p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
