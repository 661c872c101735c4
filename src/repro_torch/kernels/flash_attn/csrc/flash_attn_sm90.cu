// B5 for bf16 on Hopper: forward flash attention with wgmma fed by TMA —
// online softmax over KV tiles, GQA, causal / sliding-window tile skipping,
// tanh logit cap, a kv_len bound on the valid keys, fully masked rows
// written as 0.  flash_attn.cu's SIMT kernel stays B5's f32 instantiation
// and routes every bf16 call here.
//
// Replaces src/repro/kernels/flash_attn/kernel.py::_flash_kernel.
//
// Bound on an H100: operations.  At the llama3.2-3b prefill shape (24 query
// heads, 8 KV heads, D = 128, causal) the work is 4 * D flops per valid
// (q, k) pair against 2 * (2 * S * H + 2 * S * KV) * D bytes of q, k, v and
// o: from S ~ 300 on, the bf16 tensor-core rate (989 TFLOP/s) bounds it.
// The design puts both products on the tensor cores and keeps the copies off
// the threads that issue them:
//
//  * One block of three warpgroups per (128-row query tile, query head,
//    batch row); the grid walks heads fastest and the query tiles in
//    reverse, so the causal tiles with the most KV tiles start first.
//  * Producer warpgroup: it gives registers back (setmaxnreg 24) and one
//    thread issues every copy with TMA (cp.async.bulk.tensor): the Q tile
//    once, then K and V tiles of 128 rows through a 2-stage ring in shared
//    memory.  Each copy completes on an mbarrier with its byte count; the
//    consumers release K and V of a stage through separate "empty"
//    mbarriers, K as soon as S is computed, so the next K loads early.
//  * Two consumer warpgroups (setmaxnreg 240), 64 query rows each.  Per KV
//    tile: S = Q K^T with wgmma m64n128k16 (bf16 in, f32 accumulate, both
//    operands in shared memory through 128B-swizzled descriptors); logit
//    cap and masks on the accumulator registers; the online softmax in
//    registers (a row lives on a quad of lanes: max and sum are two
//    __shfl_xor_sync steps; one FFMA scales each logit to log2 units and
//    subtracts the row max, one ex2.approx exponentiates it); P rounded to
//    bf16 in registers and O += P V with wgmma (A = P from registers, B =
//    V from shared memory, MN-major through the transpose bit).  O stays
//    in f32 registers, is divided by l at the end and is written as bf16.
//    l sums the f32 probabilities; only the PV product sees them rounded
//    to bf16, as the model-level references do.
//  * The softmax, not the tensor cores, set the pace of a first version
//    that ran the three steps in order (~265 TFLOP/s at the llama shape,
//    S = 2048, on an H100 80GB HBM3 at 700 W).  So each consumer runs a
//    software pipeline: it issues S_i = Q K_i^T and O += P_{i-1} V_{i-1}
//    back to back, waits for S_i alone, and computes tile i's softmax
//    while the PV product of tile i - 1 is still on the tensor cores.  S,
//    P (bf16) and O are all live across the products, 160 registers a
//    thread.  Tile 0 is peeled off the loop and the mbarrier wait's loop
//    lives inside its asm: with a branch or a C++ loop between the two
//    products, ptxas serialised the wgmma groups (C7513) and spilled.
//  * Tensor maps: 4-D over (D, S, head, batch) with the caller's strides,
//    so the model layout (B, S, H, D) is read in place.  A 128B-swizzle box
//    is 64 bf16 wide, so a tile of D = 128 is two boxes; D = 80 is padded
//    to 128 in shared memory by TMA's zero fill (1.6x the work at that
//    width: padded Q.K columns add 0, padded V columns are never stored);
//    D = 64 is one box.  Rows past Sq / Sk arrive as zeros.  TMA needs a
//    16-byte-aligned base and strides that are multiples of 16 bytes:
//    kernel.py checks both and raises otherwise.  The model's callers
//    (models/attention.py: the RoPE'd q and the k / v projections) pass
//    contiguous (B, S, H, D) tensors, which satisfy them at D = 64, 80, 128.
//  * KV tiles that no (q, k) pair of the block can use — past kv_len, above
//    the causal diagonal, left of every row's window — are skipped; a tile
//    that crosses a bound applies the element mask k < kv_len, q >= k
//    (causal), q - k < window.  A masked element contributes p = 0, so a
//    row with no valid key keeps l = 0 and is written as 0.
//  * Asked for a log-sum-exp (a non-null lse: the training forward, whose
//    backward flash_attn_bwd_sm90.cu reads it in place of a statistics
//    pass), the epilogue also writes each row's ln sum_k e^y from the m and
//    l it holds, converted once from log2 units; 0 for a row with no valid
//    key.  A null lse stores nothing more, and O's bits are the same either
//    way.
//
// Instantiated for D in {64, 80, 128}.
#include "flash_sm90.cuh"

#include <cmath>

namespace {

constexpr int BQ = 128;          // query rows per block (two consumers)
constexpr int BK = 128;          // key rows per ring stage
constexpr int NT = 384;          // producer + two consumer warpgroups
constexpr uint32_t BOX_BYTES = box_bytes(128);  // one box of a 128-row tile
constexpr float NEG_INF = -1e30f;

struct Params {
  __nv_bfloat16* o;
  float* lse;         // (B, H, Sq) natural-log row statistics, or null
  long long o_sb, o_ss, o_sh;
  int H, KV, Sq, kv_lim, causal, window;
  float cap;          // <= 0: none
  float inv_sqrt_d;   // 1 / sqrt(D), D unpadded
};

// Q, K[2], V[2] tiles, 9 mbarriers, and slack to align the tiles to 1024
// bytes (the 128B swizzle repeats every 8 rows of 128 bytes).
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 5 * (padded<D>() / BOX_COLS) * (int)BOX_BYTES + 9 * 8 + 1024;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int DP = padded<D>();            // head dim in shared memory
  constexpr int NB = DP / BOX_COLS;          // boxes per tile
  constexpr uint32_t TILE = NB * BOX_BYTES;  // bytes of one 128-row tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;               // Q tile
  const uint32_t s_k = base + TILE;        // K stages 0, 1
  const uint32_t s_v = base + 3 * TILE;    // V stages 0, 1
  const uint32_t bar_q = base + 5 * TILE;  // Q full
  const uint32_t bar_k = bar_q + 8;        // K full, stages 0, 1
  const uint32_t bar_v = bar_q + 24;       // V full, stages 0, 1
  const uint32_t bar_ke = bar_q + 40;      // K empty, stages 0, 1
  const uint32_t bar_ve = bar_q + 56;      // V empty, stages 0, 1

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int kvh = h / (p.H / p.KV);

  // the KV tiles some (q, k) pair of this block can use
  int kt_end = (p.kv_lim + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, (min(q0 + BQ, p.Sq) - 1) / BK + 1);
  int kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0)
    kt_begin = (q0 - p.window + 1) / BK;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 2 * 128);  // every consumer thread arrives
      mbar_init(bar_ve + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, TILE);
      for (int j = 0; j < NB; ++j)
        tma_load(s_q + j * BOX_BYTES, &tq, bar_q, j * BOX_COLS, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1;
        const int k0 = (kt_begin + i) * BK;
        // stage s was last used by tile i - 2: wait for its K, then its V,
        // to be released (the consumers are done with K first)
        const uint32_t used = ((i >> 1) - 1) & 1;
        if (i >= 2) mbar_wait(bar_ke + 8 * s, used);
        mbar_expect_tx(bar_k + 8 * s, TILE);
        for (int j = 0; j < NB; ++j)
          tma_load(s_k + s * TILE + j * BOX_BYTES, &tk, bar_k + 8 * s,
                   j * BOX_COLS, k0, kvh, b);
        if (i >= 2) mbar_wait(bar_ve + 8 * s, used);
        mbar_expect_tx(bar_v + 8 * s, TILE);
        for (int j = 0; j < NB; ++j)
          tma_load(s_v + s * TILE + j * BOX_BYTES, &tv, bar_v + 8 * s,
                   j * BOX_COLS, k0, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = (threadIdx.x >> 7) - 1;   // consumer 0 or 1
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int row0 = 64 * cw + 16 * (t >> 5) + (lane >> 2);  // tile row
    const int qr[2] = {q0 + row0, q0 + row0 + 8};  // the thread's two rows
    const int c2 = 2 * (lane & 3);  // its first column in each 8-column group
    const int q_first = q0 + 64 * cw;
    const uint32_t q_base = s_q + cw * 64 * 128;  // this consumer's Q rows
    const bool capped = p.cap > 0.0f;
    // logits stay raw (uncapped) or become capped log2 units; the softmax
    // takes them to log2 units in the FFMA that feeds each exponential
    const float fold = capped ? 1.0f : p.inv_sqrt_d * LOG2E;
    const float cap_in = capped ? p.inv_sqrt_d / p.cap : 0.0f;
    const float cap_out = p.cap * LOG2E;

    float sc[64];        // S, then P: (row, key) per the wgmma D fragment
    uint32_t pa[32];     // the previous tile's P, bf16 A fragments
    float acc[DP / 2];   // O
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

    // O += P V for the tile in stage s: BK / 16 k-steps of 16 V rows (2048
    // bytes) each.  V is MN-major: LBO steps between its 64-column boxes,
    // SBO between groups of 8 rows.
    auto issue_pv = [&](int s) {
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        const uint64_t dv =
            sw128_desc(s_v + s * TILE + kk * 2048, BOX_BYTES, 1024);
        if constexpr (DP == 128) wgmma_rs_n128(acc, a, dv);
        else wgmma_rs_n64(acc, a, dv);
      }
      wgmma_commit();
    };

    // S = Q K^T for the tile in stage s, issued and committed, not waited
    // for: DP / 16 k-steps, 32 bytes apart inside a box
    auto issue_qk = [&](int s) {
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_base + off, 0, 1024),
                      sw128_desc(s_k + s * TILE + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
    };

    // Tile i's softmax on S (in sc), which becomes P (f32); corr is the
    // factor that rescales O and l.  Masked logits are -inf and give p =
    // 0; m starts finite, so a row with no valid key yet keeps corr = 1 and
    // l = 0.
    auto softmax = [&](int i, float (&corr)[2]) {
      const int k0 = (kt_begin + i) * BK;
      // cap and masks; the mask only where the tile crosses a bound for
      // some row of this consumer
      const bool masked = k0 + BK > p.kv_lim ||
                          (p.causal && k0 + BK - 1 > q_first) ||
                          (p.window > 0 && q_first + 63 - k0 >= p.window);
      if (capped || masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e];
            if (capped) x = cap_out * tanhf(x * cap_in);
            if (masked) {
              const int kp = k0 + 8 * j + c2 + (e & 1);
              const int qp = qr[e >> 1];
              const bool ok = kp < p.kv_lim && (!p.causal || qp >= kp) &&
                              (p.window <= 0 || qp - kp < p.window);
              x = ok ? x : -INFINITY;
            }
            sc[4 * j + e] = x;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2_ftz((m[r] - m_new) * fold);
        m[r] = m_new;
      }
      const float shift[2] = {-m[0] * fold, -m[1] * fold};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = exp2_ftz(fmaf(sc[4 * j + e], fold, shift[e >> 1]));
          sc[4 * j + e] = pr;
          sum[e >> 1] += pr;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
    };

    // P as the A fragments of the PV k-steps (16 keys each): the D fragment
    // of keys 16kk .. 16kk + 15 is the A fragment, in bf16
    auto pack_p = [&]() {
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2)
        pa[i2] = pack_bf16(sc[2 * i2], sc[2 * i2 + 1]);
    };

    // Software pipeline: iteration i issues S_i = Q K_i^T and then O +=
    // P_{i-1} V_{i-1}, waits for S_i only, and runs tile i's softmax while
    // the PV product is still on the tensor cores; then it waits for that,
    // rescales O and packs P_i for the next iteration.  Tile 0's product
    // and softmax come before the loop, the last PV product after it.
    if (n_tiles > 0) {
      float corr[2];
      mbar_wait(bar_q, 0);
      mbar_wait(bar_k, 0);
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(bar_ke);
      softmax(0, corr);   // O is still 0: nothing to rescale
      pack_p();
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i & 1, sp = s ^ 1;  // stages of tiles i and i - 1
        mbar_wait(bar_k + 8 * s, (i >> 1) & 1);
        issue_qk(s);
        mbar_wait(bar_v + 8 * sp, ((i - 1) >> 1) & 1);
        issue_pv(sp);
        wgmma_wait<1>();   // S_i is done; P_{i-1} V_{i-1} may still run
        fence_regs(sc);
        mbar_arrive(bar_ke + 8 * s);
        softmax(i, corr);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(bar_ve + 8 * sp);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
        pack_p();
      }
      const int s = (n_tiles - 1) & 1;
      mbar_wait(bar_v + 8 * s, ((n_tiles - 1) >> 1) & 1);
      issue_pv(s);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(bar_ve + 8 * s);
    }

    // O / l as bf16; rows past Sq and columns past D are not stored, and a
    // row with no valid key (l = 0) is written as 0.  Where asked, the row's
    // natural log-sum-exp too, ln sum_k e^y = (m fold + log2 l) ln 2 (0 for
    // a row with no valid key), from one lane of the row's quad
    const long long ob = b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qr[r] >= p.Sq) continue;
      if (p.lse != nullptr && (lane & 3) == 0)
        p.lse[((long long)b * p.H + h) * p.Sq + qr[r]] =
            l[r] == 0.0f ? 0.0f : (m[r] * fold + log2f(l[r])) * LN2;
      const float inv = l[r] == 0.0f ? 0.0f : 1.0f / l[r];
      __nv_bfloat16* orow = p.o + ob + qr[r] * p.o_ss;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + c2;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(p.H, (p.Sq + BQ - 1) / BQ, B);
  flash_fwd_sm90_kernel<D><<<grid, NT, smem_bytes<D>(), stream>>>(tq, tk, tv,
                                                                   p);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 instantiation of flash_attn_fwd (flash_attn.cu), same arguments
// without the dtype.  Strides are in elements; q, k and v need a 16-byte-
// aligned base and strides on S, head and batch that are positive multiples
// of 8 elements (-1 otherwise, before any launch; k and v are not checked
// when no key is valid, since they are never read).  lse: null, or f32
// (B, H, Sq) for the rows' log-sum-exp.
int flash_attn_fwd_sm90(
    int d, const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B,
    int H, int KV, int Sq, int Sk, int kv_len, int causal, int window,
    float cap, cudaStream_t stream) {
  // with no valid key every block skips every KV tile and writes zeros:
  // k and v are never read, and their maps are q's
  const int kv_lim = kv_len < Sk ? kv_len : Sk;
  const bool keys = kv_lim > 0;
  if (!tma_ok(q, q_ss, q_sh, q_sb) ||
      (keys && (!tma_ok(k, k_ss, k_sh, k_sb) || !tma_ok(v, v_ss, v_sh, v_sb))))
    return -1;
  if (Sq > 65535 * BQ) return (int)cudaErrorInvalidValue;
  if (!bind_device()) return (int)cudaErrorInvalidDevice;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, Sq, H, B, q_ss, q_sh, q_sb, BQ))
    return (int)cudaErrorInvalidValue;
  if (!keys) {
    tk = tq;
    tv = tq;
  } else if (!make_map(&tk, k, d, Sk, KV, B, k_ss, k_sh, k_sb, BK) ||
             !make_map(&tv, v, d, Sk, KV, B, v_ss, v_sh, v_sb, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{static_cast<__nv_bfloat16*>(o), lse, o_sb, o_ss, o_sh,
                 H, KV, Sq, kv_lim, causal, window, cap,
                 1.0f / sqrtf((float)d)};
  switch (d) {
    case 64: return launch<64>(tq, tk, tv, p, B, stream);
    case 80: return launch<80>(tq, tk, tv, p, B, stream);
    case 128: return launch<128>(tq, tk, tv, p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
