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
//
// Instantiated for D in {64, 80, 128}.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 128;          // query rows per block (two consumers)
constexpr int BK = 128;          // key rows per ring stage
constexpr int NT = 384;          // producer + two consumer warpgroups
constexpr int BOX_COLS = 64;     // bf16 columns of one 128B-swizzle box
constexpr uint32_t BOX_BYTES = 128u * 128u;  // one box of a 128-row tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;
  int H, KV, Sq, kv_lim, causal, window;
  float cap;          // <= 0: none
  float inv_sqrt_d;   // 1 / sqrt(D), D unpadded
};

template <int D>
__host__ __device__ constexpr int padded() { return D <= 64 ? 64 : 128; }

// Q, K[2], V[2] tiles, 9 mbarriers, and slack to align the tiles to 1024
// bytes (the 128B swizzle repeats every 8 rows of 128 bytes).
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 5 * (padded<D>() / BOX_COLS) * (int)BOX_BYTES + 9 * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase with this parity has completed.  A wait
// that outlasts 2^28 polls (seconds) is a fault: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done, stuck;\n.reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.gt.u32 stuck, polls, 268435456;\n"
      "@stuck trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One box of the 4-D map at (column, row, head, batch) into shared memory,
// completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin register operands of an asynchronous wgmma in program order.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 adds nothing to l or O at f32).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (the thread's
// four bf16 pairs), B from shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the thread's
// four bf16 pairs), B from shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
    // row with no valid key (l = 0) is written as 0
    const long long ob = b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qr[r] >= p.Sq) continue;
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

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (D, S, heads, B) of a bf16 tensor with element strides
// (ss, sh, sb) and a unit stride on D; boxes of 64 columns x 128 rows,
// 128B swizzle, zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int d, int s, int heads,
              int batch, long long ss, long long sh, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX_COLS, 128, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

bool tma_ok(const void* ptr, long long ss, long long sh, long long sb) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ss % 8 == 0 &&
         sh % 8 == 0 && sb % 8 == 0 && ss > 0 && sh > 0 && sb > 0;
}

}  // namespace

// The bf16 instantiation of flash_attn_fwd (flash_attn.cu), same arguments
// without the dtype.  Strides are in elements; q, k and v need a 16-byte-
// aligned base and strides on S, head and batch that are positive multiples
// of 8 elements (-1 otherwise, before any launch; k and v are not checked
// when no key is valid, since they are never read).
int flash_attn_fwd_sm90(
    int d, const void* q, const void* k, const void* v, void* o,
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
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, Sq, H, B, q_ss, q_sh, q_sb))
    return (int)cudaErrorInvalidValue;
  if (!keys) {
    tk = tq;
    tv = tq;
  } else if (!make_map(&tk, k, d, Sk, KV, B, k_ss, k_sh, k_sb) ||
             !make_map(&tv, v, d, Sk, KV, B, v_ss, v_sh, v_sb)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{static_cast<__nv_bfloat16*>(o), o_sb, o_ss, o_sh, H, KV, Sq,
                 kv_lim, causal, window, cap,
                 1.0f / sqrtf((float)d)};
  switch (d) {
    case 64: return launch<64>(tq, tk, tv, p, B, stream);
    case 80: return launch<80>(tq, tk, tv, p, B, stream);
    case 128: return launch<128>(tq, tk, tv, p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
