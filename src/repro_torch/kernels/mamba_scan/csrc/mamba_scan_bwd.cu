// B6-bwd and B7-bwd: the gradients of the Mamba scans.  Neither replaces a
// TPU kernel: the JAX package differentiates its scans with XLA's autodiff
// of jnp (src/repro/models/mamba.py: chunked_scan, fused_chunked_scan_m1,
// fused_chunked_scan_m2), and the port's scans are hand-written CUDA whose
// outputs autograd cannot see into, so each needs a backward of its own.
//
// B6-bwd (mamba_scan_bwd): the gradient of B6 (csrc/mamba_scan.cu,
// h_t = a_t h_{t-1} + b_t over a, b (B, L, D, S)).  Given g_hs (B, L, D, S)
// and g_hlast (B, D, S) or null, the adjoint
//     lam_t = g_hs_t + a_{t+1} lam_{t+1}   (g_hlast in place of a_L lam_L)
// gives da_t = lam_t h_{t-1} (h_{-1} = h0), db_t = lam_t, dh0 = a_0 lam_0.
// One thread per (batch, d, s) walks t from L - 1 down, as B6 walks it up,
// reading the saved states hs rather than recomputing them.  Every product
// and sum is __fmul_rn / __fadd_rn in ref.scan_ref_bwd's order, so B6-bwd is
// bitwise its plain version.  Bound: the five (B, L, D, S) float32 arrays it
// reads (g_hs, a, hs) and writes (da, db) once, over 3.35 TB/s: 1.60 ms at
// (1, 2048, 8192, 16).
//
// B7-bwd: the gradient of B7, the fused scan
//     a_t = exp(dt_t A), bx_t = (dt_t xc_t) B_t, h_t = a_t h_{t-1} + bx_t,
//     y_t = sum_s h_t C_t,
// in two forms.  Given gy (B, L, D) and g_hlast (B, D, S) or null, with the
// adjoint lam_t = gy_t C_t + a_{t+1} lam_{t+1} (g_hlast in place of
// a_L lam_L):
//  - the per-channel form (mamba_fused_bwd; falcon-mamba, any (D, S)
//    decay A) takes ga_t = (lam_t h_{t-1}) a_t, the gradient of dt_t A, and
//    returns
//     ddt_t = state_sum(lam_t B_t) xc_t + state_sum(ga_t A)   (B, L, D) f32
//     dxc_t = state_sum(lam_t B_t) dt_t                      (B, L, D)
//     dA = sum_b sum_t ga_t dt_t                            (D, S) f32;
//  - the mamba2 form (mamba_ssd_bwd; zamba2's SSD scan) takes the scan's
//    own inputs: dt (B, L, nh) and one decay a_h (nh,) a head of hd
//    channels (channel d = head * hd + e), so a_t = exp(dt_t a_h) is one
//    number a (t, head) for all hd x S of its states, and returns
//     q_t = sum_{e,s} lam_t h_{t-1},  r_t = sum_e state_sum(lam_t B_t) xc_t
//     ddt_t = r_t + (q_t a_t) a_h                         (B, L, nh) f32
//     dxh_t = state_sum(lam_t B_t) dt_t                   (B, L, nh hd)
//     da_h = sum_b sum_t (q_t a_t) dt_t                   (nh,) f32
//    (q and r over chunks of min(hd, 16) channels by pairwise halving,
//    then the chunks in order; da_h over (b, t) in 256 strided runs, then
//    a halving tree: fused.fused_ssd_scan_plain_bwd's order);
//  - both return dB_t = sum_d lam_t (dt_t xc_t), dC_t = sum_d gy_t h_t
//    (B, L, S) and dh0 = a_0 lam_0 (B, D, S) f32.
// xc, B, C and their gradients are float32 or bfloat16; every sum is f32.
//
// Bound.  The per-channel form: one exponential per (t, d, s) at the
// special-function units' 4.18e12/s (0.257 ms at (4, 2048, 8192, 16),
// 0.642 ms at (4, 2048, 5120, 64)), or its bytes (dt, xc, gy, B, C, the
// checkpoints read, the gradients written; 0.342 ms at the first shape).
// The mamba2 form has one exponential a (t, head); its bound is the larger
// of its bytes (xh, gy, the checkpoints, dxh: ~0.5 GB, ~0.15 ms at
// (4, 2048, 80 x 64, 64)) and ~12 f32 operations per (t, d, s) for the
// recurrence recomputed and walked back (~0.48 ms there at 67 TFLOP/s).
//
// Design.  B7's forward, asked for them, writes the state at the start of
// each of its tiles of B7_TILE = 64 steps (ckpt, (B, ceil(L / 64), D, S)
// f32).  A block of 256 threads takes CH channels of one sequence, a
// channel's S states on G = S / K lanes (K = B7B_K = 4 states a lane, lane
// j holding j, j + G, ...: B7's layout, so the sums over the states are
// register adds and then xor shuffles in fused.state_sum's order), and
// walks the tiles from the last:
//  - Staging.  A tile's rows (dt, or the heads' dt in the mamba2 form; xc
//    and gy of the block's channels; the B and C rows) and its checkpoint
//    sit in a ring in shared memory.  Once a sub-tile's rows are dead,
//    tile ti - 1's rows for those slots are copied in by the TMA (bulk
//    copies, one per row and array, B and C one per sub-tile, completing
//    on one mbarrier a tile; one issuing thread a warp, the rows spread
//    over the warps), so the next tile arrives while this one is walked
//    and no step waits on device memory.  Rows that do not start on 16
//    bytes take element copies instead.  (cp.async copies here slowed the
//    other block on the SM: its shared-memory loads queued behind them.)
//    The mamba2 form takes exp(dt a_h) once per (t, head) into the ring.
//  - Recompute.  From the checkpoint the tile's states are recomputed
//    forward (pass 1), each sub-tile's first state to shared memory (each
//    thread its own column); then for each sub-tile of kBSub = B7B_SUB = 8
//    steps from the last the states into registers (pass 2), and the
//    adjoint walked back through them.  The walked sub-tile is staged as
//    float32 beforehand: (dt, xc, gy, decay) a (step, channel) as one
//    16-byte load, and the B and C rows permuted so that a lane's K states
//    are one 16-byte load.  The per-channel form takes its decays'
//    exponentials again in the walk (three a state, the forward's
//    included): held in registers beside the states they spill, and the
//    walk with them ran slower (sweep_b7b.py).  __launch_bounds__(256,
//    B7B_MINB = 2) holds a thread to 128 registers: two blocks an SM.
//  - dB and dC over D.  Each step, lanes add their shares over the warp's
//    channels by a reduce-scatter (each xor level sends half of what is
//    left: K = 4 states a lane take 2 + 1 + 1 shuffles at S = 16 instead
//    of 12) and write one sum per (warp, state) to shared memory; after the
//    sub-tile, the block adds its warps in warp order.  The blocks of one
//    sequence run as clusters of B7B_CLUSTER = 2 (the sweep: clusters of 4
//    or 8 were 35-50% slower at falcon-mamba's shape, 2 as fast as 1): each
//    rank adds its half of the sub-tile's sums over the ranks' shared
//    memory (distributed shared memory) in rank order and writes it as the
//    cluster's partial (B, clusters, L, S).  The cluster barrier is split:
//    a block arrives when its sums are in and waits one sub-tile later,
//    before it reads the others', with the sums double buffered.
//  - The mamba2 form's q and r: each thread's share of q (its states'
//    lam h_{t-1}, added in the thread) and each channel's r go to shared
//    memory; after the sub-tile one warp a (step, chunk of 16 channels)
//    adds them by halving (fused.ssd_q_sum, ssd_chunk_sum).
// Determinism: no float atomics.  Sums kernels add the clusters' partials
// of dB and dC, and the batches' partials of dA (per-channel form), one
// after another in index order; the mamba2 form's heads kernel adds each
// head's chunk sums of q and r in order, writes ddt and sums da_h.  Two runs
// give the same bits.
//
// Rounding: __fmul_rn / __fadd_rn throughout and expf (never fast-math), as
// B7's forward, so the recomputed states are B7's own bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- B6-bwd

constexpr int kScanThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kScanThreads)
mamba_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ hs,
                      const float* __restrict__ h0,
                      const float* __restrict__ g_hs,
                      const float* __restrict__ g_hlast, long long n_ds,
                      int L, long long total, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dh0) {
  const long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= total) return;  // total = B * D * S
  const long long bi = i / n_ds;
  const long long base = bi * (long long)L * n_ds + (i - bi * n_ds);
  const float h_init = h0[i];
  float carry = g_hlast != nullptr ? g_hlast[i] : 0.0f;
  int t = L - 1;
  for (; t >= kUnroll - 1; t -= kUnroll) {
    float gv[kUnroll], av[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)(t - u) * n_ds;
      gv[u] = __ldg(g_hs + off);
      av[u] = __ldg(a + off);
      hv[u] = t - u > 0 ? __ldg(hs + off - n_ds) : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)(t - u) * n_ds;
      const float lam = __fadd_rn(gv[u], carry);
      db[off] = lam;
      da[off] = __fmul_rn(lam, hv[u]);
      carry = __fmul_rn(lam, av[u]);
    }
  }
  for (; t >= 0; --t) {
    const long long off = base + (long long)t * n_ds;
    const float lam = __fadd_rn(__ldg(g_hs + off), carry);
    db[off] = lam;
    da[off] = __fmul_rn(lam, t > 0 ? __ldg(hs + off - n_ds) : h_init);
    carry = __fmul_rn(lam, __ldg(a + off));
  }
  dh0[i] = carry;
}

// ---------------------------------------------------------------- B7-bwd

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the forward's tile (its checkpoint spacing): the launcher refuses a
// forward library built with another
#ifndef B7_TILE
#define B7_TILE 64
#endif
#ifndef B7B_K
#define B7B_K 4  // states per thread (at most S)
#endif
#ifndef B7B_SUB
#define B7B_SUB 8  // steps per sub-tile
#endif
#ifndef B7B_CLUSTER
#define B7B_CLUSTER 2  // blocks a cluster (1, 2, 4 or 8; sweep_b7b.py)
#endif
#ifndef B7B_MINB
#define B7B_MINB 2  // blocks an SM the registers are held to
#endif
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kBTile = B7_TILE;
constexpr int kBSub = B7B_SUB;
static_assert(kBTile % kBSub == 0, "a tile holds whole sub-tiles");
constexpr int kBSubs = kBTile / kBSub;
constexpr int kQrChunk = 16;  // mamba2: channels a partial of q and r
constexpr int kMinHd = 4;     // mamba2: the least head dim
static_assert(B7B_CLUSTER == 1 || B7B_CLUSTER == 2 || B7B_CLUSTER == 4 ||
                  B7B_CLUSTER == 8,
              "a portable cluster");

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
constexpr int imin(int a, int b) { return a < b ? a : b; }

template <typename T, int S, bool M2>
struct BwdLayout {
  static constexpr int K = B7B_K < S ? B7B_K : S;
  static constexpr int G = S / K;           // lanes a channel
  static constexpr int CH = kBThreads / G;  // channels a block
  static constexpr int NC = 32 / G;         // channels a warp
  static_assert(S % K == 0 && 32 % G == 0, "a channel inside one warp");
  static_assert(CH % kQrChunk == 0, "whole chunks of q and r a block");
  // the reduce-scatter over the warp's channels: LH levels halve a lane's
  // K sums, the rest add a single one; then KR sums a lane, distinct on
  // the first kWriters lanes
  static constexpr int LH = imin(ilog2(K), ilog2(NC));
  static constexpr int KR = K >> LH;
  static constexpr int kWriters = G << LH;
  static constexpr int kTB = (int)sizeof(T);
  // mamba2: a block's heads at most (the launcher takes hd >= kMinHd)
  static constexpr int kNhb = CH / kMinHd;
  // shared memory, in floats.  The ring of the tile's rows as copied:
  static constexpr int kDtW = M2 ? kNhb : CH;       // a row of dt
  static constexpr int kDt = 0;                     // [TILE][kDtW] f32
  static constexpr int kGy = kDt + kBTile * kDtW;   // [TILE][CH] f32
  static constexpr int kDec = kGy + kBTile * CH;    // mamba2: [TILE][kNhb]
  static constexpr int kXc = kDec + (M2 ? kBTile * kNhb : 0);  // [TILE][CH] T
  static constexpr int kBc = kXc + kBTile * CH * kTB / 4;
  // ^ B [TILE][S] T, then C [TILE][S] T
  static constexpr int kStart = kBc + kBTile * 2 * S * kTB / 4;
  // ^ [SUBS][K][threads]: each sub-tile's first state (slot 0: the tile's
  // checkpoint as it lies in ckpt, [CH][S])
  static constexpr int kRed = kStart + kBSubs * K * kBThreads;
  // ^ [SUB][warps][2][S]: the warps' sums of dB and dC
  static constexpr int kSum = kBSub * 2 * S;     // a sub-tile's [SUB][2][S]
  static constexpr int kBsum = kRed + kBWarps * kSum;  // two of them
  // the walked sub-tile as float32: (dt, xc, gy, decay) a (step, channel)
  // [SUB][CH] float4, and its B|C rows [SUB][2S], permuted so that lane j's
  // K states sit at j K ..
  static constexpr int kRows = kBsum + 2 * kSum;
  static constexpr int kCb = kRows + kBSub * CH * 4;
  static constexpr int kQr = kCb + kBSub * 2 * S;  // mamba2: r [SUB][CH]
  static constexpr int kQb = kQr + (M2 ? kBSub * CH : 0);
  // ^ mamba2: each thread's share of q [SUB][threads]
  static constexpr int kBar = kQb + (M2 ? kBSub * kBThreads : 0);
  // ^ the ring's mbarrier (8 bytes)
  static constexpr int kFloats = kBar + 4;
  static constexpr int kBytes = kFloats * 4;
};

// Every pointer and size of one call.  dt: (B, L, D) per channel, or
// (B, L, nh) in the mamba2 form; a: A (D, S) or a_h (nh,); ddt: (B, L, D)
// or (B, L, nh); part_a: the per-channel form's (B, D, S) partials of dA;
// part_qr: the mamba2 form's chunk sums of q and r, (D / chunk, B * L, 2).
struct BwdArgs {
  const float* dt;
  const void* xc;
  const void* bm;
  const void* cm;
  const float* a;
  const float* ckpt;
  const float* gy;
  const float* g_hlast;
  float* ddt;
  void* dxc;
  float* dh0;
  float* part_b;
  float* part_c;
  float* part_a;
  float* part_qr;
  int L, D, nh, hd;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster barrier in two halves: what this block wrote to its shared
// memory before arriving is visible to the cluster's blocks after they wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One element of type T into shared memory: a 4-byte cp.async for float,
// a load and a store for bfloat16 (cp.async copies 4 bytes at least).
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4)
    cp_async4(dst, src);
  else
    *dst = *src;
}

// The mamba2 form's dt of the block's heads (nhb of them from head hb0)
// for rows r0 .. r1 - 1 of the tile at step t0: 4-byte copies.
template <typename T, int S, bool M2>
__device__ __forceinline__ void copy_dth(float* __restrict__ sm,
                                         const BwdArgs& p, long long row0,
                                         int t0, int r0, int r1, int hb0,
                                         int nhb, int tid) {
  using Lay = BwdLayout<T, S, M2>;
  for (int v = tid; v < (r1 - r0) * nhb; v += kBThreads) {
    const int r = r0 + v / nhb, hb = v % nhb;
    if (t0 + r < p.L && hb0 + hb < p.nh)
      cp_async4(sm + Lay::kDt + r * Lay::kDtW + hb,
                p.dt + (row0 + t0 + r) * p.nh + hb0 + hb);
  }
}

// Rows r0 .. r1 - 1 of the tile at step t0 into the ring, one element a
// copy (rows that do not start on 16 bytes): gy (and dt) of the block's
// CH channels, xc, the B and C rows; in the mamba2 form the heads' dt.
// Rows past L and channels past D are not copied.
template <typename T, int S, bool M2>
__device__ __forceinline__ void copy_rows(float* __restrict__ sm,
                                          const BwdArgs& p, long long row0,
                                          int t0, int r0, int r1, int d0,
                                          int hb0, int nhb, int tid) {
  using Lay = BwdLayout<T, S, M2>;
  constexpr int CH = Lay::CH;
  const int nr = r1 - r0;
  T* xs = reinterpret_cast<T*>(sm + Lay::kXc);
  const T* xg = static_cast<const T*>(p.xc);
  for (int v = tid; v < nr * CH; v += kBThreads) {
    const int r = r0 + v / CH, col = v % CH;
    if (t0 + r < p.L && d0 + col < p.D) {
      const long long off = (row0 + t0 + r) * p.D + d0 + col;
      cp_async4(sm + Lay::kGy + r * CH + col, p.gy + off);
      if constexpr (!M2) cp_async4(sm + Lay::kDt + r * CH + col, p.dt + off);
      copy_elem<T>(xs + r * CH + col, xg + off);
    }
  }
  T* bc = reinterpret_cast<T*>(sm + Lay::kBc);
  for (int v = tid; v < nr * 2 * S; v += kBThreads) {
    const int r = r0 + v / (2 * S), q = v % (2 * S);
    if (t0 + r < p.L)
      copy_elem<T>(bc + (q < S ? 0 : kBTile * S) + r * S + q % S,
                   static_cast<const T*>(q < S ? p.bm : p.cm) +
                       (row0 + t0 + r) * S + q % S);
  }
  if constexpr (M2) copy_dth<T, S, M2>(sm, p, row0, t0, r0, r1, hb0, nhb, tid);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive, and expect ``bytes`` more of the phase's copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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

// A bulk copy of ``bytes`` (a multiple of 16, both ends on 16 bytes) from
// device memory into shared memory by the TMA, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The bytes one row of the ring takes through the TMA (its B and C rows,
// and the live channels' gy, xc and, per channel, dt).
template <typename T, bool M2>
__device__ __forceinline__ uint32_t row_bytes(int s, int live_ch) {
  return (uint32_t)(2 * s * (int)sizeof(T) +
                    live_ch * (4 + (int)sizeof(T) + (M2 ? 0 : 4)));
}

// Rows r0 .. r1 - 1 (all before L) of the tile at step t0 into the ring
// by the TMA, issued by lane 0 of each warp (warp w the rows r0 + w,
// r0 + w + 8, ...; warp 0 also the B and C rows, one copy each),
// completing on ``bar``.
template <typename T, int S, bool M2>
__device__ __forceinline__ void tma_rows(float* __restrict__ sm,
                                         const BwdArgs& p, long long row0,
                                         int t0, int r0, int r1, int d0,
                                         int live_ch, uint32_t bar, int w) {
  using Lay = BwdLayout<T, S, M2>;
  constexpr int CH = Lay::CH;
  T* bs = reinterpret_cast<T*>(sm + Lay::kBc);
  if (w == 0) {
    const long long g = (row0 + t0 + r0) * S;
    const uint32_t nb = (uint32_t)((r1 - r0) * S * sizeof(T));
    bulk_copy(bs + r0 * S, static_cast<const T*>(p.bm) + g, nb, bar);
    bulk_copy(bs + kBTile * S + r0 * S, static_cast<const T*>(p.cm) + g, nb,
              bar);
  }
  if (live_ch == 0) return;
  for (int r = r0 + w; r < r1; r += kBWarps) {
    const long long off = (row0 + t0 + r) * p.D + d0;
    bulk_copy(sm + Lay::kGy + r * CH, p.gy + off, live_ch * 4, bar);
    bulk_copy(reinterpret_cast<T*>(sm + Lay::kXc) + r * CH,
              static_cast<const T*>(p.xc) + off, live_ch * sizeof(T), bar);
    if constexpr (!M2)
      bulk_copy(sm + Lay::kDt + r * CH, p.dt + off, live_ch * 4, bar);
  }
}

// The tile's checkpoint of the block's CH channels (CH x S floats, one
// contiguous run of ckpt) into start slot 0 as it lies, [c][s]: one
// element a copy; channels past D are not copied (and not read).
template <int S>
__device__ __forceinline__ void copy_ckpt(float* __restrict__ start,
                                          const float* __restrict__ ckpt,
                                          int live_ch, int tid) {
  for (int v = tid; v < live_ch * S; v += kBThreads)
    cp_async4(start + v, ckpt + v);
}

// Two sums over the channel's states: adds inside the thread, then xor
// shuffles over its G lanes (fused.state_sum's order); the sums in a[0],
// b[0] on every lane of the channel.
template <int K, int G>
__device__ __forceinline__ void state_sum2(float (&a)[K], float (&b)[K]) {
#pragma unroll
  for (int hw = K / 2; hw > 0; hw >>= 1)
#pragma unroll
    for (int i = 0; i < hw; ++i) {
      a[i] = __fadd_rn(a[i], a[i + hw]);
      b[i] = __fadd_rn(b[i], b[i + hw]);
    }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    a[0] = __fadd_rn(a[0], __shfl_xor_sync(0xffffffffu, a[0], off));
    b[0] = __fadd_rn(b[0], __shfl_xor_sync(0xffffffffu, b[0], off));
  }
}

// One sum over the channel's states, as state_sum2.
template <int K, int G>
__device__ __forceinline__ void state_sum1(float (&a)[K]) {
#pragma unroll
  for (int hw = K / 2; hw > 0; hw >>= 1)
#pragma unroll
    for (int i = 0; i < hw; ++i) a[i] = __fadd_rn(a[i], a[i + hw]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    a[0] = __fadd_rn(a[0], __shfl_xor_sync(0xffffffffu, a[0], off));
}

// Two K-vectors summed over the warp's channels (lane bits M, 2M, ... 16;
// M = G at the first call): while a lane holds more than one sum, each
// level keeps half of them (the upper half where the lane's bit M is set)
// and adds the partner lane's other half; then single sums add their
// partner's.  On return v[0 .. LEN - 1] hold the sums of the states
// j + (base + q) G of the warp's channels.
template <int K, int LEN, int M>
__device__ __forceinline__ void scatter_sum2(float (&a)[K], float (&b)[K],
                                             int lane, int& base) {
  if constexpr (M < 32) {
    if constexpr (LEN > 1) {
      constexpr int H = LEN / 2;
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float sa = up ? a[q] : a[q + H], ka = up ? a[q + H] : a[q];
        const float sb = up ? b[q] : b[q + H], kb = up ? b[q + H] : b[q];
        a[q] = __fadd_rn(ka, __shfl_xor_sync(0xffffffffu, sa, M));
        b[q] = __fadd_rn(kb, __shfl_xor_sync(0xffffffffu, sb, M));
      }
      if (up) base += H;
      scatter_sum2<K, H, 2 * M>(a, b, lane, base);
    } else {
      a[0] = __fadd_rn(a[0], __shfl_xor_sync(0xffffffffu, a[0], M));
      b[0] = __fadd_rn(b[0], __shfl_xor_sync(0xffffffffu, b[0], M));
      scatter_sum2<K, 1, 2 * M>(a, b, lane, base);
    }
  }
}

// K floats from shared memory, 16 bytes a load where K allows
template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&out)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x, out[i + 1] = q.y, out[i + 2] = q.z, out[i + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x, out[1] = q.y;
  } else {
    out[0] = p[0];
  }
}

// The walk.  Grid (blocks along D, padded to whole clusters; B), clusters
// along D.  M2: the mamba2 form.
template <typename T, int S, bool M2, bool WIDE>
__global__ void __launch_bounds__(kBThreads, B7B_MINB)
mamba_fused_bwd_kernel(const BwdArgs p) {
  using Lay = BwdLayout<T, S, M2>;
  constexpr int K = Lay::K, G = Lay::G, CH = Lay::CH, DW = Lay::kDtW;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const float* dt_s = smem + Lay::kDt;
  const float* gy_s = smem + Lay::kGy;
  float* dec_s = smem + Lay::kDec;
  const T* xc_s = reinterpret_cast<const T*>(smem + Lay::kXc);
  const T* bc_s = reinterpret_cast<const T*>(smem + Lay::kBc);
  float* start = smem + Lay::kStart;
  float* red = smem + Lay::kRed;
  float* bsum = smem + Lay::kBsum;
  float4* rows = reinterpret_cast<float4*>(smem + Lay::kRows);
  float* cb_s = smem + Lay::kCb;
  float* qr_s = smem + Lay::kQr;
  float* qb_s = smem + Lay::kQb;
  const int tid = threadIdx.x, c = tid / G, j = tid % G;
  const int w = tid / 32, lane = tid % 32;
  const int d0 = blockIdx.x * CH, d = d0 + c;
  const bool live = d < p.D;
  const int bi = blockIdx.y;
  const long long row0 = (long long)bi * p.L;  // (batch, t = 0)
  auto state_at = [&](int i) {  // this thread's state i in (B, D, S)
    return ((long long)bi * p.D + d) * S + j + i * G;
  };
  const int n_tiles = (p.L + kBTile - 1) / kBTile;
  // mamba2: the block's heads (hb0 .. hb0 + nhb - 1) and this channel's
  const int hb0 = M2 ? d0 / p.hd : 0;
  const int nhb = M2 ? (p.hd >= CH ? 1 : CH / p.hd) : 0;
  const int col = M2 ? (live ? d / p.hd - hb0 : 0) : c;  // its dt column
  T* dxc = static_cast<T*>(p.dxc);
  float A[K], carry[K], dA[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    A[i] = (!M2 && live) ? p.a[(long long)d * S + j + i * G] : 0.0f;
    carry[i] = (live && p.g_hlast != nullptr) ? p.g_hlast[state_at(i)] : 0.0f;
    dA[i] = 0.0f;
  }
  // the block's run of tile ti's checkpoint, and its live channels
  auto ckpt_run = [&](int ti) {
    return p.ckpt + (((long long)bi * n_tiles + ti) * p.D + d0) * S;
  };
  const int live_ch = max(0, min(CH, p.D - d0));
  // sub-tile k's rows of the ring into the walked layout, as float32 (a
  // channel past D reads zeros; rows past L are converted and never read)
  auto convert_sub = [&](int k) {
    const int ts = k * kBSub;
#pragma unroll 1
    for (int v = tid; v < kBSub * CH; v += kBThreads) {
      const int r = ts + v / CH, c2 = v % CH;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (d0 + c2 < p.D) {
        const int cc = M2 ? (d0 + c2) / p.hd - hb0 : c2;
        val.x = dt_s[r * DW + cc];
        val.y = to_f32(xc_s[r * CH + c2]);
        val.z = gy_s[r * CH + c2];
        val.w = M2 ? dec_s[r * DW + cc] : 0.0f;
      }
      rows[v] = val;
    }
#pragma unroll 1
    for (int v = tid; v < kBSub * 2 * S; v += kBThreads) {
      const int u = v / (2 * S), q = v % (2 * S), s = q % S;
      cb_s[u * 2 * S + (q - s) + (s % G) * K + s / G] =
          to_f32(bc_s[(q < S ? 0 : kBTile * S) + (ts + u) * S + s]);
    }
  };
  // this rank's share of a sub-tile's cluster sums (double buffer pb,
  // steps t .. t + m - 1), over the ranks in order, as the cluster's partial
  auto cluster_sums = [&](int pb, int t, int m) {
    const unsigned n_cl = cluster.num_blocks(), rank = cluster.block_rank();
    const int share = Lay::kSum / (int)n_cl;
    const long long cl = blockIdx.x / n_cl, ncl = gridDim.x / n_cl;
    float* bs = bsum + pb * Lay::kSum;
#pragma unroll
    for (int it = 0; it < (Lay::kSum + kBThreads - 1) / kBThreads; ++it) {
      const int e = (int)rank * share + tid + it * kBThreads;
      if (tid + it * kBThreads < share && e / (2 * S) < m) {
        const int u = e / (2 * S);
        float acc = cluster.map_shared_rank(bs, 0u)[e];
#pragma unroll
        for (unsigned q = 1; q < B7B_CLUSTER; ++q)
          if (q < n_cl) acc = __fadd_rn(acc, cluster.map_shared_rank(bs, q)[e]);
        const int rest = e % (2 * S);
        float* part = rest < S ? p.part_b : p.part_c;
        part[((bi * ncl + cl) * p.L + t + u) * S + rest % S] = acc;
      }
    }
  };
  // rows r0 .. r1 - 1 of tile tl into the ring, and with ``ckpt`` its
  // checkpoint into start slot 0.  WIDE: by the TMA, completing on the
  // ring's mbarrier, whose phase expects the whole tile (``first``: the
  // tile's first call); the mamba2 heads' dt by 4-byte copies.
  const uint32_t bar = smem_u32(smem + Lay::kBar);
  auto refill = [&](int tl, int r0, int r1, bool first, bool ckpt) {
    const int tt = tl * kBTile, rows_tl = min(kBTile, p.L - tt);
    r1 = min(r1, rows_tl);
    if constexpr (WIDE) {
      if (lane == 0) {  // one issuing thread a warp
        // the block's reads of the dead slots (ordered by the barrier
        // before) come before the TMA's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        // (a copy may complete before the expectation is set: the phase
        // still waits for this arrival)
        if (first && w == 0)
          mbar_expect_tx(bar, (uint32_t)rows_tl * row_bytes<T, M2>(S, live_ch)
                                  + (uint32_t)(live_ch * S * 4));
        if (r0 < r1)
          tma_rows<T, S, M2>(smem, p, row0, tt, r0, r1, d0, live_ch, bar, w);
        if (ckpt && w == 1 && live_ch > 0)
          bulk_copy(start, ckpt_run(tl), live_ch * S * 4, bar);
      }
      if constexpr (M2)
        copy_dth<T, S, M2>(smem, p, row0, tt, r0, r1, hb0, nhb, tid);
    } else {
      copy_rows<T, S, M2>(smem, p, row0, tt, r0, r1, d0, hb0, nhb, tid);
      if (ckpt) copy_ckpt<S>(start, ckpt_run(tl), live_ch, tid);
    }
  };
  if constexpr (WIDE) {
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  refill(n_tiles - 1, 0, kBTile, true, true);
  // the sums' double buffer, and the steps of the sub-tile whose cluster
  // sums are pending (the one walked before: its buffer is par ^ 1)
  int par = 0, pend_m = 0;
#pragma unroll 1
  for (int ti = n_tiles - 1; ti >= 0; --ti) {
    const int t0 = ti * kBTile, n = min(kBTile, p.L - t0);
    const int nsub = (n + kBSub - 1) / kBSub;
    cp_async_wait_all();
    if constexpr (WIDE) mbar_wait(bar, (uint32_t)((n_tiles - 1 - ti) & 1));
    __syncthreads();  // the tile's rows and checkpoint are in
    if constexpr (M2) {  // one decay a (step, head)
      for (int v = tid; v < n * nhb; v += kBThreads) {
        const int r = v / nhb, hb = v % nhb;
        if (hb0 + hb < p.nh)
          dec_s[r * DW + hb] = expf(__fmul_rn(dt_s[r * DW + hb], p.a[hb0 + hb]));
      }
      __syncthreads();
    }
    convert_sub(nsub - 1);
    // the tile's states forward from its checkpoint; each sub-tile's
    // first state to its start slot (the last sub-tile's steps are walked
    // below, not here)
    {
      float h[K];
#pragma unroll
      for (int i = 0; i < K; ++i)
        h[i] = live ? start[c * S + j + i * G] : 0.0f;  // the checkpoint
#pragma unroll 1
      for (int k = 0; k + 1 < nsub; ++k) {
#pragma unroll
        for (int u = 0; u < kBSub; ++u) {
          const int r = k * kBSub + u;
          const float dtv = live ? dt_s[r * DW + col] : 0.0f;
          const float dx =
              __fmul_rn(dtv, live ? to_f32(xc_s[r * CH + c]) : 0.0f);
          const float dec2 = (M2 && live) ? dec_s[r * DW + col] : 0.0f;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const float dec = M2 ? dec2 : expf(__fmul_rn(dtv, A[i]));
            h[i] = __fadd_rn(__fmul_rn(dec, h[i]),
                             __fmul_rn(dx, to_f32(bc_s[r * S + j + i * G])));
          }
        }
#pragma unroll
        for (int i = 0; i < K; ++i)
          start[((k + 1) * K + i) * kBThreads + tid] = h[i];
      }
    }
    __syncthreads();  // the last sub-tile is converted
    // the sub-tiles from the last
#pragma unroll 1
    for (int k = nsub - 1; k >= 0; --k) {
      const int ts = k * kBSub, m = min(kBSub, n - ts);
      // the sub-tile's states (its first one read again from shared memory
      // where the walk needs it); the walk takes the decays again (per
      // channel, their exponentials: held, they would not fit beside the
      // states in 128 registers)
      float hist[kBSub + 1][K];
      auto first = [&](int i) {
        return !live ? 0.0f
               : k == 0 ? start[c * S + j + i * G]
                        : start[(k * K + i) * kBThreads + tid];
      };
#pragma unroll
      for (int i = 0; i < K; ++i) hist[0][i] = first(i);
#pragma unroll
      for (int u = 0; u < kBSub; ++u) {
        if (u < m) {
          const float4 rv = rows[u * CH + c];
          const float dx = __fmul_rn(rv.x, rv.y);
          float bv[K];
          load_k<K>(cb_s + u * 2 * S + j * K, bv);
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const float dec = M2 ? rv.w : expf(__fmul_rn(rv.x, A[i]));
            hist[u + 1][i] = __fadd_rn(__fmul_rn(dec, hist[u][i]),
                                       __fmul_rn(dx, bv[i]));
          }
        }
      }
#pragma unroll
      for (int u = kBSub - 1; u >= 0; --u) {
        if (u < m) {
          const int r = ts + u;
          const float4 rv = rows[u * CH + c];
          const float dtv = rv.x, xv = rv.y, gyv = rv.z;
          const float dx = __fmul_rn(dtv, xv);
          // in three phases, so that few temporaries are live at once:
          // the adjoint and the carry, then dB and dC's shares, then the
          // sums over the states
          float lam[K], pq[K];
          {
            float cv[K];
            load_k<K>(cb_s + u * 2 * S + S + j * K, cv);
#pragma unroll
            for (int i = 0; i < K; ++i) {
              const float dec = M2 ? rv.w : expf(__fmul_rn(dtv, A[i]));
              const float hp = u == 0 ? first(i) : hist[u][i];  // h_{t-1}
              lam[i] = __fadd_rn(__fmul_rn(gyv, cv[i]), carry[i]);
              if constexpr (M2) {
                pq[i] = __fmul_rn(lam[i], hp);
              } else {
                const float ga = __fmul_rn(__fmul_rn(lam[i], hp), dec);
                dA[i] = __fadd_rn(dA[i], __fmul_rn(ga, dtv));
                pq[i] = __fmul_rn(ga, A[i]);
              }
              carry[i] = __fmul_rn(dec, lam[i]);
            }
          }
          {
            float cb[K], cc[K];
#pragma unroll
            for (int i = 0; i < K; ++i) {
              cb[i] = __fmul_rn(lam[i], dx);
              cc[i] = __fmul_rn(gyv, hist[u + 1][i]);
            }
            int base = 0;
            scatter_sum2<K, K, G>(cb, cc, lane, base);
            if (lane < Lay::kWriters) {
              float* rw = red + (u * kBWarps + w) * 2 * S;
#pragma unroll
              for (int q = 0; q < Lay::KR; ++q) {
                rw[j + (base + q) * G] = cb[q];
                rw[S + j + (base + q) * G] = cc[q];
              }
            }
          }
          float pb[K];
          load_k<K>(cb_s + u * 2 * S + j * K, pb);
#pragma unroll
          for (int i = 0; i < K; ++i) pb[i] = __fmul_rn(lam[i], pb[i]);
          if constexpr (M2) {
            // this thread's share of q: its states added inside the
            // thread; the chunk's threads are added after the sub-tile
#pragma unroll
            for (int hw = K / 2; hw > 0; hw >>= 1)
#pragma unroll
              for (int i = 0; i < hw; ++i) pq[i] = __fadd_rn(pq[i], pq[i + hw]);
            qb_s[u * kBThreads + tid] = pq[0];
            state_sum1<K, G>(pb);
            if (live && j == 0) {
              dxc[(row0 + t0 + r) * p.D + d] = from_f32<T>(__fmul_rn(pb[0], dtv));
              qr_s[u * CH + c] = __fmul_rn(pb[0], xv);
            }
          } else {
            state_sum2<K, G>(pb, pq);
            if (live && j == 0) {
              const long long o = (row0 + t0 + r) * p.D + d;
              dxc[o] = from_f32<T>(__fmul_rn(pb[0], dtv));
              p.ddt[o] = __fadd_rn(__fmul_rn(pb[0], xv), pq[0]);
            }
          }
        }
      }
      __syncthreads();  // the sub-tile's sums are in; its rows are dead
      if (ti > 0)  // tile ti - 1's rows into the dead slots
        refill(ti - 1, ts, k == nsub - 1 ? kBTile : ts + kBSub,
               k == nsub - 1, k == 0);
      // the previous sub-tile's cluster sums: its barrier phase has had
      // this sub-tile's walk to complete
      if (pend_m > 0) {
        cluster_wait();
        cluster_sums(par ^ 1, k == nsub - 1 ? t0 + kBTile : t0 + ts + kBSub,
                     pend_m);
      }
      // the block's sums over its warps, in warp order
      float* bs = bsum + par * Lay::kSum;
#pragma unroll
      for (int it = 0; it < (Lay::kSum + kBThreads - 1) / kBThreads; ++it) {
        const int e = tid + it * kBThreads;
        if (e < m * 2 * S) {
          const float* src =
              red + (e / (2 * S)) * kBWarps * 2 * S + e % (2 * S);
          float acc = src[0];
#pragma unroll
          for (int ww = 1; ww < kBWarps; ++ww)
            acc = __fadd_rn(acc, src[ww * 2 * S]);
          bs[e] = acc;
        }
      }
      if constexpr (M2) {
        // q and r of each (step, chunk of cs channels), one warp a task:
        // the chunk's cs r values and its cs x G thread shares of q, each
        // added by pairwise halving (lane l first halves the shares l,
        // l + 32, ..., padded with zeros; then xor shuffles)
        const int cs = min(p.hd, kQrChunk), nck = CH / cs, nq = cs * G;
        const long long nrow = (long long)gridDim.y * p.L;
        constexpr int MQ = kQrChunk * G / 32 > 0 ? kQrChunk * G / 32 : 1;
        for (int task = w; task < m * nck; task += kBWarps) {
          const int u = task / nck, k2 = task % nck, dc = d0 + k2 * cs;
          const float* src = qb_s + u * kBThreads + k2 * nq;
          float t[MQ];
#pragma unroll
          for (int mm = 0; mm < MQ; ++mm)
            t[mm] = lane + 32 * mm < nq ? src[lane + 32 * mm] : 0.0f;
          float r = lane < cs ? qr_s[u * CH + k2 * cs + lane] : 0.0f;
#pragma unroll
          for (int hw = MQ / 2; hw > 0; hw >>= 1)
#pragma unroll
            for (int mm = 0; mm < hw; ++mm) t[mm] = __fadd_rn(t[mm], t[mm + hw]);
          float q = t[0];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, off));
            r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, off));
          }
          if (lane == 0 && dc < p.D) {
            const long long o =
                ((long long)(dc / cs) * nrow + row0 + t0 + ts + u) * 2;
            p.part_qr[o] = q;
            p.part_qr[o + 1] = r;
          }
        }
      }
      if (k > 0) convert_sub(k - 1);
      __syncthreads();  // red, qr_s and qb_s are read; the next sub-tile
                        // is converted
      cluster_arrive();  // this block's sums of the sub-tile are in
      pend_m = m;
      par ^= 1;
    }
  }
  cluster_wait();
  cluster_sums(par ^ 1, 0, pend_m);
  cluster.sync();  // no block leaves while another reads its sums
  if (live) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if constexpr (!M2) p.part_a[state_at(i)] = dA[i];
      p.dh0[state_at(i)] = carry[i];
    }
  }
}

// out[o][r] = sum over p of part[o][p][r], p = 0, 1, ... in order
template <typename T>
__global__ void __launch_bounds__(256)
reduce_parts_kernel(const float* __restrict__ part, int n_parts,
                    long long n_inner, long long total, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const long long o = i / n_inner, r = i - o * n_inner;
  const float* p = part + o * n_parts * n_inner + r;
  float s = p[0];
  for (int k = 1; k < n_parts; ++k) s = __fadd_rn(s, p[k * n_inner]);
  out[i] = from_f32<T>(s);
}

template <typename T>
int reduce_parts(const float* part, int n_outer, int n_parts,
                 long long n_inner, T* out, cudaStream_t stream) {
  const long long total = (long long)n_outer * n_inner;
  reduce_parts_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, n_parts, n_inner, total, out);
  return (int)cudaGetLastError();
}

// The mamba2 form's heads: one block a head.  For each (b, t) row, q and r
// as the head's chunk sums added in order, ga = q exp(dt a_h), ddt = r +
// ga a_h; da_h = the sum of ga dt over the rows, thread k adding rows k,
// k + 256, ... in order, then a halving tree over the threads.
__global__ void __launch_bounds__(256)
ssd_heads_kernel(const float* __restrict__ part_qr,
                 const float* __restrict__ dt, const float* __restrict__ a_h,
                 long long rows, int nh, int nck, float* __restrict__ ddt,
                 float* __restrict__ da_h) {
  __shared__ float red[256];
  const int h = blockIdx.x, tid = threadIdx.x;
  const float ah = a_h[h];
  float acc = 0.0f;
  for (long long i = tid; i < rows; i += 256) {
    const float* pq = part_qr + ((long long)h * nck * rows + i) * 2;
    float q = pq[0], r = pq[1];
    for (int k = 1; k < nck; ++k) {
      q = __fadd_rn(q, pq[k * rows * 2]);
      r = __fadd_rn(r, pq[k * rows * 2 + 1]);
    }
    const float dtv = dt[i * nh + h];
    const float ga = __fmul_rn(q, expf(__fmul_rn(dtv, ah)));
    ddt[i * nh + h] = __fadd_rn(r, __fmul_rn(ga, ah));
    acc = __fadd_rn(acc, __fmul_rn(ga, dtv));
  }
  red[tid] = acc;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (tid < half) red[tid] = __fadd_rn(red[tid], red[tid + half]);
    __syncthreads();
  }
  if (tid == 0) da_h[h] = red[0];
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// blocks along D before padding, and the cluster size at D channels
template <int S>
void walk_grid(int D, int* nblk, int* cl) {
  constexpr int CH = BwdLayout<float, S, false>::CH;
  const int n = (D + CH - 1) / CH;
  int c = 1;
  while (c < B7B_CLUSTER && c < n) c *= 2;
  *cl = c;
  *nblk = (n + c - 1) / c * c;
}

template <typename T, int S, bool M2, bool WIDE>
int launch_walk(const BwdArgs& p, int bsz, cudaStream_t stream) {
  using Lay = BwdLayout<T, S, M2>;
  constexpr int kBytes = Lay::kBytes;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
  auto kernel = mamba_fused_bwd_kernel<T, S, M2, WIDE>;
  static bool raised[64] = {};  // raise the limit once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = true;
  }
  int nblk = 0, cl = 1;
  walk_grid<S>(p.D, &nblk, &cl);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk, bsz);
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the TMA's bulk copies where every row of xc, gy, B, C (and the
// per-channel dt) and every checkpoint run starts on 16 bytes and is a
// multiple of 16 bytes long, else the element copies; the same kernel
// either way
template <typename T, int S, bool M2>
int launch_walk_as(const BwdArgs& p, int bsz, cudaStream_t stream) {
  if (p.D % (16 / sizeof(T)) == 0 && aligned(p.xc, 16) && aligned(p.bm, 16) &&
      aligned(p.cm, 16) && aligned(p.gy, 16) && aligned(p.ckpt, 16) &&
      (M2 || aligned(p.dt, 16)))
    return launch_walk<T, S, M2, true>(p, bsz, stream);
  return launch_walk<T, S, M2, false>(p, bsz, stream);
}

template <typename T, bool M2>
int launch_walk_s(int s, const BwdArgs& p, int bsz, cudaStream_t stream) {
  switch (s) {
    case 8:
      return launch_walk_as<T, 8, M2>(p, bsz, stream);
    case 16:
      return launch_walk_as<T, 16, M2>(p, bsz, stream);
    case 64:
      return launch_walk_as<T, 64, M2>(p, bsz, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool M2>
int launch_walk_t(int dtype, int s, const BwdArgs& p, int bsz,
                  cudaStream_t stream) {
  if (dtype == 0) return launch_walk_s<float, M2>(s, p, bsz, stream);
  if (dtype == 1) return launch_walk_s<__nv_bfloat16, M2>(s, p, bsz, stream);
  return (int)cudaErrorInvalidValue;
}

// dB and dC from the clusters' partials, in index order
int reduce_db_dc(int dtype, int s, int bsz, int L, int D, const float* part_b,
                 const float* part_c, void* db, void* dc,
                 cudaStream_t stream) {
  int nblk = 0, cl = 1;
  switch (s) {
    case 8: walk_grid<8>(D, &nblk, &cl); break;
    case 16: walk_grid<16>(D, &nblk, &cl); break;
    case 64: walk_grid<64>(D, &nblk, &cl); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int ncl = nblk / cl;
  const long long inner = (long long)L * s;
  int rc;
  if (dtype == 0) {
    rc = reduce_parts<float>(part_b, bsz, ncl, inner, static_cast<float*>(db),
                             stream);
    if (rc != 0) return rc;
    return reduce_parts<float>(part_c, bsz, ncl, inner,
                               static_cast<float*>(dc), stream);
  }
  rc = reduce_parts<__nv_bfloat16>(part_b, bsz, ncl, inner,
                                   static_cast<__nv_bfloat16*>(db), stream);
  if (rc != 0) return rc;
  return reduce_parts<__nv_bfloat16>(part_c, bsz, ncl, inner,
                                     static_cast<__nv_bfloat16*>(dc), stream);
}

// blocks an SM, registers, shared and local (spill) bytes a thread of the
// WIDE walk at (dtype, s, form)
template <typename T, int S, bool M2>
int occupancy_as(int* out) {
  using Lay = BwdLayout<T, S, M2>;
  auto kernel = mamba_fused_bwd_kernel<T, S, M2, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kBThreads, Lay::kBytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks, out[1] = fa.numRegs, out[2] = Lay::kBytes;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

template <typename T, bool M2>
int occupancy_s(int s, int* out) {
  switch (s) {
    case 8: return occupancy_as<T, 8, M2>(out);
    case 16: return occupancy_as<T, 16, M2>(out);
    case 64: return occupancy_as<T, 64, M2>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mamba_scan_bwd(const float* a, const float* hs, const float* h0,
                              const float* g_hs, const float* g_hlast,
                              long long bsz, int L, long long n_ds, float* da,
                              float* db, float* dh0, cudaStream_t stream) {
  const long long total = bsz * n_ds;
  if (total <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kScanThreads - 1) / kScanThreads;
  mamba_scan_bwd_kernel<<<(unsigned)blocks, kScanThreads, 0, stream>>>(
      a, hs, h0, g_hs, g_hlast, n_ds, L, total, da, db, dh0);
  return (int)cudaGetLastError();
}


// B7-bwd's instantiation: {states per thread, threads per block, the
// forward tile it walks, steps per sub-tile, blocks a cluster, blocks an
// SM the registers are held to}; at S = 8 a thread holds min(K, 8) states.
extern "C" void mamba_fused_bwd_config(int* out) {
  out[0] = B7B_K, out[1] = kBThreads, out[2] = kBTile, out[3] = kBSub;
  out[4] = B7B_CLUSTER, out[5] = B7B_MINB;
}

// The partials' second axis (clusters along D) at s states and D channels,
// or -1 for an s without an instantiation.
extern "C" int mamba_fused_bwd_parts(int s, int D) {
  int nblk = 0, cl = 1;
  switch (s) {
    case 8: walk_grid<8>(D, &nblk, &cl); break;
    case 16: walk_grid<16>(D, &nblk, &cl); break;
    case 64: walk_grid<64>(D, &nblk, &cl); break;
    default: return -1;
  }
  return nblk / cl;
}

// out = {blocks an SM, registers a thread, shared bytes a block, local
// bytes a thread} of the walk (dtype 0 = float32, 1 = bfloat16; m2: the
// mamba2 form).
extern "C" int mamba_fused_bwd_occupancy(int dtype, int s, int m2, int* out) {
  if (dtype == 0)
    return m2 ? occupancy_s<float, true>(s, out)
              : occupancy_s<float, false>(s, out);
  if (dtype == 1)
    return m2 ? occupancy_s<__nv_bfloat16, true>(s, out)
              : occupancy_s<__nv_bfloat16, false>(s, out);
  return (int)cudaErrorInvalidValue;
}

// The per-channel form.  dtype: 0 = float32, 1 = bfloat16 (of xc, b, c and
// of dxc, db, dc); s: 8, 16 or 64; tile: the forward's checkpoint spacing
// (must be B7_TILE); g_hlast may be null (zero).  part_b and part_c hold
// (B, mamba_fused_bwd_parts(s, D), L, S) floats, part_a (B, D, S).  Four
// launches on the stream: the walk, then the three sums.
extern "C" int mamba_fused_bwd(int dtype, int s, int tile, const float* dt,
                               const void* xc, const void* b, const void* c,
                               const float* a_mat, const float* ckpt,
                               const float* gy, const float* g_hlast, int bsz,
                               int L, int D, float* ddt, void* dxc, void* db,
                               void* dc, float* da_mat, float* dh0,
                               float* part_b, float* part_c, float* part_a,
                               cudaStream_t stream) {
  if (bsz <= 0 || L <= 0 || D <= 0 || bsz > 65535 || tile != kBTile)
    return (int)cudaErrorInvalidValue;
  const BwdArgs p{dt,     xc,     b,      c,      a_mat, ckpt,
                  gy,     g_hlast, ddt,   dxc,    dh0,   part_b,
                  part_c, part_a, nullptr, L,     D,     0,
                  0};
  int rc = launch_walk_t<false>(dtype, s, p, bsz, stream);
  if (rc != 0) return rc;
  rc = reduce_db_dc(dtype, s, bsz, L, D, part_b, part_c, db, dc, stream);
  if (rc != 0) return rc;
  return reduce_parts<float>(part_a, 1, bsz, (long long)D * s, da_mat,
                             stream);
}

// The mamba2 form: dt (B, L, nh) f32, xh (B, L, nh * hd), b, c (B, L, s),
// a_h (nh,) f32, ckpt (B, ceil(L / tile), nh * hd, s), gy (B, L, nh * hd)
// f32, g_hlast (B, nh * hd, s) or null -> ddt (B, L, nh) f32, dxh like xh,
// db, dc like b, da_h (nh,) f32, dh0 (B, nh * hd, s) f32.  hd is a power of
// two.  part_b and part_c as the per-channel form's; part_qr holds
// (nh * hd / min(hd, 16), B * L, 2) floats.  Four launches: the walk, the
// sums of dB and dC, the heads.
extern "C" int mamba_ssd_bwd(int dtype, int s, int tile, const float* dt,
                             const void* xh, const void* b, const void* c,
                             const float* a_h, const float* ckpt,
                             const float* gy, const float* g_hlast, int bsz,
                             int L, int nh, int hd, float* ddt, void* dxh,
                             void* db, void* dc, float* da_h, float* dh0,
                             float* part_b, float* part_c, float* part_qr,
                             cudaStream_t stream) {
  if (bsz <= 0 || L <= 0 || nh <= 0 || hd < kMinHd || (hd & (hd - 1)) != 0 ||
      bsz > 65535 || tile != kBTile || (long long)nh * hd > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int D = nh * hd;
  const BwdArgs p{dt,     xh,     b,      c,       a_h, ckpt,
                  gy,     g_hlast, ddt,   dxh,     dh0, part_b,
                  part_c, nullptr, part_qr, L,     D,   nh,
                  hd};
  int rc = launch_walk_t<true>(dtype, s, p, bsz, stream);
  if (rc != 0) return rc;
  rc = reduce_db_dc(dtype, s, bsz, L, D, part_b, part_c, db, dc, stream);
  if (rc != 0) return rc;
  const int cs = hd < kQrChunk ? hd : kQrChunk;
  ssd_heads_kernel<<<nh, 256, 0, stream>>>(part_qr, dt, a_h,
                                           (long long)bsz * L, nh, hd / cs,
                                           ddt, da_h);
  return (int)cudaGetLastError();
}
