// B6 and B7: the Mamba1 diagonal recurrence h_t = a_t * h_{t-1} + b_t.
//
// B6 (mamba_scan_fwd) replaces src/repro/kernels/mamba_scan/kernel.py::
// _scan_kernel: a, b (B, L, D, S) and h0 (B, D, S) float32 -> every state
// hs (B, L, D, S) and h_last (B, D, S).
//
// B7 (mamba_fused_fwd) replaces src/repro/kernels/mamba_scan/fused.py::
// _fused_kernel: it builds a = exp(dt * A) and bx = (dt * xc) * B itself
// from dt, xc (B, L, D), B, C (B, L, S) and A (D, S), runs the recurrence
// from h0 (zero when none is given) and emits only y = sum_s h * C
// (B, L, D) and h_last (B, D, S).  xc, B and C are float32 or bfloat16
// (the model's activations), cast to float32 on load.  Asked for them (a
// call that needs a gradient), it also writes the state at the start of
// each tile, ckpt (B, ceil(L / B7_TILE), D, S) float32, which B7-bwd
// (csrc/mamba_scan_bwd.cu) walks back from; the stores change nothing
// else, so y and h_last are the same bits with and without them.  S is 8 or 16
// (Mamba1, falcon-mamba) or 64 (Mamba2 / SSD, zamba2: the port's
// models/mamba.fused_chunked_scan_m2 hands B7 a head's dt and decay
// repeated over the head's channels, so the SSD scan is this function).
//
// Bound on an H100.  B6 moves 3 * B*L*D*S floats and does 2 flops per
// element: bytes (~0.96 ms at B=1, L=2048, D=8192, S=16).  B7 moves only
// O(L*(D + S)) bytes (0.0127 ms at L=517); per (t, d, s) it does one
// exponential and ~6 flops, so its bound is the exponentials at the
// special-function units' 4.18e12/s (132 SMs x 16 lanes x 1.98 GHz: 0.0162
// ms at (1, 517, 8192, 16)), then the bytes.  What limits it is instruction
// issue: expf without fast-math is 8 instructions (5 f32, a shift, one
// MUFU.EX2, a multiply), so with dt*A, dx*B, a*h, + bx and h*C an element
// needs ~13 issue slots of the SM's four warp instructions a clock, and at
// B = 1, D = 8192 there are only 32,768 lanes (8 warps an SM) to hide the
// latencies between them.
//
// Design.  The TPU kernels walk sequence chunks in order on one core, a
// log-depth doubling scan inside each chunk.  Here the recurrence is
// independent per (batch, d, s), so each state is walked t = 0..L-1 in a
// register and no state crosses a block.  The chunk and block_d of the
// reference have no meaning on the card.
//  - B6: one thread per (batch, d, s); adjacent threads take adjacent
//    (d, s), so each time step is one coalesced row of a, b and hs; the
//    loads of 8 steps are issued before their products, so each warp keeps
//    16 loads in flight.
//  - B7 before (PR 15): one thread per state, the S states of a channel on
//    S lanes.  Every step paid four shared-memory loads, one exponential
//    and a log2(S)-step shuffle tree per state: ~8 instructions on the
//    shared-memory/shuffle pipe per element, which issues about one warp
//    instruction a clock per SM; and each 64-step tile was loaded between
//    two barriers, so no load overlapped the walk.
//  - B7 now: K states per thread (B7_K, at most S) and a channel on
//    G = S / K adjacent lanes, lane j holding the states j, j+G, j+2G, ...:
//    the first log2(K) levels of fused.state_sum's pairwise halving pair
//    states inside one thread and are register adds in that order; only
//    the last log2(G) are xor shuffles.  A step of K states costs one
//    8-byte load of (dt, dt*xc), one 16-byte load each of four B and four
//    C (staged as float32, permuted so that a lane's K states are
//    contiguous) and log2(G) shuffles: ~1.5 shared/shuffle instructions per
//    element instead of ~8.  U steps are in flight (B7_U): their
//    exponentials and dt*xc*B products are issued first, then the K
//    dependent h chains, then the U sums; and the groups of U steps are
//    software-pipelined, group g's shuffles issued among group g + 1's
//    loads and exponentials.  The walk has no branch and no global memory
//    access: every lane writes y to shared memory.
//  - Tiles of B7_TILE steps.  While tile i is walked, tile i + 1's rows of
//    dt, xc, B and C arrive in an area of their own through 16-byte
//    cp.async copies, which hold no registers and are waited for only
//    after the walk.  Then, between two barriers, the block converts them
//    into the walked layout and copies tile i's y rows out in 16-byte
//    stores.  Where the rows do not start on 16 bytes (D % 4 for float32
//    xc, D % 8 for bfloat16, or an unaligned base), the same kernel copies
//    one element at a time through registers instead: one template, two
//    instantiations, chosen at launch.
//  - At S = 64 and the defaults (K = 4, 256 threads) a channel is G = 16
//    lanes and a block CH = 16 channels: 86 KB of shared memory a block
//    for float32 xc, 67 KB for bfloat16, above the 48 KB default, so the
//    launcher raises the limit, as for the larger tiles at S = 16.  A
//    variant whose layout cannot hold 64 states (a channel wider than a
//    warp, or fewer than 8 channels a block) returns cudaErrorInvalidValue
//    at S = 64 instead of being built.
//
// Rounding.  Every product and sum is __fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA and each step rounds as the plain torch
// versions (ref.scan_ref, fused.fused_mamba_scan_plain) round it: h is
// __fadd_rn(__fmul_rn(a, h), bx), dt*xc one __fmul_rn, the exponential
// expf (never ex2.approx or fast-math: a relative error of 1e-7 in a_t
// builds up over the ~1/(1-a) steps a state remembers), and y is summed
// in the pairwise order of fused.state_sum.  B6 is therefore bitwise its
// plain version, and so is B7 wherever expf rounds as torch.exp on the
// card does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kScanThreads)
mamba_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, long long n_ds, int L,
                  long long total, float* __restrict__ hs,
                  float* __restrict__ h_last) {
  const long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= total) return;  // total = B * D * S
  const long long bi = i / n_ds;
  const long long base = bi * (long long)L * n_ds + (i - bi * n_ds);
  float h = h0[i];
  int t = 0;
  for (; t + kUnroll <= L; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)(t + u) * n_ds;
      av[u] = __ldg(a + off);
      bv[u] = __ldg(b + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hs[base + (long long)(t + u) * n_ds] = h;
    }
  }
  for (; t < L; ++t) {
    const long long off = base + (long long)t * n_ds;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(b + off));
    hs[off] = h;
  }
  h_last[i] = h;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// B7's instantiation, chosen by a sweep on the card (kernels/mamba_scan/
// sweep_b7.py builds this file with other values through -D).
#ifndef B7_K
#define B7_K 4  // states per thread (at most S)
#endif
#ifndef B7_U
#define B7_U 4  // time steps in flight
#endif
#ifndef B7_THREADS
#define B7_THREADS 256  // threads per block
#endif
#ifndef B7_TILE
#define B7_TILE 64  // time steps per tile
#endif
constexpr int kFThreads = B7_THREADS;
constexpr int kFTile = B7_TILE;
constexpr int kFU = B7_U;
static_assert(kFTile % kFU == 0, "a tile holds whole groups of U steps");

template <typename T, int W>
struct alignas(W * sizeof(T)) Pack {
  T v[W];
};

// One channel's S states on G = S / K adjacent lanes: lane j holds the
// states j, j + G, ..., j + (K - 1) G, so the first log2(K) levels of
// fused.state_sum's halving (s + s + S/2, then s + s + S/4, ...) are adds
// inside the thread and only the last log2(G) are xor shuffles.
template <int S>
struct FusedLayout {
  static constexpr int K = B7_K < S ? B7_K : S;
  static constexpr int G = S / K;
  static constexpr int CH = kFThreads / G;  // channels per block
  // the walked tile, in floats: (dt, dt*xc) pairs [TILE][CH][2], y
  // [TILE][CH], then per step B and C (2S), permuted so that lane j's K
  // states sit at j*K ..
  static constexpr int kTile = kFTile * (3 * CH + 2 * S);
  // whether this instantiation lays out S states: a channel's lanes inside
  // one warp, and whole 16-byte rows of bf16 xc a block (with few threads
  // a block and few states a lane, S = 64 does not fit)
  static constexpr bool kOk = S % K == 0 && 32 % G == 0 && CH % 8 == 0;
};

// The next tile's rows as they arrive, in floats: dt [TILE][CH], xc
// [TILE][CH] and B|C [TILE][2S] in their own type.
template <typename T, int S>
struct ArrivalLayout {
  static constexpr int CH = FusedLayout<S>::CH;
  static constexpr int kXc = kFTile * CH;                          // xc at
  static constexpr int kBc = kXc + kFTile * CH * (int)sizeof(T) / 4;  // B|C
  static constexpr int kSize = kBc + kFTile * 2 * S * (int)sizeof(T) / 4;
  static constexpr int kBytes = (FusedLayout<S>::kTile + kSize) * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the rows of the tile at t0 into the arrival area: dt and xc of the
// block's CH channels, B and C of all S states.  WIDE: 16-byte cp.async
// copies that run on while the current tile is walked (rows of dt, xc, B,
// C start on 16 bytes).  Otherwise one element at a time through
// registers.  Rows past L and channels past D are not copied.
template <typename T, int S, bool WIDE>
__device__ __forceinline__ void copy_tile(
    float* __restrict__ arr, const float* __restrict__ dt,
    const T* __restrict__ xc, const T* __restrict__ bm,
    const T* __restrict__ cm, long long row0, int t0, int L, int D, int d0,
    int tid) {
  using Arr = ArrivalLayout<T, S>;
  constexpr int CH = Arr::CH;
  constexpr int VD = WIDE ? 4 : 1, VX = WIDE ? 16 / (int)sizeof(T) : 1;
  float* dt_a = arr;
  T* xc_a = reinterpret_cast<T*>(arr + Arr::kXc);
  T* bc_a = reinterpret_cast<T*>(arr + Arr::kBc);
#pragma unroll
  for (int v = tid; v < kFTile * CH / VD; v += kFThreads) {
    const int r = v / (CH / VD), col = (v % (CH / VD)) * VD;
    if (t0 + r < L && d0 + col < D) {
      const long long off = (row0 + t0 + r) * D + d0 + col;
      if constexpr (WIDE)
        cp_async16(dt_a + r * CH + col, dt + off);
      else
        dt_a[r * CH + col] = dt[off];
    }
  }
#pragma unroll
  for (int v = tid; v < kFTile * CH / VX; v += kFThreads) {
    const int r = v / (CH / VX), col = (v % (CH / VX)) * VX;
    if (t0 + r < L && d0 + col < D) {
      const long long off = (row0 + t0 + r) * D + d0 + col;
      if constexpr (WIDE)
        cp_async16(xc_a + r * CH + col, xc + off);
      else
        xc_a[r * CH + col] = xc[off];
    }
  }
#pragma unroll
  for (int v = tid; v < kFTile * 2 * S / VX; v += kFThreads) {
    const int r = v / (2 * S / VX), q = (v % (2 * S / VX)) * VX;
    if (t0 + r < L) {
      const T* src = (q < S ? bm : cm) + (row0 + t0 + r) * S + q % S;
      if constexpr (WIDE)
        cp_async16(bc_a + r * 2 * S + q, src);
      else
        bc_a[r * 2 * S + q] = *src;
    }
  }
}

// The arrived tile into the walked layout: (dt, dt*xc) pairs, dt*xc
// rounded once (__fmul_rn), and B and C as float32 in the permuted order.
// Rows and channels that were not copied are converted too and never read.
template <typename T, int S>
__device__ __forceinline__ void convert_tile(float* __restrict__ tile,
                                             const float* __restrict__ arr,
                                             int tid) {
  using Lay = FusedLayout<S>;
  using Arr = ArrivalLayout<T, S>;
  constexpr int CH = Lay::CH;
  const T* xc_a = reinterpret_cast<const T*>(arr + Arr::kXc);
  const T* bc_a = reinterpret_cast<const T*>(arr + Arr::kBc);
  float2* dd_s = reinterpret_cast<float2*>(tile);
  float* bc_s = tile + 3 * kFTile * CH;
#pragma unroll
  for (int v = tid; v < kFTile * CH / 4; v += kFThreads) {
    const int i = v * 4;  // = r * CH + col
    const Pack<float, 4> d4 = *reinterpret_cast<const Pack<float, 4>*>(arr + i);
    const Pack<T, 4> x4 = *reinterpret_cast<const Pack<T, 4>*>(xc_a + i);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dd_s[i + e] =
          make_float2(d4.v[e], __fmul_rn(d4.v[e], to_f32(x4.v[e])));
  }
#pragma unroll
  for (int v = tid; v < kFTile * 2 * S / 4; v += kFThreads) {
    const int r = v / (2 * S / 4), q = (v % (2 * S / 4)) * 4;
    const Pack<T, 4> b4 =
        *reinterpret_cast<const Pack<T, 4>*>(bc_a + r * 2 * S + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = (q + e) % S;  // the state; B below column S, C above
      bc_s[r * 2 * S + (q + e - s) + (s % Lay::G) * Lay::K + s / Lay::G] =
          to_f32(b4.v[e]);
    }
  }
}

// The walked tile's y rows t0 .. t0 + n - 1 to y, W floats a copy.
template <int S, int W>
__device__ __forceinline__ void store_y(const float* __restrict__ tile,
                                        float* __restrict__ y, long long row0,
                                        int t0, int n, int D, int d0,
                                        int tid) {
  constexpr int CH = FusedLayout<S>::CH;
  const float* y_s = tile + 2 * kFTile * CH;
#pragma unroll
  for (int v = tid; v < kFTile * CH / W; v += kFThreads) {
    const int r = v / (CH / W), col = (v % (CH / W)) * W;
    if (r < n && d0 + col < D)
      *reinterpret_cast<Pack<float, W>*>(y + (row0 + t0 + r) * D + d0 + col) =
          *reinterpret_cast<const Pack<float, W>*>(y_s + r * CH + col);
  }
}

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

// Steps tt .. tt + NU - 1 of the walked tile up to their y sums: every
// step's exponentials and dt*xc*B products first (they do not depend on
// h), then the K dependent h chains, then each step's log2(K) levels of
// adds inside the thread.  One 8-byte load brings a step's dt and dt*xc,
// one 16-byte load each four of its B and C.
template <int S, int NU>
__device__ __forceinline__ void walk_steps(
    const float* __restrict__ tile, int tt, int c, int j,
    const float (&A)[FusedLayout<S>::K], float (&h)[FusedLayout<S>::K],
    float (&sum)[NU]) {
  using Lay = FusedLayout<S>;
  constexpr int K = Lay::K, CH = Lay::CH;
  const float2* dd_s = reinterpret_cast<const float2*>(tile);
  const float* bc_s = tile + 3 * kFTile * CH;
  float a[NU][K], bx[NU][K], p[NU][K];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const float2 dd = dd_s[(tt + u) * CH + c];
    const float dtv = dd.x, dxv = dd.y;
    load_k<K>(bc_s + (tt + u) * 2 * S + j * K, bx[u]);     // B
    load_k<K>(bc_s + (tt + u) * 2 * S + S + j * K, p[u]);  // C
#pragma unroll
    for (int i = 0; i < K; ++i) {
      a[u][i] = expf(__fmul_rn(dtv, A[i]));
      bx[u][i] = __fmul_rn(dxv, bx[u][i]);
    }
  }
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int i = 0; i < K; ++i) {
      h[i] = __fadd_rn(__fmul_rn(a[u][i], h[i]), bx[u][i]);
      p[u][i] = __fmul_rn(h[i], p[u][i]);
    }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int w = K / 2; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) p[u][i] = __fadd_rn(p[u][i], p[u][i + w]);
    sum[u] = p[u][0];
  }
}

// The last log2(G) levels of those sums, xor shuffles within the channel's
// lanes, each level for all NU steps at once; every lane of the channel
// then writes y of steps tt .. tt + NU - 1 to the walked tile.
template <int S, int NU>
__device__ __forceinline__ void sum_steps(float* __restrict__ tile, int tt,
                                          int c, float (&sum)[NU]) {
  using Lay = FusedLayout<S>;
  float* y_s = tile + 2 * kFTile * Lay::CH;
#pragma unroll
  for (int off = Lay::G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < NU; ++u)
      sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(0xffffffffu, sum[u], off));
#pragma unroll
  for (int u = 0; u < NU; ++u) y_s[(tt + u) * Lay::CH + c] = sum[u];
}

// One block: CH channels of one sequence, G lanes each, walking all of L
// tile by tile.  Tile i + 1's rows arrive in their own area while tile i
// is walked; two barriers a tile.
template <typename T, int S, bool WIDE>
__global__ void __launch_bounds__(kFThreads)
mamba_fused_kernel(const float* __restrict__ dt, const T* __restrict__ xc,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ a_mat,
                   const float* __restrict__ h0, int L, int D,
                   float* __restrict__ y, float* __restrict__ h_last,
                   float* __restrict__ ckpt) {
  using Lay = FusedLayout<S>;
  static_assert(Lay::kOk, "B7 layout");
  constexpr int K = Lay::K, G = Lay::G;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* arr = smem + Lay::kTile;
  const int tid = threadIdx.x, c = tid / G, j = tid % G;
  const int d0 = blockIdx.x * Lay::CH, d = d0 + c;
  const bool live = d < D;
  const long long row0 = (long long)blockIdx.y * L;  // (batch, t = 0)
  const long long hidx = ((long long)blockIdx.y * D + d) * S + j;
  float A[K], h[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    A[i] = live ? a_mat[(long long)d * S + j + i * G] : 0.0f;
    h[i] = (live && h0 != nullptr) ? h0[hidx + i * G] : 0.0f;
  }
  copy_tile<T, S, WIDE>(arr, dt, xc, bm, cm, row0, 0, L, D, d0, tid);
  cp_async_wait_all();
  __syncthreads();
  convert_tile<T, S>(tile, arr, tid);
  __syncthreads();
  const int n_tiles = (L + kFTile - 1) / kFTile;
  for (int t0 = 0; t0 < L; t0 += kFTile) {
    const int n = min(kFTile, L - t0);
    const bool more = t0 + kFTile < L;
    if (ckpt != nullptr && live) {  // the state before step t0
      const long long at =
          (((long long)blockIdx.y * n_tiles + t0 / kFTile) * D + d) * S + j;
#pragma unroll
      for (int i = 0; i < K; ++i) ckpt[at + i * G] = h[i];
    }
    // the arrival area was last read by the conversion before the
    // previous barrier
    if (more)
      copy_tile<T, S, WIDE>(arr, dt, xc, bm, cm, row0, t0 + kFTile, L, D, d0,
                            tid);
    // software-pipelined over groups of U steps: group g's shuffles are
    // issued among group g + 1's loads, exponentials and chains
    int tt = 0;
    if (n >= kFU) {
      float pend[kFU];
      walk_steps<S, kFU>(tile, 0, c, j, A, h, pend);
#pragma unroll 1
      for (tt = kFU; tt + kFU <= n; tt += kFU) {
        float cur[kFU];
        walk_steps<S, kFU>(tile, tt, c, j, A, h, cur);
        sum_steps<S, kFU>(tile, tt - kFU, c, pend);
#pragma unroll
        for (int u = 0; u < kFU; ++u) pend[u] = cur[u];
      }
      sum_steps<S, kFU>(tile, tt - kFU, c, pend);
    }
#pragma unroll 1
    for (; tt < n; ++tt) {
      float sum[1];
      walk_steps<S, 1>(tile, tt, c, j, A, h, sum);
      sum_steps<S, 1>(tile, tt, c, sum);
    }
    cp_async_wait_all();
    __syncthreads();  // tile i + 1 has arrived; every lane has walked tile i
    if (more) convert_tile<T, S>(tile, arr, tid);
    store_y<S, WIDE ? 4 : 1>(tile, y, row0, t0, n, D, d0, tid);
    __syncthreads();  // tile i + 1 is walkable; tile i's y is out
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < K; ++i) h_last[hidx + i * G] = h[i];
  }
}

template <typename T, int S, bool WIDE>
int launch_fused_as(const float* dt, const void* xc, const void* b,
                    const void* c, const float* a_mat, const float* h0,
                    int bsz, int L, int D, float* y, float* h_last,
                    float* ckpt, cudaStream_t stream) {
  constexpr int kBytes = ArrivalLayout<T, S>::kBytes;
  auto kernel = mamba_fused_kernel<T, S, WIDE>;
  if (kBytes > 232448) return (int)cudaErrorInvalidValue;  // > 227 KB
  if (kBytes > 48 * 1024) {  // raise the limit once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !raised[dev]) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) raised[dev] = true;
    }
  }
  const dim3 grid((D + FusedLayout<S>::CH - 1) / FusedLayout<S>::CH, bsz);
  kernel<<<grid, kFThreads, kBytes, stream>>>(
      dt, static_cast<const T*>(xc), static_cast<const T*>(b),
      static_cast<const T*>(c), a_mat, h0, L, D, y, h_last, ckpt);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// the 16-byte copies where every row of dt, xc, B, C and y starts on 16
// bytes (D % 4 == 0 for float32 xc, D % 8 == 0 for bfloat16, and aligned
// bases), else the element copies; the same kernel either way
template <typename T, int S>
int launch_fused(const float* dt, const void* xc, const void* b,
                 const void* c, const float* a_mat, const float* h0, int bsz,
                 int L, int D, float* y, float* h_last, float* ckpt,
                 cudaStream_t stream) {
  if constexpr (!FusedLayout<S>::kOk) {
    return (int)cudaErrorInvalidValue;  // see FusedLayout::kOk
  } else {
    if (D % (16 / sizeof(T)) == 0 && aligned(dt, 16) && aligned(xc, 16) &&
        aligned(b, 16) && aligned(c, 16) && aligned(y, 16))
      return launch_fused_as<T, S, true>(dt, xc, b, c, a_mat, h0, bsz, L, D,
                                         y, h_last, ckpt, stream);
    return launch_fused_as<T, S, false>(dt, xc, b, c, a_mat, h0, bsz, L, D, y,
                                        h_last, ckpt, stream);
  }
}

}  // namespace

extern "C" int mamba_scan_fwd(const float* a, const float* b, const float* h0,
                              long long bsz, int L, long long n_ds,
                              float* hs, float* h_last, cudaStream_t stream) {
  const long long total = bsz * n_ds;
  if (total <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kScanThreads - 1) / kScanThreads;
  mamba_scan_kernel<<<(unsigned)blocks, kScanThreads, 0, stream>>>(
      a, b, h0, n_ds, L, total, hs, h_last);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (of xc, b and c); s: 8, 16 or 64;
// ckpt: the tile checkpoints, or null for none.
// B7's instantiation: {states per thread, steps in flight, threads per
// block, steps per tile}; at S = 8 a thread holds min(K, 8) states.
extern "C" void mamba_fused_config(int* out) {
  out[0] = B7_K, out[1] = B7_U, out[2] = B7_THREADS, out[3] = B7_TILE;
}

template <typename T>
int launch_fused_s(int s, const float* dt, const void* xc, const void* b,
                   const void* c, const float* a_mat, const float* h0,
                   int bsz, int L, int D, float* y, float* h_last,
                   float* ckpt, cudaStream_t stream) {
  switch (s) {
    case 8:
      return launch_fused<T, 8>(dt, xc, b, c, a_mat, h0, bsz, L, D, y, h_last,
                                ckpt, stream);
    case 16:
      return launch_fused<T, 16>(dt, xc, b, c, a_mat, h0, bsz, L, D, y,
                                 h_last, ckpt, stream);
    case 64:  // mamba2 (zamba2): d_state 64
      return launch_fused<T, 64>(dt, xc, b, c, a_mat, h0, bsz, L, D, y,
                                 h_last, ckpt, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mamba_fused_fwd(int dtype, int s, const float* dt,
                               const void* xc, const void* b, const void* c,
                               const float* a_mat, const float* h0, int bsz,
                               int L, int D, float* y, float* h_last,
                               float* ckpt, cudaStream_t stream) {
  if (bsz <= 0 || L <= 0 || D <= 0 || bsz > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fused_s<float>(s, dt, xc, b, c, a_mat, h0, bsz, L, D, y,
                                 h_last, ckpt, stream);
  if (dtype == 1)
    return launch_fused_s<__nv_bfloat16>(s, dt, xc, b, c, a_mat, h0, bsz, L,
                                         D, y, h_last, ckpt, stream);
  return (int)cudaErrorInvalidValue;
}
