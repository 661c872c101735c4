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
// B7-bwd (mamba_fused_bwd): the gradient of B7, the fused scan
//     a_t = exp(dt_t A), bx_t = (dt_t xc_t) B_t, h_t = a_t h_{t-1} + bx_t,
//     y_t = sum_s h_t C_t.
// Given gy (B, L, D) and g_hlast (B, D, S) or null, with the adjoint
//     lam_t = gy_t C_t + a_{t+1} lam_{t+1}   (g_hlast in place of a_L lam_L)
// and ga_t = (lam_t h_{t-1}) a_t, the gradient of dt_t A, it returns
//     ddt_t = state_sum(lam_t B_t) xc_t + state_sum(ga_t A)   (B, L, D) f32
//     dxc_t = state_sum(lam_t B_t) dt_t                      (B, L, D)
//     dB_t = sum_d lam_t (dt_t xc_t), dC_t = sum_d gy_t h_t  (B, L, S)
//     dA = sum_b sum_t ga_t dt_t                            (D, S) f32
//     dh0 = a_0 lam_0                                       (B, D, S) f32
// xc, B, C and their gradients are float32 or bfloat16; every sum is f32.
// This is fused.fused_mamba_scan_plain_bwd's arithmetic.
//
// Bound: one exponential per (t, d, s) at the special-function units'
// 4.18e12/s, as B7's (0.257 ms at (4, 2048, 8192, 16), 0.642 ms at
// (4, 2048, 5120, 64)); the bytes (dt, xc, gy, B, C, the checkpoints read,
// the gradients written) take less.
//
// Design.  B7's forward, asked for them, writes the state at the start of
// each of its tiles of B7_TILE steps (ckpt, (B, ceil(L / T), D, S) f32).
// A block here takes CH channels of one sequence, a channel's S states on
// G = S / K lanes (K = B7B_K states a lane, lane j holding j, j + G, ...:
// B7's layout, so the sums over the states are register adds and then xor
// shuffles in fused.state_sum's order).  It walks the tiles from the last:
//  - from the tile's checkpoint it recomputes the tile's states forward,
//    keeping the state at the start of each sub-tile of kBSub steps in
//    shared memory (each thread its own column, so no barrier);
//  - for each sub-tile from the last it recomputes the kBSub states and
//    decays into registers (fully unrolled, so they stay registers), then
//    walks lam back through them;
//  - every step it writes ddt and dxc for its channel (one lane) and sums
//    its share of dB_t and dC_t over the warp's channels by xor shuffles;
//    each warp's sums go to shared memory, and after the sub-tile, between
//    two barriers, the block adds its warps' sums in warp order and writes
//    them as the block's partial (B, blocks, L, S).
// Determinism: no float atomics.  A second kernel adds the blocks' partials
// of dB and dC, and the batches' partials of dA, one after another in
// index order.  Two runs give the same bits.
// Inputs are read with plain loads (the tile's recompute, the sub-tile's,
// the walk back; all but the first mostly from L1 and L2).  The
// exponentials are issued twice per element, by the two recomputes (the
// walk back reuses the sub-tile's decays): twice the bound's count, plus
// the forward's own.
//
// Rounding: __fmul_rn / __fadd_rn throughout and expf (never fast-math), as
// B7's forward, so the recomputed states are B7's own bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kBTile = B7_TILE;
constexpr int kBSub = 8;  // steps per sub-tile
static_assert(kBTile % kBSub == 0, "a tile holds whole sub-tiles");
constexpr int kBSubs = kBTile / kBSub;

template <int S>
struct BwdLayout {
  static constexpr int K = B7B_K < S ? B7B_K : S;
  static constexpr int G = S / K;           // lanes a channel
  static constexpr int CH = kBThreads / G;  // channels a block
  static_assert(S % K == 0 && 32 % G == 0, "a channel inside one warp");
  // shared memory, in floats: the sub-tile states [kBSubs][K][threads],
  // then the warps' sums of dB and of dC, each [kBSub][warps][S]
  static constexpr int kRed = kBSub * kBWarps * S;
  static constexpr int kBytes = (kBSubs * K * kBThreads + 2 * kRed) * 4;
};

template <typename T, int K>
__device__ __forceinline__ void load_states(const T* __restrict__ p, int j,
                                            int G, float (&out)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = to_f32(p[j + i * G]);
}

template <typename T, int S>
__global__ void __launch_bounds__(kBThreads)
mamba_fused_bwd_kernel(const float* __restrict__ dt, const T* __restrict__ xc,
                       const T* __restrict__ bm, const T* __restrict__ cm,
                       const float* __restrict__ a_mat,
                       const float* __restrict__ ckpt,
                       const float* __restrict__ gy,
                       const float* __restrict__ g_hlast, int L, int D,
                       float* __restrict__ ddt, T* __restrict__ dxc,
                       float* __restrict__ part_b, float* __restrict__ part_c,
                       float* __restrict__ part_a, float* __restrict__ dh0) {
  using Lay = BwdLayout<S>;
  constexpr int K = Lay::K, G = Lay::G;
  extern __shared__ __align__(16) float smem[];
  float* sub_h = smem;                           // [kBSubs][K][threads]
  float* red_b = smem + kBSubs * K * kBThreads;  // [kBSub][warps][S]
  float* red_c = red_b + Lay::kRed;
  const int tid = threadIdx.x, c = tid / G, j = tid % G;
  const int w = tid / 32, lane = tid % 32;
  const int d = blockIdx.x * Lay::CH + c;
  const bool live = d < D;
  const int bi = blockIdx.y;
  const long long row0 = (long long)bi * L;  // (batch, t = 0)
  const long long hidx = ((long long)bi * D + d) * S + j;
  const int n_tiles = (L + kBTile - 1) / kBTile;
  float A[K], carry[K], dA[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    A[i] = live ? a_mat[(long long)d * S + j + i * G] : 0.0f;
    carry[i] = (live && g_hlast != nullptr) ? g_hlast[hidx + i * G] : 0.0f;
    dA[i] = 0.0f;
  }
  // a dead channel (d >= D) reads zeros: its states, adjoints and shares
  // of the sums are all zero
  auto step_in = [&](int t, float& dtv, float& xcv, float (&bv)[K]) {
    const long long r = row0 + t;
    dtv = live ? dt[r * D + d] : 0.0f;
    xcv = live ? to_f32(xc[r * D + d]) : 0.0f;
    load_states<T, K>(bm + r * S, j, G, bv);
  };
#pragma unroll 1
  for (int ti = n_tiles - 1; ti >= 0; --ti) {
    const int t0 = ti * kBTile, n = min(kBTile, L - t0);
    // the tile's states forward from its checkpoint; each sub-tile's
    // first state to shared memory
    float h[K];
    const long long at = (((long long)bi * n_tiles + ti) * D + d) * S + j;
#pragma unroll
    for (int i = 0; i < K; ++i) h[i] = live ? ckpt[at + i * G] : 0.0f;
#pragma unroll 1
    for (int k = 0; k * kBSub < n; ++k) {
#pragma unroll
      for (int i = 0; i < K; ++i) sub_h[(k * K + i) * kBThreads + tid] = h[i];
      // (the last sub-tile's steps are walked below, not here)
      if ((k + 1) * kBSub < n) {
#pragma unroll
        for (int u = 0; u < kBSub; ++u) {  // unrolled: loads issue early
          float dtv, xcv, bv[K];
          step_in(t0 + k * kBSub + u, dtv, xcv, bv);
          const float dx = __fmul_rn(dtv, xcv);
#pragma unroll
          for (int i = 0; i < K; ++i)
            h[i] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dtv, A[i])), h[i]),
                             __fmul_rn(dx, bv[i]));
        }
      }
    }
    // the sub-tiles from the last
#pragma unroll 1
    for (int k = (n - 1) / kBSub; k >= 0; --k) {
      const int ts = t0 + k * kBSub, m = min(kBSub, n - k * kBSub);
      float hist[kBSub + 1][K], dec[kBSub][K];
#pragma unroll
      for (int i = 0; i < K; ++i)
        hist[0][i] = sub_h[(k * K + i) * kBThreads + tid];
#pragma unroll
      for (int u = 0; u < kBSub; ++u) {
        if (u < m) {
          float dtv, xcv, bv[K];
          step_in(ts + u, dtv, xcv, bv);
          const float dx = __fmul_rn(dtv, xcv);
#pragma unroll
          for (int i = 0; i < K; ++i) {
            dec[u][i] = expf(__fmul_rn(dtv, A[i]));
            hist[u + 1][i] = __fadd_rn(__fmul_rn(dec[u][i], hist[u][i]),
                                       __fmul_rn(dx, bv[i]));
          }
        }
      }
#pragma unroll
      for (int u = kBSub - 1; u >= 0; --u) {
        if (u < m) {
          const int t = ts + u;
          float dtv, xcv, bv[K], cv[K];
          step_in(t, dtv, xcv, bv);
          load_states<T, K>(cm + (row0 + t) * S, j, G, cv);
          const float gyv = live ? gy[(row0 + t) * D + d] : 0.0f;
          const float dx = __fmul_rn(dtv, xcv);
          float pb[K], pa[K], cb[K], cc[K];
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const float lam = __fadd_rn(__fmul_rn(gyv, cv[i]), carry[i]);
            const float ga = __fmul_rn(__fmul_rn(lam, hist[u][i]), dec[u][i]);
            dA[i] = __fadd_rn(dA[i], __fmul_rn(ga, dtv));
            pb[i] = __fmul_rn(lam, bv[i]);
            pa[i] = __fmul_rn(ga, A[i]);
            cb[i] = __fmul_rn(lam, dx);
            cc[i] = __fmul_rn(gyv, hist[u + 1][i]);
            carry[i] = __fmul_rn(dec[u][i], lam);
          }
          // over the channel's states: adds inside the thread, then xor
          // shuffles (fused.state_sum's order)
#pragma unroll
          for (int hw = K / 2; hw > 0; hw >>= 1)
#pragma unroll
            for (int i = 0; i < hw; ++i) {
              pb[i] = __fadd_rn(pb[i], pb[i + hw]);
              pa[i] = __fadd_rn(pa[i], pa[i + hw]);
            }
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1) {
            pb[0] = __fadd_rn(pb[0], __shfl_xor_sync(0xffffffffu, pb[0], off));
            pa[0] = __fadd_rn(pa[0], __shfl_xor_sync(0xffffffffu, pa[0], off));
          }
          if (live && j == 0) {
            const long long o = (row0 + t) * D + d;
            dxc[o] = from_f32<T>(__fmul_rn(pb[0], dtv));
            ddt[o] = __fadd_rn(__fmul_rn(pb[0], xcv), pa[0]);
          }
          // over the warp's channels, then one lane per state to shared
#pragma unroll
          for (int off = G; off < 32; off <<= 1)
#pragma unroll
            for (int i = 0; i < K; ++i) {
              cb[i] = __fadd_rn(cb[i], __shfl_xor_sync(0xffffffffu, cb[i], off));
              cc[i] = __fadd_rn(cc[i], __shfl_xor_sync(0xffffffffu, cc[i], off));
            }
          if (lane < G) {
#pragma unroll
            for (int i = 0; i < K; ++i) {
              red_b[(u * kBWarps + w) * S + j + i * G] = cb[i];
              red_c[(u * kBWarps + w) * S + j + i * G] = cc[i];
            }
          }
        }
      }
      __syncthreads();  // every warp's sums of this sub-tile are in
      for (int e = tid; e < m * S; e += kBThreads) {
        const int u = e / S, s = e % S;
        float sb = red_b[u * kBWarps * S + s], sc = red_c[u * kBWarps * S + s];
#pragma unroll
        for (int ww = 1; ww < kBWarps; ++ww) {
          sb = __fadd_rn(sb, red_b[(u * kBWarps + ww) * S + s]);
          sc = __fadd_rn(sc, red_c[(u * kBWarps + ww) * S + s]);
        }
        const long long o =
            (((long long)bi * gridDim.x + blockIdx.x) * L + ts + u) * S + s;
        part_b[o] = sb;
        part_c[o] = sc;
      }
      __syncthreads();  // the sums are read before the next sub-tile
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      part_a[hidx + i * G] = dA[i];
      dh0[hidx + i * G] = carry[i];
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

template <typename T, int S>
int launch_bwd(const float* dt, const void* xc, const void* b, const void* c,
               const float* a_mat, const float* ckpt, const float* gy,
               const float* g_hlast, int bsz, int L, int D, float* ddt,
               void* dxc, void* db, void* dc, float* da_mat, float* dh0,
               float* part_b, float* part_c, float* part_a,
               cudaStream_t stream) {
  using Lay = BwdLayout<S>;
  constexpr int kBytes = Lay::kBytes;
  auto kernel = mamba_fused_bwd_kernel<T, S>;
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
  const int nblk = (D + Lay::CH - 1) / Lay::CH;
  kernel<<<dim3(nblk, bsz), kBThreads, kBytes, stream>>>(
      dt, static_cast<const T*>(xc), static_cast<const T*>(b),
      static_cast<const T*>(c), a_mat, ckpt, gy, g_hlast, L, D, ddt,
      static_cast<T*>(dxc), part_b, part_c, part_a, dh0);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = reduce_parts<T>(part_b, bsz, nblk, (long long)L * S,
                       static_cast<T*>(db), stream);
  if (rc != 0) return rc;
  rc = reduce_parts<T>(part_c, bsz, nblk, (long long)L * S,
                       static_cast<T*>(dc), stream);
  if (rc != 0) return rc;
  return reduce_parts<float>(part_a, 1, bsz, (long long)D * S, da_mat,
                             stream);
}

template <typename T>
int launch_bwd_s(int s, const float* dt, const void* xc, const void* b,
                 const void* c, const float* a_mat, const float* ckpt,
                 const float* gy, const float* g_hlast, int bsz, int L, int D,
                 float* ddt, void* dxc, void* db, void* dc, float* da_mat,
                 float* dh0, float* part_b, float* part_c, float* part_a,
                 cudaStream_t stream) {
  switch (s) {
    case 8:
      return launch_bwd<T, 8>(dt, xc, b, c, a_mat, ckpt, gy, g_hlast, bsz, L,
                              D, ddt, dxc, db, dc, da_mat, dh0, part_b,
                              part_c, part_a, stream);
    case 16:
      return launch_bwd<T, 16>(dt, xc, b, c, a_mat, ckpt, gy, g_hlast, bsz, L,
                               D, ddt, dxc, db, dc, da_mat, dh0, part_b,
                               part_c, part_a, stream);
    case 64:
      return launch_bwd<T, 64>(dt, xc, b, c, a_mat, ckpt, gy, g_hlast, bsz, L,
                               D, ddt, dxc, db, dc, da_mat, dh0, part_b,
                               part_c, part_a, stream);
    default:
      return (int)cudaErrorInvalidValue;
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
// forward tile it walks, steps per sub-tile}; at S = 8 a thread holds
// min(K, 8) states.  The wrapper sizes the blocks' partials from it.
extern "C" void mamba_fused_bwd_config(int* out) {
  out[0] = B7B_K, out[1] = kBThreads, out[2] = kBTile, out[3] = kBSub;
}

// dtype: 0 = float32, 1 = bfloat16 (of xc, b, c and of dxc, db, dc); s: 8,
// 16 or 64; tile: the forward's checkpoint spacing (must be B7_TILE);
// g_hlast may be null (zero).  part_b and part_c hold (B, blocks, L, S)
// floats, part_a (B, D, S).  Four launches on the stream: the walk, then
// the three sums.
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
  if (dtype == 0)
    return launch_bwd_s<float>(s, dt, xc, b, c, a_mat, ckpt, gy, g_hlast, bsz,
                               L, D, ddt, dxc, db, dc, da_mat, dh0, part_b,
                               part_c, part_a, stream);
  if (dtype == 1)
    return launch_bwd_s<__nv_bfloat16>(s, dt, xc, b, c, a_mat, ckpt, gy,
                                       g_hlast, bsz, L, D, ddt, dxc, db, dc,
                                       da_mat, dh0, part_b, part_c, part_a,
                                       stream);
  return (int)cudaErrorInvalidValue;
}
