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
// (the model's activations), cast to float32 on load.
//
// Bound on an H100.  B6 moves 3 * B*L*D*S floats and does 2 flops per
// element: bytes (~0.96 ms at B=1, L=2048, D=8192, S=16).  B7 moves only
// O(L*(D + S)) bytes; per (t, d, s) it does ~6 flops and one exponential,
// so at the model's shapes the MUFU exponentials and the f32 flops bound it
// about as much as the bytes do.
//
// Design.  The TPU kernels walk sequence chunks in order on one core, a
// log-depth doubling scan inside each chunk.  Here the recurrence is
// independent per (batch, d, s), so there is one thread per element and
// it walks t = 0..L-1 with h in a register: B*D*S = 131,072 threads at
// D=8192, S=16 fill the card, and no state crosses a block.  The chunk and
// block_d of the reference have no meaning on the card.
//  - B6: adjacent threads take adjacent (d, s), so each time step is one
//    coalesced row of a, b and hs; the loads of 8 steps are issued before
//    their products, so each warp keeps 16 loads in flight.
//  - B7: the S states of one d sit in S adjacent lanes, so y[b,t,d] is a
//    log2(S)-step __shfl_xor_sync sum within those lanes.  A block of 256
//    threads covers 256/S channels; for a tile of 64 time steps it stages
//    dt, dt*xc, B and C in shared memory (coalesced rows, cast to f32 on
//    load), walks the tile, and writes the tile's y rows out coalesced.
//
// Rounding.  Every product and sum is __fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA and each step rounds as the plain torch
// versions (ref.scan_ref, fused.fused_mamba_scan_plain) round it, and
// B7's shuffle tree sums y in the pairwise order of fused.state_sum.  B6 is
// therefore bitwise its plain version, and so is B7 wherever expf (no
// fast-math) rounds as torch.exp on the card does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

constexpr int kFusedThreads = 256;
constexpr int kTile = 64;  // time steps staged per pass

template <typename T, int S>
__global__ void __launch_bounds__(kFusedThreads)
mamba_fused_kernel(const float* __restrict__ dt, const T* __restrict__ xc,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ a_mat,
                   const float* __restrict__ h0, int L, int D,
                   float* __restrict__ y, float* __restrict__ h_last) {
  constexpr int kD = kFusedThreads / S;  // channels per block
  __shared__ float dt_s[kTile][kD];
  __shared__ float dx_s[kTile][kD];      // dt * xc
  __shared__ float b_s[kTile][S];
  __shared__ float c_s[kTile][S];
  __shared__ float y_s[kTile][kD];
  const int tid = threadIdx.x;
  const int s = tid % S, dl = tid / S;
  const int d0 = blockIdx.x * kD, d = d0 + dl;
  const long long row0 = (long long)blockIdx.y * L;  // (batch, t = 0)
  const bool live = d < D;
  const long long hidx = ((long long)blockIdx.y * D + d) * S + s;
  const float A = live ? a_mat[(long long)d * S + s] : 0.0f;
  float h = (live && h0 != nullptr) ? h0[hidx] : 0.0f;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);
    for (int k = tid; k < n * kD; k += kFusedThreads) {
      const int tt = k / kD, dd = k % kD;
      float dtv = 0.0f, xv = 0.0f;
      if (d0 + dd < D) {
        const long long off = (row0 + t0 + tt) * D + d0 + dd;
        dtv = dt[off];
        xv = to_f32(xc[off]);
      }
      dt_s[tt][dd] = dtv;
      dx_s[tt][dd] = __fmul_rn(dtv, xv);
    }
    for (int k = tid; k < n * S; k += kFusedThreads) {
      const int tt = k / S, ss = k % S;
      const long long off = (row0 + t0 + tt) * S + ss;
      b_s[tt][ss] = to_f32(bm[off]);
      c_s[tt][ss] = to_f32(cm[off]);
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float at = expf(__fmul_rn(dt_s[tt][dl], A));
      const float bx = __fmul_rn(dx_s[tt][dl], b_s[tt][s]);
      h = __fadd_rn(__fmul_rn(at, h), bx);
      float p = __fmul_rn(h, c_s[tt][s]);
#pragma unroll
      for (int off = S / 2; off > 0; off >>= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      if (s == 0) y_s[tt][dl] = p;
    }
    __syncthreads();
    for (int k = tid; k < n * kD; k += kFusedThreads) {
      const int tt = k / kD, dd = k % kD;
      if (d0 + dd < D) y[(row0 + t0 + tt) * D + d0 + dd] = y_s[tt][dd];
    }
    // the next tile's staging writes dt_s .. c_s only after every thread
    // has passed the barrier above, and y_s only after the next barrier
  }
  if (live) h_last[hidx] = h;
}

template <typename T, int S>
int launch_fused(const float* dt, const void* xc, const void* b,
                 const void* c, const float* a_mat, const float* h0, int bsz,
                 int L, int D, float* y, float* h_last, cudaStream_t stream) {
  constexpr int kD = kFusedThreads / S;
  const dim3 grid((D + kD - 1) / kD, bsz);
  mamba_fused_kernel<T, S><<<grid, kFusedThreads, 0, stream>>>(
      dt, static_cast<const T*>(xc), static_cast<const T*>(b),
      static_cast<const T*>(c), a_mat, h0, L, D, y, h_last);
  return (int)cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16 (of xc, b and c); s: 8 or 16.
extern "C" int mamba_fused_fwd(int dtype, int s, const float* dt,
                               const void* xc, const void* b, const void* c,
                               const float* a_mat, const float* h0, int bsz,
                               int L, int D, float* y, float* h_last,
                               cudaStream_t stream) {
  if (bsz <= 0 || L <= 0 || D <= 0 || bsz > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && s == 8)
    return launch_fused<float, 8>(dt, xc, b, c, a_mat, h0, bsz, L, D, y,
                                  h_last, stream);
  if (dtype == 0 && s == 16)
    return launch_fused<float, 16>(dt, xc, b, c, a_mat, h0, bsz, L, D, y,
                                   h_last, stream);
  if (dtype == 1 && s == 8)
    return launch_fused<__nv_bfloat16, 8>(dt, xc, b, c, a_mat, h0, bsz, L, D,
                                          y, h_last, stream);
  if (dtype == 1 && s == 16)
    return launch_fused<__nv_bfloat16, 16>(dt, xc, b, c, a_mat, h0, bsz, L,
                                           D, y, h_last, stream);
  return (int)cudaErrorInvalidValue;
}
