// B4: a bank of B independent scalar-state Kalman filters, one predict +
// information-form correct step (paper Eqs. 1-5 at n = 1 with diagonal R),
// and, where the caller asks for it, the boost signal of the step.
//
// Replaces src/repro/kernels/kf_bank/kernel.py::_kf_bank_kernel.
//
// Bound on an H100: bytes.  Each filter reads x, p and its M observations
// and writes x and p (and the int32 signal): (2 + M + 2 [+ 1]) * 4 bytes
// for ~4M + 10 flops, far below the card's ~20 flops per byte.  So the
// design is one thread per filter, consecutive threads on consecutive
// filters (x, p and the outputs are coalesced; each thread reads its own z
// row of M floats, and a warp's rows are one contiguous span of 32 * M
// floats), h and r read through the read-only cache, and the ragged tail
// masked: any B is taken, with no padding to a block multiple.  z arrives
// as (B, M) row-major, the model's layout; the TPU's (M, B) lane transpose
// is not carried over.
//
// At the fleet's B = 65,536 and M = 3 a step moves 1.8 MB, less than the
// card keeps in flight at full bandwidth, so a launch costs about one launch
// plus one DRAM round trip whatever the body does.  What a fleet epoch
// costs around it is launches and host work: the kernel therefore also
// writes the epoch's boost signal, sig[i] = x_post > 0 (kalman.binarize at
// threshold 0: the same compare on the same float, no second rounding),
// when it is given a signal pointer, so that FleetKF.epoch is one launch.
//
// Rounding: every operation is written with __fmul_rn / __fadd_rn /
// __fdiv_rn, so nvcc contracts nothing into an FMA and each step rounds as
// the plain torch version (kf_bank_step_plain) rounds it; the sums over M
// run in order m = 0..M-1 as there.  The kernel is held to the plain
// version bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kf_bank_kernel(const float* __restrict__ x, const float* __restrict__ p,
               const float* __restrict__ z, const float* __restrict__ h,
               const float* __restrict__ r, int n, int m, float a, float aa,
               float q, float* __restrict__ x_out, float* __restrict__ p_out,
               int* __restrict__ sig) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // time update (Eqs. 1-2)
  const float x_prior = __fmul_rn(a, x[i]);
  const float p_prior = __fadd_rn(__fmul_rn(aa, p[i]), q);
  // measurement update, information form (== Eqs. 3-5 for n = 1, diag R)
  const float* zi = z + i * (long)m;
  float info = 0.0f, innov = 0.0f;
  for (int k = 0; k < m; ++k) {
    const float hk = __ldg(h + k);
    const float hr = __fdiv_rn(hk, __ldg(r + k));
    const float hh = __fmul_rn(hk, hr);
    const float hz = __fmul_rn(hr, zi[k]);
    info = k == 0 ? hh : __fadd_rn(info, hh);
    innov = k == 0 ? hz : __fadd_rn(innov, hz);
  }
  const float p_post =
      __fdiv_rn(1.0f, __fadd_rn(__fdiv_rn(1.0f, p_prior), info));
  const float x_post =
      __fmul_rn(p_post, __fadd_rn(__fdiv_rn(x_prior, p_prior), innov));
  x_out[i] = x_post;
  p_out[i] = p_post;
  if (sig != nullptr) sig[i] = x_post > 0.0f;
}

}  // namespace

// One step of the bank; sig (n int32) receives the boost signals, or is
// nullptr for the step alone.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty bank or no observations.
extern "C" int kf_bank_step(const float* x, const float* p, const float* z,
                            const float* h, const float* r, int n, int m,
                            float a, float aa, float q, float* x_out,
                            float* p_out, int* sig, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  kf_bank_kernel<<<blocks, kThreads, 0, stream>>>(x, p, z, h, r, n, m, a, aa,
                                                  q, x_out, p_out, sig);
  return (int)cudaGetLastError();
}
