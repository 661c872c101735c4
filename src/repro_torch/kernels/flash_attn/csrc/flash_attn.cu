// B5: forward flash attention — online softmax over KV tiles, GQA,
// causal / sliding-window tile skipping, tanh logit cap, a kv_len bound on
// the valid keys, fully masked rows written as 0.
//
// Replaces src/repro/kernels/flash_attn/kernel.py::_flash_kernel.
//
// This file holds B5's float32 instantiation and the library's entry point,
// which routes bfloat16 inputs to flash_attn_sm90.cu (wgmma fed by TMA, the
// instantiation every model path calls).  In f32 TF32 wgmma would not keep
// the 2e-5 agreement with the plain version, so the products stay on the
// f32 FMA units (67 TFLOP/s), which bound this kernel.  What the design
// does about the rest:
//
//  * One block of 128 threads per (query tile of 64 rows, query head,
//    batch row).  The Q tile is staged once in shared memory; K and then V
//    tiles of 64 rows pass through one shared buffer.  Rows are padded to
//    D + 1 floats so that the column walks hit distinct banks.
//  * Each thread owns 4 query rows x 8 key columns of the score tile and
//    4 rows x D/8 output columns of the accumulator, all in registers.
//    The 8 threads that share a row group are adjacent lanes of one warp,
//    so the row max and row sum of the online softmax are three
//    __shfl_xor_sync steps, with no shared-memory pass.  The running max,
//    denominator and accumulator stay in f32 registers across the KV loop.
//  * GQA reads kv head h / (H / KV) directly: repeated K/V are never
//    materialised.  The kernel reads the model layout (B, S, H, D) through
//    the strides it is given, so the caller transposes nothing.
//  * KV tiles that no (q, k) pair of the block can use — past kv_len, above
//    the causal diagonal, or left of every row's window — are skipped; the
//    tiles that run apply the element mask k < kv_len, q >= k (causal),
//    q - k < window.  A masked element contributes p = 0, so a row with no
//    valid key keeps l = 0 and is written as 0, and a skipped tile is exact.
//  * Ragged Sq and Sk are masked in the kernel; nothing is padded.
//  * Asked for it (a non-null lse), each row's natural log-sum-exp
//    m + ln l is written beside O for the backward (flash_attn_bwd.cu).
//
// Instantiated for D in {64, 80, 128}.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per tile
constexpr int NT = 128;      // threads per block: 16 row groups x 8 lanes
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) natural-log row statistics, or null
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, KV, Sq, Sk, kv_len, causal, window;
  float cap;
};

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BQ * (BK + 1)) * (int)sizeof(float);
}

// Stage rows [s0, s0 + rows) of one head into dst (row pitch D + 1); rows
// at or past `lim` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int s0,
                                          int rows, int lim) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const int s = s0 + r;
    dst[r * LD + c] = s < lim ? src[s * row_stride + c] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CW = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x LD
  float* KVs = Qs + BQ * LD;     // BK x LD, K then V
  float* Ps = KVs + BK * LD;     // BQ x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 3;       // row group: rows tr*4 .. tr*4+3
  const int tc = tid & 7;        // columns tc + 8*j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vg =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<D>(Qs, qg, a.q_ss, q0, BQ, a.Sq);

  float acc[4][CW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  // the KV tiles some (q, k) pair of this block can use
  const int kv_lim = min(a.kv_len, a.Sk);
  int kt_end = (kv_lim + BK - 1) / BK;
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  if (a.causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kt_begin = (q0 - a.window + 1) / BK;
  const float scale = sqrtf((float)D);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged; the previous tile's PV is done with KVs, Ps
    load_tile<D>(KVs, kg, a.k_ss, k0, BK, kv_lim);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = KVs[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr * 4 + i;
      unsigned valid = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tc + 8 * j;
        float x = s[i][j] / scale;
        if (a.cap > 0.0f) x = a.cap * tanhf(x / a.cap);
        const bool ok = kp < kv_lim && (!a.causal || qp >= kp) &&
                        (a.window <= 0 || qp - kp < a.window);
        valid |= (unsigned)ok << j;
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (valid >> j) & 1u ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(tr * 4 + i) * LP + tc + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done with K; P is complete
    load_tile<D>(KVs, vg, a.v_ss, k0, BK, kv_lim);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        const float vv = KVs[c * LD + tc + 8 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr * 4 + i;
    if (qp >= a.Sq) continue;
    // the row's log-sum-exp where asked: 0 for a row with no valid key
    if (a.lse != nullptr && tc == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : 0.0f;
    const float inv = l[i] == 0.0f ? 1.0f : l[i];  // fully masked rows -> 0
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
      og[qp * a.o_ss + tc + 8 * cc] = acc[i][cc] / inv;
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<D><<<grid, NT, smem_bytes<D>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The bfloat16 instantiation, in flash_attn_sm90.cu.
int flash_attn_fwd_sm90(
    int d, const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B,
    int H, int KV, int Sq, int Sk, int kv_len, int causal, int window,
    float cap, cudaStream_t stream);

// dtype: 0 float32, 1 bfloat16.  Strides are in elements (batch, seq, head
// of q, k, v, o); D has a unit stride.  window <= 0: none; cap <= 0: none.
// lse: null, or f32 (B, H, Sq) that receives each row's natural log-sum-exp
// of its valid capped, scaled logits (0 for a row with no valid key).
// Returns 0, a CUDA error, or -1 for bf16 inputs that TMA cannot read.
extern "C" int flash_attn_fwd(
    int dtype, int d, const void* q, const void* k, const void* v, void* o,
    float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B,
    int H, int KV, int Sq, int Sk, int kv_len, int causal, int window,
    float cap, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return flash_attn_fwd_sm90(d, q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss,
                               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B, H,
                               KV, Sq, Sk, kv_len, causal, window, cap,
                               stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,    lse,  q_sb, q_ss, q_sh,   k_sb,
               k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,   o_sh,
               H,    KV,   Sq,   Sk,   kv_len, causal, window, cap};
  switch (d) {
    case 64: return launch<64>(a, B, stream);
    case 80: return launch<80>(a, B, stream);
    case 128: return launch<128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
