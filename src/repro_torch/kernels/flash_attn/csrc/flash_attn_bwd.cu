// B5-bwd: the gradient of B5's function — dQ, dK and dV of causal /
// sliding-window / GQA / logit-capped attention, from q, k, v, the forward
// output O, its row log-sum-exp and the output's gradient dO.
//
// Replaces no TPU kernel.  The JAX package trains with use_kernel=False and
// differentiates its plain attention (models/attention.py::attend_ref)
// with XLA's autodiff; the port routes every attention layer through B5
// (flash_attn.cu / flash_attn_sm90.cu), so that B5's forward needs an
// autograd.Function and its backward a kernel.
//
// This file holds the library's entry point, the delta kernel of both types
// and B5-bwd's float32 kernels; every bfloat16 call (the training path's)
// goes to flash_attn_bwd_sm90.cu (wgmma fed by TMA).  One call of the
// entry point (LAUNCHES["flash_attn_bwd"] counts it) launches, back to back
// on the caller's stream:
//
//  1. delta: per query row, delta = sum_d dO * O (f32, one warp a row),
//     written with the row's log-sum-exp in log2 units into a scratch laid
//     out per 64-row query tile, the layout of both types' kernels.  The
//     log-sum-exp is not recomputed: B5's forward wrote it (a non-null lse)
//     from the row statistics it held.
//  2. dkdv (f32): one block per (64-key tile, KV head, batch row) walks
//     every query head of the KV head's group and every query tile that can
//     see the key tile, recomputes P = 2^(y log2 e - lse2) and dS = P (dP -
//     delta) (times the cap's derivative 1 - tanh^2(x / cap) where there is
//     a cap), and accumulates dV += P^T dO and dK += dS^T Q in registers;
//     it writes dK / sqrt(D) and dV once.
//  3. dq (f32): one block per (64-query tile, query head, batch row) walks
//     the key tiles the tile can see and accumulates dQ += dS K; it writes
//     dQ / sqrt(D) once.
//
// Every sum has one fixed order and every output element one writer: no
// atomics, so two launches on the same inputs give the same bits.
//
// Bound on an H100: operations, 10 * D flops per valid (q, k) pair (QK^T,
// dO V^T, P^T dO, dS^T Q and dS K) at the f32 rate (67 TFLOP/s) for this
// instantiation; TF32 wgmma would not keep the 1e-5 agreement with the
// plain version, so f32 stays on the FMA units, as B5's f32 forward does.
// It serves the tests' tight checks; training runs bf16.  This SIMT design
// does 14 * D flops per pair (QK^T and dO V^T in both kernels).  Tiles of
// 64 x 64; 256 threads a block each own 4 rows x 4 columns of the score
// tile and 4 rows x D/16 columns of the accumulators; rows in shared memory
// are padded to D + 1 floats so the column walks hit distinct banks.  KV
// tiles (or query tiles) that no pair of the block can use are skipped;
// the tiles that run apply the element mask q < Sq, k < Sk, q >= k
// (causal), q - k < window.
//
// Instantiated for D in {64, 80, 128}; the delta kernel for float32 and
// bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;           // rows of a query or key tile
constexpr int NT_DELTA = 256;    // delta: one warp a row
constexpr int NT = 256;          // dkdv, dq: 16 row groups x 16 lanes
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  void* dq;
  void* dk;
  void* dv;
  const float* stats;  // bwd_delta_kernel's tiles: lse2, then delta
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int H, KV, Sq, Sk, causal, window;
  float cap;
};

struct DeltaArgs {
  const void* o;
  const void* dO;
  const float* lse;
  float* out;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int B, H, Sq, D;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Stage rows [s0, s0 + BT) of one head (row stride rs) into dst with row
// pitch D + 1, widened to f32; rows at or past lim are zero.
template <typename T, int D, int NTH>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int s0, int lim) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < BT * D; i += NTH) {
    const int r = i / D, c = i - r * D;
    const int s = s0 + r;
    dst[r * LD + c] = s < lim ? to_f(src[s * rs + c]) : 0.0f;
  }
}

__device__ __forceinline__ bool valid_pair(const Args& a, int qp, int kp) {
  return qp < a.Sq && kp < a.Sk && (!a.causal || qp >= kp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// The key tiles [begin, end) that some query row of [q0, q0 + BT) sees.
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& begin,
                                          int& end) {
  end = (a.Sk + BT - 1) / BT;
  const int q_last = min(q0 + BT, a.Sq) - 1;
  if (a.causal) end = min(end, q_last / BT + 1);
  begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) begin = (q0 - a.window + 1) / BT;
}

// The capped logit y of the dot product s, and dy/dx of the cap.
__device__ __forceinline__ float capped(const Args& a, float s, float scale,
                                        float& dcap) {
  float x = s / scale;
  dcap = 1.0f;
  if (a.cap > 0.0f) {
    const float t = tanhf(x / a.cap);
    x = a.cap * t;
    dcap = 1.0f - t * t;
  }
  return x;
}

// delta = sum_d dO * O of each row (b, h, q): one warp a row, lanes over
// D, then xor shuffles (one fixed order).  Out: per (b, h) and 64-row query
// tile one block of 128 floats, the tile's lse in log2 units and then its
// delta, 0 for rows past Sq, so that one copy (or one read) stages both
// for a tile.
template <typename T>
__global__ void __launch_bounds__(NT_DELTA) bwd_delta_kernel(DeltaArgs a) {
  const int rows = (a.Sq + BT - 1) / BT * BT;  // a head, padded to tiles
  const long long row = (long long)blockIdx.x * (NT_DELTA / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.H * rows) return;
  const int qp = (int)(row % rows);
  const long long bh = row / rows;
  const int h = (int)(bh % a.H);
  const int b = (int)(bh / a.H);
  float acc = 0.0f;
  if (qp < a.Sq) {
    const T* og = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh +
                  qp * a.o_ss;
    const T* dog = static_cast<const T*>(a.dO) + b * a.do_sb +
                   h * a.do_sh + qp * a.do_ss;
    for (int d = lane; d < a.D; d += 32)
      acc = fmaf(to_f(og[d]), to_f(dog[d]), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane != 0) return;
  float* tile = a.out + (bh * (rows / BT) + qp / BT) * 2 * BT + qp % BT;
  tile[0] = qp < a.Sq ? a.lse[bh * a.Sq + qp] * LOG2E : 0.0f;
  tile[BT] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int CW = D / 16;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // BT x LD, this block's keys
  float* Vs = Ks + BT * LD;      // BT x LD
  float* Qs = Vs + BT * LD;      // BT x LD, the current query tile
  float* dOs = Qs + BT * LD;     // BT x LD
  float* Ps = dOs + BT * LD;     // BT x LP: P^T (key row, query column)
  float* dSs = Ps + BT * LP;     // BT x LP: dS^T
  float* lse_s = dSs + BT * LP;  // BT, in log2 units
  float* del_s = lse_s + BT;     // BT

  const int tid = threadIdx.x;
  const int tr = tid >> 4;       // key rows tr*4 .. tr*4+3
  const int tc = tid & 15;       // query columns / D columns tc + 16*j
  const int k0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.KV;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, D, NT>(Ks, kg, a.k_ss, k0, a.Sk);
  load_tile<T, D, NT>(Vs, vg, a.v_ss, k0, a.Sk);

  float dk[4][CW], dv[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dk[i][c] = dv[i][c] = 0.0f;

  // the query tiles that can see some key of this tile
  const int k_last = min(k0 + BT, a.Sk) - 1;
  const int qt_begin = a.causal ? k0 / BT : 0;
  const int q_tiles = (a.Sq + BT - 1) / BT;
  int qt_end = q_tiles;
  if (a.window > 0) qt_end = min(qt_end, (k_last + a.window - 1) / BT + 1);
  const float scale = sqrtf((float)D);

  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dog = static_cast<const T*>(a.dO) + b * a.do_sb + h * a.do_sh;
    const float* st = a.stats + ((long long)b * a.H + h) * q_tiles * 2 * BT;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // K, V staged; the previous tile's sums are done
      load_tile<T, D, NT>(Qs, qg, a.q_ss, q0, a.Sq);
      load_tile<T, D, NT>(dOs, dog, a.do_ss, q0, a.Sq);
      if (tid < 2 * BT) lse_s[tid] = st[qt * 2 * BT + tid];  // and del_s
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = Ks[(tr * 4 + i) * LD + d];
          vv[i] = Vs[(tr * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = Qs[(tc + 16 * j) * LD + d];
          oo[j] = dOs[(tc + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = tr * 4 + i, qc = tc + 16 * j;
          float p = 0.0f, ds = 0.0f;
          if (valid_pair(a, q0 + qc, k0 + kr)) {
            float dcap;
            const float y = capped(a, s[i][j], scale, dcap);
            p = exp2f(fmaf(y, LOG2E, -lse_s[qc]));
            ds = p * (dp[i][j] - del_s[qc]) * dcap;
          }
          Ps[kr * LP + qc] = p;
          dSs[kr * LP + qc] = ds;
        }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        float pp[4], ss[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = Ps[(tr * 4 + i) * LP + c];
          ss[i] = dSs[(tr * 4 + i) * LP + c];
        }
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          const float o_ = dOs[c * LD + tc + 16 * cc];
          const float q_ = Qs[c * LD + tc + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][cc] = fmaf(pp[i], o_, dv[i][cc]);
            dk[i][cc] = fmaf(ss[i], q_, dk[i][cc]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + tr * 4 + i;
    if (kp >= a.Sk) continue;
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      store(dkg + kp * a.dk_ss + tc + 16 * cc, dk[i][cc] / scale);
      store(dvg + kp * a.dv_ss + tc + 16 * cc, dv[i][cc]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int CW = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // BT x LD, this block's queries
  float* dOs = Qs + BT * LD;     // BT x LD
  float* Ks = dOs + BT * LD;     // BT x LD, the current key tile
  float* Vs = Ks + BT * LD;      // BT x LD
  float* dSs = Vs + BT * LD;     // BT x LP: dS (query row, key column)
  float* lse_s = dSs + BT * LP;  // BT, in log2 units
  float* del_s = lse_s + BT;     // BT

  const int tid = threadIdx.x;
  const int tr = tid >> 4;       // query rows tr*4 .. tr*4+3
  const int tc = tid & 15;       // key columns / D columns tc + 16*j
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dog = static_cast<const T*>(a.dO) + b * a.do_sb + h * a.do_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* st = a.stats + (((long long)b * a.H + h) * gridDim.x +
                                blockIdx.x) * 2 * BT;
  load_tile<T, D, NT>(Qs, qg, a.q_ss, q0, a.Sq);
  load_tile<T, D, NT>(dOs, dog, a.do_ss, q0, a.Sq);
  if (tid < 2 * BT) lse_s[tid] = st[tid];  // and del_s

  float dq[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dq[i][c] = 0.0f;
  int kt_begin, kt_end;
  key_tiles(a, q0, kt_begin, kt_end);
  const float scale = sqrtf((float)D);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // Q, dO staged; the previous tile's sums are done
    load_tile<T, D, NT>(Ks, kg, a.k_ss, k0, a.Sk);
    load_tile<T, D, NT>(Vs, vg, a.v_ss, k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qq[4], oo[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = Qs[(tr * 4 + i) * LD + d];
        oo[i] = dOs[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tc + 16 * j) * LD + d];
        vv[j] = Vs[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tr * 4 + i, kc = tc + 16 * j;
        float ds = 0.0f;
        if (valid_pair(a, q0 + qr, k0 + kc)) {
          float dcap;
          const float y = capped(a, s[i][j], scale, dcap);
          const float p = exp2f(fmaf(y, LOG2E, -lse_s[qr]));
          ds = p * (dp[i][j] - del_s[qr]) * dcap;
        }
        dSs[qr * LP + kc] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float ss[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ss[i] = dSs[(tr * 4 + i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        const float k_ = Ks[c * LD + tc + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][cc] = fmaf(ss[i], k_, dq[i][cc]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr * 4 + i;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
      store(dqg + qp * a.dq_ss + tc + 16 * cc, dq[i][cc] / scale);
  }
}

template <int D>
constexpr int dkdv_smem() {
  return (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT) * (int)sizeof(float);
}
template <int D>
constexpr int dq_smem() {
  return (4 * BT * (D + 1) + BT * (BT + 1) + 2 * BT) * (int)sizeof(float);
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int q_tiles = (a.Sq + BT - 1) / BT;
  const int k_tiles = (a.Sk + BT - 1) / BT;
  bwd_dkdv_kernel<T, D><<<dim3(k_tiles, a.KV, B), NT, dkdv_smem<D>(),
                          stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<T, D><<<dim3(q_tiles, a.H, B), NT, dq_smem<D>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// delta = sum_d dO * O of each row for either type (dtype 0 float32, 1
// bfloat16), with lse in log2 units, per 64-row query tile: f32 (B, H,
// ceil(Sq / 64), 2, 64) (bwd_delta_kernel).  Also called by
// flash_attn_bwd_sm90.cu.
int flash_attn_bwd_delta(int dtype, int d, const void* o, const void* dO,
                         const float* lse, float* out, long long o_sb,
                         long long o_ss, long long o_sh, long long do_sb,
                         long long do_ss, long long do_sh, int B, int H,
                         int Sq, cudaStream_t stream) {
  const DeltaArgs a{o,     dO,    lse, out, o_sb, o_ss, o_sh, do_sb,
                    do_ss, do_sh, B,   H,   Sq,   d};
  const long long rows = (long long)B * H * ((Sq + BT - 1) / BT * BT);
  const long long blocks = (rows + NT_DELTA / 32 - 1) / (NT_DELTA / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    bwd_delta_kernel<float><<<(unsigned)blocks, NT_DELTA, 0, stream>>>(a);
  else
    bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, NT_DELTA, 0,
                                      stream>>>(a);
  return (int)cudaGetLastError();
}

// The bfloat16 instantiation, in flash_attn_bwd_sm90.cu.
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
    int window, float cap, cudaStream_t stream);

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dO and the three outputs all
// of it).  Strides are in elements (batch, seq, head of q, k, v, o, dO,
// dq, dk, dv); D has a unit stride.  lse: f32 (B, H, Sq), each row's
// natural log-sum-exp as B5's forward writes it; delta: f32 scratch of
// B*H*ceil(Sq/64)*128 elements.  window <= 0: none; cap <= 0: none.
// Returns 0, a CUDA error, or -1 for bf16 inputs that TMA cannot read
// (before any launch).
extern "C" int flash_attn_bwd(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* o, const void* dO, void* dq, void* dk, void* dv,
    const float* lse, float* delta, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,
    long long dv_ss, long long dv_sh, int B, int H, int KV, int Sq, int Sk,
    int causal, int window, float cap, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return flash_attn_bwd_sm90(
        d, q, k, v, o, dO, dq, dk, dv, lse, delta, q_sb, q_ss, q_sh, k_sb,
        k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh,
        dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, B, H,
        KV, Sq, Sk, causal, window, cap, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (d != 64 && d != 80 && d != 128) return (int)cudaErrorInvalidValue;
  const int rc = flash_attn_bwd_delta(0, d, o, dO, lse, delta, o_sb, o_ss,
                                      o_sh, do_sb, do_ss, do_sh, B, H, Sq,
                                      stream);
  if (rc != 0) return rc;
  const Args a{q,     k,     v,     o,     dO,    dq,    dk,    dv,
               delta, q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,
               v_ss,  v_sh,  o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh,
               dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss,
               dv_sh, H,     KV,    Sq,    Sk,    causal, window, cap};
  switch (d) {
    case 64: return launch<float, 64>(a, B, stream);
    case 80: return launch<float, 80>(a, B, stream);
    case 128: return launch<float, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
