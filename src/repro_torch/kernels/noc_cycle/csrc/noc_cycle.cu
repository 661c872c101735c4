// Hand-written Hopper (sm_90a) kernels for the NoC cycle engine.
//
// noc_arbitrate  replaces repro/kernels/noc_cycle/kernel.py::_noc_cycle_kernel
//   One cycle of switch allocation per (subnet, router) lane: downstream VC
//   pick under the GPU/CPU VC masks, per-output round robin or SA-preferred
//   class, and the one-traversal-per-input filter.  One thread per lane,
//   128 threads a block.  Bound on this card: it reads 80 int32 rows and
//   writes 55 per lane (~540 B/lane, ~138 KB at L = 256) and does a few
//   hundred integer ops per lane, so a launch is far below a microsecond of
//   memory or ALU time; at L = 256 it fills two blocks of one SM and its
//   time is launch latency.  The design keeps every per-lane array in
//   registers (the VC count V is a template parameter, so all loops unroll).
//
// noc_fused_cycles  replaces repro/kernels/noc_cycle/kernel.py::_fused_cycle_kernel
//   Whole NoC cycles on the int32 LaneState (layout in fused.py): MC service,
//   route + arbitration, dequeue and link traversal, MC enqueue, reply
//   completion, source generation, the merged inject and the 15 counters.
//   One thread block per simulation (the grid is the batch), one thread per
//   lane of the S*64 lane axis; threads 0..127 also own the per-node lanes.
//   The kernel loops over n_cycles inside, reading each cycle's xi/xf rows
//   from device memory; with n_cycles = 1 it computes exactly one TPU
//   kernel step.  It UPDATES THE STATE ARRAYS IN PLACE (the wrapper hands it
//   fresh copies).  Bound on this card: per cycle each lane touches its
//   ~2*P*V head words, P*V neighbour counts and a few pulled/injected
//   buffer words (~1 KB per lane, all L1/L2 resident: the whole lane state
//   is ~200 KB), and the cycle is a chain of 5 block barriers
//   (__syncthreads) on one SM.  Cycles are strictly sequential, so the
//   limit is the barrier + dependent-latency chain of one block, not bytes
//   or ALU rate.  The design puts the whole epoch's cycles in one launch (no
//   per-cycle launch latency), keeps each lane's head / round-robin
//   pointers / VC counts and each node's MC and source state in registers
//   across cycles, exchanges neighbour values through shared memory, and
//   reduces counters with shared-memory integer atomics (integer sums are
//   order-independent, so results stay bitwise).
//
// noc_fused_cycles_probed  replaces
//   repro/kernels/noc_cycle/kernel.py::_fused_cycle_probed_kernel
//   B2 plus the flight-recorder carry (fused.ProbeLanes): per lane the
//   summed end-of-cycle VC counts and the summed switch grants and
//   refusals, per node the summed and maxed MC queue depth after service
//   and enqueue.  It is the PROBE = true instantiation of B2's kernel: the
//   probe code sits in `if constexpr` blocks, so the probes-off
//   instantiation is B2 unchanged.  The accumulators live in registers
//   across the cycle loop (20 + 2 ints per lane thread, 2 per node thread)
//   and are added to the probe arrays once, after the loop; no barrier is
//   added.  Bound on this card: B2's, plus ~46 KB of probe reads and
//   writes and ~50 integer adds per lane per cycle; the limit is still
//   B2's barrier chain.
//
// All three kernels call one __device__ lane_arbitrate, so they cannot
// drift.
// Every C entry point returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int P = 5;          // ports N, E, S, W, Local
constexpr int PORT_L = 4;
constexpr int R_PAD = 64;     // router lanes per subnet block
constexpr int LANES_R = 128;  // per-node lanes
constexpr int MAX_L = 256;    // S * 64 with S <= 4
constexpr int BIG = 1 << 20;
constexpr int NT_CPU = 0, NT_GPU = 1, NT_MC = 2;
constexpr int META_SRC_SHIFT = 6, META_CLS_SHIFT = 12;

enum { XI_CYCLE, XI_SA, XI_GATE, XI_ACTIVE, XI_DEST, XI_MCOK, XI_ROWS };
enum { XF_UPHASE, XF_UGEN, XF_ROWS };
enum { MC_HEAD, MC_COUNT, MC_TIMER, MC_SVALID, MC_SDST, MC_SCLS, MC_ROWS };
enum { ND_OUTST, ND_BACKLOG, ND_PHASE, ND_ROWS };
enum { PS_ENABLED, PS_IS_REQ, PS_IS_REP, PS_REQ_MATCH, PS_ROWS };
enum { PR_FS, PR_NREQ, PR_ROWS };
enum { PF_LO, PF_HI, PF_ENTER, PF_EXIT, PF_CPU, PF_ROWS };
enum { PB_GRANT, PB_DENY };
enum { PB_MCQ_SUM, PB_MCQ_MAX };
enum {
  C_GPU_PUSH, C_GPU_STALL_ICNT, C_GPU_STALL_DRAM, C_CPU_PUSH, C_GPU_DONE,
  C_CPU_DONE, C_GPU_GEN, C_CPU_GEN, C_LAT_SUM, C_LAT_CNT, C_CPU_LAT_SUM,
  C_CPU_LAT_CNT, C_GPU_LAT_SUM, C_GPU_LAT_CNT, C_MOVED, N_COUNTERS
};

// the downstream input port facing output port p (N<->S, E<->W, L->L)
__device__ __forceinline__ int opp(int p) { return p == PORT_L ? p : (p + 2) % 4; }

// floor modulo: C's % truncates toward zero, the reference floors
__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

template <int V>
struct Arb {
  int grant[P], winner[P], down_vc[P], new_rr[P], any_req[P], w_cls[P];
  int deq[P * V];
};

// Switch allocation for one lane; value for value fused.lane_arbitrate,
// including its garbage conventions: an empty column's packed minimum is
// the sentinel PV << 14 (winner 0), and without credit the VC is 0.
template <int V>
__device__ __forceinline__ void lane_arbitrate(
    const int (&valid)[P * V], const int (&cls)[P * V],
    const int (&out_port)[P * V], const int (&rr)[P],
    const int (&down)[P * V], const int (&exists)[P], const int (&gm)[V],
    const int (&cm)[V], int sa, int accept, int active, int depth,
    Arb<V>& a) {
  constexpr int PV = P * V;
  int w_port[P], rank[P];
#pragma unroll
  for (int o = 0; o < P; ++o) {
    int best = PV * (1 << 14);
    int any = 0;
#pragma unroll
    for (int pv = 0; pv < PV; ++pv) {
      if (valid[pv] && out_port[pv] == o) {
        int pref = (cls[pv] == sa) || (sa < 0);
        int key = floor_mod(pv - rr[o], PV) + (pref ? 0 : PV);
        best = min(best, key * PV + pv);
        any = 1;
      }
    }
    int win = best % PV;
    int wc = 0;
#pragma unroll
    for (int pv = 0; pv < PV; ++pv) wc = (pv == win) ? cls[pv] : wc;
    int credit = 0, first = V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int allowed = (wc == 1) ? gm[v] : cm[v];
      int has = (down[o * V + v] < depth) && allowed;
      if (has && first == V) first = v;
      credit |= has;
    }
    int g = (o == P - 1) ? (any && accept && active)
                         : (any && exists[o] && credit && active);
    a.grant[o] = g;
    a.winner[o] = win;
    a.down_vc[o] = credit ? first : 0;
    a.any_req[o] = any;
    a.w_cls[o] = wc;
    a.new_rr[o] = (win + 1) % PV;
    w_port[o] = win / V;
    rank[o] = g ? o : BIG;
  }
  // one traversal per input port: keep the lowest-output grant per port
#pragma unroll
  for (int o = 0; o < P; ++o) {
    int mr = BIG;
#pragma unroll
    for (int o2 = 0; o2 < P; ++o2)
      if (w_port[o2] == w_port[o]) mr = min(mr, rank[o2]);
    a.grant[o] = a.grant[o] && (rank[o] == mr);
    if (!a.grant[o]) a.new_rr[o] = rr[o];
  }
#pragma unroll
  for (int pv = 0; pv < PV; ++pv) {
    int d = 0;
#pragma unroll
    for (int o = 0; o < P; ++o) d |= (a.winner[o] == pv) && a.grant[o];
    a.deq[pv] = d;
  }
}

// ---------------------------------------------------------------------------
// B1: arbitration only, one thread per lane, rows of L int32 lanes
// ---------------------------------------------------------------------------
template <int V>
__global__ void noc_arbitrate_kernel(
    const int* __restrict__ valid, const int* __restrict__ cls,
    const int* __restrict__ out_port, const int* __restrict__ rr,
    const int* __restrict__ down, const int* __restrict__ exists,
    const int* __restrict__ gmask, const int* __restrict__ cmask,
    const int* __restrict__ sa, const int* __restrict__ accept,
    const int* __restrict__ active, int depth, int L,
    int* __restrict__ o_grant, int* __restrict__ o_winner,
    int* __restrict__ o_down_vc, int* __restrict__ o_deq,
    int* __restrict__ o_new_rr, int* __restrict__ o_any_req,
    int* __restrict__ o_w_cls) {
  constexpr int PV = P * V;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int va[PV], cl[PV], op[PV], dn[PV], r[P], ex[P], gm[V], cm[V];
#pragma unroll
  for (int i = 0; i < PV; ++i) {
    va[i] = valid[i * L + l] != 0;
    cl[i] = cls[i * L + l];
    op[i] = out_port[i * L + l];
    dn[i] = down[i * L + l];
  }
#pragma unroll
  for (int o = 0; o < P; ++o) {
    r[o] = rr[o * L + l];
    ex[o] = exists[o * L + l] != 0;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gm[v] = gmask[v * L + l] != 0;
    cm[v] = cmask[v * L + l] != 0;
  }
  Arb<V> a;
  lane_arbitrate<V>(va, cl, op, r, dn, ex, gm, cm, sa[l], accept[l] != 0,
                    active[l] != 0, depth, a);
#pragma unroll
  for (int o = 0; o < P; ++o) {
    o_grant[o * L + l] = a.grant[o];
    o_winner[o * L + l] = a.winner[o];
    o_down_vc[o * L + l] = a.down_vc[o];
    o_new_rr[o * L + l] = a.new_rr[o];
    o_any_req[o * L + l] = a.any_req[o];
    o_w_cls[o * L + l] = a.w_cls[o];
  }
#pragma unroll
  for (int i = 0; i < PV; ++i) o_deq[i * L + l] = a.deq[i];
}

// ---------------------------------------------------------------------------
// B2 / B3: whole cycles, one block per simulation
// ---------------------------------------------------------------------------
struct CycleArgs {
  int *buf_meta, *buf_binj, *head, *count, *rr;  // (rows, L) lane state
  int *mcq, *mc, *node, *cnt;                    // (rows, 128) node state
  const int* xi;                                 // (n_cycles, XI_ROWS, L)
  const float* xf;                               // (n_cycles, XF_ROWS, 128)
  const int *gmask, *cmask;                      // (V, L)
  const float* prof;                             // (PF_ROWS, 128)
  const int *pol_sr, *pol_r, *ntype;             // (4, L), (2, 128), (1, 128)
  const int *route, *exists;                     // (R, L) shared, (P, L)
  int n_cycles, S, R, Q, width, mc_period, mshr_limit, bcap, stamp_mask;
  int *p_occ, *p_arb, *p_mcq;  // B3's ProbeLanes: (P*V, L), (2, L), (2, 128)
};

template <int V, int B, bool PROBE>
__global__ void __launch_bounds__(MAX_L) noc_fused_cycles_kernel(CycleArgs g) {
  constexpr int PV = P * V;
  const int L = g.S * R_PAD;
  const int l = threadIdx.x;
  const int r = l & (R_PAD - 1);
  const int s = l / R_PAD;
  const bool node_thread = l < LANES_R;
  const int delta[P] = {-g.width, 1, g.width, -1, 0};

  // per-simulation offsets (the grid is the batch)
  const int b = blockIdx.x;
  int* buf_meta = g.buf_meta + b * PV * B * L;
  int* buf_binj = g.buf_binj + b * PV * B * L;
  int* head_g = g.head + b * PV * L;
  int* count_g = g.count + b * PV * L;
  int* rr_g = g.rr + b * P * L;
  int* mcq = g.mcq + b * g.Q * LANES_R;
  int* mc = g.mc + b * MC_ROWS * LANES_R;
  int* node = g.node + b * ND_ROWS * LANES_R;
  int* cnt = g.cnt + b * LANES_R;
  const int* xi = g.xi + b * g.n_cycles * XI_ROWS * L;
  const float* xf = g.xf + b * g.n_cycles * XF_ROWS * LANES_R;
  const int* gmask = g.gmask + b * V * L;
  const int* cmask = g.cmask + b * V * L;
  const float* prof = g.prof + b * PF_ROWS * LANES_R;
  const int* pol_sr = g.pol_sr + b * PS_ROWS * L;
  const int* pol_r = g.pol_r + b * PR_ROWS * LANES_R;
  const int* ntype = g.ntype + b * LANES_R;
  const int* exists = g.exists + b * P * L;
  const int* route = g.route;

  __shared__ int s_grant[P][MAX_L], s_dvc[P][MAX_L];
  __shared__ int s_wmeta[P][MAX_L], s_wbinj[P][MAX_L];
  __shared__ int s_accept[LANES_R], s_svalid[LANES_R], s_sdst[LANES_R];
  __shared__ int s_scls[LANES_R], s_can_inj[LANES_R];
  __shared__ int s_req_ej[MAX_L], s_qval[MAX_L], s_rep_ej[MAX_L];
  __shared__ int s_ecls[MAX_L], s_ok[MAX_L];
  __shared__ int s_cnt[N_COUNTERS];

  // epoch-constant per-lane rows
  int gm[V], cm[V], ex[P];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gm[v] = gmask[v * L + l] != 0;
    cm[v] = cmask[v * L + l] != 0;
  }
#pragma unroll
  for (int o = 0; o < P; ++o) ex[o] = exists[o * L + l] != 0;
  const int sub_en = pol_sr[PS_ENABLED * L + l] != 0;
  const int sub_req = pol_sr[PS_IS_REQ * L + l] != 0;
  const int sub_rep = pol_sr[PS_IS_REP * L + l] != 0;
  const int req_match = pol_sr[PS_REQ_MATCH * L + l] != 0;
  const int fs_r = pol_r[PR_FS * LANES_R + r] != 0;
  const int nt_r = ntype[r];  // node type seen by lane l (tiled by router)
  const int is_mc_lane = nt_r == NT_MC;

  // lane registers carried across cycles
  int head[PV], count[PV], rr[P];
#pragma unroll
  for (int i = 0; i < PV; ++i) {
    head[i] = head_g[i * L + l];
    count[i] = count_g[i * L + l];
  }
#pragma unroll
  for (int o = 0; o < P; ++o) rr[o] = rr_g[o * L + l];

  // node registers (threads 0..127)
  int mc_head = 0, mc_count = 0, mc_timer = 0, mc_svalid = 0, mc_sdst = 0;
  int mc_scls = 0, outst = 0, backlog = 0, phase = 0, nt = -1, n_req = 0;
  float pf[PF_ROWS] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (node_thread) {
    mc_head = mc[MC_HEAD * LANES_R + l];
    mc_count = mc[MC_COUNT * LANES_R + l];
    mc_timer = mc[MC_TIMER * LANES_R + l];
    mc_svalid = mc[MC_SVALID * LANES_R + l] != 0;
    mc_sdst = mc[MC_SDST * LANES_R + l];
    mc_scls = mc[MC_SCLS * LANES_R + l];
    outst = node[ND_OUTST * LANES_R + l];
    backlog = node[ND_BACKLOG * LANES_R + l];
    phase = node[ND_PHASE * LANES_R + l];
    nt = ntype[l];
    n_req = pol_r[PR_NREQ * LANES_R + l];
#pragma unroll
    for (int i = 0; i < PF_ROWS; ++i) pf[i] = prof[i * LANES_R + l];
  }
  if (l < N_COUNTERS) s_cnt[l] = cnt[l];

  // flight-recorder accumulators (B3), carried in registers from the
  // probe arrays handed in
  int acc_occ[PROBE ? PV : 1];
  int acc_grant = 0, acc_deny = 0, acc_mcq_sum = 0, acc_mcq_max = 0;
  int* p_occ = nullptr;
  int* p_arb = nullptr;
  int* p_mcq = nullptr;
  if constexpr (PROBE) {
    p_occ = g.p_occ + b * PV * L;
    p_arb = g.p_arb + b * 2 * L;
    p_mcq = g.p_mcq + b * 2 * LANES_R;
#pragma unroll
    for (int i = 0; i < PV; ++i) acc_occ[i] = p_occ[i * L + l];
    acc_grant = p_arb[PB_GRANT * L + l];
    acc_deny = p_arb[PB_DENY * L + l];
    if (node_thread) {
      acc_mcq_sum = p_mcq[PB_MCQ_SUM * LANES_R + l];
      acc_mcq_max = p_mcq[PB_MCQ_MAX * LANES_R + l];
    }
  }
  __syncthreads();

  for (int c = 0; c < g.n_cycles; ++c) {
    const int* xc = xi + c * XI_ROWS * L;
    const float* fc = xf + c * XF_ROWS * LANES_R;
    const int cycle = xc[XI_CYCLE * L + l];
    const int sa = xc[XI_SA * L + l];
    const int gate = xc[XI_GATE * L + l] != 0;
    const int active = xc[XI_ACTIVE * L + l] != 0;
    const int dest_x = xc[XI_DEST * L + l];

    // ---- phase 1 (node lanes): MC acceptance (queue depth before this
    // cycle's service), then MC service
    if (node_thread) {
      const int is_mc = nt == NT_MC;
      s_accept[l] = is_mc ? (mc_count <= g.Q - n_req) : 1;
      const int mc_ok = xc[XI_MCOK * L + l] != 0;
      const int can_serve = is_mc && mc_count > 0 && !mc_svalid && mc_ok;
      const int timer = can_serve ? max(mc_timer - 1, 0) : mc_timer;
      const int done = can_serve && timer == 0;
      const int q_head =
          (mc_head >= 0 && mc_head < g.Q) ? mcq[mc_head * LANES_R + l] : 0;
      if (done) {
        mc_head = floor_mod(mc_head + 1, g.Q);
        mc_count -= 1;
        mc_timer = g.mc_period;
        mc_sdst = q_head & ((1 << META_SRC_SHIFT) - 1);
        mc_scls = q_head >> META_SRC_SHIFT;
        mc_svalid = 1;
      } else {
        mc_timer = timer;
      }
      s_svalid[l] = mc_svalid;
      s_sdst[l] = mc_sdst;
      s_scls[l] = mc_scls;
    }
    __syncthreads();  // barrier 1: acceptance + staging published

    // ---- phase 2 (all lanes): peek, route, arbitrate, dequeue
    const int accept = sub_req ? s_accept[r] : 1;
    int va[PV], cl[PV], op[PV], dn[PV], meta_h[PV], binj_h[PV];
#pragma unroll
    for (int pv = 0; pv < PV; ++pv) {
      const int h = head[pv];
      const bool in = h >= 0 && h < B;
      const int row = (pv * B + (in ? h : 0)) * L + l;
      meta_h[pv] = in ? buf_meta[row] : 0;
      binj_h[pv] = in ? buf_binj[row] : 0;
      const int dest = meta_h[pv] & ((1 << META_SRC_SHIFT) - 1);
      cl[pv] = meta_h[pv] >> META_CLS_SHIFT;
      va[pv] = count[pv] > 0;
      op[pv] = dest < g.R ? route[dest * L + l] : 0;
    }
    // downstream credit: the neighbour's start-of-cycle counts (lane
    // l + delta wraps the whole lane axis; wrapped reads are masked)
#pragma unroll
    for (int o = 0; o < P; ++o) {
      const int nl = floor_mod(l + delta[o], L);
#pragma unroll
      for (int v = 0; v < V; ++v) dn[o * V + v] = count_g[(opp(o) * V + v) * L + nl];
    }
    Arb<V> a;
    lane_arbitrate<V>(va, cl, op, rr, dn, ex, gm, cm, sa, accept, active, B, a);
    int moved = 0;
#pragma unroll
    for (int o = 0; o < P; ++o) {
      int wm = 0, wb = 0;
#pragma unroll
      for (int pv = 0; pv < PV; ++pv) {
        wm = (pv == a.winner[o]) ? meta_h[pv] : wm;
        wb = (pv == a.winner[o]) ? binj_h[pv] : wb;
      }
      s_grant[o][l] = a.grant[o];
      s_dvc[o][l] = a.down_vc[o];
      s_wmeta[o][l] = wm;
      s_wbinj[o][l] = wb;
      rr[o] = a.new_rr[o];
      moved += a.grant[o];
      if constexpr (PROBE) {
        acc_grant += a.grant[o];
        acc_deny += a.any_req[o] && !a.grant[o];
      }
    }
#pragma unroll
    for (int pv = 0; pv < PV; ++pv) {
      if (a.deq[pv]) {
        head[pv] = (head[pv] + 1) % B;
        count[pv] -= 1;
      }
    }
    const int ej = a.grant[PORT_L];
    const int e_meta = s_wmeta[PORT_L][l];
    const int e_src = (e_meta >> META_SRC_SHIFT) &
                      ((1 << (META_CLS_SHIFT - META_SRC_SHIFT)) - 1);
    const int e_cls = a.w_cls[PORT_L];
    const int e_binj = s_wbinj[PORT_L][l];
    if (moved) atomicAdd(&s_cnt[C_MOVED], moved);
    if (a.any_req[PORT_L] && !accept && e_cls == 1)
      atomicAdd(&s_cnt[C_GPU_STALL_DRAM], 1);
    __syncthreads();  // barrier 2: grants published, neighbour counts read

    // ---- phase 3 (all lanes): link pull from the unique upstream sender,
    // ejection bookkeeping and latency counters
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int nl = floor_mod(l + delta[p], L);
      const int po = opp(p);
      if (s_grant[po][nl] && ex[p]) {
        const int vc = s_dvc[po][nl];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (vc == v) {
            const int pv = p * V + v;
            const int tail = (head[pv] + count[pv]) % B;
            buf_meta[(pv * B + tail) * L + l] = s_wmeta[po][nl];
            buf_binj[(pv * B + tail) * L + l] = s_wbinj[po][nl];
            count[pv] += 1;
          }
        }
      }
    }
    s_req_ej[l] = ej && sub_req && is_mc_lane;
    s_qval[l] = e_src + (e_cls << META_SRC_SHIFT);
    s_rep_ej[l] = ej && sub_rep && !is_mc_lane;
    s_ecls[l] = e_cls;
    if (ej) {
      int age = cycle - e_binj;
      if (g.stamp_mask) age &= g.stamp_mask;
      atomicAdd(&s_cnt[C_LAT_SUM], age);
      atomicAdd(&s_cnt[C_LAT_CNT], 1);
      if (e_cls == 0) {
        atomicAdd(&s_cnt[C_CPU_LAT_SUM], age);
        atomicAdd(&s_cnt[C_CPU_LAT_CNT], 1);
      } else if (e_cls == 1) {
        atomicAdd(&s_cnt[C_GPU_LAT_SUM], age);
        atomicAdd(&s_cnt[C_GPU_LAT_CNT], 1);
      }
    }
    __syncthreads();  // barrier 3: ejections published

    // ---- phase 4 (node lanes): MC enqueue (one thread per router, looping
    // over subnets in order: the exclusive prefix fixes the slot order),
    // reply completion, source generation
    if (node_thread) {
      int rep_done = 0, rep_cls = 0;
      if (l < R_PAD) {
        int off = 0;
        for (int sb = 0; sb < g.S; ++sb) {
          const int i = sb * R_PAD + l;
          if (s_req_ej[i]) {
            const int slot = floor_mod(mc_head + mc_count + off, g.Q);
            mcq[slot * LANES_R + l] = s_qval[i];
            off += 1;
          }
          if (s_rep_ej[i]) {
            rep_done = 1;
            rep_cls += s_ecls[i];
          }
        }
        mc_count += off;
      }
      if constexpr (PROBE) {  // queue depth after service and enqueue
        acc_mcq_sum += mc_count;
        acc_mcq_max = max(acc_mcq_max, mc_count);
      }
      outst -= rep_done;
      const float u_ph = fc[XF_UPHASE * LANES_R + l];
      const float u_gen = fc[XF_UGEN * LANES_R + l];
      const int enter = phase == 0 && u_ph < pf[PF_ENTER];
      const int leave = phase == 1 && u_ph < pf[PF_EXIT];
      phase = enter ? 1 : (leave ? 0 : phase);
      float rate = nt == NT_GPU ? (phase == 1 ? pf[PF_HI] : pf[PF_LO]) : 0.f;
      rate = nt == NT_CPU ? pf[PF_CPU] : rate;
      const int gen = (u_gen < rate) && nt != NT_MC;
      if (gen && backlog < g.bcap) backlog += 1;
      s_can_inj[l] = backlog > 0 && outst < g.mshr_limit && nt != NT_MC;
      if (gen && nt == NT_GPU) atomicAdd(&s_cnt[C_GPU_GEN], 1);
      if (gen && nt == NT_CPU) atomicAdd(&s_cnt[C_CPU_GEN], 1);
      if (rep_done && rep_cls == 1) atomicAdd(&s_cnt[C_GPU_DONE], 1);
      if (rep_done && rep_cls == 0) atomicAdd(&s_cnt[C_CPU_DONE], 1);
    }
    __syncthreads();  // barrier 4: injection wants published

    // ---- phase 5 (all lanes): the merged inject at the Local port
    {
      const int svalid_r = s_svalid[r], scls_r = s_scls[r];
      const int want_src = req_match && s_can_inj[r];
      const int rep_target = fs_r ? 2 * scls_r + 1 : 1;
      const int want_rep =
          (s == rep_target) && svalid_r && is_mc_lane && sub_en && gate;
      const int dest_i = sub_req ? dest_x : s_sdst[r];
      const int cls_i = sub_req ? (nt_r == NT_GPU ? 1 : 0) : scls_r;
      const int binj_i = sub_req ? cycle : cycle + 1;
      int first = V, any_has = 0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int allowed = (cls_i == 1) ? gm[v] : cm[v];
        const int has = count[PORT_L * V + v] < B && allowed;
        if (has && first == V) first = v;
        any_has |= has;
      }
      const int ok = (want_src || want_rep) && any_has;
      const int vc = any_has ? first : 0;
      if (ok) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (vc == v) {
            const int pv = PORT_L * V + v;
            const int tail = (head[pv] + count[pv]) % B;
            buf_meta[(pv * B + tail) * L + l] =
                dest_i + (r << META_SRC_SHIFT) + (cls_i << META_CLS_SHIFT);
            buf_binj[(pv * B + tail) * L + l] = binj_i;
            count[pv] += 1;
          }
        }
      }
      s_ok[l] = ok;
#pragma unroll
      for (int i = 0; i < PV; ++i) count_g[i * L + l] = count[i];
      if constexpr (PROBE) {  // end-of-cycle counts
#pragma unroll
        for (int i = 0; i < PV; ++i) acc_occ[i] += count[i];
      }
    }
    __syncthreads();  // barrier 5: inject outcomes + end-of-cycle counts

    // ---- phase 6 (node lanes): injection bookkeeping, node counters
    if (node_thread) {
      int inj_ok = 0, stage_hit = 0;
      if (l < R_PAD) {
        for (int sb = 0; sb < g.S; ++sb) {
          const int i = sb * R_PAD + l;
          const int req = pol_sr[PS_IS_REQ * L + i] != 0;
          inj_ok |= s_ok[i] && req;
          stage_hit |= s_ok[i] && !req;
        }
      }
      mc_svalid = mc_svalid && !stage_hit;
      backlog -= inj_ok;
      outst += inj_ok;
      if (inj_ok && nt == NT_GPU) atomicAdd(&s_cnt[C_GPU_PUSH], 1);
      if (inj_ok && nt == NT_CPU) atomicAdd(&s_cnt[C_CPU_PUSH], 1);
      if (nt == NT_GPU && backlog > 0) atomicAdd(&s_cnt[C_GPU_STALL_ICNT], 1);
    }
  }

  // write the carried registers back
#pragma unroll
  for (int i = 0; i < PV; ++i) head_g[i * L + l] = head[i];
#pragma unroll
  for (int o = 0; o < P; ++o) rr_g[o * L + l] = rr[o];
  if (node_thread) {
    mc[MC_HEAD * LANES_R + l] = mc_head;
    mc[MC_COUNT * LANES_R + l] = mc_count;
    mc[MC_TIMER * LANES_R + l] = mc_timer;
    mc[MC_SVALID * LANES_R + l] = mc_svalid;
    mc[MC_SDST * LANES_R + l] = mc_sdst;
    mc[MC_SCLS * LANES_R + l] = mc_scls;
    node[ND_OUTST * LANES_R + l] = outst;
    node[ND_BACKLOG * LANES_R + l] = backlog;
    node[ND_PHASE * LANES_R + l] = phase;
  }
  if constexpr (PROBE) {
#pragma unroll
    for (int i = 0; i < PV; ++i) p_occ[i * L + l] = acc_occ[i];
    p_arb[PB_GRANT * L + l] = acc_grant;
    p_arb[PB_DENY * L + l] = acc_deny;
    if (node_thread) {
      p_mcq[PB_MCQ_SUM * LANES_R + l] = acc_mcq_sum;
      p_mcq[PB_MCQ_MAX * LANES_R + l] = acc_mcq_max;
    }
  }
  __syncthreads();
  if (l < N_COUNTERS) cnt[l] = s_cnt[l];
}

template <int V>
void launch_arbitrate(const int* const* in, int depth, int L, int* const* out,
                      cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  noc_arbitrate_kernel<V><<<blocks, threads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], depth, L, out[0], out[1], out[2], out[3], out[4], out[5],
      out[6]);
}

// Launches B2 (PROBE = false) or B3 on `batch` simulations.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a (V, B) pair without
// an instantiation or a lane axis wider than one block.
template <bool PROBE>
int launch_fused(const CycleArgs& args, int batch, int V, int B,
                 void* stream) {
  if (args.S * R_PAD > MAX_L || (args.S * R_PAD) % LANES_R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Only the paper's (V, B) = (4, 4) is instantiated, as for B1.
  if (V != 4 || B != 4) return static_cast<int>(cudaErrorInvalidValue);
  noc_fused_cycles_kernel<4, 4, PROBE>
      <<<batch, args.S * R_PAD, 0, static_cast<cudaStream_t>(stream)>>>(
          args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Inputs (11 pointers, rows x L int32 in fused.lane_arbitrate's order:
// valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
// active) and outputs (7 pointers: grant, winner, down_vc, deq, new_rr,
// any_req, w_cls).  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a VC count without an instantiation.
int noc_arbitrate(const int* valid, const int* cls, const int* out_port,
                  const int* rr, const int* down, const int* exists,
                  const int* gmask, const int* cmask, const int* sa,
                  const int* accept, const int* active, int depth, int n_vcs,
                  int L, int* grant, int* winner, int* down_vc, int* deq,
                  int* new_rr, int* any_req, int* w_cls, void* stream) {
  const int* in[11] = {valid, cls, out_port, rr, down, exists,
                       gmask, cmask, sa, accept, active};
  int* out[7] = {grant, winner, down_vc, deq, new_rr, any_req, w_cls};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Only the paper's V=4 is instantiated: a further instantiation is added
  // together with an on-card check of it.
  if (n_vcs != 4) return static_cast<int>(cudaErrorInvalidValue);
  launch_arbitrate<4>(in, depth, L, out, st);
  return static_cast<int>(cudaGetLastError());
}

// B2: runs n_cycles whole cycles on `batch` simulations, updating the
// nine LaneState arrays in place.
int noc_fused_cycles(int batch, int n_cycles, int S, int R, int V, int B,
                     int Q, int width, int mc_period, int mshr_limit,
                     int bcap, int stamp_mask, int* buf_meta, int* buf_binj,
                     int* head, int* count, int* rr, int* mcq, int* mc,
                     int* node, int* cnt, const int* xi, const float* xf,
                     const int* gmask, const int* cmask, const float* prof,
                     const int* pol_sr, const int* pol_r, const int* ntype,
                     const int* route, const int* exists, void* stream) {
  CycleArgs a{buf_meta, buf_binj, head,  count, rr,     mcq,    mc,
              node,     cnt,      xi,    xf,    gmask,  cmask,  prof,
              pol_sr,   pol_r,    ntype, route, exists, n_cycles, S,
              R,        Q,        width, mc_period, mshr_limit, bcap,
              stamp_mask, nullptr, nullptr, nullptr};
  return launch_fused<false>(a, batch, V, B, stream);
}

// B3: B2 plus the ProbeLanes carry (p_occ (P*V, L), p_arb (2, L), p_mcq
// (2, 128) per simulation), which it ADDS to in place.
int noc_fused_cycles_probed(
    int batch, int n_cycles, int S, int R, int V, int B, int Q, int width,
    int mc_period, int mshr_limit, int bcap, int stamp_mask, int* buf_meta,
    int* buf_binj, int* head, int* count, int* rr, int* mcq, int* mc,
    int* node, int* cnt, const int* xi, const float* xf, const int* gmask,
    const int* cmask, const float* prof, const int* pol_sr,
    const int* pol_r, const int* ntype, const int* route,
    const int* exists, int* p_occ, int* p_arb, int* p_mcq, void* stream) {
  CycleArgs a{buf_meta, buf_binj, head,  count, rr,     mcq,    mc,
              node,     cnt,      xi,    xf,    gmask,  cmask,  prof,
              pol_sr,   pol_r,    ntype, route, exists, n_cycles, S,
              R,        Q,        width, mc_period, mshr_limit, bcap,
              stamp_mask, p_occ, p_arb, p_mcq};
  return launch_fused<true>(a, batch, V, B, stream);
}

}  // extern "C"
