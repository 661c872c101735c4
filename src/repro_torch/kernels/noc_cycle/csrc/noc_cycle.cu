// Hand-written Hopper (sm_90a) kernels for the NoC cycle engine.
//
// noc_arbitrate  replaces repro/kernels/noc_cycle/kernel.py::_noc_cycle_kernel
//   One cycle of switch allocation per (subnet, router) lane: downstream VC
//   pick under the GPU/CPU VC masks, per-output round robin or SA-preferred
//   class, and the one-traversal-per-input filter.  One thread per lane,
//   64 threads a block.  Bound on this card: it reads ~80 small values and
//   writes 55 per lane (a few KB for the paper's 144 dense lanes) and does a
//   few hundred integer ops per lane, far below a microsecond of memory or
//   ALU time; its time is one launch.  So the design is about the launch:
//   the kernel reads its 11 operands and writes its 7 outputs where the
//   caller holds them, through per-operand strides and element types in a
//   by-value descriptor (ArbArgs).  The dense engine's tensors, (S, R, .)
//   with bool, int8 and int32 elements and broadcast views (zero strides),
//   are read in place; the (rows, L) lane rows of B2's layout are another
//   stride pattern of the same kernel.  No copies, casts, pads or
//   transposes run around it: one call is one launch.  Lanes go to threads
//   in the caller's row-major lane order (a dense lane's PV values are
//   contiguous, a warp's loads one contiguous span).  It packs its operands
//   into the bitmasks of lane_arbitrate below.
//
// noc_fused_cycles  replaces repro/kernels/noc_cycle/kernel.py::_fused_cycle_kernel
//   Whole NoC cycles on the int32 LaneState (layout in fused.py): MC service,
//   route + arbitration, dequeue and link traversal, MC enqueue, reply
//   completion, source generation, the merged inject and the 15 counters.
//   One thread block per simulation (the grid is the batch), one thread per
//   lane of the S*64 lane axis plus two warps for node lanes 64..127,
//   looping over n_cycles inside; with n_cycles = 1 it computes exactly one
//   TPU kernel step.  It UPDATES THE STATE ARRAYS IN PLACE (the wrapper
//   hands it fresh copies).
//   Bound on this card: the cycles are strictly sequential, so a launch is
//   a chain of n_cycles dependent cycles on one SM, and every lane waits
//   for its neighbours twice a cycle (their grants, then their end-of-cycle
//   counts).  Neither bytes nor the card's int32 rate bound it: the
//   instructions of one cycle, issued by 8 warps on 4 schedulers, do.  The
//   design keeps those few and off device memory:
//   - the lane state lives in shared memory for the whole launch, read once
//     at the start and written back once at the end: the FIFO words (meta,
//     binj), a code byte per FIFO slot (its packet's output port at this
//     lane and class bits, written with the slot), the route table, the MC
//     queues of routers 0..63; per-VC counts and head pointers live in
//     registers, packed (W[p], h0/h1);
//   - arbitration works on bitmasks: the head peek reads one code word per
//     VC and builds per-output request masks in one pass, the round robin
//     is a mask above rr and a find-first-set (preferred class first), the
//     one-traversal filter a 5-bit mask; the winner's FIFO word is read by
//     index;
//   - threads are router-major (thread r*S + s owns lane s*64 + r), so the S
//     subnet lanes of a router sit in one warp: every lane keeps a copy of
//     its router's node state and the node stages (MC service, enqueue in
//     subnet order, replies, generation, inject bookkeeping) run on warp
//     ballots and shuffles.  Two barriers a cycle remain, named barriers
//     over the lane threads: after the grants (neighbours pull) and at the
//     end (neighbours read end-of-cycle room, a bitmask of VCs);
//   - each cycle's xi/xf rows arrive in a ring of NSTAGE slots in shared
//     memory, one 1-D TMA bulk copy per row block issued by thread 0 and
//     completed on an mbarrier (a stuck wait traps after 2^28 polls); a
//     cycle reads the next one's rows among its arithmetic;
//   - counters are summed in registers across the cycles and reduced once
//     (integer sums are order-independent, so results stay bitwise);
//   - node lanes 64..127, which no subnet lane reads or feeds, run their
//     recurrence on the two extra warps beside the cycle loop.
//   The state must keep the FIFO invariants (0 <= head < B, 0 <= count <=
//   B), as every state built by fused.pack_state and every kernel step does.
//
// noc_fused_cycles_probed  replaces
//   repro/kernels/noc_cycle/kernel.py::_fused_cycle_probed_kernel
//   B2 plus the flight-recorder carry (fused.ProbeLanes): per lane the
//   summed end-of-cycle VC counts and the summed switch grants and
//   refusals, per node the summed and maxed MC queue depth after service
//   and enqueue.  It is the PROBE = true instantiation of B2's kernel: the
//   probe code sits in `if constexpr` blocks, so the probes-off
//   instantiation is B2 unchanged.  The accumulators live in registers
//   across the cycle loop and are added to the probe arrays once, after
//   the loop; no barrier is added.  Bound on this card: B2's.
//
// noc_fused_cycles_clocked  B2's clocked development instantiation (CLOCKS =
//   true; nothing on a main path launches it): thread 0's clock64() sums
//   per stage of a cycle, for the split printed by chip_smoke.py.
//
// All three kernels call one __device__ lane_arbitrate, so they cannot
// drift.
// Every C entry point returns cudaGetLastError() (0 = launched) or the
// error of the launch's set-up.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int P = 5;          // ports N, E, S, W, Local
constexpr int PORT_L = 4;
constexpr int R_PAD = 64;     // router lanes per subnet block
constexpr int LANES_R = 128;  // per-node lanes
constexpr int NT_CPU = 0, NT_GPU = 1, NT_MC = 2;
constexpr int META_SRC_SHIFT = 6, META_CLS_SHIFT = 12;
constexpr unsigned FULL = 0xffffffffu;

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
__host__ __device__ constexpr int opp(int p) {
  return p == PORT_L ? p : (p + 2) % 4;
}

// floor modulo: C's % truncates toward zero, the reference floors
__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// floor_mod(a, n) without a division where 0 <= a < 2n (an MC ring index)
__device__ __forceinline__ int ring_mod(int a, int n) {
  return a >= 0 && a < n ? a : (a >= n && a < 2 * n ? a - n : floor_mod(a, n));
}

// ---------------------------------------------------------------------------
// Switch allocation on bitmasks
// ---------------------------------------------------------------------------
template <int V>
struct Arb {
  unsigned grant, any, deq;  // bit o, bit o, bit pv
  int winner[P], down_vc[P], new_rr[P], w_cls[P];
};

// Round robin over the requesters rq: the first at or after rot in the
// cyclic order, preferred ones (pref) first; 0 for an empty mask (the
// reference's least packed key floor_mod(pv - rr, PV) + PV * !preferred).
__device__ __forceinline__ int rr_winner(unsigned rq, unsigned pref, int rot) {
  const unsigned m = (rq & pref) ? (rq & pref) : rq;
  const unsigned hi = m & (~0u << rot);
  return m ? __ffs(hi ? hi : m) - 1 : 0;
}

// Request masks from per-VC output codes: VC pv's code (its head's output
// port 0..P-1, or 7 for no request) goes to bit pv % 10 of three 10-bit
// planes of word pv / 10 (one multiply spreads the code's three bits);
// output o's mask is the VCs whose planes spell o.
__device__ __forceinline__ void add_code(unsigned (&planes)[2], int pv,
                                         unsigned code) {
  planes[pv / 10] += ((code * 0x40201u) & 0x100401u) << (pv % 10);
}

__device__ __forceinline__ void requests(const unsigned (&planes)[2],
                                         unsigned (&req)[P]) {
  unsigned rq[2][P];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned b0 = planes[h] & 0x3FF, b1 = (planes[h] >> 10) & 0x3FF,
                   b2 = planes[h] >> 20;
    rq[h][0] = ~b0 & ~b1 & ~b2 & 0x3FF;
    rq[h][1] = b0 & ~b1 & ~b2;
    rq[h][2] = ~b0 & b1 & ~b2;
    rq[h][3] = b0 & b1 & ~b2;
    rq[h][4] = ~b0 & ~b1 & b2;
  }
#pragma unroll
  for (int o = 0; o < P; ++o) req[o] = rq[0][o] | (rq[1][o] << 10);
}

// Switch allocation for one lane; value for value fused.lane_arbitrate,
// including its garbage conventions: an empty column's winner is 0, a VC
// without credit is 0, rr is kept where nothing is granted.
//   req[o]    input VCs (bit pv) whose valid head packet routes to output o
//   pref      input VCs whose head is of the preferred class (all if sa < 0)
//   rr, rot   round-robin pointers, and the same reduced mod P*V
//   space[o]  downstream VCs (bit v) of output o with room
//   exists    bit o: the link through output o is usable
//   gm, cm    GPU / CPU VC masks (bit v)
//   cls_of(o, w)  the class of input VC w's head packet, read for output
//             o's winner (also for the garbage winner 0)
// One traversal per input port keeps the lowest granted output.
template <int V, class ClsOf>
__device__ __forceinline__ void lane_arbitrate(
    const unsigned (&req)[P], unsigned pref, const int (&rr)[P],
    const int (&rot)[P], const unsigned (&space)[P], unsigned exists,
    unsigned gm, unsigned cm, int accept, int active, ClsOf cls_of,
    Arb<V>& a) {
  constexpr int PV = P * V;
  static_assert(PV <= 20, "the request planes hold 20 VCs");
  unsigned used = 0;
  a.grant = a.any = a.deq = 0;
#pragma unroll
  for (int o = 0; o < P; ++o) {
    const unsigned rq = req[o];
    const int win = rr_winner(rq, pref, rot[o]);
    const int wc = cls_of(o, win);
    const unsigned has = space[o] & (wc == 1 ? gm : cm);
    const int g0 = (o == PORT_L)
                       ? (rq != 0 && accept && active)
                       : (rq != 0 && ((exists >> o) & 1) && has != 0 && active);
    const int wp = win / V;
    const int g = g0 && !((used >> wp) & 1);
    used |= static_cast<unsigned>(g0) << wp;
    a.winner[o] = win;
    a.w_cls[o] = wc;
    a.down_vc[o] = has ? __ffs(has) - 1 : 0;
    a.new_rr[o] = g ? (win + 1 == PV ? 0 : win + 1) : rr[o];
    a.grant |= static_cast<unsigned>(g) << o;
    a.any |= static_cast<unsigned>(rq != 0) << o;
    a.deq |= static_cast<unsigned>(g) << win;
  }
}

// ---------------------------------------------------------------------------
// B1: arbitration only, one thread per lane, every operand through strides
// ---------------------------------------------------------------------------
constexpr int ARB_LEAD = 4;     // lane dims (the caller's leading dims)
constexpr int ARB_IN = 11, ARB_OUT = 7;
constexpr int ARB_THREADS = 64;
// element types of an operand (the wrapper's codes): 1-byte unsigned (bool,
// uint8), int8, int16, int32, int64 (its low 32 bits, as .to(int32) keeps);
// outputs are 1-byte bool or int32
enum { T_U8, T_I8, T_I16, T_I32, T_I64, N_TYPES };
// the operands, in fused.lane_arbitrate's order, then the outputs
enum { I_VALID, I_CLS, I_OUT_PORT, I_RR, I_DOWN, I_EXISTS, I_GMASK, I_CMASK,
       I_SA, I_ACCEPT, I_ACTIVE };
enum { O_GRANT, O_WINNER, O_DOWN_VC, O_DEQ, O_NEW_RR, O_ANY_REQ, O_W_CLS };
// what a packed descriptor holds (int64 words): the header, then 8 words an
// operand (pointer, type, ARB_LEAD lane strides, the tail's two strides)
enum { D_LANES, D_DEPTH, D_VCS, D_SIZE, D_HEADER = D_SIZE + ARB_LEAD };
constexpr int D_OPERAND = 2 + ARB_LEAD + 2;

// Element (lane, i, j) of an operand sits at
//   ptr + sum_k lane_k * stride[k] + i * stride[ARB_LEAD] + j * stride[ARB_LEAD + 1]
// elements: i is the tail's first index (the PV requester, the output port
// or the VC), j its second (down_count's VC).  A broadcast dim has stride 0.
struct Operand {
  void* ptr;
  long long stride[ARB_LEAD + 2];
  int type;
};

struct ArbArgs {
  Operand in[ARB_IN];
  Operand out[ARB_OUT];
  int size[ARB_LEAD];  // lane dims, row-major, padded with leading 1s
  int lanes, depth;
};

// An operand's NI x NJ values of one lane, element (i, j) at base + i *
// stride[ARB_LEAD] + j * stride[ARB_LEAD + 1], as int (an int64 keeps its
// low 32 bits).  The element type is one branch per operand, outside the
// loads, so that all of an operand's loads issue back to back and every
// operand's are in flight before the arbitration uses any.
template <class T, int NI, int NJ>
__device__ __forceinline__ void load_as(const Operand& t, long long base,
                                        int (&out)[NI * NJ]) {
  const T* p = static_cast<const T*>(t.ptr) + base;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      out[i * NJ + j] = static_cast<int>(
          p[i * t.stride[ARB_LEAD] + j * t.stride[ARB_LEAD + 1]]);
}

template <int NI, int NJ = 1>
__device__ __forceinline__ void load_operand(const Operand& t, long long base,
                                             int (&out)[NI * NJ]) {
  switch (t.type) {
    case T_U8: load_as<unsigned char, NI, NJ>(t, base, out); break;
    case T_I8: load_as<signed char, NI, NJ>(t, base, out); break;
    case T_I16: load_as<short, NI, NJ>(t, base, out); break;
    case T_I32: load_as<int, NI, NJ>(t, base, out); break;
    default: load_as<long long, NI, NJ>(t, base, out); break;
  }
}

// An output's N values of one lane (bool outputs are 0/1)
template <int N>
__device__ __forceinline__ void store_operand(const Operand& t,
                                              long long base,
                                              const int (&v)[N]) {
  if (t.type == T_U8) {
    unsigned char* p = static_cast<unsigned char*>(t.ptr) + base;
#pragma unroll
    for (int i = 0; i < N; ++i)
      p[i * t.stride[ARB_LEAD]] = static_cast<unsigned char>(v[i]);
  } else {
    int* p = static_cast<int*>(t.ptr) + base;
#pragma unroll
    for (int i = 0; i < N; ++i) p[i * t.stride[ARB_LEAD]] = v[i];
  }
}

// the operand's offset of a lane, from its index over the lane dims
__device__ __forceinline__ long long lane_offset(const Operand& t,
                                                 const int (&idx)[ARB_LEAD]) {
  long long o = 0;
#pragma unroll
  for (int k = 0; k < ARB_LEAD; ++k) o += idx[k] * t.stride[k];
  return o;
}

template <int V>
__global__ void __launch_bounds__(ARB_THREADS)
noc_arbitrate_kernel(const __grid_constant__ ArbArgs g) {
  constexpr int PV = P * V;
  const int l = blockIdx.x * ARB_THREADS + threadIdx.x;
  if (l >= g.lanes) return;
  int idx[ARB_LEAD];
  int rem = l;
#pragma unroll
  for (int k = ARB_LEAD - 1; k >= 0; --k) {
    idx[k] = rem % g.size[k];
    rem /= g.size[k];
  }
  // every operand of the lane first, then the arbitration
  int va[PV], cl[PV], op[PV], r[P], dn[P * V], exv[P], gmv[V], cmv[V],
      sa[1], acc[1], act[1];
  load_operand<PV>(g.in[I_VALID], lane_offset(g.in[I_VALID], idx), va);
  load_operand<PV>(g.in[I_CLS], lane_offset(g.in[I_CLS], idx), cl);
  load_operand<PV>(g.in[I_OUT_PORT], lane_offset(g.in[I_OUT_PORT], idx), op);
  load_operand<P>(g.in[I_RR], lane_offset(g.in[I_RR], idx), r);
  load_operand<P, V>(g.in[I_DOWN], lane_offset(g.in[I_DOWN], idx), dn);
  load_operand<P>(g.in[I_EXISTS], lane_offset(g.in[I_EXISTS], idx), exv);
  load_operand<V>(g.in[I_GMASK], lane_offset(g.in[I_GMASK], idx), gmv);
  load_operand<V>(g.in[I_CMASK], lane_offset(g.in[I_CMASK], idx), cmv);
  load_operand<1>(g.in[I_SA], lane_offset(g.in[I_SA], idx), sa);
  load_operand<1>(g.in[I_ACCEPT], lane_offset(g.in[I_ACCEPT], idx), acc);
  load_operand<1>(g.in[I_ACTIVE], lane_offset(g.in[I_ACTIVE], idx), act);

  unsigned planes[2] = {0, 0}, req[P], space[P] = {}, pref = 0, ex = 0,
           gm = 0, cm = 0;
#pragma unroll
  for (int i = 0; i < PV; ++i) {
    add_code(planes, i, va[i] != 0 && op[i] >= 0 && op[i] < P ? op[i] : 7u);
    pref |= static_cast<unsigned>(cl[i] == sa[0]) << i;
  }
  if (sa[0] < 0) pref = (1u << PV) - 1;
  requests(planes, req);
  int rot[P];
#pragma unroll
  for (int o = 0; o < P; ++o) {
    rot[o] = floor_mod(r[o], PV);
    ex |= static_cast<unsigned>(exv[o] != 0) << o;
#pragma unroll
    for (int v = 0; v < V; ++v)
      space[o] |= static_cast<unsigned>(dn[o * V + v] < g.depth) << v;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    gm |= static_cast<unsigned>(gmv[v] != 0) << v;
    cm |= static_cast<unsigned>(cmv[v] != 0) << v;
  }
  auto cls_of = [&](int, int w) {
    int c = cl[0];
#pragma unroll
    for (int i = 1; i < PV; ++i) c = (i == w) ? cl[i] : c;
    return c;
  };
  Arb<V> a;
  lane_arbitrate<V>(req, pref, r, rot, space, ex, gm, cm, acc[0] != 0,
                    act[0] != 0, cls_of, a);
  int grant[P], any[P], deq[PV];
#pragma unroll
  for (int o = 0; o < P; ++o) {
    grant[o] = (a.grant >> o) & 1;
    any[o] = (a.any >> o) & 1;
  }
#pragma unroll
  for (int i = 0; i < PV; ++i) deq[i] = (a.deq >> i) & 1;
  const Operand* out = g.out;
  store_operand<P>(out[O_GRANT], lane_offset(out[O_GRANT], idx), grant);
  store_operand<P>(out[O_WINNER], lane_offset(out[O_WINNER], idx), a.winner);
  store_operand<P>(out[O_DOWN_VC], lane_offset(out[O_DOWN_VC], idx),
                   a.down_vc);
  store_operand<PV>(out[O_DEQ], lane_offset(out[O_DEQ], idx), deq);
  store_operand<P>(out[O_NEW_RR], lane_offset(out[O_NEW_RR], idx), a.new_rr);
  store_operand<P>(out[O_ANY_REQ], lane_offset(out[O_ANY_REQ], idx), any);
  store_operand<P>(out[O_W_CLS], lane_offset(out[O_W_CLS], idx), a.w_cls);
}

// ---------------------------------------------------------------------------
// Shared-memory ring of cycle inputs: mbarriers and 1-D TMA bulk copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's earlier shared-memory accesses (and, through the
// barrier before it, the block's) before later bulk copies into them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// global -> shared bulk copy of `bytes` (16-byte aligned, a multiple of
// 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier's phase with this parity has completed.  A wait
// that outlasts 2^28 polls (seconds) is a fault: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done, stuck;\n.reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "NOC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra NOC_DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.gt.u32 stuck, polls, 268435456;\n"
      "@stuck trap;\n"
      "bra NOC_WAIT;\n"
      "NOC_DONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// named barrier `id` over the first `count` threads of the block
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
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
  long long* clocks;           // CLOCKS: (N_CLOCKS,) per-stage clock sums
};

constexpr int NSTAGE = 2;     // cycles of xi/xf rows in flight
constexpr int N_CLOCKS = 7;   // marks of the clocked instantiation

// Dynamic shared memory of one block, in bytes from its base: the xi/xf
// ring, the FIFO words (meta, binj) and a code byte per FIFO slot, the
// route table, the winners' published words and grants, the room masks,
// the MC queues of routers 0..63 and the ring's mbarriers.  At the paper's
// L = 256, R = 36, Q = 16: 224,272 bytes of the 232,448 a block may use.
struct Smem {
  int ring, slot, meta, binj, code, route, xmeta, xbinj, gv, space, mcq, bar,
      total;
  __host__ __device__ Smem(int V, int B, int L, int R, int Q) {
    const int PV = P * V;
    slot = (XI_ROWS * L + XF_ROWS * LANES_R) * 4;
    ring = 0;
    meta = ring + NSTAGE * slot;
    binj = meta + PV * B * L * 4;
    code = binj + PV * B * L * 4;
    route = code + PV * L * 4;
    xmeta = route + (R + 3) / 4 * L * 4;
    xbinj = xmeta + P * L * 4;
    gv = xbinj + P * L * 4;
    space = gv + L * 4;
    mcq = space + L * 4;
    bar = (mcq + Q * R_PAD * 4 + 7) & ~7;
    total = bar + NSTAGE * 8;
  }
};

// One router's node state (MC ring pointers and staging, MSHRs, source
// backlog and burst phase).
struct Node {
  int mc_head, mc_count, mc_timer, mc_svalid, mc_sdst, mc_scls;
  int outst, backlog, phase;
};

__device__ __forceinline__ Node load_node(const int* mc, const int* node,
                                          int i) {
  return Node{mc[MC_HEAD * LANES_R + i],    mc[MC_COUNT * LANES_R + i],
              mc[MC_TIMER * LANES_R + i],   mc[MC_SVALID * LANES_R + i] != 0,
              mc[MC_SDST * LANES_R + i],    mc[MC_SCLS * LANES_R + i],
              node[ND_OUTST * LANES_R + i], node[ND_BACKLOG * LANES_R + i],
              node[ND_PHASE * LANES_R + i]};
}

__device__ __forceinline__ void store_node(const Node& n, int* mc, int* node,
                                           int i) {
  mc[MC_HEAD * LANES_R + i] = n.mc_head;
  mc[MC_COUNT * LANES_R + i] = n.mc_count;
  mc[MC_TIMER * LANES_R + i] = n.mc_timer;
  mc[MC_SVALID * LANES_R + i] = n.mc_svalid;
  mc[MC_SDST * LANES_R + i] = n.mc_sdst;
  mc[MC_SCLS * LANES_R + i] = n.mc_scls;
  node[ND_OUTST * LANES_R + i] = n.outst;
  node[ND_BACKLOG * LANES_R + i] = n.backlog;
  node[ND_PHASE * LANES_R + i] = n.phase;
}

// MC service tick: timers, head request -> staging.  `q` is the node's MC
// ring column (slot i at q[i * q_stride]).
__device__ __forceinline__ void mc_service(Node& n, int is_mc, int mc_ok,
                                           const int* q, int q_stride, int Q,
                                           int mc_period) {
  const int can_serve = is_mc && n.mc_count > 0 && !n.mc_svalid && mc_ok;
  const int timer = can_serve ? max(n.mc_timer - 1, 0) : n.mc_timer;
  if (can_serve && timer == 0) {
    const int q_head =
        (n.mc_head >= 0 && n.mc_head < Q) ? q[n.mc_head * q_stride] : 0;
    n.mc_head = ring_mod(n.mc_head + 1, Q);
    n.mc_count -= 1;
    n.mc_timer = mc_period;
    n.mc_sdst = q_head & ((1 << META_SRC_SHIFT) - 1);
    n.mc_scls = q_head >> META_SRC_SHIFT;
    n.mc_svalid = 1;
  } else {
    n.mc_timer = timer;
  }
}

// burst phase and source generation; returns whether the node generated
__device__ __forceinline__ int generate(Node& n, int nt,
                                        const float (&pf)[PF_ROWS], float u_ph,
                                        float u_gen, int bcap) {
  const int enter = n.phase == 0 && u_ph < pf[PF_ENTER];
  const int leave = n.phase == 1 && u_ph < pf[PF_EXIT];
  n.phase = enter ? 1 : (leave ? 0 : n.phase);
  float rate = nt == NT_GPU ? (n.phase == 1 ? pf[PF_HI] : pf[PF_LO]) : 0.f;
  rate = nt == NT_CPU ? pf[PF_CPU] : rate;
  const int gen = (u_gen < rate) && nt != NT_MC;
  if (gen && n.backlog < bcap) n.backlog += 1;
  return gen;
}

// the count of VC v of one input port: 4-bit fields of the port's word
__device__ __forceinline__ int cnt_of(unsigned w, int v) {
  return (w >> (4 * v)) & 0xF;
}

// the head pointer of VC pv: 2-bit fields, VCs 0..15 in h0, 16..19 in h1
// (two words and a select, so that a winner's head is not an indexed
// array access, which the compiler would put in local memory)
__device__ __forceinline__ int head_of(unsigned h0, unsigned h1, int pv) {
  return ((pv < 16 ? h0 : h1) >> (2 * (pv & 15))) & 3;
}

// bit i (< 16) of x moved to bit 2i
__device__ __forceinline__ unsigned spread2(unsigned x) {
  x &= 0xFFFF;
  x = (x | (x << 8)) & 0x00FF00FF;
  x = (x | (x << 4)) & 0x0F0F0F0F;
  x = (x | (x << 2)) & 0x33333333;
  return (x | (x << 1)) & 0x55555555;
}

// adds 1 (mod 4) to the 2-bit fields of h whose low bit is set in x
__device__ __forceinline__ unsigned bump2(unsigned h, unsigned x) {
  return h ^ x ^ ((h & x) << 1);
}

template <int V, int B, int S, bool PROBE, bool CLOCKS = false>
__global__ void __launch_bounds__(S * R_PAD + LANES_R - R_PAD, 1)
    noc_fused_cycles_kernel(CycleArgs g) {
  constexpr int PV = P * V;
  constexpr int L = S * R_PAD;  // lanes, and the threads that own them
  constexpr unsigned VMASK = (1u << V) - 1;
  static_assert(V == 4 && B == 4, "W packs 4 counts per port, h0/h1 20 "
                                  "heads of 2 bits");
  const long long clk_start = CLOCKS ? clock64() : 0;
  const int t = threadIdx.x;   // router-major: t = r * S + s
  const int s = t & (S - 1);
  const int r = t / S;
  const int l = s * R_PAD + r;  // the lane this thread owns
  const int gbase = (t & 31) & ~(S - 1);  // its router's lanes in the warp
  const unsigned gmask_s = (1u << S) - 1;
  const int n_cycles = g.n_cycles, Q = g.Q;

  // per-simulation offsets (the grid is the batch)
  const int b = blockIdx.x;
  int* buf_meta = g.buf_meta + b * PV * B * L;
  int* buf_binj = g.buf_binj + b * PV * B * L;
  int* head_g = g.head + b * PV * L;
  int* count_g = g.count + b * PV * L;
  int* rr_g = g.rr + b * P * L;
  int* mcq_g = g.mcq + b * Q * LANES_R;
  int* mc = g.mc + b * MC_ROWS * LANES_R;
  int* node = g.node + b * ND_ROWS * LANES_R;
  int* cnt = g.cnt + b * LANES_R;
  const int* xi = g.xi + b * n_cycles * XI_ROWS * L;
  const float* xf = g.xf + b * n_cycles * XF_ROWS * LANES_R;
  const int* gmask = g.gmask + b * V * L;
  const int* cmask = g.cmask + b * V * L;
  const float* prof = g.prof + b * PF_ROWS * LANES_R;
  const int* pol_sr = g.pol_sr + b * PS_ROWS * L;
  const int* pol_r = g.pol_r + b * PR_ROWS * LANES_R;
  const int* ntype = g.ntype + b * LANES_R;
  const int* exists = g.exists + b * P * L;
  const int* route = g.route;

  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay(V, B, L, g.R, Q);
  int* s_meta = reinterpret_cast<int*>(smem + lay.meta);    // [(pv*B+b)][t]
  int* s_binj = reinterpret_cast<int*>(smem + lay.binj);
  unsigned* s_code = reinterpret_cast<unsigned*>(smem + lay.code);  // [pv][t]
  unsigned* s_route = reinterpret_cast<unsigned*>(smem + lay.route);
  int* x_meta = reinterpret_cast<int*>(smem + lay.xmeta);   // [o][t]
  int* x_binj = reinterpret_cast<int*>(smem + lay.xbinj);
  unsigned* s_gv = reinterpret_cast<unsigned*>(smem + lay.gv);
  unsigned* s_space = reinterpret_cast<unsigned*>(smem + lay.space);
  int* s_mcq = reinterpret_cast<int*>(smem + lay.mcq);      // [slot][r]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  __shared__ int s_cnt[N_COUNTERS];

  // ring: thread 0 starts the first NSTAGE cycles' copies
  const uint32_t xi_bytes = XI_ROWS * L * 4, xf_bytes = XF_ROWS * LANES_R * 4;
  auto issue = [&](int c) {
    unsigned char* slot = smem + lay.ring + (c % NSTAGE) * lay.slot;
    uint64_t* bar = bars + c % NSTAGE;
    mbar_expect_tx(bar, xi_bytes + xf_bytes);
    bulk_load(slot, xi + c * XI_ROWS * L, xi_bytes, bar);
    bulk_load(slot + xi_bytes, xf + c * XF_ROWS * LANES_R, xf_bytes, bar);
  };
  if (t == 0) {
    for (int k = 0; k < NSTAGE; ++k) mbar_init(bars + k, 1);
    fence_mbar_init();
    for (int c = 0; c < NSTAGE && c < n_cycles; ++c) issue(c);
  }
  if (t < N_COUNTERS) s_cnt[t] = 0;
  __syncthreads();  // mbarriers initialised, counters zeroed

  if (t >= L) {
    // ---- node lanes 64..127: no subnet lane reads or feeds them, so the
    // two warps past the lanes run their recurrence (service, generation,
    // counters) from device memory, beside the cycle loop
    const long long clk_u = CLOCKS ? clock64() : 0;
    const int u = R_PAD + (t - L);
    Node nu = load_node(mc, node, u);
    const int nt_u = ntype[u];
    float pf_u[PF_ROWS];
#pragma unroll
    for (int i = 0; i < PF_ROWS; ++i) pf_u[i] = prof[i * LANES_R + u];
    int sum_u = 0, max_u = 0;
    if constexpr (PROBE) {
      sum_u = g.p_mcq[b * 2 * LANES_R + PB_MCQ_SUM * LANES_R + u];
      max_u = g.p_mcq[b * 2 * LANES_R + PB_MCQ_MAX * LANES_R + u];
    }
    unsigned gpu_gen = 0, cpu_gen = 0, icnt = 0;
    constexpr int TB = 16;  // cycles whose inputs are loaded together
    for (int c0 = 0; c0 < n_cycles; c0 += TB) {
      int ok_u[TB];
      float ph[TB], ug[TB];
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int c = min(c0 + j, n_cycles - 1);
        ok_u[j] = xi[(c * XI_ROWS + XI_MCOK) * L + u] != 0;
        ph[j] = xf[(c * XF_ROWS + XF_UPHASE) * LANES_R + u];
        ug[j] = xf[(c * XF_ROWS + XF_UGEN) * LANES_R + u];
      }
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        if (c0 + j >= n_cycles) break;
        mc_service(nu, nt_u == NT_MC, ok_u[j], mcq_g + u, LANES_R, Q,
                   g.mc_period);
        if constexpr (PROBE) {
          sum_u += nu.mc_count;
          max_u = max(max_u, nu.mc_count);
        }
        const int gen = generate(nu, nt_u, pf_u, ph[j], ug[j], g.bcap);
        gpu_gen += gen && nt_u == NT_GPU;
        cpu_gen += gen && nt_u == NT_CPU;
        icnt += nt_u == NT_GPU && nu.backlog > 0;
      }
    }
    store_node(nu, mc, node, u);
    if constexpr (PROBE) {
      g.p_mcq[b * 2 * LANES_R + PB_MCQ_SUM * LANES_R + u] = sum_u;
      g.p_mcq[b * 2 * LANES_R + PB_MCQ_MAX * LANES_R + u] = max_u;
    }
    atomicAdd(reinterpret_cast<unsigned*>(&s_cnt[C_GPU_GEN]), gpu_gen);
    atomicAdd(reinterpret_cast<unsigned*>(&s_cnt[C_CPU_GEN]), cpu_gen);
    atomicAdd(reinterpret_cast<unsigned*>(&s_cnt[C_GPU_STALL_ICNT]), icnt);
    if constexpr (CLOCKS) {
      if (t == L) g.clocks[b * N_CLOCKS + 5] = clock64() - clk_u;
    }
  } else {

    // epoch-constant rows: VC masks, links, subnet structure, this router
    unsigned gm = 0, cm = 0, ex = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      gm |= static_cast<unsigned>(gmask[v * L + l] != 0) << v;
      cm |= static_cast<unsigned>(cmask[v * L + l] != 0) << v;
    }
#pragma unroll
    for (int o = 0; o < P; ++o)
      ex |= static_cast<unsigned>(exists[o * L + l] != 0) << o;
    const int sub_en = pol_sr[PS_ENABLED * L + l] != 0;
    const int sub_req = pol_sr[PS_IS_REQ * L + l] != 0;
    const int sub_rep = pol_sr[PS_IS_REP * L + l] != 0;
    const int req_match = pol_sr[PS_REQ_MATCH * L + l] != 0;
    const int fs_r = pol_r[PR_FS * LANES_R + r] != 0;
    const int n_req = pol_r[PR_NREQ * LANES_R + r];
    const int nt_r = ntype[r];
    const int is_mc_r = nt_r == NT_MC;
    float pf[PF_ROWS];
#pragma unroll
    for (int i = 0; i < PF_ROWS; ++i) pf[i] = prof[i * LANES_R + r];

    // route table: byte d of word d/4 is destination d's output port, 7
    // for a value that names no port
    for (int w = 0; w < (g.R + 3) / 4; ++w) {
      unsigned word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dst = 4 * w + k;
        int code = 0;
        if (dst < g.R) {
          const int x = route[dst * L + l];
          code = (x >= 0 && x < P) ? x : 7;
        }
        word |= static_cast<unsigned>(code) << (8 * k);
      }
      s_route[w * L + t] = word;
    }
    // A FIFO slot's code byte: bits 0-2 the output port of its packet's
    // destination at this lane (0 for a destination >= R, the reference's
    // convention), bit 3 class == 0, bit 4 class == 1.  Every write of a
    // slot writes its byte, so the head peek reads one word per VC.
    auto code_of = [&](int meta) {
      const int dst = meta & ((1 << META_SRC_SHIFT) - 1);
      const int cls = meta >> META_CLS_SHIFT;
      const unsigned port =
          dst < g.R ? __byte_perm(s_route[(dst >> 2) * L + t], 0,
                                  0x4440 | (dst & 3))
                    : 0u;
      return port | static_cast<unsigned>(cls == 0) << 3 |
             static_cast<unsigned>(cls == 1) << 4;
    };
    auto set_code = [&](int pv, int slot, int meta) {
      reinterpret_cast<unsigned char*>(s_code + pv * L + t)[slot] =
          static_cast<unsigned char>(code_of(meta));
    };

    // the lane's FIFOs into shared memory; counts into W, heads into h0/h1
    for (int i = 0; i < PV * B; ++i) {
      const int meta = buf_meta[i * L + l];
      s_meta[i * L + t] = meta;
      s_binj[i * L + t] = buf_binj[i * L + l];
      set_code(i / B, i % B, meta);
    }
    unsigned W[P], h0 = 0, h1 = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      unsigned w = 0;
#pragma unroll
      for (int v = 0; v < V; ++v)
        w |= static_cast<unsigned>(count_g[(p * V + v) * L + l]) << (4 * v);
      W[p] = w;
    }
#pragma unroll
    for (int pv = 0; pv < PV; ++pv) {
      const unsigned h = static_cast<unsigned>(head_g[pv * L + l])
                         << (2 * (pv & 15));
      if (pv < 16) {
        h0 |= h;
      } else {
        h1 |= h;
      }
    }
    int rr[P], rot[P];
#pragma unroll
    for (int o = 0; o < P; ++o) {
      rr[o] = rr_g[o * L + l];
      rot[o] = floor_mod(rr[o], PV);
    }
    // the neighbour through each port: lane l + delta wraps the whole lane
    // axis (wrapped reads are masked by exists), as a thread index
    int nb[P];
    {
      const int delta[P] = {-g.width, 1, g.width, -1, 0};
#pragma unroll
      for (int o = 0; o < P; ++o) {
        const int nl = floor_mod(l + delta[o], L);
        nb[o] = (nl % R_PAD) * S + nl / R_PAD;
      }
    }
    // bit pv: count < B, i.e. bit 2 of the count's nibble clear (counts
    // are 0..4); a multiply gathers the port's four bits
    auto room = [&]() {
      unsigned m = 0;
#pragma unroll
      for (int p = 0; p < P; ++p)
        m |= ((((~W[p] >> 2) & 0x1111u) * 0x249u >> 9) & VMASK) << (p * V);
      return m;
    };
    s_space[t] = room();

    // this router's node state, one copy in each of its S lanes; the MC
    // queues of routers 0..63 move into shared memory
    Node nd = load_node(mc, node, r);
    for (int i = t; i < Q * R_PAD; i += L)
      s_mcq[i] = mcq_g[(i / R_PAD) * LANES_R + i % R_PAD];

    // counters summed in registers across the cycles (node counters count
    // in every copy and are added from lane s = 0 only)
    unsigned c_moved = 0, c_dram = 0, c_lat = 0, c_lat_n = 0, c_cpu_lat = 0,
             c_cpu_n = 0, c_gpu_lat = 0, c_gpu_n = 0, c_gpu_push = 0,
             c_cpu_push = 0, c_icnt = 0, c_gpu_done = 0, c_cpu_done = 0,
             c_gpu_gen = 0, c_cpu_gen = 0;

    // flight-recorder accumulators (B3), carried in registers from the probe
    // arrays handed in
    int acc_occ[PROBE ? PV : 1];
    int acc_grant = 0, acc_deny = 0, acc_mcq_sum = 0, acc_mcq_max = 0;
    if constexpr (PROBE) {
#pragma unroll
      for (int i = 0; i < PV; ++i) acc_occ[i] = g.p_occ[b * PV * L + i * L + l];
      acc_grant = g.p_arb[b * 2 * L + PB_GRANT * L + l];
      acc_deny = g.p_arb[b * 2 * L + PB_DENY * L + l];
      acc_mcq_sum = g.p_mcq[b * 2 * LANES_R + PB_MCQ_SUM * LANES_R + r];
      acc_mcq_max = g.p_mcq[b * 2 * LANES_R + PB_MCQ_MAX * LANES_R + r];
    }

    // the clocked instantiation's marks: thread 0 adds the clocks since its
    // last mark to clk_sum[k]
    long long clk_sum[CLOCKS ? N_CLOCKS : 1] = {};
    long long clk_last = 0;
    auto mark = [&](int k) {
      if constexpr (CLOCKS) {
        if (t == 0) {
          const long long now = clock64();
          clk_sum[k] += now - clk_last;
          clk_last = now;
        }
      }
    };
    // a cycle's inputs from its ring slot, once its copies have landed
    struct In {
      int cycle, sa, gate, active, dest_x, mc_ok;
      float u_ph, u_gen;
    };
    auto fetch = [&](int c) {
      const int k = c % NSTAGE;
      mbar_wait(bars + k, (c / NSTAGE) & 1);
      const int* xc =
          reinterpret_cast<const int*>(smem + lay.ring + k * lay.slot);
      const float* fc = reinterpret_cast<const float*>(
          smem + lay.ring + k * lay.slot + xi_bytes);
      return In{xc[XI_CYCLE * L + l],      xc[XI_SA * L + l],
                xc[XI_GATE * L + l] != 0,  xc[XI_ACTIVE * L + l] != 0,
                xc[XI_DEST * L + l],       xc[XI_MCOK * L + r] != 0,
                fc[XF_UPHASE * LANES_R + r], fc[XF_UGEN * LANES_R + r]};
    };
    bar_sync(1, L);  // the lanes' prologue done
    In in{};
    if (n_cycles > 0) in = fetch(0);
    if constexpr (CLOCKS) {
      clk_last = clock64();
      clk_sum[4] = clk_last - clk_start;  // the prologue
    }

    for (int c = 0; c < n_cycles; ++c) {
      const int cycle = in.cycle, sa = in.sa, gate = in.gate;
      const int active = in.active, dest_x = in.dest_x, mc_ok = in.mc_ok;
      const float u_ph = in.u_ph, u_gen = in.u_gen;

      // ---- node: MC acceptance (queue depth before this cycle's service),
      // then MC service
      const int accept =
          sub_req ? (is_mc_r ? (nd.mc_count <= Q - n_req) : 1) : 1;
      mc_service(nd, is_mc_r, mc_ok, s_mcq + r, R_PAD, Q, g.mc_period);

      // ---- lane: the head packets' code bytes -> the request masks (an
      // empty VC's code is 7) and the preferred-class mask (sa 0 or 1 reads
      // a class bit; any other sa >= 0 compares the heads' classes)
      unsigned planes[2] = {0, 0}, pref = 0;
      const int cls_bit = sa == 1 ? 4 : 3;
#pragma unroll
      for (int pv = 0; pv < PV; ++pv) {
        const unsigned code =
            s_code[pv * L + t] >> (8 * head_of(h0, h1, pv));
        add_code(planes, pv, cnt_of(W[pv / V], pv % V) > 0 ? code & 7 : 7u);
        pref |= ((code >> cls_bit) & 1) << pv;
      }
      if (sa < 0) {
        pref = (1u << PV) - 1;
      } else if (sa > 1) {
        pref = 0;
        for (int pv = 0; pv < PV; ++pv) {
          const int meta = s_meta[(pv * B + head_of(h0, h1, pv)) * L + t];
          pref |= static_cast<unsigned>((meta >> META_CLS_SHIFT) == sa) << pv;
        }
      }
      unsigned req[P];
      requests(planes, req);
      // the next cycle's inputs, read among this stage's arithmetic (its
      // ring slot is not the one refilled after barrier A)
      const In nxt = c + 1 < n_cycles ? fetch(c + 1) : in;
      // downstream credit: the neighbour's start-of-cycle room on the input
      // port facing us
      unsigned space[P];
#pragma unroll
      for (int o = 0; o < P; ++o)
        space[o] = (s_space[nb[o]] >> (opp(o) * V)) & VMASK;

      // ---- arbitrate; the winners' FIFO words are read by index
      int w_off[P];  // the winner's FIFO slot, in words from the array base
      int w_meta[P];
      auto cls_of = [&](int o, int win) {
        w_off[o] = (win * B + head_of(h0, h1, win)) * L + t;
        w_meta[o] = s_meta[w_off[o]];
        return w_meta[o] >> META_CLS_SHIFT;
      };
      Arb<V> a;
      lane_arbitrate<V>(req, pref, rr, rot, space, ex, gm, cm, accept, active,
                        cls_of, a);

      // ---- publish the winners for the neighbours' pulls, then dequeue
      unsigned gv = 0;
      int w_binj[P];
#pragma unroll
      for (int o = 0; o < P; ++o) {
        const int go = (a.grant >> o) & 1;
        w_binj[o] = go ? s_binj[w_off[o]] : 0;
        x_meta[o * L + t] = w_meta[o];
        x_binj[o * L + t] = w_binj[o];
        gv |= static_cast<unsigned>(go | (a.down_vc[o] << 1)) << (3 * o);
        rr[o] = a.new_rr[o];
        rot[o] = go ? a.new_rr[o] : rot[o];
      }
      s_gv[t] = gv;
      // dequeued VCs: count - 1 (a nibble per VC), head + 1 mod 4
#pragma unroll
      for (int p = 0; p < P; ++p) {
        unsigned d = (a.deq >> (p * V)) & VMASK;
        d = (d | (d << 6)) & 0x0303;
        W[p] -= (d | (d << 3)) & 0x1111;
      }
      h0 = bump2(h0, spread2(a.deq));
      h1 = bump2(h1, spread2(a.deq >> 16));
      const int ej = (a.grant >> PORT_L) & 1;
      const int e_meta = w_meta[PORT_L];
      const int e_src = (e_meta >> META_SRC_SHIFT) &
                        ((1 << (META_CLS_SHIFT - META_SRC_SHIFT)) - 1);
      const int e_cls = a.w_cls[PORT_L];
      c_moved += __popc(a.grant);
      c_dram += ((a.any >> PORT_L) & 1) && !accept && e_cls == 1;
      if (ej) {
        unsigned age = static_cast<unsigned>(cycle) -
                       static_cast<unsigned>(w_binj[PORT_L]);
        if (g.stamp_mask) age &= static_cast<unsigned>(g.stamp_mask);
        c_lat += age;
        c_lat_n += 1;
        if (e_cls == 0) {
          c_cpu_lat += age;
          c_cpu_n += 1;
        } else if (e_cls == 1) {
          c_gpu_lat += age;
          c_gpu_n += 1;
        }
      }
      if constexpr (PROBE) {
        acc_grant += __popc(a.grant);
        acc_deny += __popc(a.any & ~a.grant);
      }
      mark(0);
      bar_sync(1, L);  // barrier A: winners published
      mark(1);
      if (t == 0 && c + NSTAGE < n_cycles) {  // slot k was read by everyone
        fence_proxy_async();
        issue(c + NSTAGE);
      }

      // ---- lane: link pull from the unique upstream sender of each port
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const unsigned f = (s_gv[nb[p]] >> (3 * opp(p))) & 7;
        if ((f & 1) && ((ex >> p) & 1)) {
          const int vc = f >> 1;
          const unsigned w = W[p];
          const int tail =
              (head_of(h0, h1, p * V + vc) + cnt_of(w, vc)) & (B - 1);
          const int dst = ((p * V + vc) * B + tail) * L + t;
          const int m = x_meta[opp(p) * L + nb[p]];
          s_meta[dst] = m;
          s_binj[dst] = x_binj[opp(p) * L + nb[p]];
          set_code(p * V + vc, tail, m);
          W[p] = w + (1u << (4 * vc));
        }
      }

      // ---- node: MC enqueue in subnet order (a prefix of the router's
      // ballot fixes the slots), reply completion, source generation
      {
        const int req_ej = ej && sub_req && is_mc_r;
        const unsigned grp = (__ballot_sync(FULL, req_ej) >> gbase) & gmask_s;
        if (req_ej) {
          const int off = __popc(grp & ((1u << s) - 1));
          const int slot = ring_mod(nd.mc_head + nd.mc_count + off, Q);
          s_mcq[slot * R_PAD + r] = e_src + (e_cls << META_SRC_SHIFT);
        }
        nd.mc_count += __popc(grp);
      }
      if constexpr (PROBE) {  // queue depth after service and enqueue
        acc_mcq_sum += nd.mc_count;
        acc_mcq_max = max(acc_mcq_max, nd.mc_count);
      }
      const int rep_ej = ej && sub_rep && !is_mc_r;
      const int rep_done =
          ((__ballot_sync(FULL, rep_ej) >> gbase) & gmask_s) != 0;
      int rep_cls = rep_ej ? e_cls : 0;
      for (int m = 1; m < S; m <<= 1)
        rep_cls += __shfl_xor_sync(FULL, rep_cls, m);
      nd.outst -= rep_done;
      const int gen = generate(nd, nt_r, pf, u_ph, u_gen, g.bcap);
      const int can_inj =
          nd.backlog > 0 && nd.outst < g.mshr_limit && nt_r != NT_MC;
      c_gpu_gen += gen && nt_r == NT_GPU;
      c_cpu_gen += gen && nt_r == NT_CPU;
      c_gpu_done += rep_done && rep_cls == 1;
      c_cpu_done += rep_done && rep_cls == 0;

      // ---- lane: the merged inject at the Local port
      int ok;
      {
        const int want_src = req_match && can_inj;
        const int rep_target = fs_r ? 2 * nd.mc_scls + 1 : 1;
        const int want_rep =
            (s == rep_target) && nd.mc_svalid && is_mc_r && sub_en && gate;
        const int dest_i = sub_req ? dest_x : nd.mc_sdst;
        const int cls_i = sub_req ? (nt_r == NT_GPU ? 1 : 0) : nd.mc_scls;
        const int binj_i = sub_req ? cycle : cycle + 1;
        const unsigned wl = W[PORT_L];
        unsigned has = 0;
#pragma unroll
        for (int v = 0; v < V; ++v)
          has |= static_cast<unsigned>(cnt_of(wl, v) < B) << v;
        has &= cls_i == 1 ? gm : cm;
        ok = (want_src || want_rep) && has != 0;
        if (ok) {
          const int vc = __ffs(has) - 1;
          const int tail =
              (head_of(h0, h1, PORT_L * V + vc) + cnt_of(wl, vc)) & (B - 1);
          const int dst = ((PORT_L * V + vc) * B + tail) * L + t;
          const int m =
              dest_i + (r << META_SRC_SHIFT) + (cls_i << META_CLS_SHIFT);
          s_meta[dst] = m;
          s_binj[dst] = binj_i;
          set_code(PORT_L * V + vc, tail, m);
          W[PORT_L] = wl + (1u << (4 * vc));
        }
      }

      // ---- node: injection bookkeeping, node counters
      {
        const int inj_ok =
            ((__ballot_sync(FULL, ok && sub_req) >> gbase) & gmask_s) != 0;
        const int stage_hit =
            ((__ballot_sync(FULL, ok && !sub_req) >> gbase) & gmask_s) != 0;
        nd.mc_svalid = nd.mc_svalid && !stage_hit;
        nd.backlog -= inj_ok;
        nd.outst += inj_ok;
        c_gpu_push += inj_ok && nt_r == NT_GPU;
        c_cpu_push += inj_ok && nt_r == NT_CPU;
        c_icnt += nt_r == NT_GPU && nd.backlog > 0;
      }

      // ---- lane: end-of-cycle room for the neighbours' next arbitration
      s_space[t] = room();
      if constexpr (PROBE) {  // end-of-cycle counts
#pragma unroll
        for (int pv = 0; pv < PV; ++pv)
          acc_occ[pv] += cnt_of(W[pv / V], pv % V);
      }
      mark(2);
      bar_sync(1, L);  // barrier B: end-of-cycle room and MC queues published
      mark(3);
      in = nxt;
    }


    // ---- write the state back
    for (int i = 0; i < PV * B; ++i) {
      buf_meta[i * L + l] = s_meta[i * L + t];
      buf_binj[i * L + l] = s_binj[i * L + t];
    }
#pragma unroll
    for (int pv = 0; pv < PV; ++pv) {
      head_g[pv * L + l] = head_of(h0, h1, pv);
      count_g[pv * L + l] = cnt_of(W[pv / V], pv % V);
    }
#pragma unroll
    for (int o = 0; o < P; ++o) rr_g[o * L + l] = rr[o];
    for (int i = t; i < Q * R_PAD; i += L)
      mcq_g[(i / R_PAD) * LANES_R + i % R_PAD] = s_mcq[i];
    if (s == 0) store_node(nd, mc, node, r);
    if constexpr (PROBE) {
#pragma unroll
      for (int i = 0; i < PV; ++i) g.p_occ[b * PV * L + i * L + l] = acc_occ[i];
      g.p_arb[b * 2 * L + PB_GRANT * L + l] = acc_grant;
      g.p_arb[b * 2 * L + PB_DENY * L + l] = acc_deny;
      if (s == 0) {
        g.p_mcq[b * 2 * LANES_R + PB_MCQ_SUM * LANES_R + r] = acc_mcq_sum;
        g.p_mcq[b * 2 * LANES_R + PB_MCQ_MAX * LANES_R + r] = acc_mcq_max;
      }
    }

    // counters: a warp sum each, one shared atomic per warp
    {
      const unsigned node0 = s == 0;
      const unsigned vals[N_COUNTERS] = {
          c_gpu_push * node0, c_icnt * node0,     c_dram,
          c_cpu_push * node0, c_gpu_done * node0, c_cpu_done * node0,
          c_gpu_gen * node0,  c_cpu_gen * node0,  c_lat,
          c_lat_n,            c_cpu_lat,          c_cpu_n,
          c_gpu_lat,          c_gpu_n,            c_moved};
#pragma unroll
      for (int i = 0; i < N_COUNTERS; ++i) {
        const unsigned v = __reduce_add_sync(FULL, vals[i]);
        if ((t & 31) == 0) atomicAdd(reinterpret_cast<unsigned*>(&s_cnt[i]), v);
      }
    }
    if constexpr (CLOCKS) {
      mark(6);
      if (t == 0)
        for (int i = 0; i < N_CLOCKS; ++i)
          if (i != 5) g.clocks[b * N_CLOCKS + i] = clk_sum[i];
    }
  }
  __syncthreads();
  if (t < N_COUNTERS)
    cnt[t] = static_cast<int>(static_cast<unsigned>(cnt[t]) +
                              static_cast<unsigned>(s_cnt[t]));
}

template <int S, bool PROBE, bool CLOCKS>
int launch_lanes(const CycleArgs& args, int batch, void* stream) {
  const Smem lay(4, 4, S * R_PAD, args.R, args.Q);
  if (args.Q < 1 || args.R < 1 || args.R > R_PAD || lay.total > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = noc_fused_cycles_kernel<4, 4, S, PROBE, CLOCKS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<batch, S * R_PAD + LANES_R - R_PAD, lay.total,
           static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Launches B2 (PROBE = false), B3 or the clocked B2 on `batch` simulations.
// Returns cudaGetLastError(); cudaErrorInvalidValue for a (V, B) pair
// without an instantiation, a lane axis that is not 128 or 256 lanes, or a
// block's shared memory past the card's 227 KB; cudaErrorMisalignedAddress
// for xi / xf not on 16 bytes (the bulk copies need it); or the error of
// raising the kernel's shared-memory limit.
template <bool PROBE, bool CLOCKS = false>
int launch_fused(const CycleArgs& args, int batch, int V, int B,
                 void* stream) {
  // Only the paper's (V, B) = (4, 4) is instantiated, as for B1.
  if (V != 4 || B != 4) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(args.xi) |
       reinterpret_cast<uintptr_t>(args.xf)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (args.S == 4) return launch_lanes<4, PROBE, CLOCKS>(args, batch, stream);
  if (args.S == 2) return launch_lanes<2, PROBE, CLOCKS>(args, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// B1 on a packed descriptor (ArbArgs' layout above: D_HEADER header words,
// then D_OPERAND words for each of the 11 operands in fused.lane_arbitrate's
// order and the 7 outputs grant, winner, down_vc, deq, new_rr, any_req,
// w_cls).  Returns cudaGetLastError(), or cudaErrorInvalidValue for a VC
// count without an instantiation, no lanes, a lane dim below 1 or an
// element type the kernel does not read (write).
int noc_arbitrate(const long long* desc, void* stream) {
  // Only the paper's V=4 is instantiated: a further instantiation is added
  // together with an on-card check of it.
  if (desc[D_VCS] != 4 || desc[D_LANES] < 1 || desc[D_LANES] > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  ArbArgs g;
  g.lanes = static_cast<int>(desc[D_LANES]);
  g.depth = static_cast<int>(desc[D_DEPTH]);
  for (int k = 0; k < ARB_LEAD; ++k) {
    if (desc[D_SIZE + k] < 1) return static_cast<int>(cudaErrorInvalidValue);
    g.size[k] = static_cast<int>(desc[D_SIZE + k]);
  }
  for (int t = 0; t < ARB_IN + ARB_OUT; ++t) {
    const long long* d = desc + D_HEADER + t * D_OPERAND;
    Operand& op = t < ARB_IN ? g.in[t] : g.out[t - ARB_IN];
    op.ptr = reinterpret_cast<void*>(d[0]);
    op.type = static_cast<int>(d[1]);
    for (int s = 0; s < ARB_LEAD + 2; ++s) op.stride[s] = d[2 + s];
    const bool ok = t < ARB_IN ? op.type >= 0 && op.type < N_TYPES
                               : op.type == T_U8 || op.type == T_I32;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (g.lanes + ARB_THREADS - 1) / ARB_THREADS;
  noc_arbitrate_kernel<4><<<blocks, ARB_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(g);
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
              stamp_mask, nullptr, nullptr, nullptr, nullptr};
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
              stamp_mask, p_occ, p_arb, p_mcq, nullptr};
  return launch_fused<true>(a, batch, V, B, stream);
}

// B2's clocked development instantiation (nothing on a main path launches
// it): B2's arguments plus `clocks` (N_CLOCKS int64 per simulation), which
// it overwrites with clock64() sums: thread 0's per stage over the cycles
// (service + arbitration, barrier A, pull + node + inject, barrier B) and
// per launch (the prologue, then the epilogue), and node lanes 64..127's
// whole recurrence on their first thread.
int noc_fused_cycles_clocked(
    int batch, int n_cycles, int S, int R, int V, int B, int Q, int width,
    int mc_period, int mshr_limit, int bcap, int stamp_mask, int* buf_meta,
    int* buf_binj, int* head, int* count, int* rr, int* mcq, int* mc,
    int* node, int* cnt, const int* xi, const float* xf, const int* gmask,
    const int* cmask, const float* prof, const int* pol_sr,
    const int* pol_r, const int* ntype, const int* route,
    const int* exists, long long* clocks, void* stream) {
  CycleArgs a{buf_meta, buf_binj, head,  count, rr,     mcq,    mc,
              node,     cnt,      xi,    xf,    gmask,  cmask,  prof,
              pol_sr,   pol_r,    ntype, route, exists, n_cycles, S,
              R,        Q,        width, mc_period, mshr_limit, bcap,
              stamp_mask, nullptr, nullptr, nullptr, clocks};
  return launch_fused<false, true>(a, batch, V, B, stream);
}

}  // extern "C"
