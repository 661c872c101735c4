"""Lane-layout cycle engine in plain torch: the plain version of the kernels.

`lane_arbitrate` is the plain version of the arbitration kernel (B1),
`cycle_step_lanes` of the whole-cycle kernel (B2) and, with a
`ProbeLanes` carry, of the probed whole-cycle kernel (B3), all in
`csrc/noc_cycle.cu`.  Both mirror `repro.kernels.noc_cycle.fused` value
for value, including its garbage-value conventions, so the CPU tests can
hold them against the JAX Pallas kernels and `chip_smoke.py` can hold the
CUDA kernels against them.

Lane layout
-----------
Subnet-resolved state rides an (S * 64)-lane axis: lane l holds (subnet
l // 64, router l % 64), routers padded to 64 so a mesh neighbour is always
l +/- 1 or l +/- width; shifts wrap the whole lane axis and every wrapped
or padded read is masked by `exists`.  Per-node state (MC queues, MSHRs,
source backlogs, burst phase, epoch counters) rides one 128-lane block
with routers in lanes 0..R-1.  All state is int32, rows first:

  buf_meta/buf_binj : (P*V*B, S*64)  row = (p*V + v)*B + b
  head/count        : (P*V,   S*64)  row = p*V + v
  rr                : (P,     S*64)
  mcq               : (Q,     128)
  mc                : (6,     128)   rows MC_HEAD..MC_SCLS
  node              : (3,     128)   rows ND_OUTST/ND_BACKLOG/ND_PHASE
  cnt               : (1,     128)   lane i = EpochCounters field i

The flight-recorder carry `ProbeLanes` (B3 only) is int32 too:

  occ               : (P*V,   S*64)  summed end-of-cycle VC counts
  arb               : (2,     S*64)  rows PB_GRANT/PB_DENY
  mcq               : (2,     128)   rows PB_MCQ_SUM/PB_MCQ_MAX
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.noc.router import META_CLS_SHIFT, META_SRC_SHIFT, SubnetState
from repro_torch.core.noc.topology import (
    N_PORTS,
    NT_CPU,
    NT_GPU,
    NT_MC,
    OPPOSITE,
    PORT_L,
    Topology,
)
from repro_torch.core.noc.traffic import (
    WorkloadProfile,
    injection_rates,
    step_phase_u,
)

Tensor = torch.Tensor
_I32 = torch.int32

R_PAD = 64     # router lanes per subnet block
LANES_R = 128  # per-node state rides one 128-lane block
BIG = 1 << 20  # grant-rank sentinel

OPP = tuple(int(p) for p in OPPOSITE)

MC_HEAD, MC_COUNT, MC_TIMER, MC_SVALID, MC_SDST, MC_SCLS = range(6)
MC_ROWS = 6
ND_OUTST, ND_BACKLOG, ND_PHASE = range(3)
ND_ROWS = 3
COUNTER_FIELDS = (
    "gpu_push", "gpu_stall_icnt", "gpu_stall_dram", "cpu_push",
    "gpu_done", "cpu_done", "gpu_gen", "cpu_gen",
    "lat_sum", "lat_cnt", "cpu_lat_sum", "cpu_lat_cnt",
    "gpu_lat_sum", "gpu_lat_cnt", "moved",
)
N_COUNTERS = len(COUNTER_FIELDS)

# per-cycle xs rows (int block over S*64 lanes / float block over 128)
XI_CYCLE, XI_SA, XI_GATE, XI_ACTIVE, XI_DEST, XI_MCOK = range(6)
XI_ROWS = 6
XF_UPHASE, XF_UGEN = range(2)
XF_ROWS = 2
# per-epoch policy rows (subnet-resolved / per-node)
PS_ENABLED, PS_IS_REQ, PS_IS_REP, PS_REQ_MATCH = range(4)
PS_ROWS = 4
PR_FS, PR_NREQ = range(2)
PR_ROWS = 2
N_PROF = len(WorkloadProfile._fields)


class LaneDims(NamedTuple):
    """Static shape/parameter bundle.  `stamp_mask` is 0xFFFF when the run
    is short enough for uint16 stamps (the latency subtraction is masked to
    reproduce their wraparound) and 0 otherwise."""

    S: int
    R: int
    V: int
    B: int
    Q: int
    width: int
    mc_service_period: int
    mshr_limit: int
    bcap: int
    stamp_mask: int

    @property
    def PV(self) -> int:
        return N_PORTS * self.V

    @property
    def lanes_sr(self) -> int:
        return self.S * R_PAD

    @property
    def deltas(self) -> tuple[int, int, int, int, int]:
        """Lane offset of the neighbour through each port (N, E, S, W, L)."""
        return (-self.width, 1, self.width, -1, 0)


class LaneState(NamedTuple):
    buf_meta: Tensor  # (P*V*B, S*64)
    buf_binj: Tensor  # (P*V*B, S*64)
    head: Tensor      # (P*V,   S*64)
    count: Tensor     # (P*V,   S*64)
    rr: Tensor        # (P,     S*64)
    mcq: Tensor       # (Q, 128)
    mc: Tensor        # (MC_ROWS, 128)
    node: Tensor      # (ND_ROWS, 128)
    cnt: Tensor       # (1, 128)


class ProbeLanes(NamedTuple):
    """Flight-recorder counter lanes, accumulated per cycle from END-of-
    cycle state so the lane engine agrees bitwise with the dense engine's
    probe accumulators."""

    occ: Tensor  # (P*V, S*64) sum over cycles of per-buffer flit count
    arb: Tensor  # (2, S*64)   rows (PB_GRANT, PB_DENY) switch outcomes
    mcq: Tensor  # (2, 128)    rows (PB_MCQ_SUM, PB_MCQ_MAX) queue depth


PB_GRANT, PB_DENY = 0, 1
PB_MCQ_SUM, PB_MCQ_MAX = 0, 1


def zero_probe(d: LaneDims, device="cpu", lead: tuple[int, ...] = ()
               ) -> ProbeLanes:
    """A zero flight-recorder carry, with leading batch dims ``lead``."""
    def z(rows, lanes):
        return torch.zeros((*lead, rows, lanes), dtype=_I32, device=device)

    return ProbeLanes(occ=z(d.PV, d.lanes_sr), arb=z(2, d.lanes_sr),
                      mcq=z(2, LANES_R))


class LaneArb(NamedTuple):
    grant: Tensor    # (O, L) bool
    winner: Tensor   # (O, L) int32
    down_vc: Tensor  # (O, L) int32
    deq: Tensor      # (PV, L) int32 0/1
    new_rr: Tensor   # (O, L) int32
    any_req: Tensor  # (O, L) bool
    w_cls: Tensor    # (O, L) int32


def lane_arbitrate(
    valid: Tensor,     # (PV, L) bool — head packet present
    cls: Tensor,       # (PV, L) int32
    out_port: Tensor,  # (PV, L) int32
    rr: Tensor,        # (O, L) int32
    down: Tensor,      # (O*V, L) int32 — downstream VC occupancy
    exists: Tensor,    # (O, L) bool
    gmask: Tensor,     # (V, L) bool
    cmask: Tensor,     # (V, L) bool
    sa: Tensor,        # (1, L) int32
    accept: Tensor,    # (1, L) bool
    active: Tensor,    # (1, L) bool
    *,
    depth: int,
) -> LaneArb:
    """Switch allocation over lanes, bitwise equal to `router.arbitrate`."""
    PV, L = valid.shape
    O = rr.shape[0]
    V = gmask.shape[0]
    P = PV // V
    local = O - 1  # PORT_L is the last port
    dev = valid.device

    pv_iota = torch.arange(PV, dtype=_I32, device=dev)[:, None]   # (PV, 1)
    o_iota = torch.arange(O, dtype=_I32, device=dev)[:, None]     # (O, 1)
    v_iota = torch.arange(V, dtype=_I32, device=dev)[None, :, None]
    is_pref = (cls == sa) | (sa < 0)
    penalty = torch.where(is_pref, 0, PV).to(_I32)

    # per output o (leading axis): round-robin key relative to rr[o]
    req = valid[None] & (out_port[None] == o_iota[:, :, None])    # (O,PV,L)
    key = (pv_iota[None] - rr[:, None, :]) % PV + penalty[None]
    # the empty-column sentinel is a multiple of PV: garbage winner 0
    packed = torch.where(req, key * PV + pv_iota[None], PV * (1 << 14))
    winner = packed.amin(dim=1) % PV                              # (O, L)
    any_req = req.any(dim=1)
    w_cls = cls.gather(0, winner.long())                          # (O, L)

    allowed = torch.where((w_cls == 1)[:, None], gmask[None], cmask[None])
    has = (down.view(O, V, L) < depth) & allowed                  # (O,V,L)
    credit = has.any(dim=1)
    first_vc = torch.where(has, v_iota, V).amin(dim=1)
    down_vc = torch.where(credit, first_vc, 0)   # argmax-of-bool convention

    link = exists & credit
    link[local] = accept[0]
    grant = any_req & link & active

    # one traversal per input port: keep the lowest-output grant per port
    w_port = winner // V                                          # in [0, P)
    rank = torch.where(grant, o_iota, BIG)
    p_iota = torch.arange(P, dtype=_I32, device=dev)[:, None, None]
    min_rank = torch.where(w_port[None] == p_iota, rank[None], BIG).amin(1)
    grant = grant & (rank == min_rank.gather(0, w_port.long()))
    deq = ((pv_iota[None] == winner[:, None]) & grant[:, None]).any(0)
    new_rr = torch.where(grant, (winner + 1) % PV, rr)

    return LaneArb(
        grant=grant, winner=winner.to(_I32), down_vc=down_vc.to(_I32),
        deq=deq.to(_I32), new_rr=new_rr.to(_I32), any_req=any_req,
        w_cls=w_cls.to(_I32),
    )


# ---------------------------------------------------------------------------
# lane-axis helpers
# ---------------------------------------------------------------------------

def _shift(x: Tensor, delta: int) -> Tensor:
    """out[:, l] = x[:, (l + delta) mod L] — wrapped reads are masked."""
    return x if delta == 0 else torch.roll(x, -delta, dims=1)


def _tile_r(x: Tensor, S: int) -> Tensor:
    """Broadcast a per-node (k, 128) row onto the (k, S*64) subnet lanes."""
    return x[:, :R_PAD].repeat(1, S)


def _pad_r(x: Tensor) -> Tensor:
    """Pad a (k, 64) router block back up to the (k, 128) node lanes."""
    k, w = x.shape
    return torch.cat(
        [x, torch.zeros((k, LANES_R - w), dtype=x.dtype, device=x.device)],
        dim=1,
    )


def _peek(rows: Tensor, idx: Tensor, n: int) -> Tensor:
    """rows[idx[l], l] where 0 <= idx < n, else 0 (a one-hot sum)."""
    ok = (idx >= 0) & (idx < n)
    got = rows.gather(0, idx.clamp(0, n - 1).long())
    return torch.where(ok, got, 0)


# ---------------------------------------------------------------------------
# stage twins
# ---------------------------------------------------------------------------

def mc_service_lanes(
    d: LaneDims, mc: Tensor, mcq: Tensor, ntype: Tensor,
    mc_ok: Tensor | None = None,
):
    """MC service tick: timers, head request -> staging.  A False `mc_ok`
    lane freezes service while the queue keeps filling."""
    is_mc = ntype == NT_MC
    head = mc[MC_HEAD:MC_HEAD + 1]
    count = mc[MC_COUNT:MC_COUNT + 1]
    svalid = mc[MC_SVALID:MC_SVALID + 1] != 0

    can_serve = is_mc & (count > 0) & ~svalid
    if mc_ok is not None:
        can_serve = can_serve & mc_ok
    timer0 = mc[MC_TIMER:MC_TIMER + 1]
    timer = torch.where(can_serve, torch.clamp(timer0 - 1, min=0), timer0)
    done = can_serve & (timer == 0)
    # q_head: one-hot over Q rows (per lane, head's row of mcq)
    q_head = _peek(mcq, head, d.Q)
    src_out = q_head & ((1 << META_SRC_SHIFT) - 1)
    cls_out = q_head >> META_SRC_SHIFT
    head = torch.where(done, (head + 1) % d.Q, head)
    count = count - done.to(_I32)
    timer = torch.where(done, d.mc_service_period, timer)
    sdst = torch.where(done, src_out, mc[MC_SDST:MC_SDST + 1])
    scls = torch.where(done, cls_out, mc[MC_SCLS:MC_SCLS + 1])
    svalid = svalid | done
    return head, count, timer.to(_I32), svalid, sdst, scls


def head_rows(
    d: LaneDims, buf_meta: Tensor, buf_binj: Tensor, head: Tensor,
    count: Tensor, route: Tensor,
):
    """Head-of-line peek, route lookup and downstream credit rows: returns
    (meta_h, binj_h, valid, cls_h, out_port, down), the per-lane inputs of
    the arbitration step."""
    V, B, P = d.V, d.B, N_PORTS
    PV = P * V
    L = head.shape[1]

    # peek head-of-line packets: buffer row pv*B + head
    meta_h = _peek(buf_meta.view(PV, B, L).transpose(0, 1).reshape(B, PV * L),
                   head.reshape(1, PV * L), B).view(PV, L)
    binj_h = _peek(buf_binj.view(PV, B, L).transpose(0, 1).reshape(B, PV * L),
                   head.reshape(1, PV * L), B).view(PV, L)
    dest_h = meta_h & ((1 << META_SRC_SHIFT) - 1)
    cls_h = meta_h >> META_CLS_SHIFT
    valid = count > 0

    # route: output port of each head packet (0 for a dest past R)
    out_port = _peek(route, dest_h, d.R)

    # downstream VC occupancy: the neighbour through output o is lane
    # l + deltas[o]; its input port facing us is OPP[o]
    down = torch.cat([
        _shift(count[OPP[o] * V:(OPP[o] + 1) * V], d.deltas[o])
        for o in range(P)
    ], dim=0)
    return meta_h, binj_h, valid, cls_h, out_port, down


def router_stage_lanes(
    d: LaneDims,
    buf_meta: Tensor, buf_binj: Tensor, head: Tensor, count: Tensor,
    rr: Tensor,
    gmask: Tensor, cmask: Tensor, sa: Tensor, accept: Tensor, active: Tensor,
    route: Tensor, exists: Tensor,
):
    """One full router cycle over lanes: peek, route, arbitrate, dequeue and
    the link pull.  Returns the buffer rows, the per-lane eject rows, the
    (moved, dram_block_gpu) scalars and the (grant_cnt, deny_cnt) rows."""
    V, B, P = d.V, d.B, N_PORTS
    PV = P * V
    L = head.shape[1]
    dev = head.device

    meta_h, binj_h, valid, cls_h, out_port, down = head_rows(
        d, buf_meta, buf_binj, head, count, route
    )
    arb = lane_arbitrate(
        valid, cls_h, out_port, rr, down, exists, gmask, cmask,
        sa, accept, active, depth=B,
    )

    deq = arb.deq != 0
    head2 = torch.where(deq, (head + 1) % B, head)
    count2 = count - arb.deq
    rr2 = arb.new_rr

    # winner packet fields per output (winner 0 of an empty column reads
    # row 0's real value, like the dense one-hot sum)
    w_meta = meta_h.gather(0, arb.winner.long())                  # (O, L)
    w_binj = binj_h.gather(0, arb.winner.long())
    w_src = (w_meta >> META_SRC_SHIFT) & (
        (1 << (META_CLS_SHIFT - META_SRC_SHIFT)) - 1
    )

    ej = arb.grant[PORT_L:PORT_L + 1]
    eject_src = w_src[PORT_L:PORT_L + 1]
    eject_cls = arb.w_cls[PORT_L:PORT_L + 1]
    eject_binj = w_binj[PORT_L:PORT_L + 1]
    moved = arb.grant.sum().to(_I32)
    blocked_local = arb.any_req[PORT_L:PORT_L + 1] & ~accept
    dram_block_gpu = (blocked_local & (eject_cls == 1)).sum().to(_I32)
    grant_cnt = arb.grant.sum(0, keepdim=True).to(_I32)
    deny_cnt = (arb.any_req & ~arb.grant).sum(0, keepdim=True).to(_I32)

    # link traversals as dense pulls through lane shifts
    tail = (head2 + count2) % B                                   # (PV, L)
    in_ok = torch.cat([
        _shift(arb.grant[OPP[p]:OPP[p] + 1], d.deltas[p]) & exists[p:p + 1]
        for p in range(P)
    ], dim=0)                                                     # (P, L)
    in_vc = torch.cat([
        _shift(arb.down_vc[OPP[p]:OPP[p] + 1], d.deltas[p]) for p in range(P)
    ], dim=0)
    in_meta = torch.cat([
        _shift(w_meta[OPP[p]:OPP[p] + 1], d.deltas[p]) for p in range(P)
    ], dim=0)
    in_binj = torch.cat([
        _shift(w_binj[OPP[p]:OPP[p] + 1], d.deltas[p]) for p in range(P)
    ], dim=0)
    v_iota = torch.arange(V, dtype=_I32, device=dev)[None, :, None]
    b_iota = torch.arange(B, dtype=_I32, device=dev)[None, None, :, None]
    vm = in_ok[:, None, :] & (in_vc[:, None, :] == v_iota)       # (P, V, L)
    bm = vm[:, :, None, :] & (tail.view(P, V, 1, L) == b_iota)    # (P,V,B,L)
    bm = bm.reshape(PV * B, L)
    buf_meta2 = torch.where(
        bm, in_meta[:, None, :].expand(P, V * B, L).reshape(PV * B, L), buf_meta
    )
    buf_binj2 = torch.where(
        bm, in_binj[:, None, :].expand(P, V * B, L).reshape(PV * B, L), buf_binj
    )
    count3 = count2 + vm.reshape(PV, L).to(_I32)

    return (
        buf_meta2, buf_binj2, head2, count3, rr2,
        ej, eject_src, eject_cls, eject_binj, moved, dram_block_gpu,
        grant_cnt, deny_cnt,
    )


def inject_lanes(
    d: LaneDims,
    buf_meta: Tensor, buf_binj: Tensor, head: Tensor, count: Tensor,
    want: Tensor, dest: Tensor, src: Tensor, cls: Tensor, binj: Tensor,
    gmask: Tensor, cmask: Tensor,
):
    """Inject at the Local port of every lane (twin of `router.inject_all`).
    Returns the updated buffer rows, counts and the per-lane `ok` row."""
    V, B = d.V, d.B
    L = head.shape[1]
    dev = head.device
    l0 = PORT_L * V

    lcount = count[l0:l0 + V]                                     # (V, L)
    allowed = torch.where(cls == 1, gmask, cmask)
    has = (lcount < B) & allowed
    v_iota = torch.arange(V, dtype=_I32, device=dev)[:, None]
    first = torch.where(has, v_iota, V).amin(dim=0, keepdim=True)
    any_has = has.any(dim=0, keepdim=True)
    vc = torch.where(any_has, first, 0)
    ok = want & any_has

    tail = (head[l0:l0 + V] + lcount) % B                         # (V, L)
    meta = dest + (src << META_SRC_SHIFT) + (cls << META_CLS_SHIFT)
    vm = ok & (vc == v_iota)                                      # (V, L)
    b_iota = torch.arange(B, dtype=_I32, device=dev)[None, :, None]
    bm = (vm[:, None, :] & (tail[:, None, :] == b_iota)).reshape(V * B, L)
    lo = l0 * B
    buf_meta2 = buf_meta.clone()
    buf_binj2 = buf_binj.clone()
    buf_meta2[lo:] = torch.where(bm, meta.expand(V * B, L), buf_meta[lo:])
    buf_binj2[lo:] = torch.where(bm, binj.expand(V * B, L), buf_binj[lo:])
    count2 = count.clone()
    count2[l0:l0 + V] = lcount + vm.to(_I32)
    return buf_meta2, buf_binj2, count2, ok


def mc_enqueue_lanes(
    d: LaneDims, mcq: Tensor, head: Tensor, count: Tensor,
    req_ej: Tensor, q_val: Tensor,
):
    """Enqueue request ejections into MC ring slots: an exclusive prefix
    over the S subnet blocks serializes same-MC arrivals into consecutive
    slots.  Returns (mcq', count', arrivals) on the 64-lane router block."""
    dev = mcq.device
    head64 = head[:, :R_PAD]
    cnt64 = count[:, :R_PAD]
    q_iota = torch.arange(d.Q, dtype=_I32, device=dev)[:, None]
    off = torch.zeros_like(head64)
    hit = torch.zeros((d.Q, R_PAD), dtype=torch.bool, device=dev)
    val = torch.zeros((d.Q, R_PAD), dtype=_I32, device=dev)
    for s in range(d.S):
        a = req_ej[:, s * R_PAD:(s + 1) * R_PAD]
        slot = (head64 + cnt64 + off) % d.Q
        m = a & (slot == q_iota)                                  # (Q, 64)
        hit = hit | m
        val = val + torch.where(m, q_val[:, s * R_PAD:(s + 1) * R_PAD], 0)
        off = off + a.to(_I32)
    mcq2 = mcq.clone()
    mcq2[:, :R_PAD] = torch.where(hit, val, mcq[:, :R_PAD])
    return mcq2, cnt64 + off, off


def cycle_step_lanes(
    d: LaneDims,
    st: LaneState,
    xi: Tensor,      # (XI_ROWS, S*64) int32 — this cycle's xs
    xf: Tensor,      # (XF_ROWS, 128) float32 — this cycle's uniforms
    gmask: Tensor,   # (V, S*64) int32 0/1 — epoch VC masks
    cmask: Tensor,   # (V, S*64) int32 0/1
    prof: Tensor,    # (5, 128) float32 — WorkloadProfile rows
    pol_sr: Tensor,  # (PS_ROWS, S*64) int32 — subnet structure rows
    pol_r: Tensor,   # (PR_ROWS, 128) int32
    ntype: Tensor,   # (1, 128) int32 (padded lanes -1)
    route: Tensor,   # (R, S*64) int32 — route[dst, lane]
    exists: Tensor,  # (P, S*64) int32 0/1 — link usable through port p
    probe: ProbeLanes | None = None,
):
    """ONE simulated NoC cycle over lanes, in the dense engine's stage
    order: MC acceptance and service, route/arbitrate/traverse, MC enqueue,
    reply completion, latency, source generation, the merged inject and the
    15 counters.  Returns the new LaneState, or (LaneState, ProbeLanes)
    when a flight-recorder ``probe`` is given."""
    S = d.S
    dev = xi.device

    cycle = xi[XI_CYCLE:XI_CYCLE + 1]
    sa = xi[XI_SA:XI_SA + 1]
    gate = xi[XI_GATE:XI_GATE + 1] != 0
    active = xi[XI_ACTIVE:XI_ACTIVE + 1] != 0
    dests = xi[XI_DEST:XI_DEST + 1]
    mc_ok = xi[XI_MCOK:XI_MCOK + 1, :LANES_R] != 0
    u_ph = xf[XF_UPHASE:XF_UPHASE + 1]
    u_gen = xf[XF_UGEN:XF_UGEN + 1]

    gmask_b = gmask != 0
    cmask_b = cmask != 0
    sub_en = pol_sr[PS_ENABLED:PS_ENABLED + 1] != 0
    sub_req = pol_sr[PS_IS_REQ:PS_IS_REQ + 1] != 0
    sub_rep = pol_sr[PS_IS_REP:PS_IS_REP + 1] != 0
    req_match = pol_sr[PS_REQ_MATCH:PS_REQ_MATCH + 1] != 0
    fs_sr = _tile_r(pol_r[PR_FS:PR_FS + 1], S) != 0
    n_req = pol_r[PR_NREQ:PR_NREQ + 1]

    is_mc_r = ntype == NT_MC
    is_gpu_r = ntype == NT_GPU
    is_cpu_r = ntype == NT_CPU
    is_mc_sr = _tile_r(is_mc_r, S)
    node_cls_sr = _tile_r(is_gpu_r.to(_I32), S)
    lane = torch.arange(d.lanes_sr, dtype=_I32, device=dev)[None, :]
    sub_id_sr = lane // R_PAD

    # MC acceptance: queue depth BEFORE this cycle's service
    mc_count0 = st.mc[MC_COUNT:MC_COUNT + 1]
    can_accept = torch.where(is_mc_r, mc_count0 <= d.Q - n_req, True)
    accept = torch.where(sub_req, _tile_r(can_accept, S), True)

    # 1. MC service
    mc_head, mc_count, mc_timer, svalid, sdst, scls = mc_service_lanes(
        d, st.mc, st.mcq, ntype, mc_ok
    )

    # 2. route/arbitrate every subnet
    (buf_meta, buf_binj, head, count, rr,
     ej, eject_src, eject_cls, eject_binj, moved, dram_gpu,
     grant_cnt, deny_cnt) = router_stage_lanes(
        d, st.buf_meta, st.buf_binj, st.head, st.count, st.rr,
        gmask_b, cmask_b, sa, accept, active, route, exists != 0,
    )

    # 3a. request ejections at MCs -> MC queues
    req_ej = ej & sub_req & is_mc_sr
    q_val = eject_src + (eject_cls << META_SRC_SHIFT)
    mcq, mc_count64, _ = mc_enqueue_lanes(
        d, st.mcq, mc_head, mc_count, req_ej, q_val
    )
    mc_count = torch.cat([mc_count64, mc_count[:, R_PAD:]], dim=1)

    # 3b. reply ejections at sources -> complete transactions
    rep_ej = (ej & sub_rep & ~is_mc_sr).view(S, R_PAD)
    rep_done = _pad_r(rep_ej.any(dim=0, keepdim=True))
    rep_cls = _pad_r(
        torch.where(rep_ej, eject_cls.view(S, R_PAD), 0)
        .sum(0, keepdim=True).to(_I32)
    )
    outstanding = st.node[ND_OUTST:ND_OUTST + 1] - rep_done.to(_I32)

    # 3c. packet latency (masked subtraction == uint16 wraparound)
    age = cycle - eject_binj
    if d.stamp_mask:
        age = age & d.stamp_mask
    ej_lat = torch.where(ej, age, 0)
    cpu_ej = ej & (eject_cls == 0)
    gpu_ej = ej & (eject_cls == 1)

    # 4. source generation -> per-node source-queue depth
    prof_t = WorkloadProfile(*(prof[i:i + 1] for i in range(N_PROF)))
    phase = step_phase_u(prof_t, st.node[ND_PHASE:ND_PHASE + 1], u_ph)
    rates = injection_rates(prof_t, ntype, phase)
    gen = (u_gen < rates) & ~is_mc_r
    backlog = st.node[ND_BACKLOG:ND_BACKLOG + 1]
    backlog = backlog + (gen & (backlog < d.bcap)).to(_I32)
    can_inj = (backlog > 0) & (outstanding < d.mshr_limit) & ~is_mc_r

    # 5. ONE merged inject: sources (request rows) + staged replies
    want_src = req_match & _tile_r(can_inj, S)
    scls_sr = _tile_r(scls, S)
    rep_target = torch.where(fs_sr, 2 * scls_sr + 1, 1)
    want_rep = (
        (sub_id_sr == rep_target)
        & _tile_r(svalid & is_mc_r, S)
        & sub_en & gate
    )
    dest_i = torch.where(sub_req, dests, _tile_r(sdst, S))
    src_i = lane % R_PAD
    cls_i = torch.where(sub_req, node_cls_sr, scls_sr)
    binj_i = torch.where(sub_req, cycle, cycle + 1)
    buf_meta, buf_binj, count, ok = inject_lanes(
        d, buf_meta, buf_binj, head, count,
        want_src | want_rep, dest_i, src_i, cls_i, binj_i,
        gmask_b, cmask_b,
    )
    ok_s = ok.view(S, R_PAD)
    req_s = sub_req.view(S, R_PAD)
    inj_ok = _pad_r((ok_s & req_s).any(dim=0, keepdim=True))
    stage_hit = _pad_r((ok_s & ~req_s).any(dim=0, keepdim=True))
    svalid = svalid & ~stage_hit
    backlog = backlog - inj_ok.to(_I32)
    outstanding = outstanding + inj_ok.to(_I32)

    # 6. counters
    def n(x):
        return x.sum().to(_I32)

    gpu_blocked = is_gpu_r & (backlog > 0)
    inc = torch.stack([
        n(inj_ok & is_gpu_r),
        n(gpu_blocked),
        dram_gpu,
        n(inj_ok & is_cpu_r),
        n(rep_done & (rep_cls == 1)),
        n(rep_done & (rep_cls == 0)),
        n(gen & is_gpu_r),
        n(gen & is_cpu_r),
        n(ej_lat),
        n(ej),
        n(torch.where(cpu_ej, ej_lat, 0)),
        n(cpu_ej),
        n(torch.where(gpu_ej, ej_lat, 0)),
        n(gpu_ej),
        moved,
    ]).to(_I32)
    cnt = st.cnt.clone()
    cnt[0, :N_COUNTERS] = cnt[0, :N_COUNTERS] + inc

    mc_rows = torch.cat(
        [mc_head, mc_count, mc_timer, svalid.to(_I32), sdst, scls], dim=0
    ).to(_I32)
    node_rows = torch.cat([outstanding, backlog, phase.to(_I32)], dim=0)
    st2 = LaneState(
        buf_meta=buf_meta, buf_binj=buf_binj, head=head.to(_I32),
        count=count.to(_I32), rr=rr, mcq=mcq, mc=mc_rows,
        node=node_rows.to(_I32), cnt=cnt,
    )
    if probe is None:
        return st2
    # 7. flight recorder: END-of-cycle counts, this cycle's switch
    # outcomes, the MC queue depth after service and enqueue
    probe2 = ProbeLanes(
        occ=probe.occ + st2.count,
        arb=probe.arb + torch.cat([grant_cnt, deny_cnt], dim=0),
        mcq=torch.cat([
            probe.mcq[PB_MCQ_SUM:PB_MCQ_SUM + 1] + mc_count,
            torch.maximum(probe.mcq[PB_MCQ_MAX:PB_MCQ_MAX + 1], mc_count),
        ], dim=0).to(_I32),
    )
    return st2, probe2


def cycle_steps_lanes(
    d: LaneDims, st: LaneState, xi: Tensor, xf: Tensor, *consts: Tensor,
    probe: ProbeLanes | None = None,
):
    """`cycle_step_lanes` over every cycle row of xi (n, XI_ROWS, S*64) and
    xf (n, XF_ROWS, 128) — the plain version of one kernel launch (B2, or
    B3 with ``probe``: then it returns (LaneState, ProbeLanes)).

    A batch — xi (B, n, XI_ROWS, S*64), the state, the probe and every
    epoch row but ``route`` with the leading B — walks its rows one by
    one, as the kernel's grid runs them side by side."""
    if xi.ndim == 4:
        rows = []
        for b in range(xi.shape[0]):
            rows.append(cycle_steps_lanes(
                d, LaneState(*(x[b] for x in st)), xi[b], xf[b],
                *(c if c.ndim == 2 else c[b] for c in consts),
                probe=None if probe is None else ProbeLanes(
                    *(x[b] for x in probe)),
            ))
        if probe is None:
            return LaneState(*(torch.stack(x) for x in zip(*rows)))
        st_rows, pb_rows = zip(*rows)
        return (LaneState(*(torch.stack(x) for x in zip(*st_rows))),
                ProbeLanes(*(torch.stack(x) for x in zip(*pb_rows))))
    for c in range(xi.shape[0]):
        if probe is None:
            st = cycle_step_lanes(d, st, xi[c], xf[c], *consts)
        else:
            st, probe = cycle_step_lanes(d, st, xi[c], xf[c], *consts,
                                         probe=probe)
    return st if probe is None else (st, probe)


# ---------------------------------------------------------------------------
# packing: dense sim state <-> lane layout, plus per-epoch rows
# ---------------------------------------------------------------------------

def lane_dims(
    *, S: int, R: int, V: int, B: int, Q: int, width: int,
    mc_service_period: int, mshr_limit: int, bcap: int, stamp_mask: int,
) -> LaneDims:
    if not R <= R_PAD <= LANES_R or (S * R_PAD) % LANES_R:
        raise ValueError(f"lane layout needs R <= {R_PAD} and an even S; "
                         f"got R={R}, S={S}")
    return LaneDims(
        S=S, R=R, V=V, B=B, Q=Q, width=width,
        mc_service_period=mc_service_period, mshr_limit=mshr_limit,
        bcap=bcap, stamp_mask=stamp_mask,
    )


def run_consts(d: LaneDims, topo: Topology, device="cpu"):
    """Route, link-exists and node-type lane tables."""
    route = torch.zeros((d.R, R_PAD), dtype=_I32)
    route[:, :d.R] = torch.as_tensor(topo.route.T.copy())
    exists = torch.zeros((N_PORTS, R_PAD), dtype=_I32)
    exists[:, :d.R] = torch.as_tensor((topo.neighbor >= 0).T.astype("int32"))
    ntype = torch.full((1, LANES_R), -1, dtype=_I32)
    ntype[0, :d.R] = torch.as_tensor(topo.node_type)
    return (route.repeat(1, d.S).to(device), exists.repeat(1, d.S).to(device),
            ntype.to(device))


def _tile(x: Tensor, S: int) -> Tensor:
    """(..., k) -> (..., S*k): S copies of the last dim side by side."""
    return x.repeat(*([1] * (x.ndim - 1)), S)


def _lanes_r(d: LaneDims, x: Tensor) -> Tensor:
    """(..., R) -> (..., S*64): pad to R_PAD and tile over the subnets."""
    return _tile(torch.nn.functional.pad(x.to(_I32), (0, R_PAD - d.R)), d.S)


# Every helper below takes any leading batch dims (B, ...) on its inputs
# and gives them to its outputs: a batch of simulations is these rows
# stacked, which is the layout the kernels' grid reads.

def placement_rows(d: LaneDims, ntype_e: Tensor) -> Tensor:
    """This epoch's (..., 1, 128) node-type row; padded lanes carry -1."""
    return torch.nn.functional.pad(
        ntype_e.to(_I32), (0, LANES_R - d.R), value=-1)[..., None, :]


def policy_rows(
    d: LaneDims,
    sub_enabled: Tensor, sub_is_req: Tensor, sub_is_rep: Tensor,  # (.., S)
    req_match: Tensor,                                             # (.., S, R)
    fs: Tensor, n_req_subs: Tensor,                                # (..,)
):
    """Subnet-structure rows: (..., PS_ROWS, S*64) + (..., PR_ROWS, 128)."""
    def sr_of_s(x):
        return x.to(_I32).repeat_interleave(R_PAD, dim=-1)[..., None, :]

    lead = req_match.shape[:-2]
    rm = torch.nn.functional.pad(req_match.to(_I32), (0, R_PAD - d.R))
    pol_sr = torch.cat(
        [sr_of_s(sub_enabled), sr_of_s(sub_is_req), sr_of_s(sub_is_rep),
         rm.reshape(*lead, 1, d.lanes_sr)],
        dim=-2,
    )
    pol_r = torch.stack([
        fs.to(_I32)[..., None].expand(*lead, LANES_R),
        n_req_subs.to(_I32)[..., None].expand(*lead, LANES_R),
    ], dim=-2)
    return pol_sr, pol_r


def mask_rows(d: LaneDims, g_vec: Tensor, c_vec: Tensor):
    """Epoch VC-partition masks (..., V) -> (..., V, S*64) int32 rows."""
    def rows(x):
        return x.to(_I32)[..., None].expand(*x.shape, d.lanes_sr).contiguous()

    return rows(g_vec), rows(c_vec)


def prof_rows(prof: WorkloadProfile) -> Tensor:
    """This epoch's profile leaves (...) broadcast to (..., 5, 128)
    float32."""
    leaves = [torch.as_tensor(leaf, dtype=torch.float32) for leaf in prof]
    return torch.stack([
        x[..., None].expand(*x.shape, LANES_R) for x in leaves
    ], dim=-2)


def cycle_xs(
    d: LaneDims,
    cycles: Tensor,      # (E,) int32
    u_phase: Tensor,     # (..., E) float32
    u_gen: Tensor,       # (..., E, R) float32
    dests_all: Tensor,   # (..., E, R) int
    sa_all: Tensor,      # (..., E) int32
    active_all: Tensor,  # (..., E, S) bool
    rep_gate: Tensor,    # (E,) bool
    router_ok: Tensor | None = None,  # (..., R) bool
    mc_ok: Tensor | None = None,      # (..., R) bool
):
    """Per-cycle xs in lane layout: (..., E, XI_ROWS, S*64) + (..., E,
    XF_ROWS, 128), the leading dims those of ``u_phase``.  `router_ok` ANDs
    into the active row, `mc_ok` becomes the MC-ok row."""
    *lead, E = u_phase.shape
    L = d.lanes_sr
    dev = u_phase.device

    def b_sr(x):
        return x.to(_I32)[..., None].expand(*lead, E, L)

    act_rows = active_all.to(_I32).repeat_interleave(R_PAD, dim=-1)
    if router_ok is not None:
        act_rows = act_rows * _lanes_r(d, router_ok)[..., None, :]
    if mc_ok is None:
        mc_ok = torch.ones((d.R,), dtype=_I32, device=dev)
    xi = torch.stack(
        [b_sr(cycles), b_sr(sa_all), b_sr(rep_gate),
         act_rows.expand(*lead, E, L), _lanes_r(d, dests_all).expand(*lead, E, L),
         _lanes_r(d, mc_ok)[..., None, :].expand(*lead, E, L)],
        dim=-2,
    ).contiguous()
    u_ph = u_phase.to(torch.float32)[..., None].expand(*lead, E, LANES_R)
    u_g = torch.nn.functional.pad(u_gen.to(torch.float32), (0, LANES_R - d.R))
    xf = torch.stack([u_ph, u_g.expand(*lead, E, LANES_R)], dim=-2).contiguous()
    return xi, xf


def _to_sr_rows(d: LaneDims, x: Tensor, n_tail: int) -> Tensor:
    """(..., S, R, *tail) -> (..., prod(tail), S*64) int32, tail flattened
    C-style; ``n_tail`` is the number of tail dims."""
    lead = x.shape[:x.ndim - 2 - n_tail]
    rows = 1
    for t in x.shape[x.ndim - n_tail:]:
        rows *= t
    # one zero fill and one converting copy; a pad of the moved view would
    # keep its strides and need a third copy to flatten
    out = torch.zeros((*lead, rows, d.S, R_PAD), dtype=_I32, device=x.device)
    out[..., :d.R] = x.reshape(*lead, d.S, d.R, rows).movedim(-1, -3)
    return out.reshape(*lead, rows, d.lanes_sr)


def _from_sr_rows(d: LaneDims, x: Tensor, tail: tuple, dtype) -> Tensor:
    *lead, rows, _ = x.shape
    x = x.reshape(*lead, rows, d.S, R_PAD)[..., :d.R]
    return x.movedim(-3, -1).reshape(*lead, d.S, d.R, *tail).to(
        dtype).contiguous()


def _to_r_row(d: LaneDims, x: Tensor) -> Tensor:
    return torch.nn.functional.pad(x.to(_I32), (0, LANES_R - d.R))[..., None, :]


def pack_state(
    d: LaneDims, subs: SubnetState, mc, outstanding: Tensor,
    backlog: Tensor, phase: Tensor,
) -> LaneState:
    """Dense sim carry -> lane layout (all int32)."""
    dev = subs.buf_meta.device
    lead = outstanding.shape[:-1]
    mcq = torch.nn.functional.pad(
        mc.q_meta.to(_I32).transpose(-1, -2), (0, LANES_R - d.R)
    ).contiguous()
    mc_rows = torch.cat([
        _to_r_row(d, mc.head), _to_r_row(d, mc.count),
        _to_r_row(d, mc.timer), _to_r_row(d, mc.stage_valid),
        _to_r_row(d, mc.stage_dst), _to_r_row(d, mc.stage_cls),
    ], dim=-2)
    node_rows = torch.cat([
        _to_r_row(d, outstanding), _to_r_row(d, backlog),
        phase.to(_I32)[..., None, None].expand(*lead, 1, LANES_R),
    ], dim=-2)
    return LaneState(
        buf_meta=_to_sr_rows(d, subs.buf_meta, 3),
        buf_binj=_to_sr_rows(d, subs.buf_binj, 3),
        head=_to_sr_rows(d, subs.head, 2),
        count=_to_sr_rows(d, subs.count, 2),
        rr=_to_sr_rows(d, subs.rr_ptr, 1),
        mcq=mcq,
        mc=mc_rows,
        node=node_rows,
        cnt=torch.zeros((*lead, 1, LANES_R), dtype=_I32, device=dev),
    )


def unpack_state(d: LaneDims, ls: LaneState, mc_cls,
                 binj_dtype=torch.int32):
    """Lane layout -> dense sim carry (value-exact narrowing casts).
    `mc_cls` is the dense MCState class."""
    P, V, B = N_PORTS, d.V, d.B
    subs = SubnetState(
        buf_meta=_from_sr_rows(d, ls.buf_meta, (P, V, B), torch.int16),
        buf_binj=_from_sr_rows(d, ls.buf_binj, (P, V, B), binj_dtype),
        head=_from_sr_rows(d, ls.head, (P, V), torch.int8),
        count=_from_sr_rows(d, ls.count, (P, V), torch.int8),
        rr_ptr=_from_sr_rows(d, ls.rr, (P,), torch.int8),
    )
    mc = mc_cls(
        q_meta=ls.mcq[..., :d.R].transpose(-1, -2).to(
            torch.int8).contiguous(),
        head=ls.mc[..., MC_HEAD, :d.R].clone(),
        count=ls.mc[..., MC_COUNT, :d.R].clone(),
        timer=ls.mc[..., MC_TIMER, :d.R].clone(),
        stage_valid=ls.mc[..., MC_SVALID, :d.R] != 0,
        stage_dst=ls.mc[..., MC_SDST, :d.R].clone(),
        stage_cls=ls.mc[..., MC_SCLS, :d.R].clone(),
    )
    outstanding = ls.node[..., ND_OUTST, :d.R].clone()
    backlog = ls.node[..., ND_BACKLOG, :d.R].clone()
    phase = ls.node[..., ND_PHASE, 0].clone()
    return subs, mc, outstanding, backlog, phase


def unpack_probe(d: LaneDims, pb: ProbeLanes):
    """Probe lanes -> dense probe accumulators, all int32: (occ (S,R,P,V),
    grant (S,R), deny (S,R), mcq_sum (R,), mcq_max (R,)), with the probe's
    leading batch dims.  Padded lanes never accumulate, so the [:R] slices
    are exact."""
    occ = _from_sr_rows(d, pb.occ, (N_PORTS, d.V), _I32)
    arb = _from_sr_rows(d, pb.arb, (2,), _I32)
    return (
        occ,
        arb[..., PB_GRANT].contiguous(),
        arb[..., PB_DENY].contiguous(),
        pb.mcq[..., PB_MCQ_SUM, :d.R].clone(),
        pb.mcq[..., PB_MCQ_MAX, :d.R].clone(),
    )
