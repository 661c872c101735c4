"""Flit-level router microarchitecture, vectorized over (subnet, router).

Per-input-port VC FIFOs with credit flow control, XY routing, VC allocation
at the downstream router under the class partition (paper Fig. 7), and
switch allocation that is round-robin or the KF-triggered GPU-priority
pattern (Fig. 8).  State layout, one block for every subnet:

  buf_meta    : (S, R, P, V, B) int16 — dest | src << 6 | cls << 12
  buf_binj    : (S, R, P, V, B) int32 — injection cycle (network latency)
  head, count : (S, R, P, V)    int8
  rr_ptr      : (S, R, P)       int8  per-output RR pointer over P*V inputs

Stamps are int32 here; where the run is short enough for uint16 stamps the
simulator masks the latency subtraction with 0xFFFF instead, which gives
the wraparound arithmetic bit for bit.

`arbitrate` is the switch-allocation inner loop and the oracle of the
arbitration kernel (`repro_torch.kernels.noc_cycle`).  Every buffer write
has a unique upstream sender (input port p of router r is fed only by
`neighbor[r, p]`'s output `opposite[p]`), so writes are masked `where`s,
never scatters.  Ungranted outputs carry the same garbage values as the
reference: winner 0 for an empty column, VC 0 without credit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.noc.topology import N_PORTS, PORT_L, Topology

Tensor = torch.Tensor
_I32 = torch.int32
BIG = 1 << 20

# meta packing: dest | src << 6 | cls << 12 (needs R <= 64, cls in {0, 1})
META_SRC_SHIFT = 6
META_CLS_SHIFT = 12


def pack_meta(dest: Tensor, src: Tensor, cls: Tensor) -> Tensor:
    """Pack (dest, src, cls) into one int16 word."""
    word = dest + (src << META_SRC_SHIFT) + (cls << META_CLS_SHIFT)
    return word.to(torch.int16)


def unpack_meta(meta: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Inverse of `pack_meta`; returns int32 (dest, src, cls)."""
    w = meta.to(_I32)
    dest = w & ((1 << META_SRC_SHIFT) - 1)
    src = (w >> META_SRC_SHIFT) & ((1 << (META_CLS_SHIFT - META_SRC_SHIFT)) - 1)
    cls = w >> META_CLS_SHIFT
    return dest, src, cls


class SubnetState(NamedTuple):
    buf_meta: Tensor   # (S, R, P, V, B) int16
    buf_binj: Tensor   # (S, R, P, V, B) int32
    head: Tensor       # (S, R, P, V) int8
    count: Tensor      # (S, R, P, V) int8
    rr_ptr: Tensor     # (S, R, P) int8


class CycleEvents(NamedTuple):
    eject_valid: Tensor     # (S, R) bool
    eject_src: Tensor       # (S, R) int32
    eject_cls: Tensor       # (S, R) int32
    eject_binj: Tensor      # (S, R) int32
    moved: Tensor           # () int32 — switch traversals this cycle
    dram_block_gpu: Tensor  # () int32 — GPU ejections refused by a full MC
    dram_block_cpu: Tensor  # () int32
    grant_cnt: Tensor       # (S, R) int32 — outputs granted
    deny_cnt: Tensor        # (S, R) int32 — requested outputs refused


class Arbitration(NamedTuple):
    grant: Tensor    # (..., O) bool — output port fires this cycle
    winner: Tensor   # (..., O) int32 — flat P*V requester index
    down_vc: Tensor  # (..., O) int32 — downstream VC granted to the winner
    deq: Tensor      # (..., P*V) bool — head packet pops this cycle
    new_rr: Tensor   # (..., O) int32 — advanced round-robin pointer
    any_req: Tensor  # (..., O) bool — some head packet wants this output
    w_cls: Tensor    # (..., O) int32 — class of the winning packet


def _first_true(mask: Tensor) -> tuple[Tensor, Tensor]:
    """(index of the first True along the last axis, or 0; any True)."""
    n = mask.shape[-1]
    iota = torch.arange(n, dtype=_I32, device=mask.device)
    first = torch.where(mask, iota, n).amin(dim=-1)
    anyt = mask.any(dim=-1)
    return torch.where(anyt, first, 0).to(_I32), anyt


def arbitrate(
    valid: Tensor,        # (..., P*V) bool — head packet present
    cls: Tensor,          # (..., P*V) int32 — head packet class (0/1)
    out_port: Tensor,     # (..., P*V) int32 — desired output port
    rr_ptr: Tensor,       # (..., O) int — per-output RR pointer
    down_count: Tensor,   # (..., O, V) int — VC occupancy downstream
    down_exists: Tensor,  # (..., O) bool — a link exists through this output
    gpu_vc_mask: Tensor,  # (..., V) bool
    cpu_vc_mask: Tensor,  # (..., V) bool
    sa_pref: Tensor,      # (...,) int32: -1 round-robin, else preferred class
    accept: Tensor,       # (...,) bool — ejection credit at the local sink
    active: Tensor,       # (...,) bool — link active this cycle
    *,
    depth: int,
) -> Arbitration:
    """One switch-allocation step: per output port pick one (in_port, vc)."""
    dev = valid.device
    PV = valid.shape[-1]
    oid = torch.arange(N_PORTS, dtype=_I32, device=dev)
    pv = torch.arange(PV, dtype=_I32, device=dev)
    big = PV * (2 * PV + 1)  # > any live packed key, a multiple of PV

    req = valid[..., :, None] & (out_port[..., :, None] == oid)   # (...,PV,O)
    is_pref = (cls == sa_pref[..., None]) | (sa_pref[..., None] < 0)
    penalty = torch.where(is_pref, 0, PV).to(_I32)                # (..., PV)
    key = (pv[:, None] - rr_ptr.to(_I32)[..., None, :]) % PV      # floor mod
    key = key + penalty[..., :, None]
    packed = torch.where(req, key * PV + pv[:, None], big)
    winner = (packed.amin(dim=-2) % PV).to(_I32)                  # (..., O)
    any_req = req.any(dim=-2)

    w_onehot = pv == winner[..., None]                            # (...,O,PV)
    w_cls = torch.where(w_onehot, cls[..., None, :], 0).sum(-1).to(_I32)

    allowed = torch.where((w_cls == 1)[..., None], gpu_vc_mask[..., None, :],
                          cpu_vc_mask[..., None, :])              # (...,O,V)
    has_space = (down_count < depth) & allowed
    down_vc, credit_ok = _first_true(has_space)

    is_local = oid == PORT_L
    eject_ok = is_local & accept[..., None]
    link_ok = (~is_local) & down_exists & credit_ok
    grant = any_req & (eject_ok | link_ok) & active[..., None]

    # one traversal per input port: keep the lowest-output grant per port
    w_port = winner // (PV // N_PORTS)
    rank = torch.where(grant, oid, BIG)
    pmatch = w_port[..., None, :] == oid[:, None]                 # (...,P,O)
    min_rank = torch.where(pmatch, rank[..., None, :], BIG).amin(dim=-1)
    sel = torch.where(pmatch, min_rank[..., :, None], 0).sum(-2)
    grant = grant & (rank == sel)

    deq = (w_onehot & grant[..., None]).any(dim=-2)
    new_rr = torch.where(grant, (winner + 1) % PV, rr_ptr.to(_I32))
    return Arbitration(grant, winner, down_vc, deq, new_rr.to(_I32),
                       any_req, w_cls)


def router_cycle(
    state: SubnetState,
    topo_route: Tensor,     # (R, R) int64
    topo_neighbor: Tensor,  # (R, P) int64
    topo_opposite: Tensor,  # (P,) int64
    gpu_vc_mask: Tensor,    # (S, V) bool
    cpu_vc_mask: Tensor,    # (S, V) bool
    sa_pref_class: Tensor,  # () int32
    mc_can_accept: Tensor,  # (S, R) bool
    active: Tensor,         # (S,) bool
    arbitrate_fn: Callable[..., Arbitration] = arbitrate,
    link_ok: Tensor | None = None,    # (R, P) bool fault mask
    router_ok: Tensor | None = None,  # (R,) bool fault mask
) -> tuple[SubnetState, CycleEvents]:
    """Advance every router of every subnet by one cycle."""
    S, R, P, V, B = state.buf_meta.shape
    dev = state.buf_meta.device
    ar = torch.arange(R, device=dev)

    # peek head-of-line packets
    hidx = state.head.long()[..., None]
    meta = torch.gather(state.buf_meta, 4, hidx)[..., 0]
    binj = torch.gather(state.buf_binj, 4, hidx)[..., 0]
    dest, _, cls = unpack_meta(meta)
    valid = state.count > 0

    # route lookup; a garbage dest is clamped like an out-of-range gather
    out_port = topo_route[ar[:, None, None], dest.long().clamp(0, R - 1)]

    nb_safe = torch.clamp(topo_neighbor, min=0)
    opp_b = topo_opposite[None, :].expand(R, N_PORTS)
    down_count = state.count[:, nb_safe, opp_b, :].to(_I32)       # (S,R,O,V)
    usable = topo_neighbor >= 0
    if link_ok is not None:
        usable = usable & link_ok
    down_exists = usable.expand(S, R, N_PORTS)
    granting = active[:, None].expand(S, R)
    if router_ok is not None:
        granting = granting & router_ok[None, :]

    arb = arbitrate_fn(
        valid.reshape(S, R, P * V),
        cls.reshape(S, R, P * V),
        out_port.reshape(S, R, P * V).to(_I32),
        state.rr_ptr.to(_I32),
        down_count,
        down_exists,
        gpu_vc_mask[:, None, :],
        cpu_vc_mask[:, None, :],
        torch.broadcast_to(sa_pref_class, (S, R)),
        mc_can_accept,
        granting,
        depth=B,
    )

    # dequeue winners, advance RR pointers past them
    deq = arb.deq.reshape(S, R, P, V)
    head2 = torch.where(deq, (state.head + 1) % B, state.head)
    count2 = state.count - deq.to(state.count.dtype)
    rr2 = arb.new_rr.to(state.rr_ptr.dtype)

    # winner packet fields per output: one-hot sum over requesters (an
    # empty column's winner 0 selects row 0's real value)
    w_onehot = torch.arange(P * V, device=dev) == arb.winner[..., None]

    def gsel(x):
        return torch.where(
            w_onehot, x.reshape(S, R, 1, P * V), 0
        ).sum(-1).to(x.dtype)

    w_meta = gsel(meta.to(_I32))
    w_binj = gsel(binj)
    _, ws, _ = unpack_meta(w_meta)

    ej = arb.grant[..., PORT_L]
    blocked_local = arb.any_req[..., PORT_L] & ~mc_can_accept
    blocked_cls = arb.w_cls[..., PORT_L]
    events = CycleEvents(
        eject_valid=ej,
        eject_src=ws[..., PORT_L],
        eject_cls=arb.w_cls[..., PORT_L],
        eject_binj=w_binj[..., PORT_L],
        moved=arb.grant.sum().to(_I32),
        dram_block_gpu=(blocked_local & (blocked_cls == 1)).sum().to(_I32),
        dram_block_cpu=(blocked_local & (blocked_cls == 0)).sum().to(_I32),
        grant_cnt=arb.grant.sum(-1).to(_I32),
        deny_cnt=(arb.any_req & ~arb.grant).sum(-1).to(_I32),
    )

    # link traversals as a dense pull from the unique upstream sender
    lk = arb.grant & (torch.arange(N_PORTS, device=dev) != PORT_L)

    def up(x):
        return x[:, nb_safe, opp_b]

    in_ok = up(lk) & (topo_neighbor >= 0)                         # (S,R,P)
    in_meta = up(w_meta)
    in_binj = up(w_binj)
    in_vc = up(arb.down_vc)

    tail = ((head2 + count2) % B).to(_I32)                        # (S,R,P,V)
    vmask = in_ok[..., None] & (in_vc[..., None] == torch.arange(V, device=dev))
    bmask = vmask[..., None] & (tail[..., None] == torch.arange(B, device=dev))
    state3 = SubnetState(
        buf_meta=torch.where(
            bmask, in_meta[..., None, None].to(state.buf_meta.dtype),
            state.buf_meta,
        ),
        buf_binj=torch.where(
            bmask, in_binj[..., None, None].to(state.buf_binj.dtype),
            state.buf_binj,
        ),
        head=head2,
        count=count2 + vmask.to(count2.dtype),
        rr_ptr=rr2,
    )
    return state3, events


def inject_all(
    state: SubnetState,
    want: Tensor,                            # (..., S, R) bool
    dest: Tensor, src: Tensor, cls: Tensor,  # (..., S, R) int32 packet fields
    binj: Tensor,                            # (..., S, R) int32 stamp
    gpu_vc_mask: Tensor, cpu_vc_mask: Tensor,  # (..., S, V) bool
) -> tuple[SubnetState, Tensor]:
    """Inject at the Local input port of every (subnet, router) at once,
    over any leading batch dims of the state.

    Returns (state, accepted (..., S, R) bool): the first free VC the class
    may use takes the packet at its tail slot.
    """
    B = state.buf_meta.shape[-1]
    V = state.count.shape[-1]
    dev = state.buf_meta.device
    local_count = state.count[..., PORT_L, :]                     # (.., S, R, V)
    allowed = torch.where(cls[..., None] == 1, gpu_vc_mask[..., None, :],
                          cpu_vc_mask[..., None, :])
    has_space = (local_count < B) & allowed
    vc, any_space = _first_true(has_space)
    ok = want & any_space

    head_l = state.head[..., PORT_L, :]
    tail = ((head_l + local_count) % B).to(_I32)                  # (.., S, R, V)
    vmask = ok[..., None] & (vc[..., None] == torch.arange(V, device=dev))
    bmask = vmask[..., None] & (tail[..., None] == torch.arange(B, device=dev))
    meta = pack_meta(dest, src, cls)

    def wr(buf, val):
        val = val.to(buf.dtype)
        out = buf.clone()
        out[..., PORT_L, :, :] = torch.where(
            bmask, val[..., None, None], buf[..., PORT_L, :, :]
        )
        return out

    count = state.count.clone()
    count[..., PORT_L, :] = local_count + vmask.to(local_count.dtype)
    state = state._replace(
        buf_meta=wr(state.buf_meta, meta),
        buf_binj=wr(state.buf_binj, binj),
        count=count,
    )
    return state, ok


def device_tables(topo: Topology, device: torch.device | str = "cpu"):
    """Topology tables on the run's device: route, neighbor, opposite and
    mc_ids as int64 index tables, node_type as int32."""
    assert topo.n_routers <= 64, "meta packing assumes router ids fit 6 bits"
    return (
        torch.as_tensor(topo.route, dtype=torch.int64, device=device),
        torch.as_tensor(topo.neighbor, dtype=torch.int64, device=device),
        torch.as_tensor(topo.opposite, dtype=torch.int64, device=device),
        torch.as_tensor(topo.node_type, dtype=_I32, device=device),
        torch.as_tensor(topo.mc_ids, dtype=torch.int64, device=device),
    )
