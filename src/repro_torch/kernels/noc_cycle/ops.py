"""Entry points of the noc_cycle kernels, with launch counters.

`fused_cycle_step` runs whole cycles on the lane state and backs
`simulate(..., engine="fused")`: B2, or B3 when it is handed the flight-
recorder carry (`simulate_with_trace`).  `arbitrate_lanes` is
signature-compatible with `router.arbitrate` and backs `engine="arb"`
(B1).  On CUDA tensors they launch the hand-written kernels; on CPU
tensors they run the plain versions in `fused.py`.  There is no fallback:
a CUDA tensor either launches the kernel or raises.

`LAUNCHES` counts kernel launches per kernel; each wrapper adds one where
it launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.core.noc.router import Arbitration
from repro_torch.kernels.noc_cycle import fused

LAUNCHES = {"noc_fused_cycles": 0, "noc_fused_cycles_probed": 0,
            "noc_arbitrate": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*xs: torch.Tensor) -> bool:
    cuda = {x.is_cuda for x in xs}
    if len(cuda) != 1:
        raise ValueError("kernel inputs mix CUDA and CPU tensors")
    return cuda.pop()


def fused_cycle_step(
    d: fused.LaneDims,
    state: fused.LaneState,
    xi: torch.Tensor, xf: torch.Tensor,
    gmask: torch.Tensor, cmask: torch.Tensor, prof: torch.Tensor,
    pol_sr: torch.Tensor, pol_r: torch.Tensor,
    ntype: torch.Tensor, route: torch.Tensor, exists: torch.Tensor,
    *, probe: fused.ProbeLanes | None = None, donate: bool = False,
):
    """Run the cycles of ``xi`` (XI_ROWS, L) or (n, XI_ROWS, L) — with the
    matching ``xf`` — from ``state``; returns the new state, or (state,
    ProbeLanes) with the flight-recorder carry ``probe`` added to.  The
    inputs are left unchanged unless ``donate``: then the kernel may update
    their (contiguous) arrays in place."""
    if xi.ndim == 2:
        xi, xf = xi[None], xf[None]
    consts = (gmask, cmask, prof, pol_sr, pol_r, ntype, route, exists)
    carried = tuple(state) + (() if probe is None else tuple(probe))
    if not _on_cuda(*carried, xi, xf, *consts):
        return fused.cycle_steps_lanes(d, state, xi, xf, *consts, probe=probe)
    from repro_torch.kernels.noc_cycle import kernel

    def own(t):
        return t if donate else type(t)(
            *(x.clone(memory_format=torch.contiguous_format) for x in t)
        )

    out = own(state)
    args = (xi.contiguous(), xf.contiguous(), *(c.contiguous() for c in consts))
    if probe is None:
        kernel.noc_fused_cycles(d, out, *args)
        LAUNCHES["noc_fused_cycles"] += 1
        return out
    pb = own(probe)
    kernel.noc_fused_cycles_probed(d, out, pb, *args)
    LAUNCHES["noc_fused_cycles_probed"] += 1
    return out, pb


def arbitrate_rows(
    valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
    active, *, depth: int,
) -> fused.LaneArb:
    """Arbitration over (rows, L) lane arrays (the kernel's own layout).
    Boolean rows may be bool or int32 0/1."""
    ins = (valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
           active)
    if not _on_cuda(*ins):
        b = [x != 0 for x in (valid, exists, gmask, cmask, accept, active)]
        return fused.lane_arbitrate(
            b[0], cls, out_port, rr, down, b[1], b[2], b[3], sa, b[4], b[5],
            depth=depth,
        )
    from repro_torch.kernels.noc_cycle import kernel

    outs = kernel.noc_arbitrate(
        *(x.to(torch.int32).contiguous() for x in ins), depth=depth
    )
    LAUNCHES["noc_arbitrate"] += 1
    grant, winner, down_vc, deq, new_rr, any_req, w_cls = outs
    return fused.LaneArb(
        grant=grant != 0, winner=winner, down_vc=down_vc, deq=deq,
        new_rr=new_rr, any_req=any_req != 0, w_cls=w_cls,
    )


def arbitrate_lanes(
    valid: torch.Tensor,        # (..., P*V) bool
    cls: torch.Tensor,          # (..., P*V) int32
    out_port: torch.Tensor,     # (..., P*V) int32
    rr_ptr: torch.Tensor,       # (..., O) int32
    down_count: torch.Tensor,   # (..., O, V) int32
    down_exists: torch.Tensor,  # (..., O) bool
    gpu_vc_mask: torch.Tensor,  # (..., V) bool
    cpu_vc_mask: torch.Tensor,  # (..., V) bool
    sa_pref: torch.Tensor,      # (...,) int32
    accept: torch.Tensor,       # (...,) bool
    active: torch.Tensor,       # (...,) bool
    *,
    depth: int,
    block_l: int = 128,
) -> Arbitration:
    """`router.arbitrate` with every leading dimension flattened onto the
    lane axis and padded to a multiple of ``block_l`` lanes."""
    lead = valid.shape[:-1]
    pv = valid.shape[-1]
    o = rr_ptr.shape[-1]
    v = down_count.shape[-1]
    lanes = 1
    for n in lead:
        lanes *= n
    pad = (-lanes) % block_l

    def to_lanes(x, tail: tuple[int, ...]):
        rows = 1
        for t in tail:
            rows *= t
        x = torch.broadcast_to(x, lead + tail).reshape(lanes, rows)
        x = torch.nn.functional.pad(x.to(torch.int32), (0, 0, 0, pad))
        return x.T.contiguous()                          # (rows, L)

    arb = arbitrate_rows(
        to_lanes(valid, (pv,)), to_lanes(cls, (pv,)),
        to_lanes(out_port, (pv,)), to_lanes(rr_ptr, (o,)),
        to_lanes(down_count, (o, v)), to_lanes(down_exists, (o,)),
        to_lanes(gpu_vc_mask, (v,)), to_lanes(cpu_vc_mask, (v,)),
        to_lanes(sa_pref, ()), to_lanes(accept, ()), to_lanes(active, ()),
        depth=depth,
    )

    def back(x, tail: tuple[int, ...]):
        return x.T[:lanes].reshape(lead + tail)

    return Arbitration(
        grant=back(arb.grant, (o,)),
        winner=back(arb.winner, (o,)),
        down_vc=back(arb.down_vc, (o,)),
        deq=back(arb.deq, (pv,)) != 0,
        new_rr=back(arb.new_rr, (o,)),
        any_req=back(arb.any_req, (o,)),
        w_cls=back(arb.w_cls, (o,)),
    )
