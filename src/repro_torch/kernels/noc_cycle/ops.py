"""Entry points of the noc_cycle kernels, with launch counters.

`fused_cycle_step` runs whole cycles on the lane state and backs
`simulate(..., engine="fused")`: B2, or B3 when it is handed the flight-
recorder carry (`simulate_with_trace`).  `arbitrate_lanes` is
signature-compatible with `router.arbitrate` and backs `engine="arb"`
(B1); `arbitrate_rows` is the same arbitration over (rows, L) lane rows.
On CUDA tensors they launch the hand-written kernels; on CPU tensors they
run the plain versions in `fused.py`.  There is no fallback: a CUDA tensor
either launches the kernel or raises.

On the card both arbitration entry points are one launch of B1 and no
other CUDA kernel: B1 reads each operand where the caller holds it,
through its strides and element type (`lanes_desc`, `rows_desc` build the
descriptor), including broadcast views, and writes its outputs in the
caller's layout and dtype.

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
    their (contiguous) arrays in place.

    A batch of B simulations is xi (B, n, XI_ROWS, L), with the state, the
    probe and every epoch row but ``route`` carrying the leading B: on the
    card it is ONE launch whose grid is the batch, on the CPU the plain
    version walks the rows."""
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


def _operand(x: torch.Tensor, full: tuple[int, ...], n_tail: int):
    """(x, its strides viewed as broadcast to ``full`` = lead + tail, then
    0s up to two tail dims): B1's addressing of one operand.  A dim that x
    is broadcast along (or that it lacks) has stride 0, as in
    torch.broadcast_to's view, which is never made."""
    st = x.stride()
    if x.shape != full:
        extra = len(full) - x.dim()
        if extra < 0:
            raise ValueError(f"cannot broadcast {tuple(x.shape)} to {full}")
        bst = [0] * extra
        for size, want, s in zip(x.shape, full[extra:], st):
            if size != want and size != 1:
                raise ValueError(
                    f"cannot broadcast {tuple(x.shape)} to {full}")
            bst.append(s if size == want else 0)
        st = bst
    return x, (*st, *((0,) * (2 - n_tail)))


def _arb_outputs(cls, port_shape, deq_shape, deq_dtype, dev):
    """Fresh outputs of one arbitration, in ``cls``'s (LaneArb or
    Arbitration) shapes and dtypes: grant and any_req bool, deq
    ``deq_dtype``, the others int32."""
    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32, b8 = torch.int32, torch.bool
    return cls(grant=new(port_shape, b8), winner=new(port_shape, i32),
               down_vc=new(port_shape, i32), deq=new(deq_shape, deq_dtype),
               new_rr=new(port_shape, i32), any_req=new(port_shape, b8),
               w_cls=new(port_shape, i32))


def _arb_shapes(pv: int, o: int, v: int) -> None:
    if o != fused.N_PORTS or pv != o * v:
        raise ValueError(f"arbitration takes {fused.N_PORTS} output ports "
                         f"and P*V requesters, got PV={pv}, O={o}, V={v}")


def lanes_desc(ins, *, depth: int) -> tuple[Arbitration, list[int]]:
    """What `arbitrate_lanes` hands B1: fresh outputs in `router.arbitrate`'s
    shapes and dtypes, and the descriptor (`kernel.arb_desc`) of ``ins``
    (the 11 operands in its order, each broadcasting to the lead dims of
    ``valid``) and those outputs over the dense layout."""
    from repro_torch.kernels.noc_cycle.kernel import arb_desc

    valid, rr, down = ins[0], ins[3], ins[4]
    lead = tuple(valid.shape[:-1])
    pv, o, v = valid.shape[-1], rr.shape[-1], down.shape[-1]
    _arb_shapes(pv, o, v)
    arb = _arb_outputs(Arbitration, (*lead, o), (*lead, pv), torch.bool,
                       valid.device)
    tails = ((pv,), (pv,), (pv,), (o,), (o, v), (o,), (v,), (v,), (), (), (),
             (o,), (o,), (o,), (pv,), (o,), (o,), (o,))
    return arb, arb_desc(lead, [_operand(x, lead + t, len(t))
                                for x, t in zip(ins + tuple(arb), tails)],
                         depth=depth, n_vcs=v)


def rows_desc(ins, *, depth: int) -> tuple[fused.LaneArb, list[int]]:
    """What `arbitrate_rows` hands B1: fresh (O, L) / (PV, L) outputs in
    LaneArb's dtypes and the descriptor (`kernel.arb_desc`) of the (rows, L)
    lane rows ``ins`` (any strides) and those outputs: lane l of row i at
    x[i, l], down's row o*V + v addressed as (o, v)."""
    from repro_torch.kernels.noc_cycle.kernel import arb_desc

    valid, rr, gmask = ins[0], ins[3], ins[6]
    pv, L = valid.shape
    o, v = rr.shape[0], gmask.shape[0]
    _arb_shapes(pv, o, v)
    for x, n in zip(ins, (pv, pv, pv, o, o * v, o, v, v, 1, 1, 1)):
        if x.shape != (n, L):
            raise ValueError(f"lane rows of shape {tuple(x.shape)}, "
                             f"expected {(n, L)}")
    arb = _arb_outputs(fused.LaneArb, (o, L), (pv, L), torch.int32,
                       valid.device)

    def rows(x, split):
        sr, sl = x.stride()
        return x, ((sl, v * sr, sr) if split else (sl, sr, 0))

    return arb, arb_desc((L,), [rows(x, k == 4)
                                for k, x in enumerate(ins + tuple(arb))],
                         depth=depth, n_vcs=v)


def arbitrate_rows(
    valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
    active, *, depth: int,
) -> fused.LaneArb:
    """Arbitration over (rows, L) lane arrays (the lane layout of B2's
    state).  Boolean rows may be bool or int 0/1, the others any integer
    type.  Returns LaneArb with its dtypes (deq int32 0/1)."""
    ins = (valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
           active)
    if not _on_cuda(*ins):
        b = [x != 0 for x in (valid, exists, gmask, cmask, accept, active)]
        return fused.lane_arbitrate(
            b[0], cls, out_port, rr, down, b[1], b[2], b[3], sa, b[4], b[5],
            depth=depth,
        )
    from repro_torch.kernels.noc_cycle import kernel

    arb, desc = rows_desc(ins, depth=depth)
    if valid.shape[1] > 0:
        kernel.noc_arbitrate(desc, valid.device)
    return arb


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
    """`router.arbitrate` through the arbitration kernel.  The operands
    broadcast to the lead dims of ``valid`` (the dense engine passes
    expanded views) and may be bool or any integer type.

    On the card this is one launch of B1 on the operands as they lie
    (`lanes_desc`), with the outputs made in `router.arbitrate`'s shapes
    and dtypes; ``block_l`` is ignored there (it is the lane padding of the
    reference's TPU layout).  On the CPU every leading dim is flattened
    onto the lane axis, padded to a multiple of ``block_l`` lanes and run
    through `fused.lane_arbitrate`, as the reference's wrapper does."""
    ins = (valid, cls, out_port, rr_ptr, down_count, down_exists,
           gpu_vc_mask, cpu_vc_mask, sa_pref, accept, active)
    if valid.is_cuda:
        from repro_torch.kernels.noc_cycle import kernel

        arb, desc = lanes_desc(ins, depth=depth)
        if valid.numel() > 0:
            kernel.noc_arbitrate(desc, valid.device)
        return arb

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
