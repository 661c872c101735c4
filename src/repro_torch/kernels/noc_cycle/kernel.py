"""ctypes launchers for the CUDA kernels in csrc/noc_cycle.cu.

`noc_arbitrate` (B1) replaces repro/kernels/noc_cycle/kernel.py::
_noc_cycle_kernel, `noc_fused_cycles` (B2) replaces ::_fused_cycle_kernel
and `noc_fused_cycles_probed` (B3) replaces ::_fused_cycle_probed_kernel.
`noc_fused_cycles_clocked` launches B2's clocked development
instantiation, which returns per-stage clock sums (nothing on a main path
calls it).
Each checks device, dtype, shape and contiguity, launch on PyTorch's current
stream without synchronising, and raise if the launch reports a CUDA
error.  The library is built at first call (`repro_torch.kernels._build`),
never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.noc_cycle import fused

SOURCES = [Path(__file__).resolve().parent / "csrc" / "noc_cycle.cu"]
# the instantiated shapes: the paper's V=4 VCs of depth B=4 (the plain
# versions in fused.py cover every V and B on the CPU)
ARB_VCS = (4,)
FUSED_VB = ((4, 4),)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call) and load the noc_cycle library."""
    lib = _build.load_library("noc_cycle", SOURCES)
    lib.noc_arbitrate.argtypes = [_P] * 11 + [_I] * 3 + [_P] * 7 + [_P]
    lib.noc_arbitrate.restype = _I
    lib.noc_fused_cycles.argtypes = [_I] * 12 + [_P] * 19 + [_P]
    lib.noc_fused_cycles.restype = _I
    lib.noc_fused_cycles_probed.argtypes = [_I] * 12 + [_P] * 22 + [_P]
    lib.noc_fused_cycles_probed.restype = _I
    lib.noc_fused_cycles_clocked.argtypes = [_I] * 12 + [_P] * 20 + [_P]
    lib.noc_fused_cycles_clocked.restype = _I
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dtype=torch.int32):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def noc_arbitrate(
    valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
    active, *, depth: int,
) -> tuple[torch.Tensor, ...]:
    """B1 over (rows, L) int32 lane arrays (0/1 for the boolean rows).
    Returns (grant, winner, down_vc, deq, new_rr, any_req, w_cls)."""
    pv, L = valid.shape
    o = rr.shape[0]
    v = gmask.shape[0]
    if v not in ARB_VCS or pv != o * v:
        raise ValueError(f"noc_arbitrate has no instantiation for V={v}, "
                         f"PV={pv}, O={o}")
    ins = [valid, cls, out_port, rr, down, exists, gmask, cmask, sa, accept,
           active]
    rows = [pv, pv, pv, o, o * v, o, v, v, 1, 1, 1]
    names = ["valid", "cls", "out_port", "rr", "down", "exists", "gmask",
             "cmask", "sa", "accept", "active"]
    for n, x, r in zip(names, ins, rows):
        _check(n, x, (r, L))
    outs = [torch.empty((r, L), dtype=torch.int32, device=valid.device)
            for r in (o, o, o, pv, o, o, o)]
    stream = torch.cuda.current_stream(valid.device).cuda_stream
    rc = library().noc_arbitrate(
        *(x.data_ptr() for x in ins), depth, v, L,
        *(x.data_ptr() for x in outs), stream,
    )
    _raise_on(rc, "noc_arbitrate")
    return tuple(outs)


def _fused_args(
    d: fused.LaneDims, state: fused.LaneState, xi: torch.Tensor,
    xf: torch.Tensor, consts: tuple[torch.Tensor, ...], what: str,
) -> list[int]:
    """Check B2/B3's common operands; returns the C arguments up to the
    probe pointers (ints, then data pointers)."""
    if (d.V, d.B) not in FUSED_VB:
        raise ValueError(f"{what} has no instantiation for V={d.V}, B={d.B}")
    L, LR, P = d.lanes_sr, fused.LANES_R, fused.N_PORTS
    n = xi.shape[0]
    shapes = dict(
        buf_meta=(d.PV * d.B, L), buf_binj=(d.PV * d.B, L), head=(d.PV, L),
        count=(d.PV, L), rr=(P, L), mcq=(d.Q, LR), mc=(fused.MC_ROWS, LR),
        node=(fused.ND_ROWS, LR), cnt=(1, LR),
    )
    for name, x in zip(fused.LaneState._fields, state):
        _check(name, x, shapes[name])
    named = [
        ("xi", xi, (n, fused.XI_ROWS, L), torch.int32),
        ("xf", xf, (n, fused.XF_ROWS, LR), torch.float32),
        ("gmask", consts[0], (d.V, L), torch.int32),
        ("cmask", consts[1], (d.V, L), torch.int32),
        ("prof", consts[2], (fused.N_PROF, LR), torch.float32),
        ("pol_sr", consts[3], (fused.PS_ROWS, L), torch.int32),
        ("pol_r", consts[4], (fused.PR_ROWS, LR), torch.int32),
        ("ntype", consts[5], (1, LR), torch.int32),
        ("route", consts[6], (d.R, L), torch.int32),
        ("exists", consts[7], (P, L), torch.int32),
    ]
    for name, x, shape, dtype in named:
        _check(name, x, shape, dtype)
    return [
        1, n, d.S, d.R, d.V, d.B, d.Q, d.width, d.mc_service_period,
        d.mshr_limit, d.bcap, d.stamp_mask,
        *(x.data_ptr() for x in state),
        *(x.data_ptr() for _, x, _, _ in named),
    ]


def noc_fused_cycles(
    d: fused.LaneDims,
    state: fused.LaneState,
    xi: torch.Tensor, xf: torch.Tensor,
    gmask: torch.Tensor, cmask: torch.Tensor, prof: torch.Tensor,
    pol_sr: torch.Tensor, pol_r: torch.Tensor, ntype: torch.Tensor,
    route: torch.Tensor, exists: torch.Tensor,
) -> None:
    """B2: run xi.shape[0] cycles, updating ``state``'s arrays IN PLACE."""
    consts = (gmask, cmask, prof, pol_sr, pol_r, ntype, route, exists)
    args = _fused_args(d, state, xi, xf, consts, "noc_fused_cycles")
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    _raise_on(library().noc_fused_cycles(*args, stream), "noc_fused_cycles")


def noc_fused_cycles_probed(
    d: fused.LaneDims,
    state: fused.LaneState,
    probe: fused.ProbeLanes,
    xi: torch.Tensor, xf: torch.Tensor,
    gmask: torch.Tensor, cmask: torch.Tensor, prof: torch.Tensor,
    pol_sr: torch.Tensor, pol_r: torch.Tensor, ntype: torch.Tensor,
    route: torch.Tensor, exists: torch.Tensor,
) -> None:
    """B3: B2 plus the flight-recorder carry; updates ``state`` IN PLACE
    and ADDS this launch's probe counts to ``probe``'s arrays."""
    consts = (gmask, cmask, prof, pol_sr, pol_r, ntype, route, exists)
    args = _fused_args(d, state, xi, xf, consts, "noc_fused_cycles_probed")
    L, LR = d.lanes_sr, fused.LANES_R
    for name, x, shape in zip(fused.ProbeLanes._fields, probe,
                              ((d.PV, L), (2, L), (2, LR))):
        _check(f"probe.{name}", x, shape)
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    rc = library().noc_fused_cycles_probed(
        *args, *(x.data_ptr() for x in probe), stream
    )
    _raise_on(rc, "noc_fused_cycles_probed")


# the stages of the clocked instantiation, in the order of its clocks
# array: CYCLE_STAGES are summed over the launch's cycles (thread 0's
# clock), the rest are once per launch (node lanes 64..127 on the clock of
# their own warp, beside the cycle loop)
CYCLE_STAGES = ("service + arbitrate", "barrier A", "pull + node + inject",
                "barrier B")
CLOCK_STAGES = CYCLE_STAGES + ("prologue", "node lanes 64..127", "epilogue")


def noc_fused_cycles_clocked(
    d: fused.LaneDims,
    state: fused.LaneState,
    xi: torch.Tensor, xf: torch.Tensor,
    gmask: torch.Tensor, cmask: torch.Tensor, prof: torch.Tensor,
    pol_sr: torch.Tensor, pol_r: torch.Tensor, ntype: torch.Tensor,
    route: torch.Tensor, exists: torch.Tensor,
) -> dict[str, int]:
    """B2's clocked instantiation: runs B2 on ``state`` IN PLACE and returns
    its clock64() sums per stage (`CLOCK_STAGES`) over the launch, in SM
    clocks.  Synchronises (it reads the sums back); not counted in
    ops.LAUNCHES."""
    consts = (gmask, cmask, prof, pol_sr, pol_r, ntype, route, exists)
    args = _fused_args(d, state, xi, xf, consts, "noc_fused_cycles_clocked")
    clocks = torch.zeros(len(CLOCK_STAGES), dtype=torch.int64,
                         device=xi.device)
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    rc = library().noc_fused_cycles_clocked(*args, clocks.data_ptr(), stream)
    _raise_on(rc, "noc_fused_cycles_clocked")
    return dict(zip(CLOCK_STAGES, clocks.tolist()))
