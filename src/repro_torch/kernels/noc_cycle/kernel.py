"""ctypes launchers for the CUDA kernels in csrc/noc_cycle.cu.

`noc_arbitrate` (B1) replaces repro/kernels/noc_cycle/kernel.py::
_noc_cycle_kernel, `noc_fused_cycles` (B2) replaces ::_fused_cycle_kernel
and `noc_fused_cycles_probed` (B3) replaces ::_fused_cycle_probed_kernel.
`noc_fused_cycles_clocked` launches B2's clocked development
instantiation, which returns per-stage clock sums (nothing on a main path
calls it).
B2/B3 check device, dtype, shape and contiguity; B1 takes its operands
through strides (`arb_desc`, fed by ops.py) and checks device, element
type and the number of lane dims.  Each launches on PyTorch's current
stream without synchronising and raises if the launch reports a CUDA
error.  The library is built at first call (`repro_torch.kernels._build`),
never at import.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch

from repro_torch._util import raw_stream
from repro_torch.kernels import _build
from repro_torch.kernels.noc_cycle import fused
from repro_torch.kernels.noc_cycle.ops import LAUNCHES

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
    lib.noc_arbitrate.argtypes = [ctypes.c_char_p, _P]
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


# B1's operand descriptor (noc_cycle.cu's ArbArgs, packed as int64 words):
# element-type codes, the lane dims it takes, and the packed layout
ARB_TYPES = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
             torch.int32: 3, torch.int64: 4}
ARB_OUT_CODES = (0, 3)          # outputs: bool (or uint8), int32
ARB_IN, ARB_OUT, ARB_LEAD = 11, 7, 4
D_HEADER = 3 + ARB_LEAD         # lanes, depth, V, the lane dims
D_OPERAND = 2 + ARB_LEAD + 2    # pointer, type, lane strides, tail strides


def arb_desc(lead, operands, *, depth: int, n_vcs: int) -> list[int]:
    """B1's descriptor as the int64 words the kernel reads (ArbArgs).

    ``lead`` is the lane dims (row-major; lanes = their product);
    ``operands`` the 11 inputs in fused.lane_arbitrate's order and then the
    7 outputs (grant, winner, down_vc, deq, new_rr, any_req, w_cls), each a
    (tensor, strides) pair whose strides, in elements, run over ``lead``
    and then the tail's two dims: element (lane, i, j) is at data_ptr + the
    dot product of (lane index, i, j) with the strides, where i is the
    requester (P*V), output port or VC and j is down_count's VC.  A
    broadcast dim has stride 0.  The words are: lanes, depth, V, the lane
    dims padded with leading 1s to ARB_LEAD; then per operand its pointer,
    type code, ARB_LEAD lane strides (leading 0s) and two tail strides.
    All operands must lie on one device (any device: the CPU tests read
    the words too)."""
    if n_vcs not in ARB_VCS:
        raise ValueError(f"noc_arbitrate has no instantiation for V={n_vcs}")
    n_lead = len(lead)
    if n_lead > ARB_LEAD:
        raise ValueError(f"noc_arbitrate takes at most {ARB_LEAD} lane dims, "
                         f"got {tuple(lead)}")
    lanes = 1
    for n in lead:
        lanes *= n
    pad = (0,) * (ARB_LEAD - n_lead)
    words = [lanes, depth, n_vcs, *((1,) * (ARB_LEAD - n_lead)), *lead]
    dev = operands[0][0].get_device()
    for k, (t, strides) in enumerate(operands):
        code = ARB_TYPES.get(t.dtype)
        if (code is None or t.get_device() != dev
                or (k >= ARB_IN and code not in ARB_OUT_CODES)):
            raise ValueError(
                f"noc_arbitrate operand {k} is {t.dtype} on {t.device}; it "
                f"takes bool or integer tensors on one device (outputs bool "
                f"or int32)")
        words += (t.data_ptr(), code, *pad, *strides)
    return words


def noc_arbitrate(words: list[int], device: torch.device) -> None:
    """B1: one launch on the descriptor ``words`` (`arb_desc`) of operands
    on the CUDA ``device``, writing the outputs in place.  The outputs must
    not overlap the operands."""
    if device.type != "cuda":
        raise ValueError(f"noc_arbitrate operands must be CUDA tensors, got "
                         f"{device}")
    rc = library().noc_arbitrate(struct.pack(f"{len(words)}q", *words),
                                 raw_stream(device))
    _raise_on(rc, "noc_arbitrate")
    LAUNCHES["noc_arbitrate"] += 1


def _fused_args(
    d: fused.LaneDims, state: fused.LaneState, xi: torch.Tensor,
    xf: torch.Tensor, consts: tuple[torch.Tensor, ...], what: str,
) -> list[int]:
    """Check B2/B3's common operands; returns the C arguments up to the
    probe pointers (ints, then data pointers).  A batch of B simulations
    is xi (B, n, XI_ROWS, L) with every per-simulation operand carrying the
    leading B (the kernel's grid); ``route`` is shared.  xi (n, XI_ROWS, L)
    is one simulation, with no leading dim anywhere."""
    if (d.V, d.B) not in FUSED_VB:
        raise ValueError(f"{what} has no instantiation for V={d.V}, B={d.B}")
    L, LR, P = d.lanes_sr, fused.LANES_R, fused.N_PORTS
    batch = xi.shape[0] if xi.ndim == 4 else 1
    lead = xi.shape[:1] if xi.ndim == 4 else ()
    n = xi.shape[-3]
    shapes = dict(
        buf_meta=(d.PV * d.B, L), buf_binj=(d.PV * d.B, L), head=(d.PV, L),
        count=(d.PV, L), rr=(P, L), mcq=(d.Q, LR), mc=(fused.MC_ROWS, LR),
        node=(fused.ND_ROWS, LR), cnt=(1, LR),
    )
    for name, x in zip(fused.LaneState._fields, state):
        _check(name, x, (*lead, *shapes[name]))
    named = [
        ("xi", xi, (*lead, n, fused.XI_ROWS, L), torch.int32),
        ("xf", xf, (*lead, n, fused.XF_ROWS, LR), torch.float32),
        ("gmask", consts[0], (*lead, d.V, L), torch.int32),
        ("cmask", consts[1], (*lead, d.V, L), torch.int32),
        ("prof", consts[2], (*lead, fused.N_PROF, LR), torch.float32),
        ("pol_sr", consts[3], (*lead, fused.PS_ROWS, L), torch.int32),
        ("pol_r", consts[4], (*lead, fused.PR_ROWS, LR), torch.int32),
        ("ntype", consts[5], (*lead, 1, LR), torch.int32),
        ("route", consts[6], (d.R, L), torch.int32),
        ("exists", consts[7], (*lead, P, L), torch.int32),
    ]
    for name, x, shape, dtype in named:
        _check(name, x, shape, dtype)
    return [
        batch, n, d.S, d.R, d.V, d.B, d.Q, d.width, d.mc_service_period,
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
    """B2: run the n cycles of xi (n, XI_ROWS, L), or of each row of a
    batch xi (B, n, XI_ROWS, L) in one launch of B blocks, updating
    ``state``'s arrays IN PLACE."""
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
    lead = xi.shape[:1] if xi.ndim == 4 else ()
    for name, x, shape in zip(fused.ProbeLanes._fields, probe,
                              ((d.PV, L), (2, L), (2, LR))):
        _check(f"probe.{name}", x, (*lead, *shape))
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
    if xi.ndim == 4:
        raise ValueError("noc_fused_cycles_clocked runs one simulation")
    consts = (gmask, cmask, prof, pol_sr, pol_r, ntype, route, exists)
    args = _fused_args(d, state, xi, xf, consts, "noc_fused_cycles_clocked")
    clocks = torch.zeros(len(CLOCK_STAGES), dtype=torch.int64,
                         device=xi.device)
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    rc = library().noc_fused_cycles_clocked(*args, clocks.data_ptr(), stream)
    _raise_on(rc, "noc_fused_cycles_clocked")
    return dict(zip(CLOCK_STAGES, clocks.tolist()))
