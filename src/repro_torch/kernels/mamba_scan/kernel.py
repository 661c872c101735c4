"""ctypes launchers for the CUDA kernels in csrc/mamba_scan.cu: B6
(`mamba_scan`, which replaces repro/kernels/mamba_scan/kernel.py::
_scan_kernel) and B7 (`mamba_fused`, which replaces repro/kernels/
mamba_scan/fused.py::_fused_kernel); and in csrc/mamba_scan_bwd.cu, their
gradients, which replace no TPU kernel (the JAX package differentiates its
scans with XLA): B6-bwd (`mamba_scan_bwd`) and B7-bwd, which walks back
from the tile checkpoints that `mamba_fused(..., checkpoints=True)` writes,
in two forms: per channel (`mamba_fused_bwd`, any (D, S) decay) and
mamba2 (`mamba_ssd_bwd`, the SSD scan's per-head dt and decay).  Each
checks device, dtype, shape and contiguity, launches on PyTorch's current
stream without synchronising, raises if the launch reports a CUDA error,
and then counts the launch.
The libraries are built at first call (`repro_torch.kernels._build`),
never at import.

B7 is instantiated for S = 8 and 16 states (Mamba1) and 64 (Mamba2) and
for float32 and bfloat16 xc / B / C; any other combination raises on the
card.  `fused_config`
reports the library's B7 instantiation (states per thread, steps in
flight, threads per block, steps per tile).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.fused import SSD_CHUNK
from repro_torch.kernels.mamba_scan.ops import LAUNCHES

SOURCES = [Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"]
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" /
               "mamba_scan_bwd.cu"]
FUSED_STATES = (8, 16, 64)
FUSED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded mamba_scan library."""
    lib.mamba_scan_fwd.argtypes = [_P] * 3 + [_L, _I, _L] + [_P] * 3
    lib.mamba_scan_fwd.restype = _I
    lib.mamba_fused_fwd.argtypes = [_I, _I] + [_P] * 6 + [_I] * 3 + [_P] * 4
    lib.mamba_fused_fwd.restype = _I
    lib.mamba_fused_config.argtypes = [_P]
    lib.mamba_fused_config.restype = None
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded mamba_scan_bwd library."""
    lib.mamba_scan_bwd.argtypes = [_P] * 5 + [_L, _I, _L] + [_P] * 4
    lib.mamba_scan_bwd.restype = _I
    lib.mamba_fused_bwd.argtypes = ([_I] * 3 + [_P] * 8 + [_I] * 3
                                    + [_P] * 10)
    lib.mamba_fused_bwd.restype = _I
    lib.mamba_ssd_bwd.argtypes = ([_I] * 3 + [_P] * 8 + [_I] * 4
                                  + [_P] * 10)
    lib.mamba_ssd_bwd.restype = _I
    lib.mamba_fused_bwd_config.argtypes = [_P]
    lib.mamba_fused_bwd_config.restype = None
    lib.mamba_fused_bwd_parts.argtypes = [_I, _I]
    lib.mamba_fused_bwd_parts.restype = _I
    lib.mamba_fused_bwd_occupancy.argtypes = [_I, _I, _I, _P]
    lib.mamba_fused_bwd_occupancy.restype = _I
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call) and load the mamba_scan library."""
    return bind(_build.load_library("mamba_scan", SOURCES))


@functools.cache
def bwd_library() -> ctypes.CDLL:
    """Build (first call) and load the mamba_scan_bwd library."""
    return bind_bwd(_build.load_library("mamba_scan_bwd", BWD_SOURCES))


def fused_config(lib: ctypes.CDLL | None = None) -> dict:
    """B7's instantiation in ``lib`` (default: the library built from
    SOURCES): K states per thread (min(K, S) at S states), U steps in
    flight, threads per block, steps per tile."""
    out = (ctypes.c_int * 4)()
    (lib or library()).mamba_fused_config(out)
    return dict(zip(("K", "U", "threads", "tile"), out))


def fused_bwd_config(lib: ctypes.CDLL | None = None) -> dict:
    """B7-bwd's instantiation: K states per thread (min(K, S) at S
    states), threads per block, the forward tile it walks back over, steps
    per sub-tile, blocks a cluster, and the blocks an SM its registers are
    held to."""
    out = (ctypes.c_int * 6)()
    (lib or bwd_library()).mamba_fused_bwd_config(out)
    return dict(zip(("K", "threads", "tile", "sub", "cluster", "min_blocks"),
                    out))


def fused_bwd_parts(s: int, d: int, lib: ctypes.CDLL | None = None) -> int:
    """B7-bwd's partials of dB and dC along D at S states and D channels:
    one a cluster of blocks."""
    n = (lib or bwd_library()).mamba_fused_bwd_parts(s, d)
    if n <= 0:
        raise ValueError(f"mamba_fused_bwd has no instantiation for S={s}")
    return n


def fused_bwd_occupancy(dtype: torch.dtype, s: int, mamba2: bool,
                        lib: ctypes.CDLL | None = None) -> dict:
    """The walk kernel of B7-bwd (its bulk-copy instantiation) at xc's
    ``dtype`` and S states, per-channel or mamba2 form: blocks an SM,
    registers a thread, shared bytes a block, local (spill) bytes a
    thread, from the CUDA runtime."""
    out = (ctypes.c_int * 4)()
    rc = (lib or bwd_library()).mamba_fused_bwd_occupancy(
        FUSED_DTYPES[dtype], s, int(mamba2), out)
    if rc != 0:
        raise RuntimeError(f"mamba_fused_bwd_occupancy failed: CUDA error "
                           f"{rc}")
    return dict(zip(("blocks_per_sm", "registers", "smem_bytes",
                     "local_bytes"), out))


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mamba_scan(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B6 over a, b (B, L, D, S) and h0 (B, D, S), all float32 ->
    (hs (B, L, D, S), h_last (B, D, S))."""
    bsz, L, d, s = a.shape
    f32 = (torch.float32,)
    for name, t, shape in (("a", a, (bsz, L, d, s)), ("b", b, (bsz, L, d, s)),
                           ("h0", h0, (bsz, d, s))):
        _check(name, t, shape, f32)
    hs, h_last = torch.empty_like(a), torch.empty_like(h0)
    if h0.numel() == 0:
        return hs, h_last
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = library().mamba_scan_fwd(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                  bsz, L, d * s, hs.data_ptr(),
                                  h_last.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {rc}")
    LAUNCHES["mamba_scan"] += 1
    return hs, h_last


def mamba_fused(
    dt: torch.Tensor, xc: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a_mat: torch.Tensor, h0: torch.Tensor | None, *,
    checkpoints: bool = False,
) -> tuple[torch.Tensor, ...]:
    """B7 over dt (B, L, D) f32, xc (B, L, D), b, c (B, L, S) of one type
    (f32 or bf16), a_mat (D, S) f32 and h0 (B, D, S) f32 or None (zero) ->
    (y (B, L, D), h_last (B, D, S)), both float32; with ``checkpoints``
    also the state at the start of each of B7's tiles, (B, ceil(L / T),
    D, S) float32 (T = `fused_config()["tile"]`), for B7-bwd."""
    bsz, L, d = dt.shape
    s = a_mat.shape[-1]
    f32 = (torch.float32,)
    act = tuple(FUSED_DTYPES)
    checks = [("dt", dt, (bsz, L, d), f32), ("xc", xc, (bsz, L, d), act),
              ("b", b, (bsz, L, s), (xc.dtype,)),
              ("c", c, (bsz, L, s), (xc.dtype,)),
              ("a_mat", a_mat, (d, s), f32)]
    if h0 is not None:
        checks.append(("h0", h0, (bsz, d, s), f32))
    for name, t, shape, dtypes in checks:
        _check(name, t, shape, dtypes)
    if s not in FUSED_STATES:
        raise ValueError(f"mamba_fused has no instantiation for S={s} "
                         f"(instantiated: {FUSED_STATES})")
    if bsz > 65535:
        raise ValueError(f"mamba_fused takes at most 65535 sequences, got {bsz}")
    y = torch.empty((bsz, L, d), dtype=torch.float32, device=dt.device)
    ckpt = None
    if checkpoints:
        tile = fused_config()["tile"]
        ckpt = torch.empty((bsz, -(-L // tile), d, s), dtype=torch.float32,
                           device=dt.device)
    if y.numel() == 0:
        h_last = (torch.zeros((bsz, d, s), dtype=torch.float32,
                              device=dt.device) if h0 is None else h0.clone())
        return (y, h_last) + ((ckpt,) if checkpoints else ())
    h_last = torch.empty((bsz, d, s), dtype=torch.float32, device=dt.device)
    launch_fused(library(), dt, xc, b, c, a_mat, h0, y, h_last, ckpt)
    LAUNCHES["mamba_fused"] += 1
    return (y, h_last) + ((ckpt,) if checkpoints else ())


def launch_fused(lib, dt, xc, b, c, a_mat, h0, y, h_last, ckpt=None) -> None:
    """Launch B7 of ``lib`` on tensors `mamba_fused` has checked, into y
    and h_last (and the tile checkpoints into ``ckpt`` where given); raise
    on a CUDA error.  Counts nothing."""
    bsz, L, d = dt.shape
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    rc = lib.mamba_fused_fwd(
        FUSED_DTYPES[xc.dtype], a_mat.shape[-1], dt.data_ptr(), xc.data_ptr(),
        b.data_ptr(), c.data_ptr(), a_mat.data_ptr(),
        None if h0 is None else h0.data_ptr(), bsz, L, d, y.data_ptr(),
        h_last.data_ptr(), None if ckpt is None else ckpt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mamba_fused launch failed: CUDA error {rc}")


def mamba_scan_bwd(
    a: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
    g_hs: torch.Tensor, g_hlast: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B6-bwd over a, hs, g_hs (B, L, D, S), h0 and g_hlast (B, D, S) or
    None (zero), all float32 -> (da, db (B, L, D, S), dh0 (B, D, S))."""
    bsz, L, d, s = a.shape
    f32 = (torch.float32,)
    checks = [("a", a, (bsz, L, d, s)), ("hs", hs, (bsz, L, d, s)),
              ("g_hs", g_hs, (bsz, L, d, s)), ("h0", h0, (bsz, d, s))]
    if g_hlast is not None:
        checks.append(("g_hlast", g_hlast, (bsz, d, s)))
    for name, t, shape in checks:
        _check(name, t, shape, f32)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if h0.numel() == 0 or L == 0:
        return da, db, (torch.zeros_like(h0) if g_hlast is None
                        else g_hlast.clone())
    dh0 = torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = bwd_library().mamba_scan_bwd(
        a.data_ptr(), hs.data_ptr(), h0.data_ptr(), g_hs.data_ptr(),
        None if g_hlast is None else g_hlast.data_ptr(), bsz, L, d * s,
        da.data_ptr(), db.data_ptr(), dh0.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd launch failed: CUDA error {rc}")
    LAUNCHES["mamba_scan_bwd"] += 1
    return da, db, dh0


def mamba_fused_bwd(
    dt: torch.Tensor, xc: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a_mat: torch.Tensor, ckpt: torch.Tensor, gy: torch.Tensor,
    g_hlast: torch.Tensor | None,
) -> tuple[torch.Tensor, ...]:
    """B7-bwd: B7's inputs as `mamba_fused` takes them, its tile
    checkpoints ckpt (B, ceil(L / T), D, S) f32, gy (B, L, D) f32 and
    g_hlast (B, D, S) f32 or None (zero) -> (ddt (B, L, D) f32, dxc
    (B, L, D), db, dc (B, L, S) in xc's type, da_mat (D, S) f32, dh0
    (B, D, S) f32).  One call is four launches on the stream (the walk
    back, then the fixed-order sums of the clusters' dB and dC and of the
    batches' dA) and counts one."""
    bsz, L, d = dt.shape
    s = a_mat.shape[-1]
    f32 = (torch.float32,)
    tile = fused_config()["tile"]
    checks = [("dt", dt, (bsz, L, d), f32),
              ("xc", xc, (bsz, L, d), tuple(FUSED_DTYPES)),
              ("b", b, (bsz, L, s), (xc.dtype,)),
              ("c", c, (bsz, L, s), (xc.dtype,)),
              ("a_mat", a_mat, (d, s), f32),
              ("ckpt", ckpt, (bsz, -(-L // tile), d, s), f32),
              ("gy", gy, (bsz, L, d), f32)]
    if g_hlast is not None:
        checks.append(("g_hlast", g_hlast, (bsz, d, s), f32))
    for name, t, shape, dtypes in checks:
        _check(name, t, shape, dtypes)
    if s not in FUSED_STATES:
        raise ValueError(f"mamba_fused_bwd has no instantiation for S={s} "
                         f"(instantiated: {FUSED_STATES})")
    if bsz > 65535:
        raise ValueError(f"mamba_fused_bwd takes at most 65535 sequences, "
                         f"got {bsz}")
    dev = dt.device
    ddt, dxc = torch.empty_like(dt), torch.empty_like(xc)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    if dt.numel() == 0:
        dh0 = (torch.zeros((bsz, d, s), dtype=torch.float32, device=dev)
               if g_hlast is None else g_hlast.clone())
        return (ddt, dxc, db.zero_(), dc.zero_(),
                torch.zeros_like(a_mat), dh0)
    da_mat = torch.empty_like(a_mat)
    dh0 = torch.empty((bsz, d, s), dtype=torch.float32, device=dev)
    outs = (ddt, dxc, db, dc, da_mat, dh0)
    launch_fused_bwd(bwd_library(), dt, xc, b, c, a_mat, ckpt, gy, g_hlast,
                     outs)
    LAUNCHES["mamba_fused_bwd"] += 1
    return outs


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_fused_bwd(lib, dt, xc, b, c, a_mat, ckpt, gy, g_hlast,
                     outs) -> None:
    """Launch the per-channel form of ``lib``'s B7-bwd on tensors
    `mamba_fused_bwd` has checked, into outs = (ddt, dxc, db, dc, da_mat,
    dh0), with partials of its own sizing; raise on a CUDA error.  Counts
    nothing."""
    bsz, L, d = dt.shape
    s, dev = a_mat.shape[-1], dt.device
    part_b = torch.empty((bsz, fused_bwd_parts(s, d, lib), L, s),
                         dtype=torch.float32, device=dev)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((bsz, d, s), dtype=torch.float32, device=dev)
    rc = lib.mamba_fused_bwd(
        FUSED_DTYPES[xc.dtype], s, fused_config()["tile"], dt.data_ptr(),
        xc.data_ptr(), b.data_ptr(), c.data_ptr(), a_mat.data_ptr(),
        ckpt.data_ptr(), gy.data_ptr(), _ptr(g_hlast), bsz, L, d,
        *[o.data_ptr() for o in outs], part_b.data_ptr(), part_c.data_ptr(),
        part_a.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_fused_bwd launch failed: CUDA error {rc}")


def mamba_ssd_bwd(
    dt: torch.Tensor, xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a_h: torch.Tensor, ckpt: torch.Tensor, gy: torch.Tensor,
    g_hlast: torch.Tensor | None,
) -> tuple[torch.Tensor, ...]:
    """B7-bwd's mamba2 form: the SSD scan's inputs dt (B, L, nh) f32, xh
    (B, L, nh, hd), b, c (B, L, S) of xh's type (f32 or bf16), a_h (nh,)
    f32, B7's tile checkpoints ckpt (B, ceil(L / T), nh * hd, S) f32 (of
    the channels `models.mamba.ssd_channels` lays out), gy (B, L, nh, hd)
    f32 and g_hlast (B, nh, hd, S) f32 or None (zero) -> (ddt (B, L, nh)
    f32, dxh (B, L, nh, hd), db, dc (B, L, S) in xh's type, da_h (nh,) f32,
    dh0 (B, nh, hd, S) f32).  hd is a power of two, at least 4.  One call
    is four launches on the stream (the walk back, the fixed-order sums of
    the clusters' dB and dC, the heads' ddt and da_h) and counts one."""
    bsz, L, nh, hd = xh.shape
    s = b.shape[-1]
    d = nh * hd
    f32 = (torch.float32,)
    tile = fused_config()["tile"]
    checks = [("dt", dt, (bsz, L, nh), f32),
              ("xh", xh, (bsz, L, nh, hd), tuple(FUSED_DTYPES)),
              ("b", b, (bsz, L, s), (xh.dtype,)),
              ("c", c, (bsz, L, s), (xh.dtype,)),
              ("a_h", a_h, (nh,), f32),
              ("ckpt", ckpt, (bsz, -(-L // tile), d, s), f32),
              ("gy", gy, (bsz, L, nh, hd), f32)]
    if g_hlast is not None:
        checks.append(("g_hlast", g_hlast, (bsz, nh, hd, s), f32))
    for name, t, shape, dtypes in checks:
        _check(name, t, shape, dtypes)
    if s not in FUSED_STATES:
        raise ValueError(f"mamba_ssd_bwd has no instantiation for S={s} "
                         f"(instantiated: {FUSED_STATES})")
    if hd & (hd - 1) or hd < 4:
        raise ValueError(f"mamba_ssd_bwd needs a power-of-two head dim of "
                         f"at least 4, got {hd}")
    if bsz > 65535:
        raise ValueError(f"mamba_ssd_bwd takes at most 65535 sequences, "
                         f"got {bsz}")
    dev = dt.device
    ddt, dxh = torch.empty_like(dt), torch.empty_like(xh)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    if dt.numel() == 0 or xh.numel() == 0:
        dh0 = (torch.zeros((bsz, nh, hd, s), dtype=torch.float32, device=dev)
               if g_hlast is None else g_hlast.clone())
        return (ddt.zero_(), dxh.zero_(), db.zero_(), dc.zero_(),
                torch.zeros_like(a_h), dh0)
    da_h = torch.empty_like(a_h)
    dh0 = torch.empty((bsz, nh, hd, s), dtype=torch.float32, device=dev)
    outs = (ddt, dxh, db, dc, da_h, dh0)
    launch_ssd_bwd(bwd_library(), dt, xh, b, c, a_h, ckpt, gy, g_hlast,
                   outs)
    LAUNCHES["mamba_ssd_bwd"] += 1
    return outs


def launch_ssd_bwd(lib, dt, xh, b, c, a_h, ckpt, gy, g_hlast, outs) -> None:
    """Launch the mamba2 form of ``lib``'s B7-bwd on tensors
    `mamba_ssd_bwd` has checked, into outs = (ddt, dxh, db, dc, da_h, dh0),
    with partials of its own sizing; raise on a CUDA error.  Counts
    nothing."""
    bsz, L, nh, hd = xh.shape
    s, d, dev = b.shape[-1], nh * hd, dt.device
    part_b = torch.empty((bsz, fused_bwd_parts(s, d, lib), L, s),
                         dtype=torch.float32, device=dev)
    part_c = torch.empty_like(part_b)
    part_qr = torch.empty((d // min(hd, SSD_CHUNK), bsz * L, 2),
                          dtype=torch.float32, device=dev)
    rc = lib.mamba_ssd_bwd(
        FUSED_DTYPES[xh.dtype], s, fused_config()["tile"], dt.data_ptr(),
        xh.data_ptr(), b.data_ptr(), c.data_ptr(), a_h.data_ptr(),
        ckpt.data_ptr(), gy.data_ptr(), _ptr(g_hlast), bsz, L, nh, hd,
        *[o.data_ptr() for o in outs], part_b.data_ptr(), part_c.data_ptr(),
        part_qr.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_ssd_bwd launch failed: CUDA error {rc}")
