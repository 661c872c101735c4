"""ctypes launcher for the CUDA kernel in csrc/kf_bank.cu (B4), which
replaces repro/kernels/kf_bank/kernel.py::_kf_bank_kernel.  It checks
device, dtype, shape and contiguity, launches on PyTorch's current stream
without synchronising, and raises if the launch reports a CUDA error.  The
library is built at first call (`repro_torch.kernels._build`), never at
import."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kf_bank.ops import LAUNCHES

SOURCES = [Path(__file__).resolve().parent / "csrc" / "kf_bank.cu"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call) and load the kf_bank library."""
    lib = _build.load_library("kf_bank", SOURCES)
    lib.kf_bank_step.argtypes = [_P] * 5 + [_I, _I, _F, _F, _F] + [_P] * 2 + [_P]
    lib.kf_bank_step.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kf_bank(
    x: torch.Tensor, p: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
    r: torch.Tensor, *, a: float, q: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B4 over x, p (B,), z (B, M) row-major, h, r (M,), all float32."""
    b, m = z.shape
    for name, t, shape in (("x", x, (b,)), ("p", p, (b,)), ("z", z, (b, m)),
                           ("h", h, (m,)), ("r", r, (m,))):
        _check(name, t, shape)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    if b == 0:
        return x_out, p_out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # a * a in double, rounded once, as the reference's `a * a * p` forms it
    rc = library().kf_bank_step(
        x.data_ptr(), p.data_ptr(), z.data_ptr(), h.data_ptr(), r.data_ptr(),
        b, m, a, a * a, q, x_out.data_ptr(), p_out.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"kf_bank launch failed: CUDA error {rc}")
    LAUNCHES["kf_bank"] += 1
    return x_out, p_out
