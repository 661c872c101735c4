"""ctypes launchers for the CUDA kernel in csrc/kf_bank.cu (B4), which
replaces repro/kernels/kf_bank/kernel.py::_kf_bank_kernel.

`kf_bank` is one functional step: it checks device, dtype, shape and
contiguity of all five operands and returns fresh (x, p).  `Bank` is the
fleet's epoch: h, r and the bank's shape are checked once when it is built,
and each `Bank.epoch` checks the state and the epoch's observations, makes
three outputs and one ctypes call that launches the step with the boost
signal fused in.  Both launch on PyTorch's current stream without
synchronising, raise if the launch reports a CUDA error, and add one to
`ops.LAUNCHES["kf_bank"]` after a launch that succeeded.  The library is
built at first call (`repro_torch.kernels._build`), never at import."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch._util import raw_stream
from repro_torch.kernels import _build
from repro_torch.kernels.kf_bank.ops import LAUNCHES

SOURCES = [Path(__file__).resolve().parent / "csrc" / "kf_bank.cu"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call) and load the kf_bank library."""
    lib = _build.load_library("kf_bank", SOURCES)
    lib.kf_bank_step.argtypes = ([_P] * 5 + [_I, _I, _F, _F, _F] + [_P] * 3
                                 + [_P])
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


def _launch(x, p, z, h, r, n, m, a, q, x_out, p_out, sig) -> None:
    # a * a in double, rounded once, as the reference's `a * a * p` forms it
    rc = library().kf_bank_step(
        x.data_ptr(), p.data_ptr(), z.data_ptr(), h.data_ptr(), r.data_ptr(),
        n, m, a, a * a, q, x_out.data_ptr(), p_out.data_ptr(),
        None if sig is None else sig.data_ptr(), raw_stream(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"kf_bank launch failed: CUDA error {rc}")
    LAUNCHES["kf_bank"] += 1


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
    if b > 0:
        _launch(x, p, z, h, r, b, m, a, q, x_out, p_out, None)
    return x_out, p_out


class Bank:
    """The launch of one fleet's epoch: n filters sharing the observation
    model h and noise r (M,), float32 on one CUDA device, checked here once.

    `epoch(x, p, z)` checks x, p (n,) and z (n, M) (float32, contiguous, on
    the bank's device), launches B4 with the signal fused in, and returns
    fresh (x_post, p_post, signal): the caller's x and p are not written,
    so a caller that holds them sees no change."""

    def __init__(self, n: int, h: torch.Tensor, r: torch.Tensor, *,
                 a: float, q: float):
        m = h.shape[0] if h.dim() == 1 else -1
        _check("h", h, (m,))
        _check("r", r, (m,))
        if r.device != h.device:
            raise ValueError(f"h is on {h.device}, r on {r.device}")
        if n < 0 or m < 1:
            raise ValueError(f"a bank needs n >= 0 filters and M >= 1 "
                             f"observations, got n={n}, M={m}")
        self.n, self.m, self.device = n, m, h.device
        self._h, self._r, self._a, self._q = h, r, a, q
        self._state = torch.Size((n,))
        self._obs = torch.Size((n, m))

    def _ok(self, t: torch.Tensor, shape: torch.Size) -> bool:
        return (t.shape == shape and t.dtype == torch.float32
                and t.device == self.device and t.is_contiguous())

    def epoch(
        self, x: torch.Tensor, p: torch.Tensor, z: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        for name, t, shape in (("z", z, self._obs), ("x", x, self._state),
                               ("p", p, self._state)):
            if not self._ok(t, shape):
                raise ValueError(
                    f"{name} must be a contiguous float32 tensor of shape "
                    f"{tuple(shape)} on {self.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        x_out, p_out = torch.empty((2, self.n), dtype=torch.float32,
                                   device=self.device).unbind(0)
        sig = torch.empty(self.n, dtype=torch.int32, device=self.device)
        if self.n > 0:
            _launch(x, p, z, self._h, self._r, self.n, self.m, self._a,
                    self._q, x_out, p_out, sig)
        return x_out, p_out, sig
