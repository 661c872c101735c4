"""Entry point of the KF-bank kernel (B4), with its plain version and a
launch counter.

`kf_bank_step` advances B independent scalar-state Kalman filters one
predict + information-form correct step (the fleet layer's bank, one
filter per pod x traffic-class link; `dist.kf_scheduler.FleetKF`).  On
CUDA tensors it launches the hand-written kernel in csrc/kf_bank.cu; on
CPU tensors it runs `kf_bank_step_plain`.  There is no fallback: a CUDA
tensor launches the kernel or raises.  Inputs that are not tensors (numpy
arrays, lists) go to ``device``, which defaults to the CUDA device.

Any B is taken as it is: the kernel masks its ragged tail, so there is no
padding to a block multiple.

`kf_bank_epoch_plain` is one fleet epoch (`dist.kf_scheduler.FleetKF.epoch`):
the step and then its boost signal x_post > 0.  It is the CPU route of
that epoch; on the card the epoch is one launch of the same kernel, which
writes the signal too (`kernel.Bank`).

`LAUNCHES["kf_bank"]` counts kernel launches; the launcher in kernel.py adds
one after each launch that succeeded and nowhere else (an empty bank
launches nothing and counts nothing).
"""
from __future__ import annotations

import torch

from repro_torch._util import resolve_device

LAUNCHES = {"kf_bank": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def kf_bank_step_plain(
    x: torch.Tensor, p: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
    r: torch.Tensor, *, a: float = 1.0, q: float = 1e-3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic as torch ops, one rounding per operation and
    the sums over M in order m = 0..M-1 (what the kernel does), so that the
    kernel is held to it bitwise.  ``a * a`` is formed in double and
    rounded once, as the reference's Python expression ``a * a * p`` does."""
    x_prior = a * x
    p_prior = (a * a) * p + q
    hr = h / r                                       # (M,)
    info = h[0] * hr[0]
    innov = hr[0] * z[:, 0]
    for m in range(1, z.shape[1]):
        info = info + h[m] * hr[m]
        innov = innov + hr[m] * z[:, m]
    p_post = 1.0 / (1.0 / p_prior + info)
    x_post = p_post * (x_prior / p_prior + innov)
    return x_post, p_post


def kf_bank_epoch_plain(
    x: torch.Tensor, p: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
    r: torch.Tensor, *, a: float = 1.0, q: float = 1e-3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`kf_bank_step_plain`, then the int32 boost signal x_post > 0
    (`core.kalman.binarize` at its threshold 0), as the kernel writes it."""
    x_post, p_post = kf_bank_step_plain(x, p, z, h, r, a=a, q=q)
    return x_post, p_post, (x_post > 0).to(torch.int32)


def kf_bank_step(
    x, p, z, h, r, *, a: float = 1.0, q: float = 1e-3,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x, p (B,) states and variances, z (B, M) observations, h, r (M,)
    observation model and diagonal noise -> (x_post, p_post), each (B,)
    float32."""
    if not all(isinstance(t, torch.Tensor) for t in (x, p, z, h, r)):
        device = resolve_device(device)
    x, p, z, h, r = (_as_f32(t, device) for t in (x, p, z, h, r))
    cuda = {t.is_cuda for t in (x, p, z, h, r)}
    if len(cuda) != 1:
        raise ValueError("kf_bank_step inputs mix CUDA and CPU tensors")
    if not cuda.pop():
        return kf_bank_step_plain(x, p, z, h, r, a=a, q=q)
    from repro_torch.kernels.kf_bank import kernel

    return kernel.kf_bank(x.contiguous(), p.contiguous(), z.contiguous(),
                          h.contiguous(), r.contiguous(), a=a, q=q)
