"""Entry point of the fused selective-scan kernel (B7), with its plain
version.

`fused_mamba_scan(dt, xc, b, c, a_mat)` is the Mamba1 scan with the
decay and input built inside it and the C-projection folded in:

    a_t = exp(dt_t * A),  bx_t = (dt_t * xc_t) * B_t,
    h_t = a_t * h_{t-1} + bx_t,  y_t = sum_s h_t * C_t

so that nothing of size (L, D, S) reaches device memory.  Mamba2's (SSD)
scan is the same function with each head's dt and decay repeated over the
head's channels (`models.mamba.fused_chunked_scan_m2`).  dt (B, L, D)
and A (D, S) are float32; xc (B, L, D) and b, c (B, L, S) are float32 or
bfloat16 (the model's activations) and are read as float32.  It returns
y (B, L, D) and h_last (B, D, S), both float32.

On CUDA tensors it launches the hand-written kernel in csrc/mamba_scan.cu;
on CPU tensors it runs `fused_mamba_scan_plain`.  There is no fallback: a
CUDA tensor launches the kernel or raises.  The kernel takes any L (the
TPU kernel needs L % chunk == 0) and an optional h0 (the TPU kernel starts
from zero; the model's scan passes one); ``chunk`` and ``block_d`` are
kept for the reference's signature and change nothing on the card, where
a few lanes walk the whole sequence of one (batch, d) channel, several
states each (csrc/mamba_scan.cu's head note).  Launches count in
`ops.LAUNCHES["mamba_fused"]`.  B7 has no backward kernel yet: on CUDA
tensors that require a gradient, while gradients are recorded, it raises
NotImplementedError naming ROADMAP A6b (`ops.refuse_grad`).
"""
from __future__ import annotations

import torch


def state_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last (state) axis in the order of B7's reduction (adds
    inside a thread, then xor shuffles): pairwise halving, s + s + S/2
    first, then the halves of that, ...
    (zeros pad S to a power of two; adding +0 changes no value).  The
    port's C-projection sums in this order on every path, so y through B6
    and y through B7 are the same bits."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def fused_mamba_scan_plain(
    dt: torch.Tensor, xc: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a_mat: torch.Tensor, h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic as torch ops: the sequential recurrence, one
    rounding per operation, and y summed over s by `state_sum`, the order
    of the kernel's shuffle tree."""
    bsz, L, d = dt.shape
    s = a_mat.shape[-1]
    f32 = torch.float32
    xc, b, c = xc.to(f32), b.to(f32), c.to(f32)
    h = (torch.zeros((bsz, d, s), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((bsz, L, d), dtype=f32, device=dt.device)
    for t in range(L):
        a = torch.exp(dt[:, t, :, None] * a_mat)
        bx = (dt[:, t] * xc[:, t])[..., None] * b[:, t, None, :]
        h = a * h + bx
        y[:, t] = state_sum(h * c[:, t, None, :])
    return y, h


def fused_mamba_scan(
    dt: torch.Tensor,     # (B, L, D) fp32
    xc: torch.Tensor,     # (B, L, D)
    b: torch.Tensor,      # (B, L, S)
    c: torch.Tensor,      # (B, L, S)
    a_mat: torch.Tensor,  # (D, S) negative decay matrix
    *,
    chunk: int = 256,
    block_d: int = 256,
    h0: torch.Tensor | None = None,   # (B, D, S) fp32, zero when None
) -> tuple[torch.Tensor, torch.Tensor]:
    del chunk, block_d  # no chunks or channel blocks on the card
    ins = [dt, xc, b, c, a_mat] + ([] if h0 is None else [h0])
    cuda = {t.is_cuda for t in ins}
    if len(cuda) != 1:
        raise ValueError("fused_mamba_scan inputs mix CUDA and CPU tensors")
    if not cuda.pop():
        return fused_mamba_scan_plain(dt, xc, b, c, a_mat, h0)
    from repro_torch.kernels.mamba_scan import kernel, ops

    ops.refuse_grad("fused_mamba_scan (B7)", ins)
    f32 = torch.float32
    return kernel.mamba_fused(
        dt.to(f32).contiguous(), xc.contiguous(), b.contiguous(),
        c.contiguous(), a_mat.to(f32).contiguous(),
        None if h0 is None else h0.to(f32).contiguous())
