"""Entry point of the selective-scan kernel (B6), with a launch counter.

`mamba_chunk_scan(a, b, h0)` runs h_t = a_t * h_{t-1} + b_t over the
sequence axis of a, b (B, L, D, S) from h0 (B, D, S) and returns every
state and the last one, in float32.  On CUDA tensors it launches the
hand-written kernel in csrc/mamba_scan.cu; on CPU tensors it runs the
plain recurrence `ref.scan_ref`, which the kernel matches bitwise.  There
is no fallback: a CUDA tensor launches the kernel or raises.

The reference's argument checks are kept (L % chunk == 0 and
D % block_d == 0, each after `min()` with the shape), but ``chunk`` and
``block_d`` change nothing else: on the card one thread walks the whole
sequence of one (batch, d, s) element, so there are no chunks and no
channel blocks.

On CUDA tensors, while gradients are recorded and an input requires one,
`mamba_chunk_scan` goes through `MambaChunkScan`: B6 forward, and B6-bwd
(csrc/mamba_scan_bwd.cu) walking the adjoint back from the saved states
hs.  Otherwise it launches B6 alone.  On CPU tensors it runs plain torch,
which autograd differentiates.

`LAUNCHES` counts kernel launches: "mamba_scan" (B6), "mamba_fused" (B7,
`fused.fused_mamba_scan`), "mamba_scan_bwd" (B6-bwd), "mamba_fused_bwd"
(B7-bwd's per-channel form) and "mamba_ssd_bwd" (B7-bwd's mamba2 form,
`fused.MambaSSDScan`), each of B7-bwd's forms one a call of its four
kernels.  The
launchers in kernel.py add one after each launch that succeeded and
nowhere else (an empty input launches nothing and counts nothing).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.ref import scan_ref

LAUNCHES = {"mamba_scan": 0, "mamba_fused": 0, "mamba_scan_bwd": 0,
            "mamba_fused_bwd": 0, "mamba_ssd_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MambaChunkScan(torch.autograd.Function):
    """B6 forward, B6-bwd backward, on CUDA tensors: hs is an output, so
    the backward reads it rather than recompute it."""

    @staticmethod
    def forward(ctx, a, b, h0):
        from repro_torch.kernels.mamba_scan import kernel

        hs, h_last = kernel.mamba_scan(a, b, h0)
        ctx.save_for_backward(a, hs, h0)
        ctx.set_materialize_grads(False)
        return hs, h_last

    @staticmethod
    def backward(ctx, g_hs, g_hlast):
        from repro_torch.kernels.mamba_scan import kernel

        a, hs, h0 = ctx.saved_tensors
        if g_hs is None:
            g_hs = torch.zeros_like(hs)
        return kernel.mamba_scan_bwd(
            a, hs, h0, g_hs.contiguous(),
            None if g_hlast is None else g_hlast.contiguous())


def mamba_chunk_scan(
    a: torch.Tensor,   # (B, L, D, S) fp32
    b: torch.Tensor,
    h0: torch.Tensor,  # (B, D, S) fp32
    *,
    chunk: int = 256,
    block_d: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    bsz, L, d, s = a.shape
    chunk, block_d = min(chunk, L), min(block_d, d)
    if chunk < 1 or block_d < 1 or L % chunk or d % block_d:
        raise ValueError(f"mamba_chunk_scan needs L % chunk == 0 and "
                         f"D % block_d == 0 (L={L}, chunk={chunk}, D={d}, "
                         f"block_d={block_d})")
    if b.shape != a.shape or h0.shape != (bsz, d, s):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)} do not match")
    a, b, h0 = (t.to(torch.float32) for t in (a, b, h0))
    cuda = {t.is_cuda for t in (a, b, h0)}
    if len(cuda) != 1:
        raise ValueError("mamba_chunk_scan inputs mix CUDA and CPU tensors")
    if not cuda.pop():
        return scan_ref(a, b, h0)
    a, b, h0 = a.contiguous(), b.contiguous(), h0.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        return MambaChunkScan.apply(a, b, h0)
    from repro_torch.kernels.mamba_scan import kernel

    return kernel.mamba_scan(a, b, h0)
