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
`ops.LAUNCHES["mamba_fused"]`.

The gradient.  While gradients are recorded and an input requires one,
`fused_mamba_scan` goes through `MambaFusedScan`: on CUDA tensors B7's
forward writes, beside y and h_last, the states at its tile boundaries
(B, ceil(L / T), D, S) f32 (T = B7's tile), and B7-bwd
(csrc/mamba_scan_bwd.cu) walks the tiles in reverse, recomputing each
tile's states from its checkpoint; on CPU tensors the Function runs
`fused_mamba_scan_plain` and `fused_mamba_scan_plain_bwd`.  Every other
call launches B7 alone, without checkpoints: its y and h_last are the
same bits either way.  B7-bwd launches count in
`ops.LAUNCHES["mamba_fused_bwd"]`.
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


def fused_mamba_scan_plain_bwd(
    dt: torch.Tensor, xc: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a_mat: torch.Tensor, h0: torch.Tensor | None, gy: torch.Tensor,
    g_hlast: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The gradient of `fused_mamba_scan_plain` written out, as B7-bwd
    computes it: the states recomputed forward, then the adjoint
    lam_t = gy_t C_t + a_{t+1} lam_{t+1} (g_hlast in place of a_L lam_L)
    walked back, with ga_t = (lam_t h_{t-1}) a_t the gradient of dt_t A:

        ddt_t = state_sum(lam_t B_t) xc_t + state_sum(ga_t A)
        dxc_t = state_sum(lam_t B_t) dt_t
        dB_t  = sum_d lam_t (dt_t xc_t),   dC_t = sum_d gy_t h_t
        dA    = sum_b sum_t ga_t dt_t  (t from L - 1 down, then b in order)
        dh0   = a_0 lam_0

    -> (ddt, dxc, dB, dC, dA, dh0), each in its input's type (dh0 f32),
    with f32 sums inside."""
    bsz, L, d = dt.shape
    s = a_mat.shape[-1]
    f32 = torch.float32
    xc_f, b_f, c_f, gy = xc.to(f32), b.to(f32), c.to(f32), gy.to(f32)
    h = (torch.zeros((bsz, d, s), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    hs = [h]                                  # hs[t] = h_{t-1}
    for t in range(L):
        a = torch.exp(dt[:, t, :, None] * a_mat)
        h = a * h + (dt[:, t] * xc_f[:, t])[..., None] * b_f[:, t, None, :]
        hs.append(h)
    carry = torch.zeros_like(h) if g_hlast is None else g_hlast.to(f32)
    ddt = torch.empty((bsz, L, d), dtype=f32, device=dt.device)
    dxc = torch.empty_like(ddt)
    db = torch.empty((bsz, L, s), dtype=f32, device=dt.device)
    dc = torch.empty_like(db)
    da_acc = torch.zeros_like(h)
    for t in reversed(range(L)):
        a = torch.exp(dt[:, t, :, None] * a_mat)
        dx = dt[:, t] * xc_f[:, t]
        lam = gy[:, t, :, None] * c_f[:, t, None, :] + carry
        ga = lam * hs[t] * a
        da_acc = da_acc + ga * dt[:, t, :, None]
        gdx = state_sum(lam * b_f[:, t, None, :])
        dxc[:, t] = gdx * dt[:, t]
        ddt[:, t] = gdx * xc_f[:, t] + state_sum(ga * a_mat)
        db[:, t] = (lam * dx[..., None]).sum(1)
        dc[:, t] = (gy[:, t, :, None] * hs[t + 1]).sum(1)
        carry = a * lam
    da = da_acc[0]
    for i in range(1, bsz):
        da = da + da_acc[i]
    return (ddt, dxc.to(xc.dtype), db.to(b.dtype), dc.to(c.dtype), da,
            carry)


class MambaFusedScan(torch.autograd.Function):
    """B7 forward (asked for its tile checkpoints), B7-bwd backward, on
    CUDA tensors; the plain forward and backward on CPU tensors."""

    @staticmethod
    def forward(ctx, dt, xc, b, c, a_mat, h0):
        ctx.set_materialize_grads(False)
        ctx.has_h0 = h0 is not None
        if not dt.is_cuda:
            ctx.save_for_backward(dt, xc, b, c, a_mat, h0)
            return fused_mamba_scan_plain(dt, xc, b, c, a_mat, h0)
        from repro_torch.kernels.mamba_scan import kernel

        y, h_last, ckpt = kernel.mamba_fused(dt, xc, b, c, a_mat, h0,
                                             checkpoints=True)
        ctx.save_for_backward(dt, xc, b, c, a_mat, ckpt)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, g_hlast):
        dt, xc, b, c, a_mat, saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        if dt.is_cuda:
            from repro_torch.kernels.mamba_scan import kernel

            grads = kernel.mamba_fused_bwd(
                dt, xc, b, c, a_mat, saved, gy.contiguous(),
                None if g_hlast is None else g_hlast.contiguous())
        else:
            grads = fused_mamba_scan_plain_bwd(dt, xc, b, c, a_mat, saved,
                                               gy, g_hlast)
        return (*grads[:5], grads[5] if ctx.has_h0 else None)


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
    on_card = cuda.pop()
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    if not on_card and not grad:
        return fused_mamba_scan_plain(dt, xc, b, c, a_mat, h0)
    f32 = torch.float32
    args = (dt.to(f32).contiguous(), xc.contiguous(), b.contiguous(),
            c.contiguous(), a_mat.to(f32).contiguous(),
            None if h0 is None else h0.to(f32).contiguous())
    if grad:
        return MambaFusedScan.apply(*args)
    from repro_torch.kernels.mamba_scan import kernel

    return kernel.mamba_fused(*args)
