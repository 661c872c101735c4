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

Mamba2's scan trains through `MambaSSDScan` (`models.mamba.
fused_chunked_scan_m2` under grad on CUDA tensors): its forward is B7 over
`ssd_channels`' per-channel views, asked for checkpoints, so y and h_last
are B7's bits; its backward is B7-bwd's mamba2 form (`kernel.
mamba_ssd_bwd`), which takes the head's dt and one decay a head, takes
exp(dt * a_h) once a (t, head) and returns ddt (B, L, nh) and da_h (nh,)
itself; its plain version is `fused_ssd_scan_plain_bwd`.  Its launches
count in `ops.LAUNCHES["mamba_ssd_bwd"]`.
"""
from __future__ import annotations

import torch

# B7-bwd's mamba2 form sums a head's channels in chunks of min(hd,
# SSD_CHUNK) (csrc/mamba_scan_bwd.cu's kQrChunk: `ssd_chunk_sum`), and
# holds SSD_K states a thread (its B7B_K, at most S; `ssd_q_sum`)
SSD_CHUNK = 16
SSD_K = 4


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
    return halving_sum(v)


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


def ssd_channels(dt: torch.Tensor, xh: torch.Tensor, a_h: torch.Tensor,
                 h0: torch.Tensor | None):
    """The SSD scan's inputs as B7's per-channel ones: dt (B, L, nh) ->
    (B, L, nh * hd) and a_h (nh,) -> A (nh * hd, ds), each head's value
    repeated over its hd channels (channel h * hd + e, the layout of
    ``xh.reshape(B, L, nh * hd)``); xh and h0 (B, nh, hd, ds) as views of
    (B, L, nh * hd) and (B, nh * hd, ds) (h0 may be None)."""
    bsz, L, nh, hd = xh.shape
    di = nh * hd
    ds = None if h0 is None else h0.shape[-1]
    a_mat = a_h.repeat_interleave(hd)[:, None]
    return (dt.repeat_interleave(hd, dim=-1), xh.reshape(bsz, L, di),
            a_mat if ds is None else a_mat.expand(di, ds),
            None if h0 is None else h0.reshape(bsz, di, ds))


def ssd_chunk_sum(v: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., nh * hd) -> (..., nh): each head's hd channels summed in B7-bwd
    mamba2 form's order: chunks of min(hd, SSD_CHUNK) channels, each added
    by pairwise halving, then the chunks in order."""
    cs = min(hd, SSD_CHUNK)
    s = halving_sum(v.unflatten(-1, (-1, hd // cs, cs)))
    q = s[..., 0]
    for k in range(1, hd // cs):
        q = q + s[..., k]
    return q


def halving_sum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` (a power of two long) by pairwise halving: element
    i + n / 2 into element i, then the halves of that, ..."""
    v = v.movedim(dim, -1)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def ssd_q_sum(prod: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, nh * hd, S) -> (B, nh): each head's sum of lam h_{t-1} in the
    mamba2 form's order.  A thread holds SSD_K states of a channel (states
    j, j + G, ... on lane j of G = S / SSD_K) and adds them by halving;
    then a chunk of min(hd, SSD_CHUNK) channels adds its threads' shares
    (channel-major, lane-minor) by halving, and the chunks in order."""
    bsz, d, s = prod.shape
    k = min(SSD_K, s)
    per_lane = halving_sum(prod.view(bsz, d, k, s // k), dim=-2)  # (B, D, G)
    cs = min(hd, SSD_CHUNK)
    per_chunk = halving_sum(per_lane.reshape(bsz, d // cs, cs * (s // k)))
    q = per_chunk.view(bsz, -1, hd // cs)
    out = q[..., 0]
    for i in range(1, hd // cs):
        out = out + q[..., i]
    return out


def strided_sum(v: torch.Tensor, runs: int = 256) -> torch.Tensor:
    """Sum over axis 0 as the mamba2 form's heads kernel sums its rows:
    run k adds rows k, k + runs, ... in order from zero, then the runs are
    added by pairwise halving (run k + runs / 2 into run k, ...)."""
    acc = torch.zeros((runs,) + v.shape[1:], dtype=v.dtype, device=v.device)
    for i0 in range(0, v.shape[0], runs):
        rows = v[i0:i0 + runs]
        acc[:rows.shape[0]] = acc[:rows.shape[0]] + rows
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    return acc[0]


def fused_ssd_scan_plain_bwd(
    dt: torch.Tensor, xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    a_h: torch.Tensor, h0: torch.Tensor | None, gy: torch.Tensor,
    g_hlast: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The gradient of the SSD scan (B7 over `ssd_channels`) as B7-bwd's
    mamba2 form computes it, from its own inputs dt (B, L, nh), xh (B, L,
    nh, hd), b, c (B, L, S), a_h (nh,), h0 (B, nh, hd, S) or None, gy (B, L,
    nh, hd) and g_hlast (B, nh, hd, S) or None.  With a_t = exp(dt_t a_h)
    one number a (t, head) and the adjoint lam_t = gy_t C_t + a_{t+1}
    lam_{t+1} of each channel's states:

        q_t   = ssd_q_sum(lam_t h_{t-1})
        r_t   = ssd_chunk_sum(state_sum(lam_t B_t) xh_t)
        ddt_t = r_t + (q_t a_t) a_h,   dxh_t = state_sum(lam_t B_t) dt_t
        da_h  = strided_sum over (b, t) of (q_t a_t) dt_t
        dB_t  = sum_d lam_t (dt_t xh_t),   dC_t = sum_d gy_t h_t
        dh0   = a_0 lam_0

    -> (ddt, dxh, dB, dC, da_h, dh0), each in its input's type (dh0 f32)."""
    bsz, L, nh, hd = xh.shape
    s = b.shape[-1]
    d = nh * hd
    f32 = torch.float32
    xc = xh.reshape(bsz, L, d).to(f32)
    b_f, c_f = b.to(f32), c.to(f32)
    gy = gy.reshape(bsz, L, d).to(f32)
    dt_d = dt.repeat_interleave(hd, dim=-1)
    h = (torch.zeros((bsz, d, s), dtype=f32, device=dt.device)
         if h0 is None else h0.reshape(bsz, d, s).to(f32))
    hs = [h]                                  # hs[t] = h_{t-1}
    for t in range(L):
        a = torch.exp(dt[:, t] * a_h).repeat_interleave(hd, dim=-1)
        h = a[..., None] * h + (dt_d[:, t] * xc[:, t])[..., None] \
            * b_f[:, t, None, :]
        hs.append(h)
    carry = (torch.zeros_like(h) if g_hlast is None
             else g_hlast.reshape(bsz, d, s).to(f32))
    ddt = torch.empty((bsz, L, nh), dtype=f32, device=dt.device)
    gdt = torch.empty_like(ddt)                # (q_t a_t) dt_t
    dxh = torch.empty((bsz, L, d), dtype=f32, device=dt.device)
    db = torch.empty((bsz, L, s), dtype=f32, device=dt.device)
    dc = torch.empty_like(db)
    for t in reversed(range(L)):
        a_t = torch.exp(dt[:, t] * a_h)       # (B, nh)
        dx = dt_d[:, t] * xc[:, t]
        lam = gy[:, t, :, None] * c_f[:, t, None, :] + carry
        gdx = state_sum(lam * b_f[:, t, None, :])
        dxh[:, t] = gdx * dt_d[:, t]
        q = ssd_q_sum(lam * hs[t], hd)
        r = ssd_chunk_sum(gdx * xc[:, t], hd)
        ga = q * a_t
        ddt[:, t] = r + ga * a_h
        gdt[:, t] = ga * dt[:, t]
        db[:, t] = (lam * dx[..., None]).sum(1)
        dc[:, t] = (gy[:, t, :, None] * hs[t + 1]).sum(1)
        carry = a_t.repeat_interleave(hd, dim=-1)[..., None] * lam
    da_h = strided_sum(gdt.reshape(bsz * L, nh))
    return (ddt, dxh.view(bsz, L, nh, hd).to(xh.dtype), db.to(b.dtype),
            dc.to(c.dtype), da_h, carry.view(bsz, nh, hd, s))


class MambaSSDScan(torch.autograd.Function):
    """The SSD scan from its own inputs (dt (B, L, nh), xh (B, L, nh, hd),
    b, c, a_h (nh,), h0 (B, nh, hd, S) or None) -> y (B, L, nh, hd), h_last
    (B, nh, hd, S): on CUDA tensors B7 over `ssd_channels`' views asked for
    its tile checkpoints, then B7-bwd's mamba2 form; on CPU tensors the
    plain forward and `fused_ssd_scan_plain_bwd`."""

    @staticmethod
    def forward(ctx, dt, xh, b, c, a_h, h0):
        ctx.set_materialize_grads(False)
        ctx.has_h0 = h0 is not None
        bsz, L, nh, hd = xh.shape
        s = b.shape[-1]
        dt_d, xc, a_mat, h0_d = ssd_channels(dt, xh, a_h, h0)
        a_mat = a_mat.expand(nh * hd, s).contiguous()
        if not dt.is_cuda:
            ctx.save_for_backward(dt, xh, b, c, a_h, h0)
            y, h_last = fused_mamba_scan_plain(dt_d, xc, b, c, a_mat, h0_d)
        else:
            from repro_torch.kernels.mamba_scan import kernel

            y, h_last, ckpt = kernel.mamba_fused(dt_d, xc, b, c, a_mat, h0_d,
                                                 checkpoints=True)
            ctx.save_for_backward(dt, xh, b, c, a_h, ckpt)
        return y.view(bsz, L, nh, hd), h_last.view(bsz, nh, hd, s)

    @staticmethod
    def backward(ctx, gy, g_hlast):
        dt, xh, b, c, a_h, saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(xh.shape, dtype=torch.float32, device=dt.device)
        if dt.is_cuda:
            from repro_torch.kernels.mamba_scan import kernel

            grads = kernel.mamba_ssd_bwd(
                dt, xh, b, c, a_h, saved, gy.float().contiguous(),
                None if g_hlast is None else g_hlast.float().contiguous())
        else:
            grads = fused_ssd_scan_plain_bwd(dt, xh, b, c, a_h, saved, gy,
                                             g_hlast)
        return (*grads[:5], grads[5] if ctx.has_h0 else None)


def fused_ssd_scan(
    dt: torch.Tensor,    # (B, L, nh) fp32
    xh: torch.Tensor,    # (B, L, nh, hd)
    b: torch.Tensor,     # (B, L, S)
    c: torch.Tensor,     # (B, L, S)
    a_h: torch.Tensor,   # (nh,) negative per-head decay
    h0: torch.Tensor | None = None,   # (B, nh, hd, S) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """`MambaSSDScan` on contiguous inputs, dt, a_h and h0 as float32: the
    route of `models.mamba.fused_chunked_scan_m2` under grad on the card."""
    f32 = torch.float32
    return MambaSSDScan.apply(
        dt.to(f32).contiguous(), xh.contiguous(), b.contiguous(),
        c.contiguous(), a_h.to(f32).contiguous(),
        None if h0 is None else h0.to(f32).contiguous())


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
