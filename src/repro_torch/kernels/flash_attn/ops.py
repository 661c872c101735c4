"""Entry point of the flash attention kernel (B5), with its plain version
and a launch counter.

`flash_attention` keeps the model layout (B, S, H, D) at its public face,
as the reference's `flash_attn/ops.py` does: q (B, Sq, H, D), k and v
(B, Sk, KV, D), GQA by query head h -> kv head h // (H / KV), causal and
sliding-window masks, a tanh logit cap, and a `kv_len` bound on the valid
keys.  Scores, softmax and the accumulator are f32; the output has q's
type.  On CUDA tensors it launches a hand-written kernel that reads the
model layout through its strides (no transpose): for bfloat16, the wgmma
kernel fed by TMA in csrc/flash_attn_sm90.cu, which pads D = 80 to 128 in
shared memory and needs each of q, k and v to have a 16-byte-aligned base
and strides on B, S and H that are multiples of 8 elements (else it
raises); for float32, the SIMT kernel in csrc/flash_attn.cu.  On CPU
tensors it runs `flash_attention_plain`.  There is no fallback: a CUDA
tensor launches a kernel or raises.  Inputs that are not tensors go to ``device``, which
defaults to the CUDA device.

Gradients: on CUDA tensors of which one needs a gradient (grad mode on),
the call goes through `FlashAttention`, an autograd.Function whose forward
asks B5 for the rows' log-sum-exp too and saves it, and whose backward
launches B5-bwd (`kernel.flash_attn_bwd`: bf16 csrc/flash_attn_bwd_sm90.cu,
f32 csrc/flash_attn_bwd.cu) on it, so q, k and v get their gradients
through the kernels (a ``kv_len`` raises in the backward: training never
passes one).  Every other CUDA call (serving, no_grad, the first pass of a
reentrant checkpoint) launches B5 alone, with no lse.  On CPU tensors
autograd differentiates `flash_attention_plain` itself.
`flash_attention_plain_bwd` writes the same gradient out in PyTorch, for
the tests and the card's comparison; no main path calls it.

`LAUNCHES["flash_attn"]` counts B5 launches and
`LAUNCHES["flash_attn_bwd"]` calls of B5-bwd (three kernels a call:
delta, dK/dV, dQ); the launchers in kernel.py add one after each launch
that succeeded and nowhere else (an empty output launches nothing and
counts nothing).
"""
from __future__ import annotations

import torch

from repro_torch._util import resolve_device
from repro_torch.kernels.flash_attn.ref import NEG_INF, attention_ref

LAUNCHES = {"flash_attn": 0, "flash_attn_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
    logit_cap: float | None = None, kv_len: int | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in dense form, in the model layout; with
    ``return_lse``, (out, lse) with lse f32 (B, H, Sq), each row's natural
    log-sum-exp of its valid capped, scaled logits (0 for a row with none),
    the kernel's ``with_lse`` output."""
    res = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, logit_cap=logit_cap, kv_len=kv_len,
        return_lse=return_lse)
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


def flash_attention_plain_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, *, causal: bool = True, window: int | None = None,
    logit_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5-bwd's function in dense form (model layout, f32 inside, every
    key valid): P recomputed from q and k, delta = sum_d dO * O from the
    given forward output, dS = P (dP - delta) times the cap's derivative,
    dq = dS K / sqrt(D), dk = dS^T Q / sqrt(D) and dv = P^T dO, each summed
    over a KV head's query group; returned in q's type."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    f32 = torch.float32
    qf, of, dof = (t.transpose(1, 2).to(f32) for t in (q, o, do))
    kf, vf = (torch.repeat_interleave(t.transpose(1, 2).to(f32), rep, dim=1)
              for t in (k, v))
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / d ** 0.5
    dcap = None
    if logit_cap is not None:
        t = torch.tanh(x / logit_cap)
        x = logit_cap * t
        dcap = 1 - t * t
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    x = torch.where(mask, x, NEG_INF)
    p = torch.softmax(x, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)  # rows with no key
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) / d ** 0.5
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) / d ** 0.5
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)

    def grouped(t):   # (B, H, Sk, D) -> (B, Sk, KV, D), summed over groups
        return t.unflatten(1, (kvh, rep)).sum(dim=2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), grouped(dk).to(q.dtype),
            grouped(dv).to(q.dtype))


class FlashAttention(torch.autograd.Function):
    """B5 forward, B5-bwd backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, kv_len):
        from repro_torch.kernels.flash_attn import kernel

        o, lse = kernel.flash_attn(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, kv_len=kv_len,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, logit_cap=logit_cap)
        ctx.kv_len = kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.kv_len is not None:
            raise NotImplementedError(
                "flash attention's backward takes no kv_len (training never "
                "passes one)")
        from repro_torch.kernels.flash_attn import kernel

        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attn_bwd(q, k, v, o, do.contiguous(), lse,
                                           **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q, k, v, *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    kv_len: int | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's type."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        device = resolve_device(device)
        q, k, v = (torch.as_tensor(t, device=device) for t in (q, k, v))
    cuda = {t.is_cuda for t in (q, k, v)}
    if len(cuda) != 1:
        raise ValueError("flash_attention inputs mix CUDA and CPU tensors")
    if not cuda.pop():
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, kv_len=kv_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, logit_cap,
                                    kv_len)
    from repro_torch.kernels.flash_attn import kernel

    return kernel.flash_attn(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, kv_len=kv_len)
