"""Plain torch oracle for the flash attention kernel ((B, H, S, D) layout):
dense scores with K/V repeated per query head in f32, the masks, softmax,
and fully masked rows zeroed, as the kernel does; on request also each
row's natural log-sum-exp of its valid logits (0 for a row with none), as
the kernel writes it for the backward."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KV, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    kv_len: int | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    kv_len = sk if kv_len is None else kv_len
    kr = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) / d ** 0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows give uniform p; zero them like the kernel does
    any_valid = mask.any(dim=-1)                              # (Sq,)
    p = torch.where(any_valid[None, None, :, None], p, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(any_valid, torch.logsumexp(s, dim=-1), 0.0)
    return out, lse
