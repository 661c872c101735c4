"""Attention: GQA + RoPE (partial/theta), causal / sliding-window.

Three lowerings of the same math, as in the JAX package:
  * `attend_ref`    — plain O(S^2) torch (the oracle);
  * `attend`        — prefill/training attention through the flash kernel
                      entry point `kernels.flash_attn.ops.flash_attention`:
                      the CUDA kernel (B5) on a CUDA tensor, its plain
                      version on a CPU tensor;
  * `attend_decode` — single-query attention against a KV cache (plain
                      torch, as the reference computes it outside any
                      kernel).
The encoder-decoder's `cross_attention` runs `attend_ref` with no mask,
as the reference does, outside any kernel.

The reference's `attend` takes `use_kernel=False` by default and leaves
the fusion to XLA, which the port does not have; the port therefore always
routes `attend` through the flash entry point and has no `use_kernel` flag.
The flash path keeps the probabilities in f32 where `attend_ref` rounds
them to the value type before the PV product, so the two differ by that
rounding.

Activations are bf16; logits and softmax are f32.  The attention products
upcast their (small) operands to f32 on both devices, which is what the
reference's f32-accumulated einsums compute.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
NEG_INF = -1e30


# --------------------------------------------------------------------------
# RoPE (rotary position embeddings), partial-rotary capable
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float, device):
    rot = int(head_dim * fraction) // 2 * 2  # rotated dims, even
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: Tensor, positions: Tensor, fraction: float,
               theta: float) -> Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates the
    interleaved pairs (x[..., 0::2], x[..., 1::2]) of the first
    int(D * fraction) // 2 * 2 dims."""
    d = x.shape[-1]
    inv, rot = rope_frequencies(d, fraction, theta, x.device)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1 = xr[..., 0::2].to(torch.float32)
    x2 = xr[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def softcap(logits: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def make_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": layers.dense_init(gen, d, (d, cfg.n_heads, hd), dtype),
        "wk": layers.dense_init(gen, d, (d, cfg.n_kv_heads, hd), dtype),
        "wv": layers.dense_init(gen, d, (d, cfg.n_kv_heads, hd), dtype),
        "wo": layers.dense_init(gen, cfg.n_heads * hd,
                                (cfg.n_heads, hd, d), dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
    return p


def _project_heads(x: Tensor, w: Tensor) -> Tensor:
    """(B, S, D) x (D, H, K) -> (B, S, H, K)."""
    d, h, k = w.shape
    return layers.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def out_project(o: Tensor, wo: Tensor) -> Tensor:
    """(B, S, H, K) x (H, K, D) -> (B, S, D)."""
    h, k, d = wo.shape
    return layers.matmul(o.flatten(-2), wo.reshape(h * k, d))


def qkv_project(p, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied."""
    q = _project_heads(x, p["wq"])
    k = _project_heads(x, p["wk"])
    v = _project_heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


# --------------------------------------------------------------------------
# Reference attention (oracle)
# --------------------------------------------------------------------------

def attend_ref(
    q: Tensor, k: Tensor, v: Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D). Returns (B, Sq, H, D).

    `q_offset`: absolute position of q[0] relative to k[0]."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qf = q.reshape(b, sq, kvh, rep, d).to(torch.float32)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(torch.float32))
    logits = softcap(logits / d ** 0.5, logit_cap)
    dev = q.device
    q_pos = torch.arange(sq, device=dev) + q_offset
    k_pos = torch.arange(sk, device=dev)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(b, sq, h, d)


def attend(
    q: Tensor, k: Tensor, v: Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> Tensor:
    """Prefill/training attention through the flash entry point (B5 on a
    CUDA tensor, with B5-bwd as its backward under autograd; its plain
    version, which autograd differentiates, on a CPU tensor).  (B, S, H,
    D) layout."""
    return flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, logit_cap=logit_cap)


def attend_decode(
    q: Tensor, k_cache: Tensor, v_cache: Tensor, cache_len: Tensor,
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> Tensor:
    """One-token decode: q (B, 1, H, D) vs cache (B, Smax, KV, D).

    `cache_len` (B,) int32 — number of valid cache entries (includes the
    token being decoded, already written at cache_len-1)."""
    b, _, h, d = q.shape
    smax, kvh = k_cache.shape[1], k_cache.shape[2]
    rep = h // kvh
    qf = q.reshape(b, kvh, rep, d).to(torch.float32)
    logits = torch.einsum("bgrd,bkgd->bgrk", qf, k_cache.to(torch.float32))
    logits = softcap(logits / d ** 0.5, logit_cap)
    k_pos = torch.arange(smax, device=q.device)[None, :]
    mask = k_pos < cache_len[:, None]
    if window is not None:
        mask &= k_pos >= (cache_len[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", probs.to(torch.float32),
                       v_cache.to(torch.float32)).to(v_cache.dtype)
    return out.reshape(b, 1, h, d)


# --------------------------------------------------------------------------
# Full block-level entry points
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor        # (B, Smax, KV, D)
    v: Tensor
    length: Tensor   # (B,) valid entries


def self_attention(p, x: Tensor, cfg: ModelConfig,
                   positions: Tensor) -> Tensor:
    q, k, v = qkv_project(p, x, cfg, positions)
    o = attend(q, k, v, causal=True, window=cfg.sliding_window,
               logit_cap=cfg.attn_logit_softcap)
    return out_project(o, p["wo"])


def self_attention_decode(
    p, x: Tensor, cfg: ModelConfig, cache: KVCache
) -> tuple[Tensor, KVCache]:
    """x: (B, 1, D). Appends to the cache then attends.

    The new token's K/V are written into ``cache.k`` / ``cache.v`` IN PLACE
    (the reference returns updated copies); the returned KVCache holds the
    same tensors and the new lengths.

    Sliding-window archs use a RING cache of size `window`: the write slot
    wraps (`length % Smax`), all resident entries are in-window by
    construction, and RoPE is applied with absolute positions at write time
    so dot products stay relative-position-correct."""
    positions = cache.length[:, None]  # absolute position of the new token
    q, k, v = qkv_project(p, x, cfg, positions)
    b = x.shape[0]
    smax = cache.k.shape[1]
    ring = cfg.sliding_window is not None and smax <= cfg.sliding_window
    idx = (cache.length % smax if ring else cache.length).to(torch.int64)
    # the reference's scatter drops a write past the cache's end (an idle
    # engine slot's length keeps growing); so does this masked write, with
    # no host sync
    keep = (idx < smax)[:, None, None]
    idx = torch.clamp(idx, max=smax - 1)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, idx] = torch.where(keep, k[:, 0], cache.k[rows, idx])
    cache.v[rows, idx] = torch.where(keep, v[:, 0], cache.v[rows, idx])
    new_len = cache.length + 1
    if ring:
        o = attend_decode(
            q, cache.k, cache.v, torch.clamp(new_len, max=smax),
            window=None,  # residency == window by construction
            logit_cap=cfg.attn_logit_softcap,
        )
    else:
        o = attend_decode(
            q, cache.k, cache.v, new_len,
            window=cfg.sliding_window,
            logit_cap=cfg.attn_logit_softcap,
        )
    out = out_project(o, p["wo"])
    return out, KVCache(k=cache.k, v=cache.v, length=new_len)


def cross_attention(
    p, x: Tensor, enc_kv: tuple[Tensor, Tensor], cfg: ModelConfig
) -> Tensor:
    """Decoder cross-attention over precomputed encoder K/V (seamless-m4t).

    The reference computes it with `attend_ref(..., causal=False)`, outside
    any kernel, even where its `use_kernel` is set; the port does the same
    through its own `attend_ref`, on the card too (no kernel computes it in
    the reference, so none does here)."""
    q = _project_heads(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    k, v = enc_kv
    o = attend_ref(q, k, v, causal=False)
    return out_project(o, p["wo"])


def encode_kv(p, enc_out: Tensor, cfg: ModelConfig
              ) -> tuple[Tensor, Tensor]:
    """The encoder output's K and V for one decoder block's cross-attention,
    (B, F, KV, hd) each, with no RoPE."""
    k = _project_heads(enc_out, p["wk"])
    v = _project_heads(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return k, v
