"""Decoder LM assembly, dense subset: parameters, prefill and decode.

The reference repeats a short *pattern* of block kinds and scans it with
`lax.scan` over parameters stacked on a leading `n_super` axis.  The port
keeps the same parameter and cache trees, except that a pattern position's
blocks are a Python list of per-layer dicts (``params["blocks"][j][i]`` is
layer i of pattern position j) walked by a Python loop; caches keep the
stacked layout, ``caches[j].k`` of shape (n_super, B, Smax, KV, D), and a
layer works on its slice.

This slice runs the dense kind ([attn + mlp], P = 1).  The other kinds
raise NotImplementedError naming the ROADMAP item that brings them:
`moe` (grok-1, llama4), `mamba1` / `mamba2` and the hybrid shared block
(falcon-mamba, zamba2), encoder-decoder (seamless-m4t) and the modality
frontends (internvl2).  `forward` and `lm_loss` belong to the training
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch._util import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

ACT_DTYPE = torch.bfloat16

_LATER = {
    "moe": "ROADMAP queue A 'MoE (grok-1, llama4)'",
    "mamba1": "ROADMAP queue A 'mamba family' (B6/B7)",
    "mamba2": "ROADMAP queue A 'mamba family' (B6/B7)",
    "hybrid": "ROADMAP queue A 'mamba family' (zamba2's shared block)",
    "encdec": "ROADMAP queue A 'encoder-decoder and frontends'",
    "frontend": "ROADMAP queue A 'encoder-decoder and frontends'",
}


def layer_pattern(cfg: ModelConfig) -> tuple[tuple[str, ...], int]:
    """Return (pattern, n_super). pattern entries: dense|moe|mamba1|mamba2."""
    if cfg.is_hybrid:
        p = cfg.shared_attn_period
        if cfg.n_layers % p:
            raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                             f"the shared-attention period {p}")
        return tuple(["mamba2"] * p), cfg.n_layers // p
    if cfg.is_ssm:
        return ("mamba1",), cfg.n_layers
    if cfg.is_moe:
        period = cfg.moe_layer_period
        if cfg.n_layers % period:
            raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                             f"the MoE period {period}")
        mask = cfg.moe_layer_mask()[:period]
        return (tuple("moe" if m else "dense" for m in mask),
                cfg.n_layers // period)
    return ("dense",), cfg.n_layers


def _require_dense(cfg: ModelConfig) -> tuple[tuple[str, ...], int]:
    """The pattern, if this slice runs it; else NotImplementedError."""
    pattern, n_super = layer_pattern(cfg)
    why = None
    if cfg.is_encoder_decoder:
        why = "encdec"
    elif cfg.frontend:
        why = "frontend"
    elif cfg.is_hybrid:
        why = "hybrid"
    else:
        why = next((k for k in pattern if k != "dense"), None)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {why} kind is not ported yet ({_LATER[why]})")
    return pattern, n_super


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _make_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {
        "ln1": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "ln2": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "attn": attention.make_attention(gen, cfg, dtype),
        "mlp": layers.make_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def make_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (the reference
    draws from a JAX key, so the numbers differ; tests carry the
    reference's parameters across with `interop.lm_params`)."""
    pattern, n_super = _require_dense(cfg)
    dtype = param_dtype(cfg)
    params: dict[str, Any] = {
        "embed": layers.make_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype),
        "final_norm": layers.make_norm(cfg.d_model, cfg.norm, gen.device),
        "blocks": [[_make_dense_block(gen, cfg, dtype)
                    for _ in range(n_super)] for _ in pattern],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": layers.truncated_normal(
            gen, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, dtype)}
    return params


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    """Stacked per-pattern-position caches + shared-block caches."""

    caches: list[Any]             # caches[j]: KVCache, leaves (n_super, ...)
    shared_kv: Optional[KVCache]  # the hybrid shared block (not in this slice)
    length: Tensor                # (B,) tokens decoded so far


def init_decode_state(batch: int, max_len: int, cfg: ModelConfig,
                      device: str | torch.device | None = None) -> DecodeState:
    pattern, n_super = _require_dense(cfg)
    dev = resolve_device(device)
    if cfg.sliding_window is not None:  # ring cache: O(window) not O(context)
        max_len = min(max_len, cfg.sliding_window)
    shape = (n_super, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    caches = [KVCache(
        k=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
        v=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
        length=torch.zeros((n_super, batch), dtype=torch.int32, device=dev),
    ) for _ in pattern]
    return DecodeState(caches=caches, shared_kv=None,
                       length=torch.zeros((batch,), dtype=torch.int32,
                                          device=dev))


def _layer_cache(cache: KVCache, i: int) -> KVCache:
    return KVCache(k=cache.k[i], v=cache.v[i], length=cache.length[i])


def _final_logits(params: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return layers.unembed(head, x)


def decode_step(
    params: dict, token: Tensor, state: DecodeState, cfg: ModelConfig
) -> tuple[Tensor, DecodeState]:
    """token: (B, 1) int -> (logits (B, 1, V) f32, new state).

    The new token's K/V are written into ``state``'s cache tensors IN PLACE
    (the reference returns updated copies); the returned DecodeState holds
    the same cache tensors, the new per-layer lengths and length + 1."""
    pattern, n_super = _require_dense(cfg)
    x = layers.embed(params["embed"], token, ACT_DTYPE)
    lengths = [[None] * n_super for _ in pattern]
    for i in range(n_super):
        for j, _ in enumerate(pattern):
            p = params["blocks"][j][i]
            h = layers.apply_norm(p["ln1"], x, cfg.norm)
            h, c = attention.self_attention_decode(
                p["attn"], h, cfg, _layer_cache(state.caches[j], i))
            lengths[j][i] = c.length
            x = x + h
            h = layers.apply_norm(p["ln2"], x, cfg.norm)
            x = x + layers.apply_mlp(p["mlp"], h, cfg.act)
    caches = [KVCache(k=c.k, v=c.v, length=torch.stack(lengths[j]))
              for j, c in enumerate(state.caches)]
    return _final_logits(params, x, cfg), DecodeState(
        caches=caches, shared_kv=None, length=state.length + 1)


def prefill_caches(
    params: dict, tokens: Tensor, cfg: ModelConfig, max_len: int,
) -> DecodeState:
    """Run the full sequence once and return a DecodeState holding its K/V,
    padded to ``max_len`` positions.  Attention goes through `attend`, so
    through the flash kernel (B5) on the card: one launch per layer."""
    pattern, n_super = _require_dense(cfg)
    b, s = tokens.shape
    dev = tokens.device
    x = layers.embed(params["embed"], tokens, ACT_DTYPE)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    shape = (n_super, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    caches = [KVCache(
        k=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
        v=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
        length=lens.expand(n_super, b).clone(),
    ) for _ in pattern]
    for i in range(n_super):
        for j, _ in enumerate(pattern):
            p = params["blocks"][j][i]
            h = layers.apply_norm(p["ln1"], x, cfg.norm)
            q, k, v = attention.qkv_project(p["attn"], h, cfg, positions)
            o = attention.attend(q, k, v, causal=True,
                                 window=cfg.sliding_window,
                                 logit_cap=cfg.attn_logit_softcap)
            x = x + attention.out_project(o, p["attn"]["wo"])
            h = layers.apply_norm(p["ln2"], x, cfg.norm)
            x = x + layers.apply_mlp(p["mlp"], h, cfg.act)
            caches[j].k[i, :, :s] = k
            caches[j].v[i, :, :s] = v
    return DecodeState(caches=caches, shared_kv=None, length=lens)
