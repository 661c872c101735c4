"""Decoder LM assembly: parameters, forward, prefill and decode.

The reference repeats a short *pattern* of block kinds and scans it with
`lax.scan` over parameters stacked on a leading `n_super` axis.  The port
keeps the same parameter and cache trees, except that a pattern position's
blocks are a Python list of per-layer dicts (``params["blocks"][j][i]`` is
layer i of pattern position j) walked by a Python loop; caches keep the
stacked layout, ``caches[j].k`` of shape (n_super, B, Smax, KV, D) or
``caches[j].ssm`` of shape (n_super, B, di, ds), and a layer works on its
slice.

The port runs the dense kind ([attn + mlp], P = 1), the moe kind
([attn + moe]: grok-1 with P = 1, llama4-maverick with P = 2, [attn +
mlp, attn + moe]; `forward` sums the MoE aux losses over the layers and
averages the per-super-block expert load, as the reference's scan
carry does), the mamba1 kind ([mamba1], P = 1: falcon-mamba) and
zamba2's hybrid ([mamba2 x 6], then ONE shared attn + mlp block whose
weights every super-block reuses, ``params["shared_attn"]``; its caches
are ``DecodeState.shared_kv``, one stacked KVCache entry per
application).  A config with a modality frontend (internvl2's vision
prefix) gets ``params["projector"]``, and `forward` / `prefill_caches`
take ``embeds=`` (B, F, frontend_dim): the projected prefix replaces the
first F token embeddings (`frontends.splice_prefix`).  The
encoder-decoder (seamless-m4t) is `models.encdec`.

Training: `cross_entropy` and `lm_loss` are the reference's loss (the MoE
aux terms added as there), and `forward` applies ``cfg.remat`` to each
super-block when gradients are being recorded (`_remat_wrap`).
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch._util import resolve_device
from repro_torch.models import attention, frontends, layers, mamba, moe
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEAux

Tensor = torch.Tensor

ACT_DTYPE = torch.bfloat16


class _MambaKind(NamedTuple):
    make: Any      # (gen, cfg, dtype) -> mixer params
    scan: Any      # (p, x, cfg) -> (y, final state): prefill
    decode: Any    # (p, x, cfg, state) -> (y, state): one token
    init: Any      # (batch, cfg, dtype, device) -> zero state


_MAMBA = {
    "mamba1": _MambaKind(mamba.make_mamba1, mamba._mamba1_scan,
                         mamba.apply_mamba1_decode, mamba.init_mamba1_state),
    "mamba2": _MambaKind(mamba.make_mamba2, mamba._mamba2_scan,
                         mamba.apply_mamba2_decode, mamba.init_mamba2_state),
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


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _make_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                dtype) -> dict:
    dev = gen.device
    if kind in _MAMBA:
        return {"ln": layers.make_norm(cfg.d_model, cfg.norm, dev),
                "mixer": _MAMBA[kind].make(gen, cfg, dtype)}
    p = {
        "ln1": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "ln2": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "attn": attention.make_attention(gen, cfg, dtype),
    }
    if kind == "moe":
        p["moe"] = moe.make_moe(gen, cfg, dtype)
    else:
        p["mlp"] = layers.make_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def make_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (the reference
    draws from a JAX key, so the numbers differ; tests carry the
    reference's parameters across with `interop.lm_params`)."""
    pattern, n_super = layer_pattern(cfg)
    dtype = param_dtype(cfg)
    params: dict[str, Any] = {
        "embed": layers.make_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype),
        "final_norm": layers.make_norm(cfg.d_model, cfg.norm, gen.device),
        "blocks": [[_make_block(gen, kind, cfg, dtype)
                    for _ in range(n_super)] for kind in pattern],
    }
    if cfg.is_hybrid:  # zamba2's single shared attention block
        params["shared_attn"] = _make_block(gen, "dense", cfg, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": layers.truncated_normal(
            gen, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, dtype)}
    if cfg.frontend:
        params["projector"] = frontends.make_projector(gen, cfg, dtype)
    return params


def embed_inputs(params: dict, tokens: Tensor, cfg: ModelConfig,
                 embeds: Optional[Tensor] = None) -> Tensor:
    """The token embeddings (B, S, D) in ACT_DTYPE, the projected modality
    prefix spliced over the first F positions when the config has a
    frontend and ``embeds`` (B, F, frontend_dim) is given."""
    x = layers.embed(params["embed"], tokens, ACT_DTYPE)
    if cfg.frontend and embeds is not None:
        prefix = frontends.apply_projector(params["projector"],
                                           embeds.to(ACT_DTYPE), cfg)
        x = frontends.splice_prefix(x, prefix)
    return x


def _final_logits(params: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return layers.unembed(head, x)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: Tensor
    aux: MoEAux
    caches: Any  # a DecodeState when return_caches, else None


def _ffn(p, kind: str, h: Tensor, cfg: ModelConfig
         ) -> tuple[Tensor, Optional[MoEAux]]:
    """The block's MLP, or its MoE layer and that layer's aux."""
    if kind == "moe":
        return moe.apply_moe(p["moe"], h, cfg)
    return layers.apply_mlp(p["mlp"], h, cfg.act), None


def _apply_block(p, kind: str, x: Tensor, cfg: ModelConfig,
                 positions: Tensor, *, use_kernel: bool
                 ) -> tuple[Tensor, Optional[MoEAux]]:
    """x after the block, and the block's MoE aux (None but for moe)."""
    if kind == "mamba1":
        h = layers.apply_norm(p["ln"], x, cfg.norm)
        return x + mamba.apply_mamba1(p["mixer"], h, cfg,
                                      use_kernel=use_kernel), None
    if kind == "mamba2":
        h = layers.apply_norm(p["ln"], x, cfg.norm)
        return x + mamba.apply_mamba2(p["mixer"], h, cfg), None
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    x = x + attention.self_attention(p["attn"], h, cfg, positions)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    h, aux = _ffn(p, kind, h, cfg)
    return x + h, aux


def _sum(terms) -> Tensor:
    """The terms added left to right, as the reference's carry adds them."""
    return functools.reduce(operator.add, terms)


# the matrix products "dots" keeps: products with no batch dims, as
# jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims keeps them
# (the model's 2-D weight products fold to mm; attention's batched
# products, bmm, and the flash kernel are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under the config's activation-checkpoint policy: "none" keeps
    every activation; "full" keeps only the super-block's inputs and
    recomputes the rest in the backward (non-reentrant
    `torch.utils.checkpoint`); "dots" keeps the outputs of the matrix
    products as well (a selective checkpoint).  Only while gradients are
    recorded: under no_grad there is nothing to keep.  Recomputing changes
    no number."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def forward(
    params: dict, tokens: Tensor, cfg: ModelConfig, *,
    embeds: Optional[Tensor] = None, use_kernel: bool = False,
    return_caches: bool = False, cache_len: Optional[int] = None,
) -> ForwardOut:
    """tokens: (B, S) int -> logits (B, S, V) f32, the MoE aux (zero for
    the kinds without experts; else lb and zl summed over the MoE layers,
    and the expert load summed over a super-block's MoE layers and
    averaged over the super-blocks, (E,)), and the prefilled caches when
    ``return_caches`` (a re-run through `prefill_caches`, as the
    reference does).

    ``use_kernel`` picks the mamba1 scan (B6 when L % chunk == 0, else B7;
    without it B7); the mamba2 scan is B7 either way; dense attention, the
    hybrid's shared block included, always goes through the flash entry
    point (B5 on the card, with its backward kernel under autograd).
    While gradients are recorded, each super-block runs under
    ``cfg.remat`` (`_remat_wrap`), as the reference's scan body does; the
    numbers do not change.  ``embeds`` (B, F, frontend_dim), for a config
    with a frontend, is projected and spliced over the first F token
    embeddings (`embed_inputs`)."""
    pattern, n_super = layer_pattern(cfg)
    b, s = tokens.shape
    dev = tokens.device
    x = embed_inputs(params, tokens, cfg, embeds)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)

    def super_block(x, i):
        auxes = []
        for j, kind in enumerate(pattern):
            x, aux = _apply_block(params["blocks"][j][i], kind, x, cfg,
                                  positions, use_kernel=use_kernel)
            if aux is not None:
                auxes.append(aux)
        if cfg.is_hybrid:
            x, _ = _apply_block(params["shared_attn"], "dense", x, cfg,
                                positions, use_kernel=use_kernel)
        return x, (MoEAux(*(_sum(f) for f in zip(*auxes))) if auxes
                   else None)

    body = _remat_wrap(super_block, cfg)
    per_super = []   # each super-block's MoE aux, its layers' summed
    for i in range(n_super):
        x, aux = body(x, i)
        if aux is not None:
            per_super.append(aux)
    logits = _final_logits(params, x, cfg)
    if per_super:   # the reference's carry: x + 0 is x, so no zero terms
        lb, zl, loads = zip(*per_super)
        aux = MoEAux(_sum(lb), _sum(zl), torch.stack(loads).mean(dim=0))
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        aux = MoEAux(zero, zero, torch.zeros((1,), dtype=torch.float32,
                                             device=dev))
    caches = (prefill_caches(params, tokens, cfg, cache_len or s,
                             embeds=embeds) if return_caches else None)
    return ForwardOut(logits=logits, aux=aux, caches=caches)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    """logits (B, S, V), labels (B, S) int, mask (B, S) {0, 1} -> the
    masked mean of -log softmax(logits)[label], in float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(
    params: dict, batch: dict, cfg: ModelConfig, *,
    use_kernel: bool = False, lb_coef: float = 0.01, z_coef: float = 1e-3,
) -> tuple[Tensor, dict]:
    """The next-token loss of ``batch`` ({tokens, labels, mask}) and its
    metrics {ce[, lb_loss, z_loss], loss}; a MoE decoder adds lb_coef x
    its load-balance loss and z_coef x its router z-loss, as the
    reference does.  A batch's ``embeds`` go to `forward`."""
    out = forward(params, batch["tokens"], cfg, embeds=batch.get("embeds"),
                  use_kernel=use_kernel)
    ce = cross_entropy(out.logits, batch["labels"], batch["mask"])
    loss = ce
    metrics = {"ce": ce}
    if cfg.is_moe:
        loss = loss + lb_coef * out.aux.load_balance_loss \
            + z_coef * out.aux.router_z_loss
        metrics["lb_loss"] = out.aux.load_balance_loss
        metrics["z_loss"] = out.aux.router_z_loss
    metrics["loss"] = loss
    return loss, metrics


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    """Stacked per-pattern-position caches + shared-block caches."""

    caches: list[Any]             # caches[j]: KVCache, Mamba1State or
    #                               Mamba2State, leaves (n_super, B, ...)
    shared_kv: Optional[KVCache]  # the hybrid's shared block, one entry
    #                               per application: (n_super, B, ...)
    length: Tensor                # (B,) tokens decoded so far


def _new_cache(kind: str, n_super: int, batch: int, max_len: int,
               cfg: ModelConfig, dev, length: Tensor):
    """Zeroed stacked caches of one pattern position (or of the shared
    block: kind "dense")."""
    if kind in _MAMBA:
        one = _MAMBA[kind].init(batch, cfg, ACT_DTYPE, dev)
        return type(one)(*(x.expand(n_super, *x.shape).clone() for x in one))
    shape = (n_super, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
                   v=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
                   length=length.expand(n_super, batch).clone())


def init_decode_state(batch: int, max_len: int, cfg: ModelConfig,
                      device: str | torch.device | None = None) -> DecodeState:
    pattern, n_super = layer_pattern(cfg)
    dev = resolve_device(device)
    if cfg.sliding_window is not None:  # ring cache: O(window) not O(context)
        max_len = min(max_len, cfg.sliding_window)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    caches = [_new_cache(kind, n_super, batch, max_len, cfg, dev, length)
              for kind in pattern]
    shared_kv = (_new_cache("dense", n_super, batch, max_len, cfg, dev,
                            length) if cfg.is_hybrid else None)
    return DecodeState(caches=caches, shared_kv=shared_kv, length=length)


def _layer_cache(cache, i: int):
    """Layer i's slice of a stacked cache (views of the stacked tensors)."""
    return type(cache)(*(leaf[i] for leaf in cache))


def _decode_block(p, kind: str, x: Tensor, cfg: ModelConfig, cache,
                  i: int) -> tuple[Tensor, Optional[Tensor]]:
    """One block's decode step on layer i of the stacked ``cache``, written
    in place; returns x and, for an attention block, its new lengths."""
    if kind in _MAMBA:
        h = layers.apply_norm(p["ln"], x, cfg.norm)
        h, st = _MAMBA[kind].decode(p["mixer"], h, cfg,
                                   _layer_cache(cache, i))
        cache.conv[i] = st.conv
        cache.ssm[i] = st.ssm
        return x + h, None
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    h, c = attention.self_attention_decode(p["attn"], h, cfg,
                                           _layer_cache(cache, i))
    x = x + h
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + _ffn(p, kind, h, cfg)[0], c.length


def _with_lengths(cache: KVCache, lengths: list) -> KVCache:
    return KVCache(k=cache.k, v=cache.v, length=torch.stack(lengths))


def decode_step(
    params: dict, token: Tensor, state: DecodeState, cfg: ModelConfig
) -> tuple[Tensor, DecodeState]:
    """token: (B, 1) int -> (logits (B, 1, V) f32, new state).

    Every slot advances, idle ones included, as in the reference.  The new
    token's K/V, and each mamba layer's new conv ring and SSM state, are
    written into ``state``'s cache tensors IN PLACE (the reference returns
    updated copies); the returned DecodeState holds the same cache tensors,
    the new per-layer lengths and length + 1."""
    pattern, n_super = layer_pattern(cfg)
    x = layers.embed(params["embed"], token, ACT_DTYPE)
    lengths = [[None] * n_super for _ in pattern]
    shared_lengths = [None] * n_super
    for i in range(n_super):
        for j, kind in enumerate(pattern):
            x, lengths[j][i] = _decode_block(params["blocks"][j][i], kind, x,
                                             cfg, state.caches[j], i)
        if cfg.is_hybrid:
            x, shared_lengths[i] = _decode_block(
                params["shared_attn"], "dense", x, cfg, state.shared_kv, i)
    caches = [c if kind in _MAMBA else _with_lengths(c, lengths[j])
              for j, (kind, c) in enumerate(zip(pattern, state.caches))]
    shared_kv = (_with_lengths(state.shared_kv, shared_lengths)
                 if cfg.is_hybrid else None)
    return _final_logits(params, x, cfg), DecodeState(
        caches=caches, shared_kv=shared_kv, length=state.length + 1)


def _prefill_block(p, kind: str, x: Tensor, cfg: ModelConfig,
                   positions: Tensor, cache, i: int) -> Tensor:
    """One block over the whole sequence, its final states or its K/V
    written into layer i of the stacked ``cache``."""
    if kind in _MAMBA:
        h = layers.apply_norm(p["ln"], x, cfg.norm)
        y, st = _MAMBA[kind].scan(p["mixer"], h, cfg)
        cache.conv[i] = st.conv
        cache.ssm[i] = st.ssm
        return x + y
    h = layers.apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = attention.qkv_project(p["attn"], h, cfg, positions)
    o = attention.attend(q, k, v, causal=True, window=cfg.sliding_window,
                         logit_cap=cfg.attn_logit_softcap)
    x = x + attention.out_project(o, p["attn"]["wo"])
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    s = k.shape[1]
    cache.k[i, :, :s] = k
    cache.v[i, :, :s] = v
    return x + _ffn(p, kind, h, cfg)[0]


def prefill_caches(
    params: dict, tokens: Tensor, cfg: ModelConfig, max_len: int,
    *, embeds: Optional[Tensor] = None,
) -> DecodeState:
    """Run the full sequence once and return a DecodeState holding its K/V
    (padded to ``max_len`` positions) or its final conv and SSM states.
    Attention goes through `attend`, so through the flash kernel (B5) on
    the card, the hybrid's shared block included (one launch per
    application); the mamba1 scan through `fused_chunked_scan_m1` and the
    mamba2 scan through `fused_chunked_scan_m2`, so through the fused
    kernel (B7): one launch per layer.  ``embeds`` as in `forward`."""
    pattern, n_super = layer_pattern(cfg)
    b, s = tokens.shape
    dev = tokens.device
    x = embed_inputs(params, tokens, cfg, embeds)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    caches = [_new_cache(kind, n_super, b, max_len, cfg, dev, lens)
              for kind in pattern]
    shared_kv = (_new_cache("dense", n_super, b, max_len, cfg, dev, lens)
                 if cfg.is_hybrid else None)
    for i in range(n_super):
        for j, kind in enumerate(pattern):
            x = _prefill_block(params["blocks"][j][i], kind, x, cfg,
                               positions, caches[j], i)
        if cfg.is_hybrid:
            x = _prefill_block(params["shared_attn"], "dense", x, cfg,
                               positions, shared_kv, i)
    return DecodeState(caches=caches, shared_kv=shared_kv, length=lens)
