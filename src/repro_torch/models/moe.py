"""Mixture-of-Experts layer: top-k router and capacity-bounded dispatch.

Covers the two MoE archs:
  * llama4-maverick — 128 experts, top-1, + 1 shared expert, MoE every
    second layer
  * grok-1          — 8 experts, top-2

The reference's semantics, kept exactly: an f32 router, top-k on the
softmax probabilities (the lower expert index first among equal values,
as `jax.lax.top_k` orders them), the gates renormalized when k > 1, and
capacity positions assigned slot-major (every token's first choice before
any second choice); a route at or past the capacity gets gate 0 and is
dropped.  Tokens are dispatched in groups (`n_groups`); several groups run
as one batch over a leading axis, as the reference's `vmap` does.

The reference dispatches and combines with dense one-hot tensors of
(E, cap + 1, Tg).  The port uses the index form of the same function:
each kept route copies its token's row into its (expert, position) slot
(each slot holds at most one token, so the copy is exact), and the gated
expert rows are added back to their tokens in f32 (a token sums at most k
non-zero terms, so the order of the adds does not change the sum), with
the gates cast to the activation type first, as the reference's combine
casts them.  Empty slots stay zero, and an expert maps zero rows to zero.

The expert products follow `layers.matmul`'s dtype rule: on the card one
batched bf16 product over the experts (f32 accumulation); on the CPU an
f32 product per expert that holds a token, so that the host never holds
an f32 copy of all the experts' weights.
No Pallas kernel computes this layer in the reference, so none does here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

DEFAULT_GROUP_TOKENS = 4096


class MoEAux(NamedTuple):
    """The reference's MoE auxiliary outputs."""

    load_balance_loss: Tensor
    router_z_loss: Tensor
    expert_load: Tensor  # (E,) fraction of tokens routed per expert


class Routes(NamedTuple):
    """The routing of a batch of G dispatch groups of Tg tokens; the route
    arrays are slot-major, (G, k * Tg): route r is token r % Tg's choice
    r // Tg."""

    probs: Tensor    # (G, Tg, E) f32 router probabilities
    expert: Tensor   # (G, k*Tg) int64 chosen expert
    gate: Tensor     # (G, k*Tg) f32 gate, 0 where dropped
    pos: Tensor      # (G, k*Tg) int64 capacity position, cap where dropped
    keep: Tensor     # (G, k*Tg) bool


def make_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": layers.dense_init(gen, d, (d, e), torch.float32),
        "wi": layers.dense_init(gen, d, (e, d, f), dtype),
        "wg": layers.dense_init(gen, d, (e, d, f), dtype),
        "wo": layers.dense_init(gen, f, (e, f, d), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.make_mlp(gen, d, f * cfg.n_shared_experts,
                                      dtype)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.n_experts_active * cfg.capacity_factor
              / cfg.n_experts)
    return max(cap, 1)


def n_groups(t: int, cfg: ModelConfig) -> int:
    """GShard-style dispatch groups of ~DEFAULT_GROUP_TOKENS tokens (the
    reference's count; it bounds the one-hot dispatch's quadratic cost
    there), or ``cfg.moe_groups``; lowered until it divides t."""
    if cfg.moe_groups > 0:
        g = cfg.moe_groups
    else:
        g = max(t // DEFAULT_GROUP_TOKENS, 1)
    while t % g:
        g -= 1
    return g


def _logsumexp(x: Tensor) -> Tensor:
    """`jax.nn.logsumexp` over the last axis, as it expands: the max (0
    where it is not finite) plus log of the sum of exp(x - max)."""
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def _route(p, xg: Tensor, cfg: ModelConfig, cap: int
           ) -> tuple[Routes, Tensor, Tensor, Tensor]:
    """Routes of xg (G, Tg, D), and the aux terms per group: f_e (G, E),
    lb (G,), zl (G,)."""
    e, k = cfg.n_experts, cfg.n_experts_active
    g, t, _ = xg.shape
    # the router in f32 (TF32 must stay off on the card)
    logits = torch.matmul(xg.to(torch.float32), p["router"])     # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with the lower index first among equal values (jax.lax.top_k's
    # order; torch.topk promises none)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    if k > 1:  # renormalize the top-k gates (grok-1 style)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux: E * sum_e(f_e * p_e), and the router z-loss
    onehot = torch.nn.functional.one_hot(expert_idx, e).to(torch.float32)
    f_e = onehot.sum(dim=2).mean(dim=1)                          # (G, E)
    p_e = probs.mean(dim=1)
    lb = e * (f_e * p_e).sum(dim=-1)
    zl = (_logsumexp(logits) ** 2).mean(dim=-1)

    # capacity positions, slot-major: every first choice before any second
    flat_e = expert_idx.transpose(1, 2).reshape(g, k * t)
    flat_g = gate_vals.transpose(1, 2).reshape(g, k * t)
    oh = torch.nn.functional.one_hot(flat_e, e)                  # (G, kTg, E)
    pos = oh.cumsum(dim=1).gather(2, flat_e[..., None])[..., 0] - 1
    keep = pos < cap
    routes = Routes(probs=probs, expert=flat_e,
                    gate=torch.where(keep, flat_g, 0.0),
                    pos=torch.where(keep, pos, cap), keep=keep)
    return routes, f_e, lb, zl


def _slots(r: Routes, cap: int) -> Tensor:
    """(G * k * Tg,): each route's row in the expert-major slot buffer
    (E, G * cap, D) seen flat (expert, then group, then position), and
    E * G * cap, one row past the end, where the route is dropped."""
    g, e = r.expert.shape[0], r.probs.shape[-1]
    grp = torch.arange(g, device=r.expert.device)[:, None]
    row = (r.expert * g + grp) * cap + r.pos
    return torch.where(r.keep, row, e * g * cap).reshape(-1)


def _tokens(r: Routes) -> Tensor:
    """(G * k * Tg,): each route's token, as a row of the (G * Tg, D)
    tokens."""
    g, t = r.probs.shape[:2]
    k = r.expert.shape[1] // t
    dev = r.expert.device
    return (torch.arange(g, device=dev)[:, None] * t
            + torch.arange(t, device=dev).repeat(k)[None, :]).reshape(-1)


def _dispatch(xg: Tensor, slots: Tensor, tokens: Tensor, e: int,
              cap: int) -> Tensor:
    """(G, Tg, D) -> the experts' inputs (E, G * cap, D): each kept
    route's token row in its slot, every other slot zero."""
    g, t, d = xg.shape
    buf = torch.zeros((e * g * cap + 1, d), dtype=xg.dtype, device=xg.device)
    # dropped routes all land on the last row, which is cut off
    buf[slots] = xg.reshape(g * t, d)[tokens]
    return buf[:-1].view(e, g * cap, d)


def _experts(p, xe: Tensor, cfg: ModelConfig, r: Routes) -> Tensor:
    """The expert MLPs on their slots: xe (E, M, D) -> (E, M, D) in xe's
    type.  On the CPU only the experts that hold a kept route of ``r`` are
    computed (every slot of the others is empty, so zero); on the meta
    device, where no route can be read, every expert is, as on the card."""
    act = layers.silu if cfg.act == "silu" else layers.gelu_tanh

    def mlp(x, wi, wg, wo):
        return layers.matmul(act(layers.matmul(x, wi))
                             * layers.matmul(x, wg), wo)

    if xe.is_cuda or xe.is_meta:
        return mlp(xe, p["wi"], p["wg"], p["wo"])
    out = torch.zeros_like(xe)
    for i in r.expert[r.keep].unique().tolist():
        out[i] = mlp(xe[i], p["wi"][i], p["wg"][i], p["wo"][i])
    return out


def _combine(ye: Tensor, gate: Tensor, slots: Tensor, tokens: Tensor,
             shape) -> Tensor:
    """The experts' outputs (E, M, D) -> ``shape`` (G, Tg, D): each
    token's gated rows summed in f32, the gates cast to ye's type first,
    the sum rounded to ye's type once.  A dropped route (gate 0, its slot
    past the end) reads the last row."""
    d = ye.shape[-1]
    flat = ye.reshape(-1, d)
    rows = slots.clamp(max=flat.shape[0] - 1)
    gate = gate.to(ye.dtype).to(torch.float32).reshape(-1, 1)
    out = torch.zeros((shape[0] * shape[1], d), dtype=torch.float32,
                      device=ye.device)
    out.index_add_(0, tokens, gate * flat[rows].to(torch.float32))
    return out.to(ye.dtype).view(shape)


def _moe_group(p, xg: Tensor, cfg: ModelConfig
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Capacity-bounded top-k dispatch within each of G token groups, as
    one batch: xg (G, Tg, D) -> (out (G, Tg, D), f_e (G, E), lb (G,),
    zl (G,))."""
    cap = _capacity(xg.shape[1], cfg)
    r, f_e, lb, zl = _route(p, xg, cfg, cap)
    slots, tokens = _slots(r, cap), _tokens(r)
    xe = _dispatch(xg, slots, tokens, cfg.n_experts, cap)
    ye = _experts(p, xe, cfg, r)
    return _combine(ye, r.gate, slots, tokens, xg.shape), f_e, lb, zl


def apply_moe(p, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, MoEAux]:
    """x: (B, S, D) -> (B, S, D) + aux losses (grouped dispatch); with more
    than one group, f_e, lb and zl are their means over the groups."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    g = n_groups(t, cfg)
    out, f_e, lb, zl = _moe_group(p, xt.reshape(g, t // g, d), cfg)
    out = out.reshape(t, d)
    if g == 1:
        f_e, lb, zl = f_e[0], lb[0], zl[0]
    else:
        f_e, lb, zl = f_e.mean(dim=0), lb.mean(), zl.mean()
    if cfg.n_shared_experts:
        out = out + layers.apply_mlp(p["shared"], xt, cfg.act)
    aux = MoEAux(load_balance_loss=lb, router_z_loss=zl, expert_load=f_e)
    return out.reshape(b, s, d), aux
