"""AdamW + global-norm clip + warmup-cosine schedule, on trees of tensors.

The reference's arithmetic op for op: the schedule and the bias
corrections are float32 tensors, the clip scale is applied in each
gradient's type, the moment update runs in float32 and the moments are
stored in `moment_dtype` (``cfg.optimizer_dtype``: bf16 for the 300B+ MoE
configs).

Weight decay.  The reference decays every leaf with ``p.ndim >= 2``
(`_decay_mask`), applied to ITS leaves, which stack each pattern
position's layers on a leading n_super axis: a block's norm scale
``blocks/j/ln1/scale`` is (n_super, D) there, so it IS decayed, while
``final_norm/scale`` (D,) is not.  The port keeps one leaf per layer, so
the same formula on the port's leaves would decay no norm at all; `decays`
mirrors the reference's set of decayed leaves instead: a leaf under
``blocks`` (an encoder-decoder's ``enc_blocks`` / ``dec_blocks``) counts
the stacked axis it has in the reference.  zamba2's
``shared_attn`` block is unstacked in both, so it follows its own shapes.

`update` writes the new parameters and moments into the given tensors IN
PLACE and returns them (the reference returns new arrays): at
llama3.2-3b that saves a second copy of the 38.6 GB training state on one
80 GB card.  Callers that need the old state keep a copy.

The global norm sums the squares leaf by leaf in the reference's
``jax.tree.leaves`` order (sorted keys, each stacked leaf's layers one
after another); the port's per-layer leaves split those sums, so the norm
agrees to rounding (tests hold 1e-6 relative).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._util import map_tree, tree_leaves

Tensor = torch.Tensor
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # float32 | bfloat16


class OptState(NamedTuple):
    step: Tensor   # () int32
    mu: Any        # first moments (a tree like params)
    nu: Any        # second moments


def _mdtype(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32


def init(cfg: OptimizerConfig, params: Any) -> OptState:
    dt = _mdtype(cfg)
    dev = next(leaf for _, leaf in tree_leaves(params)).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=map_tree(zeros, params), nu=map_tree(zeros, params))


def schedule(cfg: OptimizerConfig, step: Tensor) -> Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, a float32 scalar."""
    one = torch.ones((), dtype=F32, device=step.device)
    warm = torch.minimum(step.to(F32) / float(max(cfg.warmup_steps, 1)), one)
    t = torch.clamp(
        (step - cfg.warmup_steps).to(F32)
        / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# the subtrees the reference stacks over layers
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def ref_order(params: Any) -> list[tuple]:
    """The port's leaf paths in the reference's ``jax.tree.leaves`` order:
    sorted keys, and each stacked leaf's layers one after another where
    the reference holds them in one stacked leaf."""
    paths = [path for path, _ in tree_leaves(params)]

    def key(path):
        if path and path[0] == "blocks":   # (blocks, j, i, *keys)
            path = (path[0], path[1], *path[3:], path[2])
        elif path and path[0] in STACKED:  # (enc_blocks, i, *keys)
            path = (path[0], *path[2:], path[1])
        return tuple((isinstance(k, str), k) for k in path)

    return sorted(paths, key=key)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, Tensor]:
    by_path = dict(tree_leaves(grads))
    sq = [(g.to(F32) * g.to(F32)).sum()
          for g in (by_path[p] for p in ref_order(grads))]
    gn = torch.sqrt(sum(sq))
    one = torch.ones((), dtype=F32, device=gn.device)
    scale = torch.minimum(one, max_norm / (gn + 1e-9))
    return map_tree(lambda g: g * scale.to(g.dtype), grads), gn


def decays(path: tuple, p: Tensor) -> bool:
    """Whether the reference decays this leaf: ``ndim >= 2`` of its leaf,
    which has one more (stacked) axis under ``blocks`` (and an
    encoder-decoder's ``enc_blocks`` / ``dec_blocks``)."""
    return p.ndim + (1 if path and path[0] in STACKED else 0) >= 2


@torch.no_grad()
def update(
    cfg: OptimizerConfig, state: OptState, grads: Any, params: Any
) -> tuple[Any, OptState, dict]:
    """One AdamW step; writes params and the moments in place (module
    docstring) and returns (params, new OptState, {grad_norm, lr})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    mdt = _mdtype(cfg)
    # bias correction in fp32
    stepf = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device),
                          stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device),
                          stepf)
    # the four trees share one structure, so their leaves pair up in order
    for (path, p), (_, g), (_, mu), (_, nu) in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
            tree_leaves(state.nu)):
        g32 = g.to(F32)
        mu32 = b1 * mu.to(F32) + (1 - b1) * g32
        nu32 = b2 * nu.to(F32) + (1 - b2) * g32 * g32
        del g32
        delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if decays(path, p):
            delta = delta + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
        mu.copy_(mu32.to(mdt))
        nu.copy_(nu32.to(mdt))
    new_state = OptState(step=step, mu=state.mu, nu=state.nu)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
