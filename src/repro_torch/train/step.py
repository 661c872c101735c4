"""Train-step factories: the step VARIANTS the KF scheduler switches
between (the paper's pre-defined router configurations).

  variant 0 'balanced'      — one forward and backward over the batch;
  variant 1 'comm-priority' — on one card, the reference's single-pod form:
                              2-way microbatched gradient accumulation
                              (halves activation memory, the z1
                              'dramfull' signal) at unchanged math: the
                              microbatches' bf16 gradients summed in the
                              reference's order, then divided by 2.

Both variants produce the same optimizer update given the same gradients;
only the memory traffic pattern differs.  A step is a plain function
(state, batch) -> (state, metrics): PyTorch runs eagerly, so there is no
``jit_step``; `optimizer.update` writes the state in place.  The
reference's multi-pod variant (int8 + error-feedback gradient sync over a
`pod` axis) and its residual buckets need a mesh: on one card there is no
`pod` axis, so ``mesh`` and ``with_residuals`` raise, naming ROADMAP A9.
An encoder-decoder trains through `encdec.encdec_loss`.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch._util import map_tree, tree_leaves
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib

Tensor = torch.Tensor

BALANCED, COMM_PRIORITY = 0, 1
_A9 = ("ROADMAP queue A, A9: the multi-device paths; one card has no pod "
       "axis")


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.OptState


def make_loss_fn(cfg: ModelConfig, *, use_kernel: bool = False) -> Callable:
    """``use_kernel`` picks the mamba scan (`lm.forward`); an
    encoder-decoder has no scan, and its attention always goes through B5,
    so there it must stay False."""
    if cfg.is_encoder_decoder:
        if use_kernel:
            raise ValueError(f"{cfg.name}: use_kernel picks a mamba scan; "
                             f"an encoder-decoder has none")
        return functools.partial(encdec.encdec_loss, cfg=cfg)
    return functools.partial(lm.lm_loss, cfg=cfg, use_kernel=use_kernel)


def init_train_state(
    gen: torch.Generator, cfg: ModelConfig,
    opt_cfg: opt_lib.OptimizerConfig, *, with_residuals: bool = False,
) -> TrainState:
    """Random parameters from ``gen`` (on its device: `lm.make_lm`, or
    `encdec.make_encdec` for an encoder-decoder) and zero moments.  The
    reference also returns its sharding specs; the port has none."""
    if with_residuals:
        raise NotImplementedError(f"error-feedback residuals: {_A9}")
    make = encdec.make_encdec if cfg.is_encoder_decoder else lm.make_lm
    params = make(gen, cfg)
    return TrainState(params=params, opt=opt_lib.init(opt_cfg, params))


def value_and_grad(loss_fn, params: Any, batch: dict
                   ) -> tuple[dict, Any]:
    """(metrics, grads) of ``loss_fn(params, batch) -> (loss, metrics)``:
    the gradients a tree like ``params`` in each parameter's type, the
    metrics detached.  Every parameter must reach the loss through
    autograd: a leaf without a gradient (an output computed outside the
    graph, such as a kernel's written through ctypes) raises, naming the
    leaves, rather than training on zeros."""
    tracked = map_tree(lambda p: p.detach().requires_grad_(), params)
    named = list(tree_leaves(tracked))
    leaves = [leaf for _, leaf in named]
    with torch.enable_grad():
        loss, metrics = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    unused = ["/".join(map(str, path))
              for (path, _), g in zip(named, grads) if g is None]
    if unused:
        raise RuntimeError(f"no gradient reaches {len(unused)} parameter "
                           f"leaves: {unused}")
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    del loss, grads
    return ({k: v.detach() for k, v in metrics.items()},
            map_tree(lambda p: by_leaf[id(p)], tracked))


def _balanced_step(loss_fn, opt_cfg):
    def step(state: TrainState, batch: dict):
        metrics, grads = value_and_grad(loss_fn, state.params, batch)
        params, opt_state, opt_m = opt_lib.update(
            opt_cfg, state.opt, grads, state.params)
        return TrainState(params, opt_state), {**metrics, **opt_m}

    return step


def _comm_priority_singlepod_step(loss_fn, opt_cfg, n_micro: int = 2):
    def step(state: TrainState, batch: dict):
        gacc, lsum = None, None
        for m in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + v.shape[1:])[m] for k, v in batch.items()}
            metrics, grads = value_and_grad(loss_fn, state.params, mb)
            # the reference's carry starts at zeros: 0 + g is g
            gacc = grads if gacc is None else map_tree(torch.add, gacc,
                                                       grads)
            del grads
            lsum = (metrics["loss"] if lsum is None
                    else lsum + metrics["loss"])
        grads = map_tree(lambda g: g / n_micro, gacc)
        del gacc
        params, opt_state, opt_m = opt_lib.update(
            opt_cfg, state.opt, grads, state.params)
        loss = lsum / n_micro
        return TrainState(params, opt_state), {"loss": loss, "ce": loss,
                                               **opt_m}

    return step


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: opt_lib.OptimizerConfig,
    *,
    mesh: Optional[Any] = None,
    variant: int = BALANCED,
    use_kernel: bool = False,
):
    """Returns a step fn (state, batch) -> (state, metrics)."""
    if mesh is not None:
        raise NotImplementedError(f"a mesh (the multi-pod variant): {_A9}")
    loss_fn = make_loss_fn(cfg, use_kernel=use_kernel)
    if variant == BALANCED:
        return _balanced_step(loss_fn, opt_cfg)
    return _comm_priority_singlepod_step(loss_fn, opt_cfg)
