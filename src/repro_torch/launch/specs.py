"""Shape cells, abstract inputs and step builders for every (architecture x
input-shape) cell, on the meta device.

Shapes:
  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill step (fwd logits)
  decode_32k   seq 32,768  global_batch 128   -> serve step (1 new token,
                                                 KV/SSM cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve step; SSM/hybrid/SWA
                                                 archs only (sub-quadratic)

Applicability:
  * long_500k is skipped for pure full-attention archs;
  * seamless-m4t (enc-dec): train/prefill run the teacher-forced decoder
    over `seq` tokens with `frontend_len` encoder frames; decode shapes
    run its DECODER step (self-KV cache of seq_len + precomputed cross
    K/V), so its decode cells run.

The abstract builders return tensors on the meta device with the shapes
and dtypes `lm.make_lm` / `encdec.make_encdec` / `lm.init_decode_state`
give: nothing is allocated and nothing is drawn (a random op on a meta
tensor only sets its shape).  A step run on them executes nothing either,
which is what `launch.op_cost` counts.  `abstract_train_state` is the
one-card form of the reference's: the state alone, with no error-feedback
residuals and no spec tree.  `param_specs`, `decode_specs` and the spec
tree (the sharding rules) belong to the distributed slice and are not
here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

import repro_torch.configs as configs
from repro_torch.models import encdec, lm
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs with sub-quadratic long-context decode
LONG_CTX_ARCHS = ("h2o-danube-1.8b", "zamba2-2.7b", "falcon-mamba-7b")


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CTX_ARCHS
    return True


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in configs.ARCH_IDS for s in SHAPES]


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that the model
    builders, which allocate on ``gen.device``, build meta tensors."""

    @property
    def device(self) -> torch.device:
        return META


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, cell: ShapeCell) -> dict[str, Any]:
    """Abstract train/prefill batch for one cell."""
    b, s = cell.batch, cell.seq
    out = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
        "mask": _meta((b, s), torch.float32),
    }
    if cfg.frontend:
        out["embeds"] = _meta((b, cfg.frontend_len, cfg.frontend_dim),
                              torch.float32)
    return out


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree `make_lm` / `make_encdec` build, as meta
    tensors."""
    make = encdec.make_encdec if cfg.is_encoder_decoder else lm.make_lm
    return make(_MetaGenerator(), cfg)


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: opt_lib.OptimizerConfig
                         ) -> step_lib.TrainState:
    """The `TrainState` `train.step.init_train_state` builds (parameters
    and zero moments), as meta tensors.  The reference also returns the
    state's spec tree and may add residual buckets; on one card there is
    neither."""
    return step_lib.init_train_state(_MetaGenerator(), cfg, opt_cfg)


def abstract_decode_inputs(cfg: ModelConfig, cell: ShapeCell):
    """(token, state) meta tensors for the serve step at this cell."""
    b, s = cell.batch, cell.seq
    token = _meta((b, 1), torch.int32)
    if cfg.is_encoder_decoder:
        # cross K/V from a frontend_len encoder pass; self cache len s
        kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        cross = (cfg.n_layers, b, cfg.frontend_len, cfg.n_kv_heads,
                 cfg.head_dim)
        state = encdec.EncDecState(
            self_kv=KVCache(k=_meta(kv, lm.ACT_DTYPE),
                            v=_meta(kv, lm.ACT_DTYPE),
                            length=_meta((cfg.n_layers, b), torch.int32)),
            cross_k=_meta(cross, lm.ACT_DTYPE),
            cross_v=_meta(cross, lm.ACT_DTYPE),
            length=_meta((b,), torch.int32),
        )
        return token, state
    return token, lm.init_decode_state(b, s, cfg, device=META)


# --------------------------------------------------------------------------
# Step functions per cell kind
# --------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig) -> Callable:
    if cfg.is_encoder_decoder:
        def prefill(params, batch):
            return encdec.forward(params, batch["tokens"], batch["embeds"],
                                  cfg)
        return prefill

    def prefill(params, batch):
        return lm.forward(params, batch["tokens"], cfg,
                          embeds=batch.get("embeds")).logits

    return prefill


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, token, state) -> (logits, state); the port's decode step
    writes the caches of ``state`` in place."""
    if cfg.is_encoder_decoder:
        def serve(params, token, state):
            return encdec.decode_step(params, token, state, cfg)
        return serve

    def serve(params, token, state):
        return lm.decode_step(params, token, state, cfg)

    return serve


def default_opt_cfg(cfg: ModelConfig) -> opt_lib.OptimizerConfig:
    return opt_lib.OptimizerConfig(moment_dtype=cfg.optimizer_dtype)
