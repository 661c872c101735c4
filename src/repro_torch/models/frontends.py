"""Modality frontend stubs: the learned projector and the prefix splice.

The ViT and speech encoders themselves are out of scope, as in the JAX
package: a caller supplies *precomputed* patch or frame embeddings,
(batch, frontend_len, frontend_dim).  What is part of the backbone is the
projector that maps them into the model's embedding space (internvl2: a
layernorm and a 2-layer GELU MLP; seamless: one linear frame projector).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def make_projector(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Random projector weights from ``gen`` on its device (biases zero)."""
    fd, d = cfg.frontend_dim, cfg.d_model
    dev = gen.device
    if cfg.frontend == "vision":  # internvl2: norm + 2-layer GELU MLP
        return {
            "norm": layers.make_norm(fd, "layernorm", dev),
            "w1": layers.dense_init(gen, fd, (fd, d), dtype),
            "b1": torch.zeros((d,), dtype=dtype, device=dev),
            "w2": layers.dense_init(gen, d, (d, d), dtype),
            "b2": torch.zeros((d,), dtype=dtype, device=dev),
        }
    # audio (seamless): one linear projection of the fbank-frame features
    return {
        "w1": layers.dense_init(gen, fd, (fd, d), dtype),
        "b1": torch.zeros((d,), dtype=dtype, device=dev),
    }


def apply_projector(p, embeds: Tensor, cfg: ModelConfig) -> Tensor:
    """embeds: (B, F, frontend_dim) -> (B, F, d_model) in embeds' type.
    The vision MLP's GELU is the tanh form (`jax.nn.gelu`'s default),
    expanded op by op as the reference computes it (`layers.gelu_tanh`)."""
    x = embeds
    if cfg.frontend == "vision":
        x = layers.apply_norm(p["norm"], x, "layernorm")
        x = layers.matmul(x, p["w1"]) + p["b1"].to(x.dtype)
        x = layers.gelu_tanh(x)
        return layers.matmul(x, p["w2"]) + p["b2"].to(x.dtype)
    return layers.matmul(x, p["w1"]) + p["b1"].to(x.dtype)


def splice_prefix(token_embeds: Tensor, prefix: Tensor) -> Tensor:
    """The token embedding stream with its first F positions replaced by
    the projected modality prefix (B, F, D)."""
    f = prefix.shape[1]
    return torch.cat([prefix, token_embeds[:, f:]], dim=1)
