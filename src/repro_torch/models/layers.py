"""Parameter-dict building blocks: norms, embeddings, gated MLPs.

Params are nested dicts of tensors with the JAX package's names and
shapes.  Weights are stored in `cfg.param_dtype`, norms in float32.
Matrix products follow the reference's `matmul` (bf16 inputs, f32
accumulation, result cast back to the input type): on the CPU as an f32
product followed by the cast, which is what the reference computes; on the
card as a bf16 `torch.matmul`, which accumulates in f32 and rounds its
output once.  Norms run in f32 as there.  The activations are written op for op as
`jax.nn.silu` and `jax.nn.gelu` (tanh approximation) expand, each operation
rounding to the activation type, with the constants in that type: in bf16
that is what the reference computes, bitwise.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def truncated_normal(gen: torch.Generator, shape, scale, dtype) -> Tensor:
    """He-style init: an f32 draw from the standard normal truncated to
    [-2, 2], times ``scale``, then cast; on ``gen``'s device."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(scale).to(dtype)   # in place: one f32 copy at a time


def dense_init(gen: torch.Generator, in_dim: int, shape, dtype) -> Tensor:
    return truncated_normal(gen, shape, (1.0 / in_dim) ** 0.5, dtype)


def make_norm(d: int, kind: str, device, dtype=torch.float32) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p, x: Tensor, kind: str, eps: float = 1e-5) -> Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * rms * p["scale"]).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def matmul(x: Tensor, w: Tensor) -> Tensor:
    """x (..., K) @ w (K, N) with f32 accumulation, in x's type."""
    if x.is_cuda:
        return torch.matmul(x, w.to(x.dtype))
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------

def make_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "wi": dense_init(gen, d_model, (d_model, d_ff), dtype),   # gate
        "wg": dense_init(gen, d_model, (d_model, d_ff), dtype),   # up
        "wo": dense_init(gen, d_ff, (d_ff, d_model), dtype),
    }


def silu(x: Tensor) -> Tensor:
    """x * logistic(x), logistic as 1 / (1 + exp(-x)), one rounding per op."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: Tensor) -> Tensor:
    """The tanh approximation (jax.nn.gelu's default), one rounding per op,
    its constants rounded to x's type."""
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def apply_mlp(p, x: Tensor, act: str) -> Tensor:
    g = matmul(x, p["wi"])
    u = matmul(x, p["wg"])
    a = silu(g) if act == "silu" else gelu_tanh(g)
    return matmul(a * u, p["wo"])


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def make_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype) -> dict:
    return {"table": truncated_normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(p, tokens: Tensor, dtype) -> Tensor:
    """Rows of the table, as the reference's `jnp.take(table, tokens,
    axis=0)` gives them: an id in [0, vocab) takes its row, an id in
    [-vocab, 0) wraps to row vocab + id, and any other id gives a row of
    NaN (take's default "fill" mode).  No host sync: one gather at the
    clamped ids and one `torch.where`."""
    table = p["table"]
    n = table.shape[0]
    ids = torch.where(tokens < 0, tokens + n, tokens)
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)].to(dtype)
    return torch.where(inside[..., None], rows, float("nan"))


def unembed(p, x: Tensor) -> Tensor:
    """Logits in f32.  On the CPU an f32 product (the reference's
    f32-accumulated einsum); on the card a bf16 product, whose f32
    accumulator cuBLAS rounds to bf16 on output, then widened to f32."""
    table = p["table"]
    if x.is_cuda:
        return torch.matmul(x, table.to(x.dtype).T).to(torch.float32)
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).T)
