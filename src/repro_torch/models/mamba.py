"""Selective state-space layers: Mamba1 (falcon-mamba).

The reference (`repro.models.mamba`) evaluates the diagonal recurrence
h_t = a_t * h_{t-1} + b_t with a chunked associative scan: a loop over
chunks of `cfg.ssm_chunk` tokens carrying the (B, d_inner, d_state)
boundary state, an associative scan inside each chunk.  `ref_scan` is the
naive O(L) oracle.

Scan routing in `_mamba1_scan` (one path, forced by the platform):
  * ``use_kernel`` and L % chunk == 0: a and bx are built as (B, L, D, S)
    tensors and go through `kernels.mamba_scan.ops.mamba_chunk_scan` (the
    CUDA kernel B6 on a CUDA tensor), then the plain C-projection, which
    lies outside the kernel in the reference too;
  * every other case, ragged L included: `fused_chunked_scan_m1`, which on
    a CUDA tensor launches the fused kernel B7 (decay, input, scan and
    C-projection in one pass, any L) and on a CPU tensor runs the
    reference's chunked body, its last chunk shorter where L is ragged.
The reference sends ragged L to `ref_scan` over (B, L, D, S) tensors; the
port has no XLA to fuse that loop, so the serving scan goes through B7.

The C-projection y = sum_s h * C sums over the states in one order on
every path (`fused.state_sum`, B7's shuffle-tree order; the reference's
einsum leaves the order to XLA), so that on the card the B6 path and the
B7 path give the same bits.  With random weights, a deep Mamba1 stack
amplifies any last-bit difference: the scan carries a bf16 rounding flip
to every later token, and the layers above grow it.

Decode is a single-step state update (`apply_mamba1_decode`) carrying a
conv ring buffer and the SSM state: the SSM analogue of a KV cache.

Mamba2 (zamba2) is not in this slice: its functions raise
NotImplementedError naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.mamba_scan import fused as scan_fused
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
F32 = torch.float32
MAMBA2_LATER = "ROADMAP queue A 'mamba2 and zamba2's hybrid'"


# --------------------------------------------------------------------------
# Core diagonal-recurrence scans
# --------------------------------------------------------------------------

def _assoc_scan(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Inclusive scan of the pairs (a, b) along dim 1 under the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2): a doubling scan, log2(n)
    full-width steps (`lax.associative_scan` uses another tree, so the two
    round differently)."""
    n, shift = b.shape[1], 1
    while shift < n:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], 1)
        shift *= 2
    return a, b


def ref_scan(a: Tensor, b: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """Oracle: h_t = a_t h_{t-1} + b_t by a loop over time.

    a, b: (B, L, ...) broadcast-compatible; h0: (B, ...).
    Returns (hs (B, L, ...), h_final)."""
    h, hs = h0, []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


def chunked_scan(a: Tensor, b: Tensor, h0: Tensor,
                 chunk: int) -> tuple[Tensor, Tensor]:
    """Chunked associative scan; a, b: (B, L, ...) broadcast-compatible
    trailing dims, L % chunk == 0.  Materializes hs for the full L."""
    L = b.shape[1]
    if L % chunk:
        raise ValueError(f"chunked_scan needs L % chunk == 0 ({L}, {chunk})")
    h, hs = h0, []
    for t0 in range(0, L, chunk):
        pa, pb = _assoc_scan(a[:, t0:t0 + chunk], b[:, t0:t0 + chunk])
        hc = pa * h[:, None] + pb
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, 1), h


def fused_chunked_scan_m1(
    dt: Tensor,     # (B, L, di) fp32 — softplus'd step sizes
    xc: Tensor,     # (B, L, di) conv output (post-silu)
    b_t: Tensor,    # (B, L, ds)
    c_t: Tensor,    # (B, L, ds)
    a_mat: Tensor,  # (di, ds) negative decay matrix
    h0: Tensor,     # (B, di, ds) fp32
    chunk: int,
) -> tuple[Tensor, Tensor]:
    """Memory-bounded Mamba1 scan emitting y (B, L, di) and h_last.

    On CUDA tensors: the fused kernel B7 (`fused_mamba_scan`, from h0).  On
    CPU tensors: the reference's body, a = exp(dt*A) and bx = dt*x*B built
    per chunk, an associative scan inside it and the C-projection folded
    in.  Any L: where L % chunk != 0 the last chunk is shorter."""
    if dt.is_cuda:
        return scan_fused.fused_mamba_scan(dt, xc, b_t, c_t, a_mat, h0=h0,
                                           chunk=chunk)
    h, ys = h0, []
    for t0 in range(0, dt.shape[1], chunk):
        dt_c = dt[:, t0:t0 + chunk]
        a = torch.exp(dt_c[..., None] * a_mat)             # (B, C, di, ds)
        bx = (dt_c * xc[:, t0:t0 + chunk].to(F32))[..., None] \
            * b_t[:, t0:t0 + chunk].to(F32)[:, :, None, :]
        pa, pb = _assoc_scan(a, bx)
        hs = pa * h[:, None] + pb
        ys.append(scan_fused.state_sum(
            hs * c_t[:, t0:t0 + chunk].to(F32)[:, :, None, :]))
        h = hs[:, -1]
    return torch.cat(ys, 1), h


def causal_conv1d(x: Tensor, w: Tensor, bias: Tensor,
                  state: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv. x: (B, L, C); w: (K, C); state: (B, K-1, C).

    Returns (y (B, L, C), new_state (B, K-1, C)); every product and sum in
    x's type, as the reference's."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], 1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    y = y + bias.to(x.dtype)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _softplus(x: Tensor) -> Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
    Not `F.softplus`, whose threshold of 20 and formula round otherwise."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


# --------------------------------------------------------------------------
# Mamba1 (falcon-mamba-7b)
# --------------------------------------------------------------------------

def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def make_mamba1(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Random parameters on ``gen``'s device, the reference's init: S4D-real
    A, and dt_bias = softplus^-1 of steps log-uniform in [1e-3, 1e-1]."""
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    r = dt_rank(cfg)
    dev = gen.device
    a = torch.arange(1, ds + 1, dtype=F32, device=dev)[None, :].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    inv_dt = dt_init + torch.log(-torch.expm1(-dt_init))  # softplus^-1
    return {
        "in_proj": layers.dense_init(gen, d, (d, 2 * di), dtype),
        "conv_w": layers.truncated_normal(gen, (dc, di), (1.0 / dc) ** 0.5,
                                          dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": layers.dense_init(gen, di, (di, r + 2 * ds), dtype),
        "dt_proj": layers.truncated_normal(gen, (r, di), r ** -0.5, F32),
        "dt_bias": inv_dt,
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), dtype=F32, device=dev),
        "out_proj": layers.dense_init(gen, di, (di, d), dtype),
    }


def _mamba1_ssm_inputs(p, xc: Tensor, cfg: ModelConfig):
    """xc: conv output (B, L, di) -> (dt, b_t, c_t, a_mat)."""
    r, ds = dt_rank(cfg), cfg.ssm_state
    proj = layers.matmul(xc, p["x_proj"])
    dt_r, b_t, c_t = torch.split(proj, [r, ds, ds], dim=-1)
    dt = torch.einsum("blr,rd->bld", dt_r.to(F32), p["dt_proj"])
    dt = _softplus(dt + p["dt_bias"])                     # (B, L, di) fp32
    a_mat = -torch.exp(p["a_log"])                        # (di, ds)
    return dt, b_t, c_t, a_mat


def apply_mamba1(p, x: Tensor, cfg: ModelConfig, *,
                 use_kernel: bool = False) -> Tensor:
    """Full-sequence Mamba1 mixer. x: (B, L, D)."""
    y, _ = _mamba1_scan(p, x, cfg, use_kernel=use_kernel)
    return y


def _mamba1_scan(p, x: Tensor, cfg: ModelConfig, *,
                 use_kernel: bool = False) -> tuple[Tensor, "Mamba1State"]:
    di = cfg.d_inner
    xz = layers.matmul(x, p["in_proj"])
    xr, z = torch.split(xz, [di, di], dim=-1)
    xc, conv_state = causal_conv1d(xr, p["conv_w"], p["conv_b"])
    xc = layers.silu(xc)
    dt, b_t, c_t, a_mat = _mamba1_ssm_inputs(p, xc, cfg)
    h0 = torch.zeros((x.shape[0], di, cfg.ssm_state), dtype=F32,
                     device=x.device)
    L = x.shape[1]
    chunk = min(cfg.ssm_chunk, L)
    if use_kernel and L % chunk == 0:
        a = (dt[..., None] * a_mat).exp_()
        bx = (dt * xc.to(F32))[..., None] * b_t.to(F32)[:, :, None, :]
        hs, h_last = scan_ops.mamba_chunk_scan(a, bx, h0, chunk=chunk)
        del a, bx
        y = scan_fused.state_sum(hs.mul_(c_t.to(F32)[:, :, None, :]))
    else:
        y, h_last = fused_chunked_scan_m1(dt, xc, b_t, c_t, a_mat, h0, chunk)
    y = y + xc.to(F32) * p["d_skip"]
    y = y.to(x.dtype) * layers.silu(z)
    out = layers.matmul(y, p["out_proj"])
    return out, Mamba1State(conv=conv_state, ssm=h_last)


class Mamba1State(NamedTuple):
    conv: Tensor  # (B, K-1, di)
    ssm: Tensor   # (B, di, ds) fp32


def init_mamba1_state(batch: int, cfg: ModelConfig, dtype,
                      device=None) -> Mamba1State:
    return Mamba1State(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=F32,
                        device=device),
    )


def apply_mamba1_decode(p, x: Tensor, cfg: ModelConfig,
                        state: Mamba1State) -> tuple[Tensor, Mamba1State]:
    """x: (B, 1, D) — one-token state update (the SSM 'KV cache' step)."""
    di = cfg.d_inner
    xz = layers.matmul(x, p["in_proj"])
    xr, z = torch.split(xz, [di, di], dim=-1)
    xc, conv_state = causal_conv1d(xr, p["conv_w"], p["conv_b"], state.conv)
    xc = layers.silu(xc)
    dt, b_t, c_t, a_mat = _mamba1_ssm_inputs(p, xc, cfg)
    a = torch.exp(dt[:, 0, :, None] * a_mat)                # (B, di, ds)
    bx = (dt[:, 0] * xc[:, 0].to(F32))[..., None] \
        * b_t[:, 0].to(F32)[:, None, :]
    h = a * state.ssm + bx                                  # (B, di, ds)
    y = torch.einsum("bds,bs->bd", h, c_t[:, 0].to(F32))
    y = y + xc[:, 0].to(F32) * p["d_skip"]
    y = y[:, None].to(x.dtype) * layers.silu(z)
    out = layers.matmul(y, p["out_proj"])
    return out, Mamba1State(conv=conv_state, ssm=h)


# --------------------------------------------------------------------------
# Mamba2 / SSD (zamba2): not in this slice
# --------------------------------------------------------------------------

def _mamba2_later(*_args, **_kwargs):
    raise NotImplementedError(f"mamba2 is not ported yet ({MAMBA2_LATER})")


make_mamba2 = apply_mamba2 = apply_mamba2_decode = _mamba2_later
init_mamba2_state = fused_chunked_scan_m2 = _mamba2_later
