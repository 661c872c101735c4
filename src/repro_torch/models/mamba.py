"""Selective state-space layers: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

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

Mamba2 (SSD) scans per head: one decay exp(dt * a_h) per (token, head)
for all of the head's hd x ds states.  `_mamba2_scan` always goes through
`fused_chunked_scan_m2` (the reference has no kernel branch for it): on a
CUDA tensor the fused kernel B7 with each head's dt and decay repeated over
the head's hd channels, one launch a layer at any L; on a CPU tensor the
reference's chunked body, its last chunk shorter where L is ragged (the
reference sends ragged L to `ref_scan`).  y sums over the states by
`fused.state_sum` there too.

Training: under autograd on the card both scans go through their
kernels' `torch.autograd.Function`s (`fused.MambaFusedScan`: B7 with tile
checkpoints, then B7-bwd's per-channel form; `ops.MambaChunkScan`: B6,
then B6-bwd); mamba2's scan goes through `fused.MambaSSDScan` (B7 over
`ssd_channels`' views with tile checkpoints, then B7-bwd's mamba2 form,
which returns the per-head ddt and da_h itself).  On the CPU autograd
differentiates the reference's chunked body.

Decode is a single-step state update (`apply_mamba1_decode`,
`apply_mamba2_decode`) carrying a conv ring buffer and the SSM state: the
SSM analogue of a KV cache.
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
        c_f = c_t.to(F32)[:, :, None, :]
        # in place unless autograd keeps hs for B6's backward
        y = scan_fused.state_sum(hs * c_f if hs.requires_grad
                                 else hs.mul_(c_f))
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
# Mamba2 / SSD (zamba2)
# --------------------------------------------------------------------------

def n_ssm_heads(cfg: ModelConfig) -> int:
    return cfg.d_inner // cfg.ssm_head_dim


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x + B + C (n_groups = 1)


def ssd_channels(dt: Tensor, xh: Tensor, a_h: Tensor, h0: Tensor):
    """The SSD scan's inputs as B7's per-channel ones: dt (B, L, nh) ->
    (B, L, nh * hd) and a_h (nh,) -> A (nh * hd, ds), each head's value
    repeated over its hd channels (channel h * hd + e, the layout of
    ``xh.reshape(B, L, nh * hd)``); xh and h0 (B, nh, hd, ds) as views of
    (B, L, nh * hd) and (B, nh * hd, ds) (`scan_fused.ssd_channels`)."""
    return scan_fused.ssd_channels(dt, xh, a_h, h0)


def fused_chunked_scan_m2(
    dt: Tensor,    # (B, L, nh) fp32
    xh: Tensor,    # (B, L, nh, hd)
    b_t: Tensor,   # (B, L, ds)
    c_t: Tensor,   # (B, L, ds)
    a_h: Tensor,   # (nh,) negative per-head decay
    h0: Tensor,    # (B, nh, hd, ds) fp32
    chunk: int,
) -> tuple[Tensor, Tensor]:
    """Memory-bounded Mamba2/SSD scan emitting y (B, L, nh, hd) and h_last.

    On CUDA tensors: B7 (`fused_mamba_scan`, from h0) over the nh * hd
    channels, channel h * hd + e taking head h's dt and its decay a_h[h] at
    every state, so that exp(dt * A), (dt * x) * B, the recurrence and
    sum_s h * C are the reference's per-head values element for element;
    one launch at any L.  Under grad (an input requiring one) the same B7
    launch asked for its tile checkpoints, inside `scan_fused.MambaSSDScan`,
    whose backward is B7-bwd's mamba2 form (ddt and da_h a head, from one
    decay a (t, head)).  On CPU tensors: the reference's body, a =
    exp(dt * a_h) per head and bx = dt * x * B built per chunk, an
    associative scan inside it and the C-projection folded in; where
    L % chunk != 0 the last chunk is shorter."""
    bsz, L, nh, hd = xh.shape
    ds = b_t.shape[-1]
    if dt.is_cuda:
        ins = (dt, xh, b_t, c_t, a_h, h0)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
            return scan_fused.fused_ssd_scan(dt, xh, b_t, c_t, a_h, h0)
        dt_d, xc, a_mat, h0_d = ssd_channels(dt, xh, a_h, h0)
        y, h_last = scan_fused.fused_mamba_scan(dt_d, xc, b_t, c_t, a_mat,
                                                h0=h0_d, chunk=chunk)
        return y.view(bsz, L, nh, hd), h_last.view(bsz, nh, hd, ds)
    h, ys = h0, []
    for t0 in range(0, L, chunk):
        dt_c = dt[:, t0:t0 + chunk]
        a = torch.exp(dt_c * a_h)[..., None, None]          # (B,C,nh,1,1)
        bx = (dt_c[..., None] * xh[:, t0:t0 + chunk].to(F32))[..., None] \
            * b_t[:, t0:t0 + chunk].to(F32)[:, :, None, None, :]
        pa, pb = _assoc_scan(a, bx)                         # (B,C,nh,hd,ds)
        hs = pa * h[:, None] + pb
        ys.append(scan_fused.state_sum(
            hs * c_t[:, t0:t0 + chunk].to(F32)[:, :, None, None, :]))
        h = hs[:, -1]
    return torch.cat(ys, 1), h


def make_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Random parameters on ``gen``'s device, the reference's init and leaf
    types: A = -(1 .. nh) per head, dt_bias = softplus^-1 of steps
    log-uniform in [1e-3, 1e-1]; dt_bias, a_log, d_skip and the norm's
    scale in float32, the rest in ``dtype``."""
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh, cd = n_ssm_heads(cfg), conv_dim(cfg)
    dev = gen.device
    u = torch.rand((nh,), generator=gen, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    inv_dt = dt_init + torch.log(-torch.expm1(-dt_init))  # softplus^-1
    return {
        # z | x | B | C | dt
        "in_proj": layers.dense_init(gen, d, (d, 2 * di + 2 * ds + nh),
                                     dtype),
        "conv_w": layers.truncated_normal(gen, (dc, cd), (1.0 / dc) ** 0.5,
                                          dtype),
        "conv_b": torch.zeros((cd,), dtype=dtype, device=dev),
        "dt_bias": inv_dt,
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=F32, device=dev)),
        "d_skip": torch.ones((nh,), dtype=F32, device=dev),
        "norm": layers.make_norm(di, "rmsnorm", dev),
        "out_proj": layers.dense_init(gen, di, (di, d), dtype),
    }


def _mamba2_split(p, x: Tensor, cfg: ModelConfig):
    """x (B, L, D) -> z (B, L, di), xbc (B, L, conv_dim), dt (B, L, nh)."""
    zxbcdt = layers.matmul(x, p["in_proj"])
    return torch.split(zxbcdt, [cfg.d_inner, conv_dim(cfg), n_ssm_heads(cfg)],
                       dim=-1)


def _mamba2_ssm_inputs(p, xbc: Tensor, dt_raw: Tensor, cfg: ModelConfig):
    """Returns (dt, xh, b_t, c_t, a_h); the decay is built in the scan."""
    di, ds = cfg.d_inner, cfg.ssm_state
    xr, b_t, c_t = torch.split(xbc, [di, ds, ds], dim=-1)
    xh = xr.unflatten(-1, (n_ssm_heads(cfg), cfg.ssm_head_dim))
    dt = _softplus(dt_raw.to(F32) + p["dt_bias"])               # (B, L, nh)
    a_h = -torch.exp(p["a_log"])                                # (nh,)
    return dt, xh, b_t, c_t, a_h


def apply_mamba2(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence Mamba2/SSD mixer. x: (B, L, D)."""
    y, _ = _mamba2_scan(p, x, cfg)
    return y


def _mamba2_scan(p, x: Tensor, cfg: ModelConfig
                 ) -> tuple[Tensor, "Mamba2State"]:
    nh, hd, ds = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt_raw = _mamba2_split(p, x, cfg)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xbc = layers.silu(xbc)
    dt, xh, b_t, c_t, a_h = _mamba2_ssm_inputs(p, xbc, dt_raw, cfg)
    bsz, L = x.shape[0], x.shape[1]
    h0 = torch.zeros((bsz, nh, hd, ds), dtype=F32, device=x.device)
    y, h_last = fused_chunked_scan_m2(dt, xh, b_t, c_t, a_h, h0,
                                      min(cfg.ssm_chunk, L))
    y = y + xh.to(F32) * p["d_skip"][:, None]
    y = y.reshape(bsz, L, cfg.d_inner)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y.to(x.dtype) * layers.silu(z)
    y = layers.apply_norm(p["norm"], y, "rmsnorm")
    out = layers.matmul(y, p["out_proj"])
    return out, Mamba2State(conv=conv_state, ssm=h_last)


class Mamba2State(NamedTuple):
    conv: Tensor  # (B, K-1, conv_dim)
    ssm: Tensor   # (B, nh, hd, ds) fp32


def init_mamba2_state(batch: int, cfg: ModelConfig, dtype,
                      device=None) -> Mamba2State:
    return Mamba2State(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, n_ssm_heads(cfg), cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=F32, device=device),
    )


def apply_mamba2_decode(p, x: Tensor, cfg: ModelConfig,
                        state: Mamba2State) -> tuple[Tensor, Mamba2State]:
    """x: (B, 1, D) — one-token state update."""
    z, xbc, dt_raw = _mamba2_split(p, x, cfg)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                    state.conv)
    xbc = layers.silu(xbc)
    dt, xh, b_t, c_t, a_h = _mamba2_ssm_inputs(p, xbc, dt_raw, cfg)
    a = torch.exp(dt[:, 0] * a_h)[..., None, None]            # (B,nh,1,1)
    bx = (dt[:, 0, :, None] * xh[:, 0].to(F32))[..., None] \
        * b_t[:, 0].to(F32)[:, None, None, :]
    h = a * state.ssm + bx                                    # (B,nh,hd,ds)
    y = torch.einsum("bhds,bs->bhd", h, c_t[:, 0].to(F32))
    y = y + xh[:, 0].to(F32) * p["d_skip"][:, None]
    y = y.reshape(x.shape[0], 1, cfg.d_inner).to(x.dtype) * layers.silu(z)
    y = layers.apply_norm(p["norm"], y, "rmsnorm")
    out = layers.matmul(y, p["out_proj"])
    return out, Mamba2State(conv=conv_state, ssm=h)
