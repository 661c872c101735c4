"""Port congruence: the scans' gradients (B6-bwd and B7-bwd's plain
versions, and the autograd Functions that route to them) against the JAX
package's, on the same numpy inputs.

The JAX package differentiates its scans with XLA's autodiff of jnp; its
Pallas B6 has no VJP, so B6's plain backward is held against `jax.vjp` of
`chunked_scan` (the same function), and B7's against `jax.vjp` of
`fused_chunked_scan_m1` and `fused_chunked_scan_m2` (the latter also
through B7-bwd's mamba2 form's plain version, `fused_ssd_scan_plain_bwd`).

Tolerances and why:
  * against JAX: relative L2 1e-5 per gradient in float32.  JAX's forward
    is a doubling scan inside each chunk and its sums run in XLA's order,
    so the two round differently (~2e-7 here), not more.
  * B7's plain backward against torch autograd of `fused_mamba_scan_plain`:
    relative L2 1e-5 (dB, dC, dA sum in another order; ~1e-7 here).
  * B6's plain backward against autograd of `scan_ref`: bitwise (the same
    products and sums, one rounding each, in the same order).
  * the mamba2 plain backward against torch autograd through
    `ssd_channels`: relative L2 1e-5 (the head sums run in another order).
  * `MambaFusedScan` / `MambaSSDScan` / `MambaChunkScan` wiring on CPU
    tensors: bitwise the plain backward (the Function runs it).
The kernels run only on the card: tests/test_torch_cuda.py holds them
against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro_torch.kernels.mamba_scan import fused as tfused
from repro_torch.kernels.mamba_scan import ops as tops
from repro_torch.kernels.mamba_scan import ref as tref
from repro_torch.models import mamba as tmamba

REL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _fused_inputs(B, L, D, S, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        dt=rng.uniform(0.001, 0.1, (B, L, D)).astype(f),
        xc=rng.normal(size=(B, L, D)).astype(f),
        b=rng.normal(size=(B, L, S)).astype(f),
        c=rng.normal(size=(B, L, S)).astype(f),
        a_mat=(-np.exp(rng.normal(size=(D, S)) * 0.3)).astype(f),
        h0=rng.normal(size=(B, D, S)).astype(f),
        gy=rng.normal(size=(B, L, D)).astype(f),
        ghl=rng.normal(size=(B, D, S)).astype(f))


M1_SHAPES = [(2, 32, 12, 8, 8), (1, 48, 20, 16, 16), (2, 16, 8, 16, 16)]


@pytest.mark.parametrize("B,L,D,S,chunk", M1_SHAPES)
def test_fused_plain_bwd_matches_jax_vjp_m1(B, L, D, S, chunk):
    x = _fused_inputs(B, L, D, S, seed=L + S)
    ins = [x[k] for k in ("dt", "xc", "b", "c", "a_mat", "h0")]
    _, vjp = jax.vjp(
        lambda *a: jmamba.fused_chunked_scan_m1(*a, chunk),
        *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(x["gy"]), jnp.asarray(x["ghl"])))
    got = tfused.fused_mamba_scan_plain_bwd(*_t(*ins, x["gy"], x["ghl"]))
    for name, g, w in zip(("dt", "xc", "b", "c", "a_mat", "h0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= REL, (name, _rel(g, w))


M2_SHAPES = [(2, 16, 3, 4, 8, 8), (1, 24, 2, 8, 16, 8)]


@pytest.mark.parametrize("B,L,nh,hd,S,chunk", M2_SHAPES)
def test_fused_bwd_through_ssd_channels_matches_jax_vjp_m2(
        B, L, nh, hd, S, chunk):
    """Mamba2: each head's dt and decay repeated over its hd channels by
    `ssd_channels` (torch ops outside the Function), so autograd sums the
    channels' gradients back into the head."""
    rng = np.random.default_rng(100 + L)
    f = np.float32
    dt = rng.uniform(0.001, 0.1, (B, L, nh)).astype(f)
    xh = rng.normal(size=(B, L, nh, hd)).astype(f)
    b, c = (rng.normal(size=(B, L, S)).astype(f) for _ in range(2))
    a_h = -np.arange(1, nh + 1, dtype=f)
    h0 = rng.normal(size=(B, nh, hd, S)).astype(f)
    gy = rng.normal(size=(B, L, nh, hd)).astype(f)
    ghl = rng.normal(size=(B, nh, hd, S)).astype(f)
    ins = (dt, xh, b, c, a_h, h0)
    _, vjp = jax.vjp(
        lambda *a: jmamba.fused_chunked_scan_m2(*a, chunk),
        *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(ghl)))
    leaves = [t.requires_grad_() for t in _t(*ins)]
    dt_d, xc, a_mat, h0_d = tmamba.ssd_channels(leaves[0], leaves[1],
                                                leaves[4], leaves[5])
    y, hl = tfused.fused_mamba_scan(dt_d, xc, leaves[2], leaves[3], a_mat,
                                    h0=h0_d)
    got = torch.autograd.grad(
        (y, hl), leaves, (torch.from_numpy(gy).reshape(y.shape),
                          torch.from_numpy(ghl).reshape(hl.shape)))
    for name, g, w in zip(("dt", "xh", "b", "c", "a_h", "h0"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= REL, (name, _rel(g, w))


def _ssd_inputs(B, L, nh, hd, S, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        dt=rng.uniform(0.001, 0.1, (B, L, nh)).astype(f),
        xh=rng.normal(size=(B, L, nh, hd)).astype(f),
        b=rng.normal(size=(B, L, S)).astype(f),
        c=rng.normal(size=(B, L, S)).astype(f),
        a_h=-np.arange(1, nh + 1, dtype=f),
        h0=rng.normal(size=(B, nh, hd, S)).astype(f),
        gy=rng.normal(size=(B, L, nh, hd)).astype(f),
        ghl=rng.normal(size=(B, nh, hd, S)).astype(f))


SSD_NAMES = ("dt", "xh", "b", "c", "a_h", "h0")
# (B, L, nh, hd, S, chunk): hd 32 sums two chunks of 16 channels a head
SSD_SHAPES = [(2, 16, 3, 4, 8, 8), (1, 24, 2, 32, 16, 8),
              (2, 20, 2, 8, 16, 4)]


@pytest.mark.parametrize("B,L,nh,hd,S,chunk", SSD_SHAPES)
def test_ssd_plain_bwd_matches_jax_vjp_m2(B, L, nh, hd, S, chunk):
    """B7-bwd's mamba2 form's plain version (ddt and da_h a head, from one
    decay a (t, head)) against `jax.vjp` of `fused_chunked_scan_m2`."""
    x = _ssd_inputs(B, L, nh, hd, S, seed=200 + L + hd)
    ins = [x[k] for k in SSD_NAMES]
    _, vjp = jax.vjp(
        lambda *a: jmamba.fused_chunked_scan_m2(*a, chunk),
        *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(x["gy"]), jnp.asarray(x["ghl"])))
    got = tfused.fused_ssd_scan_plain_bwd(*_t(*ins, x["gy"], x["ghl"]))
    for name, g, w in zip(SSD_NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= REL, (name, _rel(g, w))


@pytest.mark.parametrize("B,L,nh,hd,S,with_ghl",
                         [(2, 13, 3, 4, 8, True), (1, 9, 2, 32, 64, False)])
def test_ssd_plain_bwd_matches_autograd_through_ssd_channels(
        B, L, nh, hd, S, with_ghl):
    """The mamba2 plain backward against torch autograd of B7's plain
    forward over `ssd_channels` (autograd sums each head's channels back
    into the head in its own order): relative L2 1e-5."""
    x = _ssd_inputs(B, L, nh, hd, S, seed=300 + L)
    leaves = [t.requires_grad_() for t in _t(*(x[k] for k in SSD_NAMES))]
    dt_d, xc, a_mat, h0_d = tmamba.ssd_channels(leaves[0], leaves[1],
                                                leaves[4], leaves[5])
    y, hl = tfused.fused_mamba_scan_plain(dt_d, xc, leaves[2], leaves[3],
                                          a_mat, h0_d)
    gy, ghl = _t(x["gy"], x["ghl"])
    outs = (y, hl) if with_ghl else (y,)
    grads = ((gy.reshape(y.shape), ghl.reshape(hl.shape)) if with_ghl
             else (gy.reshape(y.shape),))
    want = torch.autograd.grad(outs, leaves, grads)
    got = tfused.fused_ssd_scan_plain_bwd(
        *[t.detach() for t in leaves], gy, ghl if with_ghl else None)
    for name, g, w in zip(SSD_NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g.detach(), w) <= REL, (name, _rel(g.detach(), w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_on_cpu_returns_the_plain_backward(dtype):
    """`MambaSSDScan` on CPU tensors runs B7's plain forward over
    `ssd_channels` (y and h_last the bits `fused_mamba_scan` gives there)
    and `fused_ssd_scan_plain_bwd`: the gradients bitwise, in the inputs'
    types; without h0 its gradient is not asked for."""
    x = _ssd_inputs(2, 17, 2, 8, 16, seed=7)
    dt, a_h, h0 = _t(x["dt"], x["a_h"], x["h0"])
    xh, b, c = (t.to(dtype) for t in _t(x["xh"], x["b"], x["c"]))
    gy, ghl = _t(x["gy"], x["ghl"])
    leaves = [t.clone().requires_grad_() for t in (dt, xh, b, c, a_h, h0)]
    y, hl = tfused.fused_ssd_scan(*leaves)
    assert "MambaSSDScan" in type(y.grad_fn).__name__
    dt_d, xc, a_mat, h0_d = tmamba.ssd_channels(dt, xh, a_h, h0)
    y0, hl0 = tfused.fused_mamba_scan(dt_d, xc, b, c, a_mat, h0=h0_d)
    assert torch.equal(y.detach(), y0.view(y.shape))
    assert torch.equal(hl.detach(), hl0.view(hl.shape))
    got = torch.autograd.grad((y, hl), leaves, (gy, ghl))
    want = tfused.fused_ssd_scan_plain_bwd(dt, xh, b, c, a_h, h0, gy, ghl)
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype and torch.equal(g, w)
    leaves = [t.clone().requires_grad_() for t in (dt, xh, b, c, a_h)]
    y, _ = tfused.fused_ssd_scan(*leaves)
    got = torch.autograd.grad(y, leaves, gy)
    want = tfused.fused_ssd_scan_plain_bwd(dt, xh, b, c, a_h, None, gy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


PLAIN_SHAPES = [(2, 19, 10, 8, False, False), (1, 33, 6, 16, True, True),
                (2, 9, 5, 64, True, False)]


@pytest.mark.parametrize("B,L,D,S,with_h0,with_ghl", PLAIN_SHAPES)
def test_fused_plain_bwd_matches_autograd(B, L, D, S, with_h0, with_ghl):
    x = _fused_inputs(B, L, D, S, seed=3 * L + S)
    names = ("dt", "xc", "b", "c", "a_mat") + (("h0",) if with_h0 else ())
    leaves = [t.requires_grad_() for t in _t(*(x[k] for k in names))]
    h0 = leaves[5] if with_h0 else None
    y, hl = tfused.fused_mamba_scan_plain(*leaves[:5], h0)
    gy, ghl = _t(x["gy"], x["ghl"])
    outs, grads = ((y, hl), (gy, ghl)) if with_ghl else ((y,), (gy,))
    want = torch.autograd.grad(outs, leaves, grads)
    got = tfused.fused_mamba_scan_plain_bwd(
        *[t.detach() for t in leaves[:5]],
        None if h0 is None else h0.detach(), gy, ghl if with_ghl else None)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g.detach(), w) <= REL, (name, _rel(g.detach(), w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_function_on_cpu_returns_the_plain_backward(dtype):
    """`fused_mamba_scan` under grad goes through `MambaFusedScan`, which
    on CPU tensors runs the plain forward and the plain backward; without
    grad it returns the plain forward alone, the same bits.  The gradients
    come back in the inputs' types."""
    x = _fused_inputs(2, 21, 7, 16, seed=5)
    dt, a_mat, h0 = _t(x["dt"], x["a_mat"], x["h0"])
    xc, b, c = (t.to(dtype) for t in _t(x["xc"], x["b"], x["c"]))
    gy, ghl = _t(x["gy"], x["ghl"])
    want = tfused.fused_mamba_scan_plain_bwd(dt, xc, b, c, a_mat, h0, gy,
                                             ghl)
    leaves = [t.clone().requires_grad_() for t in (dt, xc, b, c, a_mat, h0)]
    y, hl = tfused.fused_mamba_scan(*leaves[:5], h0=leaves[5])
    assert y.grad_fn is not None and "MambaFusedScan" in type(
        y.grad_fn).__name__
    with torch.no_grad():
        y0, hl0 = tfused.fused_mamba_scan(*leaves[:5], h0=leaves[5])
    assert torch.equal(y.detach(), y0) and torch.equal(hl.detach(), hl0)
    got = torch.autograd.grad((y, hl), leaves, (gy, ghl))
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype and torch.equal(g, w)
    # no h0: its gradient is not asked for; h_last unused: g_hlast is zero
    leaves = [t.clone().requires_grad_() for t in (dt, xc, b, c, a_mat)]
    y, _ = tfused.fused_mamba_scan(*leaves)
    got = torch.autograd.grad(y, leaves, gy)
    want = tfused.fused_mamba_scan_plain_bwd(dt, xc, b, c, a_mat, None, gy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


SCAN_SHAPES = [(2, 32, 6, 8, 8), (1, 64, 4, 16, 16), (2, 24, 3, 4, 8)]


@pytest.mark.parametrize("B,L,D,S,chunk", SCAN_SHAPES)
def test_scan_plain_bwd_matches_jax_vjp_and_autograd(B, L, D, S, chunk):
    rng = np.random.default_rng(L + D)
    f = np.float32
    a = rng.uniform(0.5, 0.999, (B, L, D, S)).astype(f)
    bb = (rng.normal(size=(B, L, D, S)) * 0.1).astype(f)
    h0 = rng.normal(size=(B, D, S)).astype(f)
    g_hs = rng.normal(size=(B, L, D, S)).astype(f)
    ghl = rng.normal(size=(B, D, S)).astype(f)
    _, vjp = jax.vjp(lambda *x: jmamba.chunked_scan(*x, chunk),
                     *map(jnp.asarray, (a, bb, h0)))
    want = vjp((jnp.asarray(g_hs), jnp.asarray(ghl)))
    ta, tb, th0, tg, tghl = _t(a, bb, h0, g_hs, ghl)
    hs, _ = tref.scan_ref(ta, tb, th0)
    got = tref.scan_ref_bwd(ta, hs, th0, tg, tghl)
    for name, g, w in zip(("a", "b", "h0"), got, want):
        assert _rel(g, w) <= REL, (name, _rel(g, w))
    leaves = [t.clone().requires_grad_() for t in (ta, tb, th0)]
    auto = torch.autograd.grad(tref.scan_ref(*leaves), leaves, (tg, tghl))
    for g, w in zip(got, auto):
        assert torch.equal(g, w)
    # no g_hlast (h_last unused): autograd's gradient of hs alone
    auto = torch.autograd.grad(tref.scan_ref(*leaves)[0], leaves, tg)
    for g, w in zip(tref.scan_ref_bwd(ta, hs, th0, tg), auto):
        assert torch.equal(g, w)


def test_chunk_scan_under_grad_on_cpu_is_differentiable():
    """On CPU tensors `mamba_chunk_scan` is plain torch under grad: its
    gradient is autograd's of `scan_ref`, the B6 plain backward's bits;
    the Mamba1 mixer's B6 path keeps hs out of place under grad."""
    rng = np.random.default_rng(9)
    f = np.float32
    a, bb = (rng.uniform(0.5, 0.999, (1, 16, 4, 8)).astype(f),
             rng.normal(size=(1, 16, 4, 8)).astype(f))
    h0 = rng.normal(size=(1, 4, 8)).astype(f)
    ta, tb, th0 = (t.requires_grad_() for t in _t(a, bb, h0))
    hs, hl = tops.mamba_chunk_scan(ta, tb, th0, chunk=8)
    g = torch.ones_like(hs)
    got = torch.autograd.grad(hs, (ta, tb, th0), g)
    want = tref.scan_ref_bwd(ta.detach(), hs.detach(), th0.detach(), g)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
