"""Port congruence: the selective-scan kernels' entry points (B6
`ops.mamba_chunk_scan`, B7 `fused.fused_mamba_scan`) and their plain
versions against the JAX package, on the same numpy inputs.

Tolerances and why:
  * B6's plain version (`scan_ref`, the sequential recurrence) against the
    JAX oracle and the JAX kernel in interpret mode (a doubling scan inside
    each chunk, which rounds otherwise): atol/rtol 1e-5, the JAX kernel
    test's own bound (tests/test_kernels.py).
  * B7's plain version (sequential recurrence, y by `state_sum`'s pairwise
    order) against the JAX fused kernel in interpret mode and the
    model-level fused scan (associative scan per chunk): atol/rtol 2e-4,
    the JAX test's own bound for the same comparison.
The kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions (B6 bitwise, B7 within 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import fused as jfused
from repro.kernels.mamba_scan import ops as jops
from repro.kernels.mamba_scan import ref as jref
from repro.models import mamba as jmamba
from repro_torch.kernels.mamba_scan import fused as tfused
from repro_torch.kernels.mamba_scan import ops as tops
from repro_torch.kernels.mamba_scan import ref as tref
from repro_torch.models import mamba as tmamba

SCAN_SHAPES = [(2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 32, 32),
               (2, 32, 16, 4, 32, 16), (1, 64, 128, 8, 64, 64)]
FUSED_SHAPES = [(2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 32, 32)]
TOL_B6 = dict(atol=1e-5, rtol=1e-5)
TOL_B7 = dict(atol=2e-4, rtol=2e-4)


def _scan_inputs(b, L, d, s, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, L, d, s)).astype(np.float32)
    bb = (rng.normal(size=(b, L, d, s)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(b, d, s)).astype(np.float32)
    return a, bb, h0


def _fused_inputs(B, L, D, S, seed=7):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, (B, L, D)).astype(np.float32)
    xc = rng.normal(size=(B, L, D)).astype(np.float32)
    b = rng.normal(size=(B, L, S)).astype(np.float32)
    c = rng.normal(size=(B, L, S)).astype(np.float32)
    a_mat = (-np.exp(rng.normal(size=(D, S)) * 0.3)).astype(np.float32)
    return dt, xc, b, c, a_mat


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("b,L,d,s,chunk,bd", SCAN_SHAPES)
def test_scan_matches_jax(b, L, d, s, chunk, bd):
    a, bb, h0 = _scan_inputs(b, L, d, s)
    hs_j, hl_j = jref.scan_ref(jnp.asarray(a), jnp.asarray(bb),
                               jnp.asarray(h0))
    hs_k, hl_k = jops.mamba_chunk_scan(jnp.asarray(a), jnp.asarray(bb),
                                       jnp.asarray(h0), chunk=chunk,
                                       block_d=bd)
    hs_t, hl_t = tref.scan_ref(*_t(a, bb, h0))
    hs_o, hl_o = tops.mamba_chunk_scan(*_t(a, bb, h0), chunk=chunk,
                                       block_d=bd)
    # the CPU entry point is the plain version, bitwise
    assert torch.equal(hs_o, hs_t) and torch.equal(hl_o, hl_t)
    assert hs_o.dtype == torch.float32 and hs_o.shape == (b, L, d, s)
    for want in ((hs_j, hl_j), (hs_k, hl_k)):
        np.testing.assert_allclose(hs_t.numpy(), np.asarray(want[0]), **TOL_B6)
        np.testing.assert_allclose(hl_t.numpy(), np.asarray(want[1]), **TOL_B6)


@pytest.mark.parametrize("L,chunk,bd", [(60, 16, 16), (64, 64, 24)])
def test_chunk_scan_keeps_the_reference_checks(L, chunk, bd):
    """L % chunk and D % block_d must be 0 after min() with the shape (the
    reference asserts it); the port raises."""
    a, bb, h0 = _t(*_scan_inputs(1, L, 32, 4))
    with pytest.raises(ValueError, match="L % chunk"):
        tops.mamba_chunk_scan(a, bb, h0, chunk=chunk, block_d=bd)
    # min() with the shape: a chunk longer than L is L
    hs, _ = tops.mamba_chunk_scan(a, bb, h0, chunk=4 * L, block_d=32)
    assert hs.shape == a.shape


@pytest.mark.parametrize("B,L,D,S,chunk,bd", FUSED_SHAPES)
def test_fused_plain_matches_jax_kernel(B, L, D, S, chunk, bd):
    ins = _fused_inputs(B, L, D, S)
    y_k, hl_k = jfused.fused_mamba_scan(*map(jnp.asarray, ins), chunk=chunk,
                                        block_d=bd)
    y_m, hl_m = jmamba.fused_chunked_scan_m1(
        *map(jnp.asarray, ins), jnp.zeros((B, D, S)), chunk)
    y_t, hl_t = tfused.fused_mamba_scan_plain(*_t(*ins))
    y_o, hl_o = tfused.fused_mamba_scan(*_t(*ins), chunk=chunk, block_d=bd)
    assert torch.equal(y_o, y_t) and torch.equal(hl_o, hl_t)
    assert y_t.dtype == torch.float32 and y_t.shape == (B, L, D)
    for y_w, hl_w in ((y_k, hl_k), (y_m, hl_m)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_w), **TOL_B7)
        np.testing.assert_allclose(hl_t.numpy(), np.asarray(hl_w), **TOL_B7)


@pytest.mark.parametrize("L,chunk", [(61, 16), (64, 16), (5, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_from_h0_at_any_length_matches_jax(L, chunk, dtype):
    """A nonzero h0 and ragged L, which the JAX kernel does not take: the
    plain version and the port's model-level chunked scan against the JAX
    oracle (`ref_scan` on a = exp(dt A), bx = dt x B, then the C einsum),
    with xc, B, C in the model's bf16 or in f32."""
    B, D, S = 2, 32, 8
    dt, xc, b, c, a_mat = _fused_inputs(B, L, D, S, seed=11)
    h0 = np.random.default_rng(12).normal(size=(B, D, S)).astype(np.float32)
    jdt, ja = jnp.asarray(dt), jnp.asarray(a_mat)
    jx, jb, jc = (jnp.asarray(v).astype(dtype) for v in (xc, b, c))
    a = jnp.exp(jdt[..., None] * ja)
    bx = (jdt * jx.astype(jnp.float32))[..., None] \
        * jb.astype(jnp.float32)[:, :, None, :]
    hs, hl_w = jmamba.ref_scan(a, bx, jnp.asarray(h0))
    y_w = jnp.einsum("blds,bls->bld", hs, jc.astype(jnp.float32))
    tx, tb, tc = (torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for v in (jx, jb, jc))
    tdt, ta, th0 = _t(dt, a_mat, h0)
    y_p, hl_p = tfused.fused_mamba_scan_plain(tdt, tx, tb, tc, ta, th0)
    y_c, hl_c = tmamba.fused_chunked_scan_m1(tdt, tx, tb, tc, ta, th0, chunk)
    for y, hl in ((y_p, hl_p), (y_c, hl_c)):
        assert y.shape == (B, L, D) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(y_w), **TOL_B7)
        np.testing.assert_allclose(hl.numpy(), np.asarray(hl_w), **TOL_B7)


@pytest.mark.parametrize("chunk", [8, 32])
def test_model_scans_match_jax(chunk):
    """The port's `ref_scan`, `chunked_scan` and CPU `fused_chunked_scan_m1`
    against the reference's, L % chunk == 0, from a nonzero h0."""
    B, L, D, S = 2, 64, 16, 8
    a, bb, h0 = _scan_inputs(B, L, D, S, seed=13)
    ja, jb, jh = map(jnp.asarray, (a, bb, h0))
    for jfn, tfn in ((jmamba.ref_scan, tmamba.ref_scan),
                     (lambda *x: jmamba.chunked_scan(*x, chunk),
                      lambda *x: tmamba.chunked_scan(*x, chunk))):
        hs_w, hl_w = jfn(ja, jb, jh)
        hs, hl = tfn(*_t(a, bb, h0))
        np.testing.assert_allclose(hs.numpy(), np.asarray(hs_w), **TOL_B6)
        np.testing.assert_allclose(hl.numpy(), np.asarray(hl_w), **TOL_B6)
    ins = _fused_inputs(B, L, D, S, seed=14)
    y_w, hl_w = jmamba.fused_chunked_scan_m1(*map(jnp.asarray, ins), jh, chunk)
    y, hl = tmamba.fused_chunked_scan_m1(*_t(*ins), torch.from_numpy(h0),
                                         chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_w), **TOL_B7)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_w), **TOL_B7)
