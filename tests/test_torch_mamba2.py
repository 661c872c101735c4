"""Port congruence: the Mamba2 (SSD) mixer of zamba2 against the JAX
package, at zamba2's smoke size (d_model 64, d_inner 128, 8 heads of 16,
state 8, chunk 8), with the reference's parameters carried across by
`interop.lm_params`.

Tolerances and why:
  * `causal_conv1d` over conv_dim channels: bitwise (the same bf16
    products and sums in order).
  * `fused_chunked_scan_m2` against the reference's: y and h_last to rtol
    1e-5 (atol 1e-6); the two associative scans pair the steps in another
    tree, so f32 sums round differently.  B7's route (`ssd_channels`
    into `fused.fused_mamba_scan`, whose plain version runs here) to the
    same bound: a sequential recurrence against the chunked one.
  * The mixer (`_mamba2_scan` at L = 16, the chunked path, and L = 13,
    ragged: the reference's `ref_scan`; `apply_mamba2_decode` stepped 16
    times) against the JAX functions called eagerly: one bf16 ulp of the
    value (rtol 2^-7, atol 1e-6) on the bf16 outputs, the conv ring
    bitwise, the f32 SSM state to rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro_torch import interop
from repro_torch.kernels.mamba_scan import fused as scan_fused
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba

ARCH = "zamba2-2.7b"
ULP = dict(atol=1e-6, rtol=2 ** -7)
SCAN = dict(atol=1e-6, rtol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


@pytest.fixture(scope="module")
def mixers(model):
    """Super-block 1's first mixer in both packages."""
    params, cfg_j, tparams, cfg_t = model
    pj = jax.tree.map(lambda x: x[1], params["blocks"][0]["mixer"])
    return pj, cfg_j, tparams["blocks"][0][1]["mixer"], cfg_t


def test_conv_dim_and_heads_match_jax(model):
    _, cfg_j, _, cfg_t = model
    assert tmamba.conv_dim(cfg_t) == jmamba.conv_dim(cfg_j) == 128 + 16
    assert tmamba.n_ssm_heads(cfg_t) == jmamba.n_ssm_heads(cfg_j) == 8
    full = tconfigs.get(ARCH)
    assert (tmamba.conv_dim(full), tmamba.n_ssm_heads(full)) == (5248, 80)


def test_causal_conv1d_over_conv_dim_matches_jax(mixers):
    pj, _, pt, cfg_t = mixers
    cd = tmamba.conv_dim(cfg_t)
    x = _bf16((2, 19, cd), 1)
    state = _bf16((2, 3, cd), 2)
    bias = _bf16((cd,), 3)   # the init's bias is zero
    for st in (None, state):
        yj, sj = jmamba.causal_conv1d(x, pj["conv_w"], bias, st)
        yt, s_t = tmamba.causal_conv1d(
            interop.tensor(x), pt["conv_w"], interop.tensor(bias),
            None if st is None else interop.tensor(st))
        assert yt.dtype == torch.bfloat16 and s_t.shape == (2, 3, cd)
        np.testing.assert_array_equal(_np(yt), _np(yj))
        np.testing.assert_array_equal(_np(s_t), _np(sj))


def _scan_inputs(B, L, nh, hd, ds, seed):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.5, (B, L, nh)).astype(np.float32)
    xh, b, c = (rng.normal(size=sh).astype(np.float32)
                for sh in ((B, L, nh, hd), (B, L, ds), (B, L, ds)))
    a_h = (-np.arange(1, nh + 1)).astype(np.float32)
    h0 = rng.normal(size=(B, nh, hd, ds)).astype(np.float32)
    return dt, xh, b, c, a_h, h0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_chunked_scan_m2_matches_jax(dtype):
    """The CPU body and B7's route against the reference's scan, from a
    nonzero h0, at L = 16 in chunks of 8."""
    dt, xh, b, c, a_h, h0 = _scan_inputs(2, 16, 4, 8, 8, seed=11)
    xh, b, c = (jnp.asarray(v).astype(dtype) for v in (xh, b, c))
    yj, hj = jmamba.fused_chunked_scan_m2(jnp.asarray(dt), xh, b, c,
                                          jnp.asarray(a_h), jnp.asarray(h0),
                                          8)
    t = [interop.tensor(v) for v in (dt, xh, b, c, a_h, h0)]
    scan_ops.reset_launches()
    yt, ht = tmamba.fused_chunked_scan_m2(*t, 8)
    assert yt.shape == (2, 16, 4, 8) and ht.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(_np(yt), _np(yj), **SCAN)
    np.testing.assert_allclose(_np(ht), _np(hj), **SCAN)
    # B7's inputs (the plain version of B7 runs on CPU tensors)
    dt_d, xc, a_mat, h0_d = tmamba.ssd_channels(t[0], t[1], t[4], t[5])
    assert dt_d.shape == (2, 16, 32) and a_mat.shape == (32, 8)
    assert torch.equal(dt_d[..., 8:16], t[0][..., 1:2].expand(-1, -1, 8))
    assert torch.equal(a_mat[8:16], torch.full((8, 8), -2.0))
    yb, hb = scan_fused.fused_mamba_scan(dt_d, xc, t[2], t[3], a_mat,
                                         h0=h0_d)
    assert scan_ops.LAUNCHES == {  # CPU
        "mamba_scan": 0, "mamba_fused": 0, "mamba_scan_bwd": 0,
        "mamba_fused_bwd": 0, "mamba_ssd_bwd": 0}
    np.testing.assert_allclose(_np(yb.view(2, 16, 4, 8)), _np(yj), **SCAN)
    np.testing.assert_allclose(_np(hb.view(2, 4, 8, 8)), _np(hj), **SCAN)


@pytest.mark.parametrize("L", [16, 13])
def test_mixer_matches_jax(mixers, L):
    """L = 16 is a multiple of the smoke chunk (8): the chunked scan on both
    sides; L = 13 is ragged: the reference's `ref_scan`, the port's chunked
    body with a short last chunk."""
    pj, cfg_j, pt, cfg_t = mixers
    x = _bf16((2, L, cfg_j.d_model), 5)
    scan_ops.reset_launches()
    yj, sj = jmamba._mamba2_scan(pj, x, cfg_j)
    yt, st = tmamba._mamba2_scan(pt, interop.tensor(x), cfg_t)
    assert scan_ops.LAUNCHES == {  # CPU
        "mamba_scan": 0, "mamba_fused": 0, "mamba_scan_bwd": 0,
        "mamba_fused_bwd": 0, "mamba_ssd_bwd": 0}
    assert isinstance(st, tmamba.Mamba2State)
    assert yt.dtype == torch.bfloat16 and yt.shape == yj.shape
    np.testing.assert_allclose(_np(yt), _np(yj), **ULP)
    assert st.conv.dtype == torch.bfloat16 and st.ssm.dtype == torch.float32
    np.testing.assert_array_equal(_np(st.conv), _np(sj.conv))
    np.testing.assert_allclose(_np(st.ssm), _np(sj.ssm), **SCAN)
    assert torch.equal(tmamba.apply_mamba2(pt, interop.tensor(x), cfg_t), yt)


def test_mixer_decode_16_steps_matches_jax(mixers):
    pj, cfg_j, pt, cfg_t = mixers
    x = _bf16((2, 16, cfg_j.d_model), 6)
    sj = jmamba.init_mamba2_state(2, cfg_j, jnp.bfloat16)
    st = tmamba.init_mamba2_state(2, cfg_t, torch.bfloat16)
    for a, b in zip(st, sj):
        assert a.shape == b.shape and not a.any()
    for t in range(16):
        oj, sj = jmamba.apply_mamba2_decode(pj, x[:, t:t + 1], cfg_j, sj)
        ot, st = tmamba.apply_mamba2_decode(pt, interop.tensor(x[:, t:t + 1]),
                                            cfg_t, st)
        assert ot.dtype == torch.bfloat16 and ot.shape == oj.shape
        np.testing.assert_allclose(_np(ot), _np(oj), **ULP, err_msg=t)
    np.testing.assert_array_equal(_np(st.conv), _np(sj.conv))
    np.testing.assert_allclose(_np(st.ssm), _np(sj.ssm), **SCAN)


def test_decode_steps_continue_the_scan(mixers):
    """16 decode steps from zero end in the state the full-sequence scan
    ends in (the port against itself: the two paths of one recurrence)."""
    _, _, pt, cfg_t = mixers
    x = interop.tensor(_bf16((1, 16, cfg_t.d_model), 7))
    _, full = tmamba._mamba2_scan(pt, x, cfg_t)
    st = tmamba.init_mamba2_state(1, cfg_t, torch.bfloat16)
    for t in range(16):
        _, st = tmamba.apply_mamba2_decode(pt, x[:, t:t + 1], cfg_t, st)
    assert torch.equal(st.conv, full.conv)
    np.testing.assert_allclose(_np(st.ssm), _np(full.ssm), **SCAN)


def test_make_mamba2_has_the_reference_leaves(model):
    """Names, shapes and types of the port's random mixer against the
    reference's carried across (`MAMBA2_F32` in float32, the rest bf16)."""
    _, _, tparams, cfg_t = model
    carried = tparams["blocks"][0][0]["mixer"]
    made = tmamba.make_mamba2(torch.Generator().manual_seed(0), cfg_t,
                              torch.bfloat16)
    assert sorted(made) == sorted(carried)
    for k, v in carried.items():
        want = (torch.float32 if k in interop.MAMBA2_F32 else torch.bfloat16)
        leaves = v.values() if isinstance(v, dict) else [v]
        mine = made[k].values() if isinstance(v, dict) else [made[k]]
        for a, b in zip(leaves, mine):
            assert a.dtype == b.dtype == want, k
            assert a.shape == b.shape, k
    nh = tmamba.n_ssm_heads(cfg_t)
    assert torch.equal(made["a_log"], torch.log(torch.arange(1.0, nh + 1)))
    dt0 = tmamba._softplus(made["dt_bias"])
    assert bool(((dt0 > 9e-4) & (dt0 < 0.11)).all())
