"""Port congruence: the Mamba1 mixer and falcon-mamba through `lm.forward`,
`prefill_caches` and `decode_step` against the JAX package, with the
reference's parameters carried across by `interop.lm_params`.

Tolerances and why:
  * `causal_conv1d`: bitwise (the same bf16 products and sums in order).
  * `_softplus`: rtol 1e-6 against the float64 value of the reference's
    formula, logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), and against
    `jax.nn.softplus` (XLA:CPU's exp and log1p are its own polynomials,
    which may round a last bit or two otherwise).
  * The mixer (`apply_mamba1` with ``use_kernel`` off and on, and
    `apply_mamba1_decode` stepped 16 times) against the JAX functions
    called eagerly: one bf16 ulp of the value (rtol 2^-7, atol 1e-6) on the
    bf16 outputs, since the scans sum in another order in f32 and that can
    move a bf16 rounding (measured here: bitwise); the f32 SSM state to
    rtol 1e-5.
  * Whole models against the reference's compiled scans (lax.scan keeps
    excess f32 precision between bf16 ops): logits and SSM states to
    relative L2 <= 1e-2, the bound held for the dense models
    (tests/test_torch_lm.py); conv rings and lengths as there.
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
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba

ARCH = "falcon-mamba-7b"
ULP = dict(atol=1e-6, rtol=2 ** -7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


def _rel_l2(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


def _mixers(model):
    """Layer 0's mixer in both packages."""
    params, cfg_j, tparams, cfg_t = model
    pj = jax.tree.map(lambda x: x[0], params["blocks"][0]["mixer"])
    return pj, cfg_j, tparams["blocks"][0][0]["mixer"], cfg_t


def test_causal_conv1d_matches_jax(model):
    pj, _, pt, _ = _mixers(model)
    x = _bf16((2, 19, pt["conv_w"].shape[1]), 1)
    state = _bf16((2, 3, pt["conv_w"].shape[1]), 2)
    bias = _bf16(pt["conv_b"].shape, 3)   # the init's bias is zero
    for st in (None, state):
        yj, sj = jmamba.causal_conv1d(x, pj["conv_w"], bias, st)
        yt, s_t = tmamba.causal_conv1d(
            interop.tensor(x), pt["conv_w"], interop.tensor(bias),
            None if st is None else interop.tensor(st))
        assert yt.dtype == torch.bfloat16 and s_t.shape == (2, 3, 128)
        np.testing.assert_array_equal(_np(yt), _np(yj))
        np.testing.assert_array_equal(_np(s_t), _np(sj))


def test_softplus_is_jax_softplus():
    x = np.random.default_rng(4).normal(0, 8, 50_000).astype(np.float32)
    x[:4] = (0.0, 25.0, -25.0, 90.0)   # F.softplus switches to x above 20
    got = tmamba._softplus(torch.from_numpy(x)).numpy()
    # the reference's formula, logaddexp(x, 0), in float64
    exact = np.logaddexp(x.astype(np.float64), 0.0)
    jx = np.asarray(jax.nn.softplus(x))

    def worst(ref, sel):
        """The element of ``sel`` farthest from ``ref`` (relative), with x,
        the port's, JAX's and the float64 value, so that a failure names
        the side that moved."""
        i = np.flatnonzero(sel)[np.argmax(
            np.abs(got[sel] - ref[sel]) / np.abs(ref[sel]))]
        return (f"worst element {i}: x {x[i]:.9g}, port {got[i]:.9g}, JAX "
                f"{jx[i]:.9g}, float64 {exact[i]:.17g}")

    everywhere = np.ones_like(exact, dtype=bool)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0,
                               err_msg=worst(exact, everywhere))
    # against JAX where the result is >= 1e-5 (x > -11.5, the model's dt
    # lies in about [-8, 2]): below it the two were seen 1.5e-4 apart in
    # 2 of 12 runs of the suite under xdist; the port held its float64
    # bound above, so that gap was most likely JAX's side, not shown
    big = exact >= 1e-5
    np.testing.assert_allclose(got[big], jx[big], rtol=1e-6, atol=0,
                               err_msg=worst(jx.astype(np.float64), big))


@pytest.mark.parametrize("L", [16, 21])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mixer_matches_jax(model, L, use_kernel):
    """L = 16 is a multiple of the smoke chunk (8): B6's entry point with
    ``use_kernel``, else the fused chunked scan; L = 21 is ragged: the
    fused chunked scan either way (the reference: `ref_scan`)."""
    pj, cfg_j, pt, cfg_t = _mixers(model)
    x = _bf16((2, L, cfg_j.d_model), 5)
    scan_ops.reset_launches()
    yj, sj = jmamba._mamba1_scan(pj, x, cfg_j, use_kernel=use_kernel)
    yt, st = tmamba._mamba1_scan(pt, interop.tensor(x), cfg_t,
                                 use_kernel=use_kernel)
    assert scan_ops.LAUNCHES == {  # CPU
        "mamba_scan": 0, "mamba_fused": 0, "mamba_scan_bwd": 0,
        "mamba_fused_bwd": 0, "mamba_ssd_bwd": 0}
    assert yt.dtype == torch.bfloat16 and yt.shape == yj.shape
    np.testing.assert_allclose(_np(yt), _np(yj), **ULP)
    np.testing.assert_array_equal(_np(st.conv), _np(sj.conv))
    np.testing.assert_allclose(_np(st.ssm), _np(sj.ssm), rtol=1e-5, atol=1e-6)
    assert torch.equal(
        tmamba.apply_mamba1(pt, interop.tensor(x), cfg_t,
                            use_kernel=use_kernel), yt)


def test_mixer_decode_16_steps_matches_jax(model):
    pj, cfg_j, pt, cfg_t = _mixers(model)
    x = _bf16((2, 16, cfg_j.d_model), 6)
    sj = jmamba.init_mamba1_state(2, cfg_j, jnp.bfloat16)
    st = tmamba.init_mamba1_state(2, cfg_t, torch.bfloat16)
    for t in range(16):
        oj, sj = jmamba.apply_mamba1_decode(pj, x[:, t:t + 1], cfg_j, sj)
        ot, st = tmamba.apply_mamba1_decode(pt, interop.tensor(x[:, t:t + 1]),
                                            cfg_t, st)
        np.testing.assert_allclose(_np(ot), _np(oj), **ULP, err_msg=t)
    np.testing.assert_array_equal(_np(st.conv), _np(sj.conv))
    np.testing.assert_allclose(_np(st.ssm), _np(sj.ssm), rtol=1e-5, atol=1e-6)


def test_lm_params_carry_mamba1_dtypes(model):
    _, cfg_j, tparams, cfg_t = model
    _, n_super = tlm.layer_pattern(cfg_t)
    assert len(tparams["blocks"][0]) == n_super == cfg_t.n_layers
    mixer = tparams["blocks"][0][1]["mixer"]
    for k, v in mixer.items():
        want = (torch.float32 if k in interop.MAMBA1_F32 else torch.bfloat16)
        assert v.dtype == want, k
    made = tlm.make_lm(torch.Generator().manual_seed(0), cfg_t)
    for k, v in made["blocks"][0][0]["mixer"].items():
        assert (v.dtype, v.shape) == (mixer[k].dtype, mixer[k].shape), k


@pytest.mark.parametrize("L", [16, 21])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(model, L, use_kernel):
    params, cfg_j, tparams, cfg_t = model
    toks = np.random.default_rng(L).integers(
        0, cfg_j.vocab_size, (2, L)).astype(np.int32)
    want = jlm.forward(params, jnp.asarray(toks), cfg_j,
                       use_kernel=use_kernel)
    got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t,
                      use_kernel=use_kernel)
    assert got.logits.dtype == torch.float32
    assert got.logits.shape == want.logits.shape and got.caches is None
    err = _rel_l2(got.logits, want.logits)
    print(f"forward L={L} use_kernel={use_kernel}: relative L2 {err:.3e}")
    assert err <= 1e-2
    for g, w in zip(got.aux, want.aux):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_forward_matches_jax_run_eagerly(model):
    """With jit off (lax.scan run op by op) the reference rounds as the
    port does: the 8e-3 gap above is the compiled scan's excess f32
    precision, not a different computation."""
    params, cfg_j, tparams, cfg_t = model
    toks = np.random.default_rng(16).integers(
        0, cfg_j.vocab_size, (2, 16)).astype(np.int32)
    with jax.disable_jit():
        want = jlm.forward(params, jnp.asarray(toks), cfg_j).logits
    got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t).logits
    assert _rel_l2(got, want) <= 1e-6


def test_forward_returns_the_prefilled_caches(model):
    _, _, tparams, cfg_t = model
    toks = torch.arange(12)[None] % cfg_t.vocab_size
    out = tlm.forward(tparams, toks, cfg_t, return_caches=True, cache_len=32)
    pre = tlm.prefill_caches(tparams, toks, cfg_t, 32)
    for a, b in zip(out.caches.caches[0], pre.caches[0]):
        assert torch.equal(a, b)
    assert torch.equal(out.caches.length, pre.length)


@pytest.mark.parametrize("s", [16, 13])
def test_prefill_and_decode_match_jax(model, s):
    params, cfg_j, tparams, cfg_t = model
    rng = np.random.default_rng(s)
    toks = rng.integers(0, cfg_j.vocab_size, (2, s)).astype(np.int32)
    js = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)
    ts = tlm.prefill_caches(tparams, torch.from_numpy(toks), cfg_t, 32)
    errs = {}

    def compare(tag):
        a, b = ts.caches[0], js.caches[0]
        assert a.conv.shape == b.conv.shape and a.conv.dtype == torch.bfloat16
        assert a.ssm.shape == b.ssm.shape and a.ssm.dtype == torch.float32
        errs[f"{tag} conv"] = _rel_l2(a.conv, b.conv)
        errs[f"{tag} ssm"] = _rel_l2(a.ssm, b.ssm)
        np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))

    compare("prefill")
    for step in range(3):
        tok = rng.integers(0, cfg_j.vocab_size, (2, 1)).astype(np.int32)
        jl, js = jlm.decode_step(params, jnp.asarray(tok), js, cfg_j)
        tl, ts = tlm.decode_step(tparams, torch.from_numpy(tok), ts, cfg_t)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        errs[f"logits {step}"] = _rel_l2(tl, jl)
        compare(f"decode {step}")
    worst = max(errs.values())
    print(f"{ARCH} s={s}: worst relative L2 {worst:.3e} "
          f"({max(errs, key=errs.get)})")
    assert worst <= 1e-2, errs


def test_init_decode_state_matches_jax(model):
    _, cfg_j, _, cfg_t = model
    js = jlm.init_decode_state(3, 16, cfg_j)
    ts = tlm.init_decode_state(3, 16, cfg_t, device="cpu")
    got = interop.decode_state(js)
    for a, b in zip(ts.caches[0], got.caches[0]):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()
    assert isinstance(ts.caches[0], tmamba.Mamba1State)


def test_mamba2_and_hybrid_build():
    """zamba2 is ported: its mixer and its hybrid model build on the CPU,
    and the falcon-mamba helpers above leave it alone."""
    cfg = tconfigs.smoke("zamba2-2.7b")
    params = tlm.make_lm(torch.Generator().manual_seed(0), cfg)
    assert "shared_attn" in params
    mixer = tmamba.make_mamba2(torch.Generator().manual_seed(1), cfg,
                               torch.bfloat16)
    assert mixer["in_proj"].shape == (
        cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state
        + tmamba.n_ssm_heads(cfg))
    st = tlm.init_decode_state(2, 16, cfg, device="cpu")
    assert isinstance(st.caches[0], tmamba.Mamba2State)
    assert st.shared_kv is not None
