"""Port congruence: zamba2's hybrid (mamba2 layers in super-blocks of
`shared_attn_period`, then ONE shared attention + MLP block) through
`lm.make_lm`, `forward`, `prefill_caches`, `decode_step` and
`init_decode_state`, against the JAX package at zamba2's smoke size (4
layers, period 2: two super-blocks, so the shared block runs twice), with
the reference's parameters carried across by `interop.lm_params`.

Two sources part the two packages, and the tests hold each apart:
  * GEMM summation order.  The reference's bf16 `matmul` (XLA's dot)
    sums in another order than the port's f32 product on the CPU (which
    sums k in order); about 7 in 10 f32 results differ in the last bit,
    and now and then that moves a bf16 rounding.  With random weights the
    smoke model grows one such flip in the first block's out_proj
    (relative L2 1e-4 of that block's output) to ~2.6e-3 at the logits.
  * The reference's compiled scans keep excess f32 precision between bf16
    ops; its own compiled and eager runs part by ~1.5e-2 at the logits.
So the tests hold:
  * eager, with ONE GEMM on both sides (`layers.matmul` of both packages
    replaced by the same float64-accumulated product, and the reference's
    `attend` routed through its flash kernel, as the port's always is:
    f32 probabilities): logits, SSM states, conv rings and the shared
    block's K/V to relative L2 <= 1e-5 (measured ~1e-7);
  * eager, each package's own GEMM: within twice the port's drift from
    itself when only its GEMM's summation order changes (k reversed);
  * compiled: relative L2 <= max(1e-2, 1.5 x the reference's own distance
    between that compiled run and its eager flash-routed run), the bound
    set by that witness; both numbers are printed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models.attention import KVCache

from _torch_hybrid import (
    ARCH, compile_witness, flash_attend, jax_matmul, prefill_decode, rel_l2,
    reversed_k_matmul, runs, state_fields, to_np, tokens, torch_matmul, worst)

EAGER = 1e-5
MODEL = 1e-2


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


@pytest.fixture
def one_gemm(monkeypatch):
    """Both packages on one GEMM, the reference's attention on its flash
    kernel."""
    monkeypatch.setattr(jlayers, "matmul", jax_matmul)
    monkeypatch.setattr(tlayers, "matmul", torch_matmul)
    flash_attend(monkeypatch)


# --------------------------------------------------------------------------
# Parameters and state
# --------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_make_lm_tree_matches_jax(model):
    """The port's random init has the reference's tree, the shared block
    included (one block, not stacked): names, shapes and types, per
    layer."""
    params, cfg_j, tparams, cfg_t = model
    made = tlm.make_lm(torch.Generator().manual_seed(0), cfg_t)
    assert list(made) == ["embed", "final_norm", "blocks", "shared_attn",
                          "unembed"]
    assert sorted(made) == sorted(params)
    pattern, n_super = tlm.layer_pattern(cfg_t)
    assert (pattern, n_super) == (("mamba2", "mamba2"), 2)
    assert [len(b) for b in made["blocks"]] == [n_super] * len(pattern)
    carried = dict(_leaves(tparams))
    mine = dict(_leaves(made))
    assert sorted(carried) == sorted(mine)
    for name, v in carried.items():
        assert (mine[name].dtype, mine[name].shape) == (v.dtype, v.shape), \
            name
    # the reference's own leaves: per-layer slices of its stacked blocks
    for j in range(len(pattern)):
        for name, v in _leaves(jax.tree.map(lambda x: x[0],
                                            params["blocks"][j])):
            t = dict(_leaves(made["blocks"][j][0]))[name]
            assert tuple(t.shape) == v.shape, name
            assert str(t.dtype).split(".")[-1] == str(v.dtype), name
    for name, v in _leaves(params["shared_attn"]):
        t = dict(_leaves(made["shared_attn"]))[name]
        assert tuple(t.shape) == v.shape, name
        assert str(t.dtype).split(".")[-1] == str(v.dtype), name


def test_init_decode_state_matches_jax(model):
    _, cfg_j, _, cfg_t = model
    js = jlm.init_decode_state(3, 16, cfg_j)
    ts = tlm.init_decode_state(3, 16, cfg_t, device="cpu")
    got = interop.decode_state(js)
    assert all(isinstance(c, tmamba.Mamba2State) for c in ts.caches)
    assert all(isinstance(c, tmamba.Mamba2State) for c in got.caches)
    assert isinstance(ts.shared_kv, KVCache)
    for mine, carried in ((ts.caches, got.caches),
                          ([ts.shared_kv], [got.shared_kv])):
        for a, b in zip(mine, carried):
            for x, y in zip(a, b):
                assert x.shape == y.shape and x.dtype == y.dtype
                assert not x.any() and not y.any()
    assert ts.shared_kv.k.shape == (2, 3, 16, 4, 16)
    assert ts.caches[0].ssm.shape == (2, 3, 8, 16, 8)
    assert torch.equal(ts.length, got.length)


def test_interop_decode_state_carries_a_prefilled_state(model):
    params, cfg_j, _, _ = model
    js = jlm.prefill_caches(params, jnp.asarray(tokens(3, 9)), cfg_j, 16)
    got = interop.decode_state(js)
    for j, c in enumerate(js.caches):
        assert isinstance(got.caches[j], tmamba.Mamba2State)
        np.testing.assert_array_equal(to_np(got.caches[j].ssm), to_np(c.ssm))
        np.testing.assert_array_equal(to_np(got.caches[j].conv), to_np(c.conv))
    for f in ("k", "v", "length"):
        np.testing.assert_array_equal(to_np(getattr(got.shared_kv, f)),
                                      to_np(getattr(js.shared_kv, f)))
    assert got.shared_kv.length.dtype == torch.int32


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,s", [(16, 16), (1, 13)])
def test_forward_matches_jax_run_eagerly_on_one_gemm(model, one_gemm, seed,
                                                     s):
    """With one GEMM on both sides and the reference's attention on its
    flash kernel, the hybrid computes the reference's function: logits
    within 1e-5 relative L2 of the reference run eagerly."""
    params, cfg_j, tparams, cfg_t = model
    toks = tokens(seed, s)
    scan_ops.reset_launches()
    fa_ops.reset_launches()
    got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t)
    assert scan_ops.LAUNCHES["mamba_fused"] == 0    # CPU: no kernel
    assert fa_ops.LAUNCHES["flash_attn"] == 0
    with jax.disable_jit():
        want = jlm.forward(params, jnp.asarray(toks), cfg_j, use_kernel=True)
    err = rel_l2(got.logits, want.logits)
    print(f"{ARCH} eager, one GEMM, s={s}: relative L2 {err:.3e}")
    assert got.logits.shape == want.logits.shape
    assert err <= EAGER
    for g, w in zip(got.aux, want.aux):
        np.testing.assert_array_equal(to_np(g), to_np(w))


def test_forward_eager_gap_is_the_gemm_order(model, monkeypatch):
    """Each package on its own GEMM, run eagerly: the port is as close to
    the reference as to itself with only its GEMM's summation order
    changed (within twice that witness), and inside the model bound."""
    params, cfg_j, tparams, cfg_t = model
    toks = torch.from_numpy(tokens(16, 16))
    got = tlm.forward(tparams, toks, cfg_t).logits
    with jax.disable_jit():
        want = jlm.forward(params, jnp.asarray(toks.numpy()), cfg_j,
                           use_kernel=True).logits
    monkeypatch.setattr(tlayers, "matmul", reversed_k_matmul)
    witness = rel_l2(tlm.forward(tparams, toks, cfg_t).logits, got)
    err = rel_l2(got, want)
    print(f"{ARCH} eager, own GEMMs: relative L2 {err:.3e}; the port "
          f"against itself with k reversed in its GEMMs {witness:.3e}")
    assert 0 < witness and err <= 2 * witness and err <= MODEL


@pytest.mark.parametrize("seed,s", [(16, 16), (1, 13)])
def test_forward_matches_jax(model, monkeypatch, seed, s):
    """Against the compiled reference (its default route: attend_ref):
    within max(1e-2, 1.5 x the reference's own distance between this
    compiled run and its eager flash-routed run)."""
    params, cfg_j, tparams, cfg_t = model
    toks = tokens(seed, s)
    got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t)
    want = jlm.forward(params, jnp.asarray(toks), cfg_j)
    with jax.disable_jit():
        eager = jlm.forward(params, jnp.asarray(toks), cfg_j,
                            use_kernel=True).logits
    witness = rel_l2(eager, want.logits)
    err = rel_l2(got.logits, want.logits)
    bound = max(MODEL, 1.5 * witness)
    print(f"{ARCH} compiled, s={s}: relative L2 {err:.3e}; the reference's "
          f"compiled against its eager run {witness:.3e}; bound {bound:.3e}")
    assert got.logits.dtype == torch.float32
    assert got.logits.shape == want.logits.shape and got.caches is None
    assert err <= bound


def test_forward_returns_the_prefilled_caches(model):
    _, _, tparams, cfg_t = model
    toks = torch.arange(12)[None] % cfg_t.vocab_size
    out = tlm.forward(tparams, toks, cfg_t, return_caches=True, cache_len=32)
    pre = tlm.prefill_caches(tparams, toks, cfg_t, 32)
    for a, b in zip(state_fields(out.caches).values(), state_fields(pre).values()):
        assert torch.equal(a, b)
    assert torch.equal(out.caches.length, pre.length)
    assert torch.equal(out.caches.shared_kv.length, pre.shared_kv.length)
    # the prefill's last token gives the forward's last logits
    lg, _ = tlm.decode_step(tparams, toks[:, -1:], tlm.prefill_caches(
        tparams, toks[:, :-1], cfg_t, 32), cfg_t)
    assert rel_l2(lg[:, 0], out.logits[:, -1]) <= MODEL


# --------------------------------------------------------------------------
# Prefill and decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 13])
def test_prefill_and_decode_match_jax_eagerly_on_one_gemm(model, one_gemm, s):
    """prefill_caches, then 3 decode_step: every mamba2 ssm and conv
    state, the shared block's K/V (`shared_kv`, one entry per application)
    and the logits within 1e-5 relative L2 of the reference run eagerly."""
    (jp, js), (tp, ts) = runs(model, eager_jax=True)
    toks = tokens(s, s)
    want = prefill_decode(js, jp, toks)
    got = prefill_decode(ts, tp, toks)
    name, err = worst(got, want)
    print(f"{ARCH} eager, one GEMM, s={s}: worst relative L2 {err:.3e} "
          f"({name})")
    assert err <= EAGER, name
    for k in want:
        if "conv" in k or "shared" in k:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("s", [16, 13])
def test_prefill_and_decode_match_jax(model, s):
    """Against the compiled reference: the worst field within max(1e-2,
    1.5 x the worst distance of the reference's compiled run from its
    eager flash-routed run on the same calls); lengths exactly."""
    params, cfg_j, tparams, cfg_t = model
    toks = tokens(s, s)
    want, w_name, witness = compile_witness(model, s)
    _, (tp, ts) = runs(model, eager_jax=False)
    got = prefill_decode(ts, tp, toks)
    name, err = worst(got, want)
    bound = max(MODEL, 1.5 * witness)
    print(f"{ARCH} compiled, s={s}: worst relative L2 {err:.3e} ({name}); "
          f"the reference's compiled against its eager run {witness:.3e} "
          f"({w_name}); bound {bound:.3e}")
    assert err <= bound, name
    st = tlm.prefill_caches(tparams, torch.from_numpy(toks), cfg_t, 32)
    jst = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)
    assert st.shared_kv.k.shape == jst.shared_kv.k.shape
    np.testing.assert_array_equal(st.length.numpy(), np.asarray(jst.length))
    np.testing.assert_array_equal(st.shared_kv.length.numpy(),
                                  np.asarray(jst.shared_kv.length))
    _, st = tlm.decode_step(tparams, torch.zeros((2, 1), dtype=torch.int64),
                            st, cfg_t)
    assert st.shared_kv.length.tolist() == [[s + 1] * 2] * 2
    assert st.length.tolist() == [s + 1] * 2
