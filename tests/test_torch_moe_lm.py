"""Port congruence: the MoE decoders — grok-1 ([attn + moe], P = 1) and
llama4-maverick ([attn + mlp, attn + moe], P = 2) — through
`lm.make_lm`, `forward` (logits and the three aux fields),
and `init_decode_state`, against the JAX package at their smoke sizes (2
layers each), with the reference's parameters carried across by
`interop.lm_params`; `prefill_caches` and `decode_step` are held in
tests/test_torch_moe_decode.py, to the same bounds.

Held first eagerly, then against the compiled reference:
  * eager, with ONE GEMM on both sides (tests/_torch_moe.py: the
    reference's expert einsums, both `layers.matmul`s; the reference's
    attention on its flash kernel): logits and K/V caches to relative L2
    <= 1e-5, the aux within 1e-6 (the layer alone, each package on its own
    GEMMs, is held to its GEMM-order witness in tests/test_torch_moe.py;
    through a whole model a flipped bf16 rounding can flip a route whose
    two probabilities nearly tie, so the eager models are compared on one
    GEMM);
  * compiled: relative L2 <= max(1e-2, 1.5 x the reference's own distance
    between that compiled run and its eager flash-routed run), and each
    aux field within max(1e-6, 1.5 x the same witness of that field).
    The compiled reference's excess f32 precision moves a hidden state by
    ~1e-2, enough to flip a route whose two probabilities nearly tie, and
    a flipped route moves its token's output far more than rounding does;
    the witness measures that in the reference itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models import lm as tlm
from repro_torch.models.attention import KVCache

from _torch_hybrid import flash_attend, rel_l2, to_np
from _torch_moe import ARCHS, model, one_gemm, tokens

EAGER = 1e-5
MODEL = 1e-2
AUX = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", params=ARCHS)
def m(request):
    return model(request.param)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_lm_params_carry_moe_blocks(m):
    """`interop.lm_params` keeps the reference's leaf types: the router in
    f32, the experts, the shared expert and attention in bf16; per layer
    slices of the stacked blocks."""
    params, cfg_j, tparams, cfg_t = m
    pattern, n_super = tlm.layer_pattern(cfg_t)
    assert pattern == (("moe",) if cfg_t.moe_layer_period == 1
                       else ("dense", "moe"))
    j = pattern.index("moe")
    for i in range(n_super):
        block = tparams["blocks"][j][i]
        assert "mlp" not in block
        assert block["moe"]["router"].dtype == torch.float32
        for name in ("wi", "wg", "wo"):
            assert block["moe"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            to_np(block["moe"]["wi"]),
            to_np(params["blocks"][j]["moe"]["wi"][i]))
        np.testing.assert_array_equal(
            block["moe"]["router"].numpy(),
            np.asarray(params["blocks"][j]["moe"]["router"][i]))
    if cfg_t.n_shared_experts:
        shared = tparams["blocks"][j][0]["moe"]["shared"]
        assert shared["wi"].shape == (cfg_t.d_model, cfg_t.d_ff)
        assert shared["wi"].dtype == torch.bfloat16


def test_make_lm_tree_matches_jax(m):
    """The port's random init has the carried tree: names, shapes and
    types, per layer."""
    _, _, tparams, cfg_t = m
    made = tlm.make_lm(torch.Generator().manual_seed(0), cfg_t)
    mine = dict(_leaves(made))
    carried = dict(_leaves(tparams))
    assert sorted(mine) == sorted(carried)
    for name, v in carried.items():
        assert (mine[name].dtype, mine[name].shape) == (v.dtype, v.shape), \
            name


def test_init_decode_state_matches_jax(m):
    _, cfg_j, _, cfg_t = m
    js = jlm.init_decode_state(3, 16, cfg_j)
    ts = tlm.init_decode_state(3, 16, cfg_t, device="cpu")
    got = interop.decode_state(js)
    assert len(ts.caches) == len(got.caches) == len(tlm.layer_pattern(
        cfg_t)[0])
    for a, b in zip(ts.caches, got.caches):
        assert isinstance(a, KVCache)
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert not x.any() and not y.any()
    assert ts.shared_kv is None and torch.equal(ts.length, got.length)


def test_forward_matches_jax_eagerly_on_one_gemm(m):
    """One GEMM on both sides: logits within 1e-5 relative L2 of the
    reference run eagerly, the aux within 1e-6; no kernel on the CPU."""
    params, cfg_j, tparams, cfg_t = m
    toks = tokens(cfg_t, 1, 20)
    with one_gemm():
        fa_ops.reset_launches()
        got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t)
        assert fa_ops.LAUNCHES["flash_attn"] == 0
        with jax.disable_jit():
            want = jlm.forward(params, jnp.asarray(toks), cfg_j)
    err = rel_l2(got.logits, want.logits)
    print(f"{cfg_t.name} eager, one GEMM: relative L2 {err:.3e}")
    assert got.logits.shape == want.logits.shape and got.caches is None
    assert err <= EAGER
    assert got.aux.expert_load.shape == (cfg_t.n_experts,)
    for name, a, b in zip(want.aux._fields, got.aux, want.aux):
        np.testing.assert_allclose(to_np(a), to_np(b), **AUX, err_msg=name)
    # one MoE layer a super-block: its load sums to k
    assert abs(float(got.aux.expert_load.sum())
               - cfg_t.n_experts_active) < 1e-6


def test_forward_matches_jax(m):
    """Against the compiled reference (its default route: attend_ref):
    logits within max(1e-2, 1.5 x the reference's compiled-against-eager
    distance), each aux field within max(1e-6, 1.5 x its own)."""
    params, cfg_j, tparams, cfg_t = m
    toks = tokens(cfg_t, 1, 20)
    got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t)
    want = jlm.forward(params, jnp.asarray(toks), cfg_j)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        flash_attend(mp)
        eager = jlm.forward(params, jnp.asarray(toks), cfg_j)
    witness = rel_l2(eager.logits, want.logits)
    err = rel_l2(got.logits, want.logits)
    bound = max(MODEL, 1.5 * witness)
    print(f"{cfg_t.name} compiled: relative L2 {err:.3e}; the reference's "
          f"compiled against its eager run {witness:.3e}; bound {bound:.3e}")
    assert got.logits.dtype == torch.float32
    assert got.logits.shape == want.logits.shape
    assert err <= bound
    for name, a, b, e in zip(want.aux._fields, got.aux, want.aux,
                             eager.aux):
        a, b, e = to_np(a), to_np(b), to_np(e)
        aux_bound = max(1e-6, 1.5 * float(np.abs(e - b).max()))
        print(f"  {name}: |port - compiled| {np.abs(a - b).max():.3e}, "
              f"bound {aux_bound:.3e}")
        assert float(np.abs(a - b).max()) <= aux_bound, name


def test_forward_returns_the_prefilled_caches(m):
    _, _, tparams, cfg_t = m
    toks = torch.arange(12)[None] % cfg_t.vocab_size
    out = tlm.forward(tparams, toks, cfg_t, return_caches=True, cache_len=32)
    pre = tlm.prefill_caches(tparams, toks, cfg_t, 32)
    for a, b in zip(out.caches.caches, pre.caches):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(out.caches.length, pre.length)
