"""Port congruence: the dense decoder LM — layers, RoPE, projections, the
decode attention with its caches, and prefill + decode of whole models —
against the JAX package, with the reference's parameters carried across by
`interop.lm_params`.

Tolerances and why:
  * Block-level functions run against the reference's own functions called
    eagerly (op by op).  The activations, RoPE and projections then agree
    bitwise in bf16 here; they are held to one bf16 ulp of the value (rtol
    2^-7, atol 1e-6), because XLA:CPU's exp/tanh/rsqrt and the two BLAS
    builds' f32 sums may each round a last f32 bit differently, which can
    move a bf16 rounding.
  * Whole models run against the reference's compiled `prefill_caches` /
    `decode_step` (lax.scan), whose fusions keep excess f32 precision
    between bf16 ops, and whose prefill attention (`attend_ref`) rounds the
    probabilities to bf16 where the port's flash path keeps them in f32.
    K/V caches and logits are held to relative L2 <= 1e-2 (the measured
    worst case is in CHANGES.md); cache lengths are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

ULP = dict(atol=1e-6, rtol=2 ** -7)
DENSE = ("llama3.2-3b", "h2o-danube-1.8b", "stablelm-1.6b", "glm4-9b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    """A JAX array as a torch tensor of the same type (bf16 exactly)."""
    return interop.tensor(x)


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


def _rel_l2(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    x = _bf16((2, 20, 64), 0, 2.0)
    rng = np.random.default_rng(1)
    p = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 64).astype(np.float32)),
         "bias": jnp.asarray(rng.normal(size=64).astype(np.float32))}
    if kind == "rmsnorm":
        del p["bias"]
    want = jlayers.apply_norm(p, x, kind)
    got = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **ULP)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    """The gated MLP, activations written op for op as jax.nn expands them
    (gelu: the tanh approximation with bf16-rounded constants)."""
    p = jlayers.make_mlp(jax.random.PRNGKey(2), 48, 96, jnp.bfloat16)
    x = _bf16((2, 20, 48), 3)
    want = jlayers.apply_mlp(p, x, act)
    got = tlayers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(_np(got), _np(want), **ULP)
    g = _bf16((4096,), 4, 3.0)
    act_j = jax.nn.silu(g) if act == "silu" else jax.nn.gelu(g)
    act_t = tlayers.silu(_t(g)) if act == "silu" else tlayers.gelu_tanh(_t(g))
    np.testing.assert_allclose(_np(act_t), _np(act_j), **ULP)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_apply_rope_matches_jax(fraction):
    x = _bf16((2, 20, 4, 16), 5)
    pos = np.broadcast_to(np.arange(7, 27)[None], (2, 20)).astype(np.int32)
    want = jattn.apply_rope(x, jnp.asarray(pos), fraction, 10_000.0)
    got = tattn.apply_rope(_t(x), torch.from_numpy(pos.copy()), fraction,
                           10_000.0)
    np.testing.assert_allclose(_np(got), _np(want), **ULP)
    rot = int(16 * fraction) // 2 * 2
    assert torch.equal(got[..., rot:], _t(x)[..., rot:])   # pass-through


def _attn_params(cfg, seed):
    """The reference's attention params with non-zero biases."""
    p = jattn.make_attention(jax.random.PRNGKey(seed), cfg, jnp.bfloat16)
    if cfg.qkv_bias:
        for i, name in enumerate(("bq", "bk", "bv")):
            p[name] = _bf16(p[name].shape, seed + i, 0.5)
    return p


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "glm4-9b"])
def test_qkv_project_with_bias_matches_jax(arch):
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    p = _attn_params(cfg_j, 6)
    x = _bf16((2, 12, cfg_j.d_model), 7)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    want = jattn.qkv_project(p, x, cfg_j, jnp.asarray(pos))
    got = tattn.qkv_project({k: _t(v) for k, v in p.items()}, _t(x), cfg_t,
                            torch.from_numpy(pos.copy()))
    for name, w, g in zip("qkv", want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), **ULP, err_msg=name)


@pytest.mark.parametrize("arch,smax,lengths", [
    ("h2o-danube-1.8b", 16, (14, 3)),      # ring cache of the window: wraps
    ("h2o-danube-1.8b", 32, (20, 3)),      # longer than the window: masked
    ("llama3.2-3b", 32, (31, 5)),          # row 0 runs past the cache end
])
def test_self_attention_decode_matches_jax(arch, smax, lengths):
    """Three decode steps through one attention layer from a random cache.
    A write past the cache's end is dropped, as the reference's scatter
    drops it (an idle engine slot's length keeps growing)."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    p = _attn_params(cfg_j, 8)
    tp = {k: _t(v) for k, v in p.items()}
    shape = (2, smax, cfg_j.n_kv_heads, cfg_j.head_dim)
    jc = jattn.KVCache(k=_bf16(shape, 9), v=_bf16(shape, 10),
                       length=jnp.asarray(lengths, jnp.int32))
    tc = tattn.KVCache(k=_t(jc.k), v=_t(jc.v), length=_t(jc.length))
    for step in range(3):
        x = _bf16((2, 1, cfg_j.d_model), 11 + step)
        jo, jc = jattn.self_attention_decode(p, x, cfg_j, jc)
        to, tc = tattn.self_attention_decode(tp, _t(x), cfg_t, tc)
        np.testing.assert_allclose(_np(to), _np(jo), **ULP, err_msg=step)
        np.testing.assert_allclose(_np(tc.k), _np(jc.k), **ULP)
        np.testing.assert_allclose(_np(tc.v), _np(jc.v), **ULP)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_attend_goes_through_the_flash_entry_point():
    """`attend` is the flash entry point (its plain version on the CPU),
    not `attend_ref`; the two differ by attend_ref's bf16 probabilities."""
    q, k, v = (_t(_bf16(s, i)) for i, s in
               enumerate(((1, 40, 6, 16), (1, 40, 2, 16), (1, 40, 2, 16))))
    got = tattn.attend(q, k, v, causal=True, window=24)
    want = flash_ops.flash_attention_plain(q, k, v, causal=True, window=24)
    assert torch.equal(got, want)
    ref = tattn.attend_ref(q, k, v, causal=True, window=24)
    assert _rel_l2(got, ref) < 1e-2


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    rng = np.random.default_rng(0)
    # h2o's window of 16: a 14-token prompt in a 16-slot ring, which the
    # three decode steps wrap
    s, max_len = (14, 16) if cfg_j.sliding_window else (20, 32)
    toks = rng.integers(0, cfg_j.vocab_size, (2, s)).astype(np.int32)
    js = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, max_len)
    ts = tlm.prefill_caches(tparams, torch.from_numpy(toks), cfg_t, max_len)
    errs = {}

    def compare(tag):
        for name in ("k", "v"):
            a, b = getattr(ts.caches[0], name), getattr(js.caches[0], name)
            assert a.shape == b.shape and a.dtype == torch.bfloat16
            errs[f"{tag} {name}"] = _rel_l2(a, b)
        np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))
        np.testing.assert_array_equal(ts.caches[0].length.numpy(),
                                      np.asarray(js.caches[0].length))

    compare("prefill")
    for step in range(3):
        tok = rng.integers(0, cfg_j.vocab_size, (2, 1)).astype(np.int32)
        jl, js = jlm.decode_step(params, jnp.asarray(tok), js, cfg_j)
        tl, ts = tlm.decode_step(tparams, torch.from_numpy(tok), ts, cfg_t)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        errs[f"logits {step}"] = _rel_l2(tl, jl)
        compare(f"decode {step}")
    worst = max(errs.values())
    print(f"{arch}: worst relative L2 {worst:.3e} ({max(errs, key=errs.get)})")
    assert worst <= 1e-2, errs


@pytest.mark.parametrize("arch", ["llama3.2-3b", "h2o-danube-1.8b"])
def test_forward_matches_jax(arch):
    """`lm.forward` on a dense kind: logits to relative L2 <= 1e-2 (the
    whole-model bound above), zero MoE aux as the reference's."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    toks = np.random.default_rng(1).integers(
        0, cfg_j.vocab_size, (2, 20)).astype(np.int32)
    want = jlm.forward(params, jnp.asarray(toks), cfg_j)
    got = tlm.forward(tparams, torch.from_numpy(toks), cfg_t)
    assert got.logits.shape == want.logits.shape
    assert _rel_l2(got.logits, want.logits) <= 1e-2
    for g, w in zip(got.aux, want.aux):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-2b"])
def test_frontend_configs_build_as_the_reference_does(arch):
    """`make_lm` and `init_decode_state` take the frontend configs as the
    reference's do: a decoder tree with the projector (seamless's own
    model is `encdec`: tests/test_torch_encdec.py), and empty caches."""
    cfg = tconfigs.smoke(arch)
    tp, carried = _made_and_carried(arch)
    shapes = lambda tree: [(p, s, d) for p, s, d in _tree_leaves(tree)]
    assert shapes(tp) == shapes(carried)
    assert "projector" in tp
    st = tlm.init_decode_state(2, 16, cfg, device="cpu")
    assert st.caches[0].k.shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                    cfg.head_dim)


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _tree_leaves(x, f"{prefix}/{i}")
    else:
        yield prefix, tuple(tree.shape), tree.dtype


def _made_and_carried(arch):
    """The port's random init of ``arch``'s smoke config, and the
    reference's init carried across."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jp, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tp = tlm.make_lm(torch.Generator().manual_seed(0), cfg_t)
    return tp, interop.lm_params(jax.tree.map(np.asarray, jp), cfg_t)


def test_make_lm_tree_matches_jax():
    """The port's random init has the reference's tree: names, shapes and
    types, per layer."""
    tp, carried = _made_and_carried("stablelm-1.6b")
    assert list(_tree_leaves(tp)) == list(_tree_leaves(carried))


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_moe_kinds_build(arch):
    """The MoE kinds build, with the reference's tree (names, shapes and
    types per layer), the router in float32, and a decode state of one
    attention cache per pattern position."""
    tp, carried = _made_and_carried(arch)
    assert list(_tree_leaves(tp)) == list(_tree_leaves(carried))
    moe_blocks = [b["moe"] for pos in tp["blocks"] for b in pos
                  if "moe" in b]
    assert moe_blocks and all(b["router"].dtype == torch.float32
                              and b["wi"].dtype == torch.bfloat16
                              for b in moe_blocks)
    cfg = tconfigs.smoke(arch)
    st = tlm.init_decode_state(2, 16, cfg, device="cpu")
    assert [type(c) for c in st.caches] == [tattn.KVCache] * len(
        tlm.layer_pattern(cfg)[0])
