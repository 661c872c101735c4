"""Port congruence: the encoder-decoder (seamless-m4t-large-v2's smoke
config) — `attention.cross_attention` / `encode_kv`, `encdec.encode`,
`forward`, `init_encdec_state` and `decode_step`, `encdec_loss` and its
gradients, and one `train.step` — against the JAX package, with the
reference's parameters carried across by `interop.encdec_params`.

Tolerances and why:
  * Block-level functions run against the reference's own, called
    eagerly: one bf16 ulp of the value (rtol 2^-7, atol 1e-6), as in
    tests/test_torch_lm.py.
  * `encode` against the reference's `encode(use_kernel=True)` (its
    Pallas flash kernel in interpret mode, f32 probabilities, which is
    what the port's B5 and its plain version compute), run eagerly:
    relative L2 <= 1e-5 (bitwise here).  Against its
    `encode(use_kernel=False)` (`attend_ref`, probabilities rounded to
    bf16), compiled: max(1e-2, 1.5 x the witness), the witness being the
    reference's own distance between its two paths.
  * Whole-model outputs are held twice.  Against the reference run
    eagerly with its `attend` on its flash kernel's jnp oracle (f32
    probabilities, as the port's path keeps them): relative L2 <= 1e-3
    (bf16 activations whose f32 GEMM sums round at other last bits).
    Against the compiled reference (lax.scan, whose fusions keep excess
    f32 precision; `attend_ref` in bf16): max(1e-2, 1.5 x the witness),
    the witness being the compiled reference's distance from its eager
    run.  Lengths are equal.
  * The loss: 1e-5 relative against the eager reference, 1e-2 against the
    compiled one.  Gradient leaves: against the eager reference, relative
    L2 <= max(1e-2, 1.5 x an eager witness, the eager reference's own
    distance between its bf16 run and the same run with f32 activations);
    against the compiled one, max(1e-2, 1.5 x the compiled reference's
    distance from its eager run).  A gradient that flows back through the
    decoder's cross-attention into the encoder carries the bf16 rounding
    of every block on its way: the eager reference's bf16 gradient sits
    1.0-1.3e-2 from its f32 one on the first encoder block's leaves and
    the projector, and the port's distance from the eager run, 1.0e-2 at
    worst (the first encoder block's wk), is at most ~0.6 of its bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels.flash_attn.ref import attention_ref as jflash_ref
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import interop
from repro_torch._util import tree_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from _torch_train import one_thread  # noqa: F401  (autouse fixture)

ARCH = "seamless-m4t-large-v2"
ULP = dict(atol=1e-6, rtol=2 ** -7)
B, S, STEPS, MAX_LEN = 2, 16, 3, 8


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flash_jnp(q, k, v, *, causal=True, window=None, logit_cap=None,
              use_kernel=False):
    """The reference's `attend` as its flash kernel computes it (f32
    probabilities), in jnp so that JAX can differentiate it."""
    t = lambda x: jnp.swapaxes(x, 1, 2)
    return t(jflash_ref(t(q), t(k), t(v), causal=causal, window=window,
                        logit_cap=logit_cap))


def eager(fn, *args):
    """``fn(*args)`` run by the reference op by op, its `attend` on the
    flash oracle."""
    orig = jattn.attend
    jattn.attend = flash_jnp
    try:
        with jax.disable_jit():
            return fn(*args)
    finally:
        jattn.attend = orig


def held(got, eager_want, compiled_want, what):
    """The port against the eager reference (1e-3) and the compiled one
    (max(1e-2, 1.5 x the compiled reference's distance from eager))."""
    d_eager = rel_l2(got, eager_want)
    witness = rel_l2(compiled_want, eager_want)
    d_comp = rel_l2(got, compiled_want)
    assert d_eager <= 1e-3, (what, d_eager)
    assert d_comp <= max(1e-2, 1.5 * witness), (what, d_comp, witness)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params_j = jax.jit(lambda k: jencdec.make_encdec(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    params_t = interop.encdec_params(jax.tree.map(np.asarray, params_j),
                                     cfg_t)
    rng = np.random.default_rng(0)
    embeds = rng.normal(size=(B, cfg_t.frontend_len, cfg_t.frontend_dim)
                        ).astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, embeds=embeds, tokens=tokens,
                eager_cfg=dataclasses.replace(cfg_j, remat="none"))


def test_make_encdec_tree_matches_the_reference(model):
    """The port's random init has the reference's tree, shapes and types
    (blocks as per-layer lists; no unembed when embeddings are tied)."""
    cfg = model["cfg_t"]
    got = tencdec.make_encdec(torch.Generator().manual_seed(0), cfg)
    shape = lambda tree: {p: (tuple(t.shape), t.dtype)
                          for p, t in tree_leaves(tree)}
    assert shape(got) == shape(model["params_t"])
    assert len(got["enc_blocks"]) == cfg.n_encoder_layers
    assert len(got["dec_blocks"]) == cfg.n_layers
    tied = tencdec.make_encdec(torch.Generator().manual_seed(0),
                               dataclasses.replace(cfg, tie_embeddings=True))
    assert "unembed" not in tied and "unembed" in got


def test_decayed_leaves_and_norm_order_are_the_references(model):
    """AdamW decays the reference's leaves with ndim >= 2, its blocks
    stacked over layers (a block's norm scale is decayed, enc_norm's is
    not), and the global norm sums the leaves in the reference's
    `jax.tree.leaves` order: the port's per-layer leaves give the same set
    and order."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    shapes = jax.eval_shape(lambda k: jencdec.make_encdec(k, cfg_j)[0],
                            jax.random.PRNGKey(0))
    layers = {"enc_blocks": cfg_t.n_encoder_layers,
              "dec_blocks": cfg_t.n_layers}
    want, order = set(), []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        paths = ([(keys[0], i, *keys[1:]) for i in range(layers[keys[0]])]
                 if keys[0] in layers else [keys])
        order += paths
        if len(leaf.shape) >= 2:
            want |= set(paths)
    params = model["params_t"]
    assert {p for p, t in tree_leaves(params) if topt.decays(p, t)} == want
    assert ("enc_blocks", 0, "ln1", "scale") in want
    assert ("enc_norm", "scale") not in want
    assert topt.ref_order(params) == order


def test_cross_attention_and_encode_kv_match_jax(model):
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    p_j = model["params_j"]["dec_blocks"]["cross"]
    p_j = jax.tree.map(lambda x: x[0], p_j)
    p_t = model["params_t"]["dec_blocks"][0]["cross"]
    rng = np.random.default_rng(1)
    enc = jnp.asarray(rng.normal(size=(B, 24, cfg_t.d_model)),
                      jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(B, S, cfg_t.d_model)), jnp.bfloat16)
    with jax.disable_jit():
        kv_j = jattn.encode_kv(p_j, enc, cfg_j)
        out_j = jattn.cross_attention(p_j, x, kv_j, cfg_j)
    kv_t = tattn.encode_kv(p_t, interop.tensor(enc), cfg_t)
    out_t = tattn.cross_attention(p_t, interop.tensor(x), kv_t, cfg_t)
    for got, want in zip((*kv_t, out_t), (*kv_j, out_j)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        np.testing.assert_allclose(to_np(got), to_np(want), **ULP)


def test_encode_matches_both_reference_paths(model):
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    emb = jnp.asarray(model["embeds"])
    got = tencdec.encode(model["params_t"], torch.from_numpy(model["embeds"]),
                         cfg_t)
    with jax.disable_jit():
        kern = jencdec.encode(model["params_j"], emb, cfg_j, use_kernel=True)
    plain = jax.jit(lambda p, e: jencdec.encode(p, e, cfg_j))(
        model["params_j"], emb)
    assert got.shape == kern.shape and got.dtype == torch.bfloat16
    assert rel_l2(got, kern) <= 1e-5
    witness = rel_l2(plain, kern)
    assert rel_l2(got, plain) <= max(1e-2, 1.5 * witness), (
        rel_l2(got, plain), witness)


def test_init_state_and_decode_steps_match_jax(model):
    """init_encdec_state's cross K/V, then STEPS decode steps: logits and
    the self-attention caches, against the reference eager and compiled."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    pj, emb = model["params_j"], jnp.asarray(model["embeds"])
    toks = model["tokens"][:, :STEPS]

    def run_ref(init, step):
        st = init(pj, emb)
        seen = [st.cross_k, st.cross_v]
        for i in range(STEPS):
            lg, st = step(pj, jnp.asarray(toks[:, i:i + 1]), st)
            seen += [lg, st.self_kv.k, st.self_kv.v]
        return seen, st

    ecfg = model["eager_cfg"]
    want_e, _ = eager(lambda: run_ref(
        lambda p, e: jencdec.init_encdec_state(p, e, ecfg, MAX_LEN),
        lambda p, t, s: jencdec.decode_step(p, t, s, ecfg)))
    want_c, st_c = run_ref(
        jax.jit(lambda p, e: jencdec.init_encdec_state(p, e, cfg_j, MAX_LEN)),
        jax.jit(lambda p, t, s: jencdec.decode_step(p, t, s, cfg_j)))

    st = tencdec.init_encdec_state(model["params_t"],
                                   torch.from_numpy(model["embeds"]), cfg_t,
                                   MAX_LEN)
    assert st.self_kv.k.shape == (cfg_t.n_layers, B, MAX_LEN,
                                  cfg_t.n_kv_heads, cfg_t.head_dim)
    cross0 = st.cross_k.clone()
    got = [st.cross_k, st.cross_v]
    for i in range(STEPS):
        lg, st = tencdec.decode_step(model["params_t"],
                                     torch.from_numpy(toks[:, i:i + 1]), st,
                                     cfg_t)
        got += [lg, st.self_kv.k.clone(), st.self_kv.v.clone()]
    names = ["cross K", "cross V"] + [f"{n} {i}" for i in range(STEPS)
                                      for n in ("logits", "self K", "self V")]
    for name, g, e, c in zip(names, got, want_e, want_c):
        assert g.shape == e.shape, name
        held(g, e, c, name)
    assert torch.equal(st.cross_k, cross0)   # read, never written
    assert np.array_equal(st.length.numpy(), np.asarray(st_c.length))
    assert np.array_equal(st.self_kv.length.numpy(),
                          np.asarray(st_c.self_kv.length))
    assert st.self_kv.length.shape == (cfg_t.n_layers, B)
    # the first decoded token sits at position 0 of the self cache
    assert not bool((st.self_kv.k[:, :, STEPS:] != 0).any())


def test_encdec_state_crosses_over(model):
    cfg_j = model["cfg_j"]
    st_j = jax.jit(lambda p, e: jencdec.init_encdec_state(p, e, cfg_j,
                                                          MAX_LEN))(
        model["params_j"], jnp.asarray(model["embeds"]))
    st_t = interop.encdec_state(jax.tree.map(np.asarray, st_j))
    assert st_t.cross_k.dtype == torch.bfloat16
    assert st_t.self_kv.length.dtype == torch.int32
    np.testing.assert_array_equal(to_np(st_t.cross_v), to_np(st_j.cross_v))


@pytest.fixture(scope="module")
def grads(model):
    """The logits, loss and gradients of one synthetic batch (the port's,
    bitwise the reference's: tests/test_torch_frontends.py) with an
    all-ones mask, so that every decoder position counts: the reference's
    eager (flash-routed) and compiled ones, and the port's; and the eager
    reference's gradients with f32 activations and weights, its bf16 run's
    witness."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    batch_t = tsyn.make_dataset(cfg_t, 32, B, seed=0, device="cpu").batch(0)
    batch_t["mask"] = torch.ones_like(batch_t["mask"])
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in batch_t.items()}

    def loss_and_logits(cfg):
        def fn(p):
            logits = jencdec.forward(p, batch_j["tokens"], batch_j["embeds"],
                                     cfg)
            ce = jax.nn.logsumexp(logits, axis=-1) - jnp.take_along_axis(
                logits, batch_j["labels"][..., None], axis=-1)[..., 0]
            # encdec_loss's cross entropy, the logits kept beside it
            return jnp.sum(ce * batch_j["mask"]) / jnp.maximum(
                jnp.sum(batch_j["mask"]), 1.0), logits
        return jax.value_and_grad(fn, has_aux=True)

    (loss_e, logits_e), g_e = eager(loss_and_logits(model["eager_cfg"]),
                                    model["params_j"])
    (loss_c, logits_c), g_c = jax.jit(loss_and_logits(cfg_j))(
        model["params_j"])
    act = jlm.ACT_DTYPE
    jlm.ACT_DTYPE = jencdec.ACT_DTYPE = jnp.float32
    try:
        _, g_e32 = eager(loss_and_logits(model["eager_cfg"]),
                         jax.tree.map(lambda x: x.astype(jnp.float32),
                                      model["params_j"]))
    finally:
        jlm.ACT_DTYPE = jencdec.ACT_DTYPE = act
    metrics, g = tstep.value_and_grad(tstep.make_loss_fn(cfg_t),
                                      model["params_t"], batch_t)
    logits = tencdec.forward(model["params_t"], batch_t["tokens"],
                             batch_t["embeds"], cfg_t)

    def leaves(tree):
        return dict(tree_leaves(interop.encdec_params(
            jax.tree.map(np.asarray, tree), cfg_t)))

    return dict(loss=float(metrics["loss"]), grads=dict(tree_leaves(g)),
                loss_e=float(loss_e), loss_c=float(loss_c),
                grads_e=leaves(g_e), grads_c=leaves(g_c),
                grads_e32=leaves(g_e32), batch_t=batch_t,
                logits=logits, logits_e=logits_e, logits_c=logits_c)


def test_forward_logits_match_jax(model, grads):
    cfg = model["cfg_t"]
    got = grads["logits"]
    assert got.shape == (B, 32, cfg.vocab_size) and got.dtype == torch.float32
    held(got, grads["logits_e"], grads["logits_c"], "logits")


def test_encdec_loss_matches_jax(grads):
    assert abs(grads["loss"] - grads["loss_e"]) <= 1e-5 * abs(grads["loss_e"])
    assert abs(grads["loss"] - grads["loss_c"]) <= 1e-2 * abs(grads["loss_c"])


def test_encdec_gradients_match_jax(grads):
    got, want_e, want_c = grads["grads"], grads["grads_e"], grads["grads_c"]
    assert set(got) == set(want_e)
    rows = []
    for p in got:
        assert got[p].dtype == want_e[p].dtype, p
        bound_e = max(1e-2, 1.5 * rel_l2(want_e[p], grads["grads_e32"][p]))
        bound_c = max(1e-2, 1.5 * rel_l2(want_c[p], want_e[p]))
        rows.append((rel_l2(got[p], want_e[p]), bound_e,
                     rel_l2(got[p], want_c[p]), bound_c, p))
    print("leaf: vs eager JAX (bound), vs compiled JAX (bound)")
    for row in sorted(rows, key=lambda r: -r[0]):
        print("  %.3e (%.3e)  %.3e (%.3e)  %s" % row)
    for d_e, bound_e, d_c, bound_c, p in rows:
        assert d_e <= bound_e, (p, d_e, bound_e)
        assert d_c <= bound_c, (p, d_c, bound_c)


def test_one_train_step_matches_the_reference_loss(model, grads):
    """`train.step`'s balanced step on seamless smoke, from the reference's
    own initial state: its loss against the reference's step's (1e-2
    relative: compiled), the step counter advanced, every parameter
    finite and moved."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    ocfg_j = jopt.OptimizerConfig(warmup_steps=1, total_steps=10)
    ocfg_t = topt.OptimizerConfig(warmup_steps=1, total_steps=10)
    state_j, _ = jstep.init_train_state(jax.random.PRNGKey(0), cfg_j, ocfg_j)
    batch_t = grads["batch_t"]
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in batch_t.items()}
    _, m_j = jax.jit(jstep.make_train_step(cfg_j, ocfg_j))(state_j, batch_j)
    state_t = interop.train_state(jax.tree.map(np.asarray, state_j), cfg_t)
    before = {p: t.clone() for p, t in tree_leaves(state_t.params)}
    new, m_t = tstep.make_train_step(cfg_t, ocfg_t)(state_t, batch_t)
    want = float(m_j["loss"])
    assert abs(float(m_t["loss"]) - want) <= 1e-2 * abs(want)
    assert int(new.opt.step) == 1
    for p, t in tree_leaves(new.params):
        assert bool(torch.isfinite(t.float()).all()), p
    assert any(not torch.equal(t, before[p])
               for p, t in tree_leaves(new.params))
