"""Port congruence: the modality frontends — `frontends.apply_projector`
(vision and audio), `splice_prefix`, internvl2-2b's `lm.forward`,
`prefill_caches` and decode with ``embeds``, its `lm_loss` and gradients
with them — and the draws behind the frontends' synthetic data:
`threefry.normal` (with XLA:CPU's `erf_inv` and `log1p`) and the
synthetic batch's ``embeds`` and mask.

Tolerances and why:
  * `splice_prefix`, `threefry.normal`, `xla_log1p`, `xla_erfinv` and the
    synthetic batch (tokens, labels, mask, embeds): bitwise, under both
    settings of `jax_threefry_partitionable` (0 ulp).
  * The projector against the reference's, called eagerly: one bf16 ulp
    of the value (rtol 2^-7, atol 1e-6), as tests/test_torch_lm.py holds
    the blocks.
  * Whole-model outputs against the reference run eagerly with its
    `attend` on its flash kernel's jnp oracle (f32 probabilities, as the
    port's path keeps them): relative L2 <= 1e-3; against the compiled
    reference (excess f32 precision; `attend_ref` rounds probabilities to
    bf16): max(1e-2, 1.5 x the witness), the witness being the compiled
    reference's distance from its eager run.
  * The loss: 1e-5 relative against the eager reference, 1e-2 against the
    compiled one; gradient leaves within max(1e-2, 1.5 x the leaf's
    witness) of both.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data import synthetic as jsyn
from repro.kernels.flash_attn.ref import attention_ref as jflash_ref
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch._util import tree_leaves
from repro_torch.core import threefry as tf
from repro_torch.data import synthetic as tsyn
from repro_torch.models import frontends as tfront
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from _torch_train import one_thread  # noqa: F401  (autouse fixture)

ARCH = "internvl2-2b"
ULP = dict(atol=1e-6, rtol=2 ** -7)
FLAGS = [True, False]
B, S, STEPS = 2, 16, 3


@contextlib.contextmanager
def both(flag):
    with jax.threefry_partitionable(flag), tf.threefry_partitionable(flag):
        yield


def same_bits(a, b: torch.Tensor):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flash_jnp(q, k, v, *, causal=True, window=None, logit_cap=None,
              use_kernel=False):
    t = lambda x: jnp.swapaxes(x, 1, 2)
    return t(jflash_ref(t(q), t(k), t(v), causal=causal, window=window,
                        logit_cap=logit_cap))


def eager(fn, *args):
    """``fn(*args)`` run by the reference op by op, its `attend` on the
    flash oracle (f32 probabilities)."""
    orig = jattn.attend
    jattn.attend = flash_jnp
    try:
        with jax.disable_jit():
            return fn(*args)
    finally:
        jattn.attend = orig


def held(got, eager_want, compiled_want, what, eager_bound=1e-3):
    d_eager = rel_l2(got, eager_want)
    witness = rel_l2(compiled_want, eager_want)
    d_comp = rel_l2(got, compiled_want)
    assert d_eager <= eager_bound, (what, d_eager)
    assert d_comp <= max(1e-2, 1.5 * witness), (what, d_comp, witness)


# --------------------------------------------------------------------------
# threefry.normal and the synthetic embeds
# --------------------------------------------------------------------------

def test_xla_log1p_and_erfinv_are_xla_cpus():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 400_000),
                        1 - np.exp(rng.uniform(-16, -1, 50_000)),
                        [0.0, 0.5, -0.5, 0.41421354, -0.41421357,
                         1 - 2 ** -24]]).astype(np.float32)
    same_bits(jnp.log1p(-x * x), tf.xla_log1p(torch.from_numpy(-x * x)))
    same_bits(jax.scipy.special.erfinv(x), tf.xla_erfinv(torch.from_numpy(x)))


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("seed, shape", [(0, ()), (7, (7, 33)),
                                         (3, (2, 256, 1024)),
                                         (2**31 - 1, (300_001,))])
def test_normal_is_jax_random_normal(flag, seed, shape):
    """Bitwise (0 ulp) at every shape, under both threefry settings."""
    with both(flag):
        want = jax.random.normal(jax.random.PRNGKey(seed), shape,
                                 jnp.float32)
        got = tf.normal(tf.prng_key(seed), shape)
    same_bits(want, got)


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_synthetic_batch_with_embeds_is_the_reference_bits(flag, arch):
    """tokens, labels, the mask zeroed on the first frontend_len positions
    (for seamless those are decoder positions: the reference's quirk,
    mirrored) and the normal embeds, bitwise."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    with both(flag):
        want = jsyn.make_dataset(cfg_j, 32, 3, seed=5).batch(2)
        got = tsyn.make_dataset(cfg_t, 32, 3, seed=5, device="cpu").batch(2)
    assert set(got) == set(want) == {"tokens", "labels", "mask", "embeds"}
    for k in want:
        same_bits(want[k], got[k])
    assert got["embeds"].shape == (3, cfg_t.frontend_len, cfg_t.frontend_dim)
    assert not bool(got["mask"][:, :cfg_t.frontend_len].any())
    assert bool(got["mask"][:, cfg_t.frontend_len:].all())


# --------------------------------------------------------------------------
# the projector and the splice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_apply_projector_matches_jax(arch):
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    p_j = jfront.make_projector(jax.random.PRNGKey(3), cfg_j, jnp.bfloat16)
    if "b1" in p_j:   # non-zero biases and norm, so that each one shows
        rng = np.random.default_rng(4)
        for k in [k for k in p_j if k.startswith("b")]:
            p_j[k] = jnp.asarray(rng.normal(size=p_j[k].shape), jnp.bfloat16)
        if "norm" in p_j:
            p_j["norm"] = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape),
                                          jnp.float32)
                           for k, v in p_j["norm"].items()}
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(B, cfg_t.frontend_len, cfg_t.frontend_dim)), jnp.bfloat16)
    want = jfront.apply_projector(p_j, x, cfg_j)
    p_t = jax.tree.map(interop.tensor, p_j)
    got = tfront.apply_projector(p_t, interop.tensor(x), cfg_t)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(to_np(got), to_np(want), **ULP)
    made = tfront.make_projector(torch.Generator().manual_seed(0), cfg_t,
                                 torch.bfloat16)
    assert {k: tuple(t.shape) for k, t in tree_leaves(made)} == {
        k: tuple(t.shape) for k, t in tree_leaves(p_t)}


def test_splice_prefix_is_bitwise():
    rng = np.random.default_rng(6)
    toks = jnp.asarray(rng.normal(size=(2, 12, 8)), jnp.bfloat16)
    prefix = jnp.asarray(rng.normal(size=(2, 5, 8)), jnp.bfloat16)
    want = jfront.splice_prefix(toks, prefix)
    got = tfront.splice_prefix(interop.tensor(toks), interop.tensor(prefix))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), to_np(want))


# --------------------------------------------------------------------------
# internvl2-2b with its image prefix
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params_j = jax.jit(lambda k: jlm.make_lm(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    params_t = interop.lm_params(jax.tree.map(np.asarray, params_j), cfg_t)
    batch_t = tsyn.make_dataset(cfg_t, S, B, seed=0, device="cpu").batch(0)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, batch_t=batch_t,
                batch_j={k: jnp.asarray(v.numpy())
                         for k, v in batch_t.items()},
                eager_cfg=dataclasses.replace(cfg_j, remat="none"))


def test_make_lm_draws_the_projector(vlm):
    """`make_lm` draws internvl2's projector: the reference's tree."""
    got = tlm.make_lm(torch.Generator().manual_seed(0), vlm["cfg_t"])
    shape = lambda tree: {p: (tuple(t.shape), t.dtype)
                          for p, t in tree_leaves(tree)}
    assert shape(got) == shape(vlm["params_t"])
    assert set(got["projector"]) == {"norm", "w1", "b1", "w2", "b2"}
    # AdamW decays the projector's matrices, as the reference (ndim >= 2)
    decayed = {p[1] for p, t in tree_leaves(got)
               if p[0] == "projector" and topt.decays(p, t)}
    assert decayed == {"w1", "w2"}


def test_forward_prefill_and_decode_with_embeds_match_jax(vlm):
    """forward's logits, prefill_caches' K/V and STEPS decode steps
    (logits, K/V, lengths) with the image prefix spliced in."""
    cfg_j, cfg_t = vlm["cfg_j"], vlm["cfg_t"]
    pj, bj, bt = vlm["params_j"], vlm["batch_j"], vlm["batch_t"]
    max_len = S + STEPS
    steps = np.random.default_rng(7).integers(
        0, cfg_t.vocab_size, (STEPS, B, 1)).astype(np.int32)

    def run_ref(cfg):
        seen = [jlm.forward(pj, bj["tokens"], cfg,
                            embeds=bj["embeds"]).logits]
        st = jlm.prefill_caches(pj, bj["tokens"], cfg, max_len,
                                embeds=bj["embeds"])
        seen += [st.caches[0].k, st.caches[0].v]
        for i in range(STEPS):
            lg, st = jlm.decode_step(pj, jnp.asarray(steps[i]), st, cfg)
            seen += [lg, st.caches[0].k, st.caches[0].v]
        return seen, st

    want_e, _ = eager(lambda: run_ref(vlm["eager_cfg"]))
    want_c, st_c = jax.jit(lambda: run_ref(cfg_j))()
    pt = vlm["params_t"]
    out = tlm.forward(pt, bt["tokens"], cfg_t, embeds=bt["embeds"])
    got = [out.logits]
    st = tlm.prefill_caches(pt, bt["tokens"], cfg_t, max_len,
                            embeds=bt["embeds"])
    got += [st.caches[0].k.clone(), st.caches[0].v.clone()]
    for i in range(STEPS):
        lg, st = tlm.decode_step(pt, torch.from_numpy(steps[i]), st, cfg_t)
        got += [lg, st.caches[0].k.clone(), st.caches[0].v.clone()]
    names = ["logits", "K", "V"] + [f"{n} {i}" for i in range(STEPS)
                                    for n in ("logits", "K", "V")]
    for name, g, e, c in zip(names, got, want_e, want_c):
        assert g.shape == e.shape, name
        held(g, e, c, name)
    assert np.array_equal(st.length.numpy(), np.asarray(st_c.length))
    # the prefix changes the output: the same tokens without it differ
    plain = tlm.forward(pt, bt["tokens"], cfg_t).logits
    assert rel_l2(plain, out.logits) > 1e-2


def test_lm_loss_with_embeds_matches_jax(vlm):
    """internvl2's lm_loss with the batch's embeds: the value and every
    gradient leaf, the projector's included."""
    cfg_j, cfg_t = vlm["cfg_j"], vlm["cfg_t"]
    bj = vlm["batch_j"]
    vg = lambda cfg: jax.value_and_grad(
        lambda p: jlm.lm_loss(p, bj, cfg)[0])
    loss_e, g_e = eager(vg(vlm["eager_cfg"]), vlm["params_j"])
    loss_c, g_c = jax.jit(vg(cfg_j))(vlm["params_j"])
    metrics, g = tstep.value_and_grad(tstep.make_loss_fn(cfg_t),
                                      vlm["params_t"], vlm["batch_t"])
    loss = float(metrics["loss"])
    assert abs(loss - float(loss_e)) <= 1e-5 * abs(float(loss_e))
    assert abs(loss - float(loss_c)) <= 1e-2 * abs(float(loss_c))

    def leaves(tree):
        return dict(tree_leaves(interop._unstack(
            jax.tree.map(np.asarray, tree), cfg_t, "cpu")))

    got, want_e, want_c = dict(tree_leaves(g)), leaves(g_e), leaves(g_c)
    assert set(got) == set(want_e)
    assert any(p[0] == "projector" for p in got)
    for p in got:
        assert got[p].dtype == want_e[p].dtype, p
        bound = max(1e-2, 1.5 * rel_l2(want_c[p], want_e[p]))
        assert rel_l2(got[p], want_e[p]) <= bound, p
        assert rel_l2(got[p], want_c[p]) <= bound, p
