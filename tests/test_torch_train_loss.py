"""Port congruence: the training loss and its gradients — `lm.lm_loss`
and every gradient leaf on llama3.2-3b's smoke config — against the JAX
package, with the reference's parameters carried across by
`interop.lm_params` (remat, the decayed leaves and flash attention's
backward: tests/test_torch_train_grad.py).

Tolerances and why:
  * Eager: the reference under `jax.disable_jit()`, its `attend` routed
    to the flash kernel's jnp oracle (`repro.kernels.flash_attn.ref`,
    f32 probabilities, as the port's plain path keeps them; the
    reference's `attend_ref` rounds them to bf16).  The loss is held to
    1e-5 relative and each gradient leaf to relative L2 1e-2 (bf16
    activations: XLA's and torch's f32 GEMM sums round to bf16 at other
    last bits).
  * Compiled: `jax.jit` of the reference as it trains (`attend_ref`),
    whose fusions keep excess f32 precision between bf16 ops.  Each leaf
    is held to max(1e-2, 1.5 x the witness): the witness is the compiled
    reference's own distance from the eager run above, computed here.
The reference runs eagerly without remat (the same numbers: remat only
recomputes), a third of the time of an eager run with it.
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
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch._util import tree_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.train import step as tstep

from _torch_train import one_thread  # noqa: F401  (autouse fixture)

ARCH = "llama3.2-3b"


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


def ref_leaves(grads_j, cfg):
    """The reference's gradient tree in the port's layout: {path: array}."""
    return dict(tree_leaves(interop._unstack(
        jax.tree.map(np.asarray, grads_j), cfg, "cpu")))


@pytest.fixture(scope="module")
def model():
    """The reference's parameters and batch, its eager (flash-routed) and
    compiled losses and gradients, and the port's."""
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params_j = jax.jit(lambda k: jlm.make_lm(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    # the port's batch, which is bitwise the reference's
    # (tests/test_torch_train_data.py)
    batch_t = tsyn.make_dataset(cfg_t, 32, 2, seed=0, device="cpu").batch(0)
    batch_j = {k: jnp.asarray(v.numpy()) for k, v in batch_t.items()}
    loss_j = jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg_j)[0])
    compiled = jax.jit(loss_j)(params_j, batch_j)
    # eagerly without remat: the same numbers, a third of the time
    eager_cfg = dataclasses.replace(cfg_j, remat="none")
    orig = jattn.attend
    jattn.attend = flash_jnp
    try:
        with jax.disable_jit():
            eager = jax.value_and_grad(
                lambda p, b: jlm.lm_loss(p, b, eager_cfg)[0])(params_j,
                                                              batch_j)
    finally:
        jattn.attend = orig
    params_t = interop.lm_params(params_j, cfg_t)
    metrics, grads_t = tstep.value_and_grad(
        tstep.make_loss_fn(cfg_t), params_t, batch_t)
    return dict(cfg=cfg_t, params_j=params_j, params_t=params_t,
                batch_t=batch_t, eager=eager, compiled=compiled,
                loss_t=metrics["loss"], grads_t=dict(tree_leaves(grads_t)))


def test_loss_matches_eager_jax(model):
    want = float(model["eager"][0])
    got = float(model["loss_t"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_gradients_match_eager_jax(model):
    want = ref_leaves(model["eager"][1], model["cfg"])
    got = model["grads_t"]
    assert set(want) == set(got)
    dist = {p: rel_l2(got[p], want[p]) for p in got}
    worst = max(dist, key=dist.get)
    print(f"worst gradient leaf vs eager JAX: {worst} {dist[worst]:.3e}")
    for p in got:
        assert got[p].dtype == want[p].dtype, p
        assert dist[p] <= 1e-2, (p, dist[p])


def test_gradients_match_compiled_jax(model):
    """Against the compiled reference as it trains; the bound follows the
    witness (the compiled reference's distance from its eager run)."""
    cfg = model["cfg"]
    eager = ref_leaves(model["eager"][1], cfg)
    compiled = ref_leaves(model["compiled"][1], cfg)
    got = model["grads_t"]
    rows = []
    for p in got:
        witness = rel_l2(compiled[p], eager[p])
        bound = max(1e-2, 1.5 * witness)
        rows.append((rel_l2(got[p], compiled[p]), bound, witness, p))
    worst = max(rows)
    print(f"worst gradient leaf vs compiled JAX: {worst[3]} {worst[0]:.3e} "
          f"(witness {worst[2]:.3e}, bound {worst[1]:.3e})")
    for d, bound, witness, p in rows:
        assert d <= bound, (p, d, witness)
    want = float(model["compiled"][0])
    assert abs(float(model["loss_t"]) - want) <= 1e-2 * abs(want)
