"""Port congruence: AdamW (`train.optimizer`) against the reference's
`repro.train.optimizer`, on the reference's own gradients and state
carried across by `interop.train_state`.

The reference runs eagerly (`jax.disable_jit()`: no fused multiply-adds).
With ``clip_norm`` so large that the clip scale is exactly 1, the
learning rate agrees within 1 float32 ulp (XLA's and torch's cos and pow
may round a last bit apart) and the new parameters (bf16, f32 norms) and
moments (f32) within 2 ulp of their type.  With clipping active the
global norm sums its squares in another order (the port's per-layer
leaves split the reference's stacked ones): the norm agrees within 1e-6
relative and every leaf within relative L2 1e-5."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch._util import tree_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.train import optimizer as topt

from _torch_train import one_thread  # noqa: F401  (autouse fixture)

ARCH = "llama3.2-3b"


def ulps(a: np.ndarray, b: np.ndarray, dtype) -> float:
    """max |a - b| in units of the larger ulp of a and b in ``dtype``."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    sp = np.maximum(np.spacing(np.abs(a)), np.spacing(np.abs(b)))
    if dtype == torch.bfloat16:
        sp = sp * 2.0 ** 16
    return float(np.max(np.abs(a - b) / sp))


def rel_l2(a, b) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def port_cfg(cfg: jopt.OptimizerConfig) -> topt.OptimizerConfig:
    return topt.OptimizerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def ref():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params = jax.jit(lambda k: jlm.make_lm(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    ds = tsyn.make_dataset(cfg_t, 32, 2, seed=0, device="cpu")
    grad = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(p, b, cfg_j)[0]))
    grads = [grad(params, {k: jnp.asarray(v.numpy())
                           for k, v in ds.batch(s).items()})
             for s in range(2)]
    return cfg_t, params, grads


def leaves(tree) -> dict:
    return {p: t for p, t in tree_leaves(tree)}


@pytest.mark.parametrize("clip", [1e9, 0.05])
def test_update_matches_reference(ref, clip):
    cfg_t, params, (g0, g1) = ref
    ocfg = jopt.OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=30,
                                clip_norm=clip)
    with jax.disable_jit():
        p1, s1, _ = jopt.update(ocfg, jopt.init(ocfg, params), g0, params)
        p2, s2, m2 = jopt.update(ocfg, s1, g1, p1)
    state = interop.train_state(types.SimpleNamespace(params=p1, opt=s1),
                                cfg_t)
    grads = interop._unstack(jax.tree.map(np.asarray, g1), cfg_t, "cpu")
    tp, ts, tm = topt.update(port_cfg(ocfg), state.opt, grads, state.params)
    assert int(ts.step) == int(s2.step) == 2
    assert ulps(tm["lr"].numpy(), np.asarray(m2["lr"]), torch.float32) <= 1
    gn, want_gn = float(tm["grad_norm"]), float(m2["grad_norm"])
    assert abs(gn - want_gn) <= 1e-6 * want_gn
    assert (clip < want_gn) == (clip == 0.05)   # the clip is active or not
    ref_state = interop.train_state(types.SimpleNamespace(params=p2, opt=s2),
                                    cfg_t)
    for name, got, want in (("params", tp, ref_state.params),
                            ("mu", ts.mu, ref_state.opt.mu),
                            ("nu", ts.nu, ref_state.opt.nu)):
        want = leaves(want)
        for path, t in leaves(got).items():
            w = want[path]
            assert t.dtype == w.dtype, (name, path)
            a, b = t.float().numpy(), w.float().numpy()
            if clip == 1e9:
                assert ulps(a, b, t.dtype) <= 2, (name, path)
            else:
                assert rel_l2(a, b) <= 1e-5, (name, path)


def test_schedule_matches_reference():
    ocfg = jopt.OptimizerConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    with jax.disable_jit():
        want = np.array([jopt.schedule(ocfg, jnp.int32(s))
                         for s in range(60)])
    got = np.array([float(topt.schedule(port_cfg(ocfg),
                                        torch.tensor(s, dtype=torch.int32)))
                    for s in range(60)], np.float32)
    assert ulps(got, want, torch.float32) <= 1


def test_update_is_in_place_and_moments_keep_their_type():
    """`update` writes the given tensors (no second copy of the state) and
    keeps bf16 moments in bf16."""
    cfg = tconfigs.smoke(ARCH)
    from repro_torch.models import lm as tlm

    params = tlm.make_lm(torch.Generator().manual_seed(0), cfg)
    ocfg = topt.OptimizerConfig(moment_dtype="bfloat16")
    state = topt.init(ocfg, params)
    grads = {p: torch.ones_like(t) for p, t in leaves(params).items()}
    from repro_torch._util import map_paths

    gtree = map_paths(lambda p, t: grads[p], params)
    ptrs = {p: t.data_ptr() for p, t in leaves(params).items()}
    before = {p: t.clone() for p, t in leaves(params).items()}
    new_p, new_s, _ = topt.update(ocfg, state, gtree, params)
    for p, t in leaves(new_p).items():
        assert t.data_ptr() == ptrs[p] and not torch.equal(t, before[p]), p
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves(new_s.mu))
    assert int(new_s.step) == 1
