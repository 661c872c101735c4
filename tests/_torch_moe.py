"""Helpers of the MoE congruence tests (tests/test_torch_moe.py,
test_torch_moe_lm.py, test_torch_moe_decode.py and the Engine's
test_torch_serve_grok.py / test_torch_serve_maverick.py): the two MoE
smoke models, a spy that reads the reference's routing out of its own
`_moe_group`, one GEMM for both packages' expert products, the
prefill-and-decode runs of either package, and the Engine comparison.

The reference's expert products are `jnp.einsum`s with f32 accumulation
(`src/repro/models/moe.py:129-135`), not its `layers.matmul`;
`one_gemm` routes them, the reference's `layers.matmul` and the port's
`layers.matmul` through one float64-accumulated product (the helpers of
tests/_torch_hybrid.py), so that a comparison sees everything else.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import batching as jbatch
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve import batching as tbatch
from repro_torch.serve import engine as tengine

from _torch_hybrid import (_exact, flash_attend, jax_matmul, rel_l2, to_np,
                           torch_matmul)

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
EXPERT_SPECS = ("ecd,edf->ecf", "ecf,efd->ecd")


def model(arch):
    """(params, cfg_j, tparams, cfg_t): the reference's smoke model and
    its parameters carried into the port."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


def moe_params(tree, device="cpu"):
    """A reference MoE layer's parameter dict in the port (leaf types
    kept: the router f32, the experts in the parameter type)."""
    return {k: moe_params(v, device) if isinstance(v, dict)
            else interop.tensor(v, device) for k, v in tree.items()}


def _exact_einsum(spec, a, b, preferred_element_type=None):
    out = jax.eval_shape(lambda x, y: jnp.einsum(
        spec, x, y, preferred_element_type=jnp.float32), a, b)
    return jax.pure_callback(
        lambda x, y: _exact(np.asarray(x, np.float32),
                            np.asarray(y, np.float32), spec),
        out, a.astype(jnp.float32), b.astype(jnp.float32),
        vmap_method="sequential")   # the reference vmaps its groups


class _Jnp(types.SimpleNamespace):
    """`jax.numpy` as the reference's moe module sees it, with its expert
    einsums on one float64-accumulated product when ``exact``, and its two
    `where`s recorded (the kept gates, then the kept positions)."""

    def __init__(self, exact: bool):
        super().__init__(exact=exact, wheres=[])

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if self.exact and spec in EXPERT_SPECS:
            return _exact_einsum(spec, *ops, **kw)
        return jnp.einsum(spec, *ops, **kw)

    def where(self, *args):
        out = jnp.where(*args)
        self.wheres.append(out)
        return out


@contextlib.contextmanager
def reference_moe(exact: bool = False):
    """Within: the reference's moe module on the `_Jnp` spy (yielded), and
    `jax.lax.top_k`'s outputs recorded in ``spy.top_k``."""
    spy = _Jnp(exact)
    spy.top_k = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = top_k(x, k)
        spy.top_k.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "jnp", spy)
        mp.setattr(jax.lax, "top_k", recording_top_k)
        yield spy


def reference_routes(p, xt, cfg):
    """The reference's `_moe_group` on one group xt (Tg, D), run eagerly:
    (expert (k*Tg,) slot-major, gate (k*Tg,), pos (k*Tg,), keep (k*Tg,))
    as its own arrays hold them."""
    with reference_moe() as spy, jax.disable_jit():
        jmoe._moe_group(p, xt, cfg)
    (_, idx), = spy.top_k
    gate, pos = spy.wheres
    expert = np.asarray(idx).T.reshape(-1)
    pos = np.asarray(pos)
    return expert, np.asarray(gate), pos, pos < jmoe._capacity(xt.shape[0],
                                                               cfg)


@contextlib.contextmanager
def one_gemm():
    """Both packages on one GEMM (the reference's expert einsums, its
    `layers.matmul` and the port's), the reference's attention on its
    flash kernel (f32 probabilities, as the port's flash path)."""
    with pytest.MonkeyPatch.context() as mp, reference_moe(exact=True):
        mp.setattr(jlayers, "matmul", jax_matmul)
        mp.setattr(tlayers, "matmul", torch_matmul)
        flash_attend(mp)
        yield


def tokens(cfg, seed: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)


def state_fields(st) -> dict:
    """Every attention cache of a decode state, by pattern position."""
    out = {}
    for j, c in enumerate(st.caches):
        out[f"k{j}"], out[f"v{j}"] = c.k, c.v
    return out


def prefill_decode(m, toks, eager_jax: bool, n_steps: int = 3):
    """Prefill (cache 32) and n_steps decode steps on seeded tokens, in
    each package: ({field: array} of the reference, of the port), the
    logits of each step and every cache after each (numpy copies: the
    port's decode_step writes its caches in place); the reference runs
    eagerly when ``eager_jax``."""
    params, cfg_j, tparams, cfg_t = m
    ctx = jax.disable_jit if eager_jax else contextlib.nullcontext
    rng = np.random.default_rng(100 + toks.shape[1])
    steps = rng.integers(0, cfg_j.vocab_size, (n_steps, 2, 1)).astype(
        np.int32)

    def seen_of(st, tag, seen):
        seen.update({f"{tag} {k}": to_np(v).copy()
                     for k, v in state_fields(st).items()})

    with ctx():
        js = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)
    ts = tlm.prefill_caches(tparams, torch.from_numpy(toks), cfg_t, 32)
    want, got = {}, {}
    seen_of(js, "prefill", want)
    seen_of(ts, "prefill", got)
    for t, tok in enumerate(steps):
        with ctx():
            jl, js = jlm.decode_step(params, jnp.asarray(tok), js, cfg_j)
        tl, ts = tlm.decode_step(tparams, torch.from_numpy(tok), ts, cfg_t)
        want[f"logits {t}"], got[f"logits {t}"] = to_np(jl), to_np(tl)
        seen_of(js, f"decode {t}", want)
        seen_of(ts, f"decode {t}", got)
    np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))
    for a, b in zip(ts.caches, js.caches):
        np.testing.assert_array_equal(a.length.numpy(), np.asarray(b.length))
    return want, got


def worst(got: dict, want: dict) -> tuple[str, float]:
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    k = max(errs, key=errs.get)
    return k, errs[k]


def compile_witness(m, toks) -> tuple[dict, str, float]:
    """The reference's compiled prefill + 3 decode steps on ``toks``, and
    its worst distance (field, relative L2) from the same calls run
    eagerly with its attention on the flash kernel."""
    want, _ = prefill_decode(m, toks, eager_jax=False)
    with pytest.MonkeyPatch.context() as mp:
        flash_attend(mp)
        eager, _ = prefill_decode(m, toks, eager_jax=True)
    return (want, *worst(eager, want))


# the Engine runs: a small workload with few prompt lengths (the JAX Engine
# compiles its prefill per prompt length) on which the KF boosts
WORKLOAD = dict(n_requests=12, mean_prompt=8, mean_gen=6, burst_rate=8.0,
                calm_rate=0.1, seed=1)
ENGINE = dict(max_slots=4, max_len=32, budget_tokens=16, warmup_iters=2)
MODES = ("kf", "rr", "static")


def jax_engine_runs(m) -> dict:
    """One JAX Engine run per mode: its stats and its final decode state
    carried into the port."""
    params, cfg_j, _, _ = m
    runs = {}
    for mode in MODES:
        eng = jengine.Engine(params, cfg_j,
                             jengine.EngineConfig(mode=mode, **ENGINE))
        stats = eng.run(jbatch.generate(jbatch.WorkloadConfig(**WORKLOAD)),
                        max_iters=600)
        runs[mode] = stats, interop.decode_state(eng.state)
    return runs


def engine_matches(m, runs, mode, bound):
    """The port's Engine on the CPU: its statistics equal to the JAX
    Engine's, the caches the run leaves within ``bound`` relative L2 of
    the JAX run's, the cleared slots zero, every slot finite."""
    _, _, tparams, cfg_t = m
    want, want_state = runs[mode]
    eng = tengine.Engine(tparams, cfg_t,
                         tengine.EngineConfig(mode=mode, **ENGINE),
                         device="cpu")
    got = eng.run(tbatch.generate(tbatch.WorkloadConfig(**WORKLOAD)),
                  max_iters=600)
    assert got.configs == want.configs
    assert got.kf_signals == want.kf_signals
    assert (got.iters, got.clock) == (want.iters, want.clock)
    assert [(r.rid, r.t_first_token, r.t_done, r.tokens_out, r.prompt_len)
            for r in got.finished] == \
        [(r.rid, r.t_first_token, r.t_done, r.tokens_out, r.prompt_len)
         for r in want.finished]
    assert got.summary() == want.summary()
    assert got.summary()["n_finished"] == WORKLOAD["n_requests"]
    if mode == "kf":
        assert 0 < sum(got.configs) < len(got.configs)

    assert torch.equal(eng.state.length, want_state.length)
    errs = {}
    for j, (c, w) in enumerate(zip(eng.state.caches, want_state.caches)):
        assert torch.equal(c.length, w.length)
        errs[f"k{j}"] = rel_l2(c.k, w.k)
        errs[f"v{j}"] = rel_l2(c.v, w.v)
    name = max(errs, key=errs.get)
    print(f"{cfg_t.name} {mode}: caches worst relative L2 "
          f"{errs[name]:.3e} ({name}; bound {bound:.3e})")
    assert errs[name] <= bound, errs
    cleared = (eng.state.length == 0).nonzero().flatten().tolist()
    assert cleared
    for c in eng.state.caches:
        for slot in cleared:
            assert not c.k[:, slot].any() and not c.v[:, slot].any()
        assert bool(torch.isfinite(c.k.float()).all())
