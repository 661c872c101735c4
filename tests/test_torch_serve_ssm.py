"""Port congruence: the serving path on falcon-mamba (Mamba1 conv rings and
SSM states as the decode caches) and on zamba2 (Mamba2 states, and the
shared attention block's `shared_kv`) against the JAX package — the slot
algebra, the KF-arbitrated Engine (falcon-mamba in modes kf and rr,
zamba2 in kf, rr and static), and the serve launcher.

The Engine's statistics are held EQUAL (the reference prefills all-zero
prompts and decodes a token buffer it never updates, so its schedule
depends only on the workload, the EngineConfig and the cache lengths).
The caches left after a run are held to the JAX run's to relative L2
<= 1e-2 (the model-level bound, tests/test_torch_mamba.py).  Every slot
is decoded each step, idle ones too, as in the reference, so an idle
slot's state moves on after `clear_slot`; the slots cleared in the last
iteration are zero, and every slot stays finite and bounded.  The
workload is small, with four prompt lengths (8 and ragged 9, 13, 18),
because the JAX Engine compiles its prefill per call; its KF boosts 7 of
29 iterations.  On zamba2 `clear_slot` leaves `shared_kv` as it is, as
the reference's does, and the run's shared K/V are held like the other
caches; its caches are held to max(1e-2, 1.5 x the reference's own
compiled-against-eager distance), the bound of tests/test_torch_hybrid.py,
there measured at the logits and caches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch import serve as jlaunch
from repro.models import lm as jlm
from repro.serve import batching as jbatch
from repro.serve import cache as jcache
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.mamba import Mamba1State, Mamba2State
from repro_torch.serve import batching as tbatch
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine

from _torch_hybrid import compile_witness

ARCH = "falcon-mamba-7b"
HYBRID = "zamba2-2.7b"
WORKLOAD = dict(n_requests=12, mean_prompt=8, mean_gen=6, burst_rate=8.0,
                calm_rate=0.1, seed=1)
ENGINE = dict(max_slots=4, max_len=32, budget_tokens=16, warmup_iters=2)


def _rel_l2(a, b):
    a, b = a.double().numpy(), b.double().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _model(arch):
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


@pytest.fixture(scope="module")
def model():
    return _model(ARCH)


@pytest.fixture(scope="module")
def hybrid():
    return _model(HYBRID)


def _insert_clear(model, state_type):
    """insert_request into slots 2 and 0, then clear_slot(2), on both
    packages from one prefilled state: every cache leaf, the lengths and
    the occupancy equal after each.  Returns the port's final state."""
    params, cfg_j, _, cfg_t = model
    toks = np.arange(1, 12, dtype=np.int32)[None]
    jpre = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)
    tpre = interop.decode_state(jpre)          # the same prefilled state
    js = jlm.init_decode_state(4, 32, cfg_j)
    ts = tlm.init_decode_state(4, 32, cfg_t, device="cpu")
    assert all(isinstance(c, state_type) for c in tpre.caches)

    def same():
        got = interop.decode_state(js)
        for mine, carried in zip(ts.caches, got.caches):
            for a, b in zip(mine, carried):
                assert torch.equal(a, b)
        assert (ts.shared_kv is None) == (got.shared_kv is None)
        if ts.shared_kv is not None:
            for a, b in zip(ts.shared_kv, got.shared_kv):
                assert torch.equal(a, b)
        assert torch.equal(ts.length, got.length)
        assert tcache.kv_occupancy(ts, 32) == jcache.kv_occupancy(js, 32)

    for slot in (2, 0):
        js = jcache.insert_request(js, jpre, slot)
        ts = tcache.insert_request(ts, tpre, slot)
        same()
    assert ts.caches[0].ssm[:, 2].any() and ts.caches[0].conv[:, 0].any()
    assert tcache.kv_occupancy(ts, 32) == 22 / 128
    js = jcache.clear_slot(js, 2)
    ts = tcache.clear_slot(ts, 2)
    same()
    assert int(ts.length[2]) == 0
    for c in ts.caches:
        assert not c.ssm[:, 2].any() and not c.conv[:, 2].any()
    return ts


def test_insert_clear_and_occupancy_match_jax(model):
    _insert_clear(model, Mamba1State)


def test_insert_clear_and_occupancy_match_jax_hybrid(hybrid):
    """zamba2: the Mamba2 states and the shared block's `shared_kv`; as in
    the reference, clear_slot leaves the cleared slot's shared K/V (and
    their lengths) as they were."""
    ts = _insert_clear(hybrid, Mamba2State)
    assert ts.shared_kv.k[:, 2, :11].any() and ts.shared_kv.v[:, 2].any()
    assert ts.shared_kv.length[:, 2].tolist() == [11, 11]


def _jax_runs(model, modes):
    """One JAX Engine run per mode: its stats and its final decode state."""
    params, cfg_j, _, _ = model
    runs = {}
    for mode in modes:
        eng = jengine.Engine(params, cfg_j,
                             jengine.EngineConfig(mode=mode, **ENGINE))
        stats = eng.run(jbatch.generate(jbatch.WorkloadConfig(**WORKLOAD)),
                        max_iters=600)
        runs[mode] = stats, interop.decode_state(eng.state)
    return runs


@pytest.fixture(scope="module")
def jax_runs(model):
    return _jax_runs(model, ("kf", "rr"))


@pytest.fixture(scope="module")
def hybrid_jax_runs(hybrid):
    return _jax_runs(hybrid, ("kf", "rr", "static"))


def _engine_matches(model, jax_runs, mode, bound):
    """The Engine's statistics equal to the JAX Engine's, and the caches
    the run leaves within ``bound`` relative L2 of the JAX run's, cleared
    slots zero, every slot finite and bounded."""
    _, _, tparams, cfg_t = model
    want, want_state = jax_runs[mode]
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
    for j, (st, want_st) in enumerate(zip(eng.state.caches,
                                          want_state.caches)):
        for name in ("conv", "ssm"):
            errs[f"{name}{j}"] = _rel_l2(getattr(st, name).float(),
                                         getattr(want_st, name).float())
    if eng.state.shared_kv is not None:
        for name in ("k", "v"):
            errs[f"shared {name}"] = _rel_l2(
                getattr(eng.state.shared_kv, name).float(),
                getattr(want_state.shared_kv, name).float())
        assert torch.equal(eng.state.shared_kv.length,
                           want_state.shared_kv.length)
    worst = max(errs, key=errs.get)
    print(f"{cfg_t.name} {mode}: caches worst relative L2 {errs[worst]:.3e} "
          f"({worst}; bound {bound:.3e})")
    assert errs[worst] <= bound, errs
    cleared = (eng.state.length == 0).nonzero().flatten().tolist()
    assert cleared
    for st in eng.state.caches:
        for slot in cleared:
            assert not st.ssm[:, slot].any() and not st.conv[:, slot].any()
        assert bool(torch.isfinite(st.ssm).all())
        assert float(st.ssm.abs().max()) < 10
        assert bool(torch.isfinite(st.conv.float()).all())


@pytest.mark.parametrize("mode", ["kf", "rr"])
def test_engine_matches_jax(model, jax_runs, mode):
    _engine_matches(model, jax_runs, mode, 1e-2)


@pytest.fixture(scope="module")
def hybrid_bound(hybrid):
    """max(1e-2, 1.5 x the reference's own compiled-against-eager distance
    on a prefill and 3 decode steps), as in tests/test_torch_hybrid.py."""
    _, name, witness = compile_witness(hybrid, 16)
    print(f"{HYBRID}: the reference's compiled against its eager run "
          f"{witness:.3e} ({name})")
    return max(1e-2, 1.5 * witness)


@pytest.mark.parametrize("mode", ["kf", "rr", "static"])
def test_engine_matches_jax_hybrid(hybrid, hybrid_jax_runs, hybrid_bound,
                                   mode):
    _engine_matches(hybrid, hybrid_jax_runs, mode, hybrid_bound)


def _launch_matches(arch):
    """The launcher on the smoke config (its own random weights in each
    package: the statistics do not depend on them)."""
    want = jlaunch.run(arch, "kf", n_requests=6)
    got = tlaunch.run(arch, "kf", n_requests=6, device="cpu")
    assert got == want and got["n_finished"] == 6


def test_launch_serve_falcon_mamba_matches_jax():
    _launch_matches(ARCH)


def test_launch_serve_zamba2_matches_jax():
    _launch_matches(HYBRID)
