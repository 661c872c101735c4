"""Port congruence: the serving path on falcon-mamba (Mamba1 conv rings and
SSM states as the decode caches) against the JAX package — the slot
algebra on `Mamba1State`, the KF-arbitrated Engine in modes kf and rr, and
the serve launcher.

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
29 iterations.
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
from repro_torch.models.mamba import Mamba1State
from repro_torch.serve import batching as tbatch
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine

ARCH = "falcon-mamba-7b"
WORKLOAD = dict(n_requests=12, mean_prompt=8, mean_gen=6, burst_rate=8.0,
                calm_rate=0.1, seed=1)
ENGINE = dict(max_slots=4, max_len=32, budget_tokens=16, warmup_iters=2)


def _rel_l2(a, b):
    a, b = a.double().numpy(), b.double().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


def test_insert_clear_and_occupancy_match_jax(model):
    params, cfg_j, _, cfg_t = model
    toks = np.arange(1, 12, dtype=np.int32)[None]
    jpre = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)
    tpre = interop.decode_state(jpre)          # the same prefilled state
    js = jlm.init_decode_state(4, 32, cfg_j)
    ts = tlm.init_decode_state(4, 32, cfg_t, device="cpu")
    assert isinstance(tpre.caches[0], Mamba1State)

    def same():
        got = interop.decode_state(js)
        for a, b in zip(ts.caches[0], got.caches[0]):
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
    assert not ts.caches[0].ssm[:, 2].any()
    assert not ts.caches[0].conv[:, 2].any()


@pytest.fixture(scope="module")
def jax_runs(model):
    """One JAX Engine run per mode: its stats and its final decode state."""
    params, cfg_j, _, _ = model
    runs = {}
    for mode in ("kf", "rr"):
        eng = jengine.Engine(params, cfg_j,
                             jengine.EngineConfig(mode=mode, **ENGINE))
        stats = eng.run(jbatch.generate(jbatch.WorkloadConfig(**WORKLOAD)),
                        max_iters=600)
        runs[mode] = stats, interop.decode_state(eng.state)
    return runs


@pytest.mark.parametrize("mode", ["kf", "rr"])
def test_engine_matches_jax(model, jax_runs, mode):
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

    # the caches the run leaves: the JAX run's, cleared slots zero, and
    # every slot finite and bounded
    st = eng.state.caches[0]
    assert torch.equal(eng.state.length, want_state.length)
    for name in ("conv", "ssm"):
        err = _rel_l2(getattr(st, name).float(),
                      getattr(want_state.caches[0], name).float())
        assert err <= 1e-2, (name, err)
    cleared = (eng.state.length == 0).nonzero().flatten().tolist()
    assert cleared
    for slot in cleared:
        assert not st.ssm[:, slot].any() and not st.conv[:, slot].any()
    assert bool(torch.isfinite(st.ssm).all()) and float(st.ssm.abs().max()) < 10
    assert bool(torch.isfinite(st.conv.float()).all())


def test_launch_serve_falcon_mamba_matches_jax():
    """The launcher on falcon-mamba's smoke config (its own random weights
    in each package: the statistics do not depend on them)."""
    want = jlaunch.run(ARCH, "kf", n_requests=6)
    got = tlaunch.run(ARCH, "kf", n_requests=6, device="cpu")
    assert got == want and got["n_finished"] == 6
