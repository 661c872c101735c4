"""Port congruence: the serving path — the workload generator, the slot
algebra of the decode caches, the KF-arbitrated Engine in its three modes
and the serve launcher — against the JAX package.

The Engine's statistics are held EQUAL, not close: the reference
prefills all-zero prompts and decodes a token buffer it never updates, so
its schedule depends only on the workload, the EngineConfig and the cache
lengths; its KF (a 3x3 solve) runs on host float32 in both packages.  The
JAX Engine compiles a prefill per prompt length and its decode step per
instance, so each mode runs once per module (a shared fixture).
"""
import dataclasses

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
from repro_torch.serve import batching as tbatch
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine

ARCH = "llama3.2-3b"
# bursty arrivals that make the KF boost and revert (13 of 52 iterations
# boosted, four switches), with a static split that runs config 1
WORKLOAD = dict(n_requests=20, mean_prompt=40, mean_gen=6, burst_rate=8.0,
                calm_rate=0.1, seed=3)
ENGINE = dict(max_slots=4, max_len=64, budget_tokens=32, warmup_iters=2,
              static_prefill_frac=0.75)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    params, _ = jlm.make_lm(jax.random.PRNGKey(0), cfg_j)
    tparams = interop.lm_params(jax.tree.map(np.asarray, params), cfg_t)
    return params, cfg_j, tparams, cfg_t


@pytest.mark.parametrize("wl", [
    {}, dict(n_requests=40, mean_prompt=512, mean_gen=16, seed=5),
    WORKLOAD,
])
def test_generate_matches_jax(wl):
    want = jbatch.generate(jbatch.WorkloadConfig(**wl))
    got = tbatch.generate(tbatch.WorkloadConfig(**wl))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


def test_insert_clear_and_occupancy_match_jax(model):
    params, cfg_j, tparams, cfg_t = model
    toks = np.arange(1, 9, dtype=np.int32)[None]
    jpre = jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)
    tpre = interop.decode_state(jpre)          # the same prefilled cache
    js = jlm.init_decode_state(4, 32, cfg_j)
    ts = tlm.init_decode_state(4, 32, cfg_t, device="cpu")

    def same():
        got = interop.decode_state(js)
        for a, b in zip(ts.caches[0], got.caches[0]):
            assert torch.equal(a, b)
        assert torch.equal(ts.length, got.length)
        assert tcache.kv_occupancy(ts, 32) == jcache.kv_occupancy(js, 32)

    js = jcache.insert_request(js, jpre, 2)
    ts = tcache.insert_request(ts, tpre, 2)
    same()
    js = jcache.insert_request(js, jpre, 0)
    ts = tcache.insert_request(ts, tpre, 0)
    same()
    assert tcache.kv_occupancy(ts, 32) == 16 / 128
    js = jcache.clear_slot(js, 2)
    ts = tcache.clear_slot(ts, 2)
    same()
    assert int(ts.length[2]) == 0 and not ts.caches[0].k[:, 2].any()


@pytest.fixture(scope="module")
def jax_runs(model):
    """One JAX Engine run per mode."""
    params, cfg_j, _, _ = model
    runs = {}
    for mode in ("rr", "static", "kf"):
        eng = jengine.Engine(params, cfg_j,
                             jengine.EngineConfig(mode=mode, **ENGINE))
        runs[mode] = eng.run(jbatch.generate(jbatch.WorkloadConfig(
            **WORKLOAD)), max_iters=600)
    return runs


@pytest.mark.parametrize("mode", ["rr", "static", "kf"])
def test_engine_matches_jax(model, jax_runs, mode):
    _, _, tparams, cfg_t = model
    want = jax_runs[mode]
    eng = tengine.Engine(tparams, cfg_t,
                         tengine.EngineConfig(mode=mode, **ENGINE),
                         device="cpu")
    got = eng.run(tbatch.generate(tbatch.WorkloadConfig(**WORKLOAD)),
                  max_iters=600)
    assert got.configs == want.configs
    assert got.kf_signals == want.kf_signals
    assert (got.iters, got.clock) == (want.iters, want.clock)
    assert [r.rid for r in got.finished] == [r.rid for r in want.finished]
    assert [(r.t_first_token, r.t_done, r.tokens_out, r.prompt_len)
            for r in got.finished] == \
        [(r.t_first_token, r.t_done, r.tokens_out, r.prompt_len)
         for r in want.finished]
    assert got.summary() == want.summary()
    assert got.summary()["n_finished"] == WORKLOAD["n_requests"]
    if mode == "kf":
        assert 0 < sum(got.configs) < len(got.configs)


def test_launch_serve_run_matches_jax():
    """The launcher at the reference's defaults (smoke config, its own random
    weights in each package: the statistics do not depend on them)."""
    want = jlaunch.run(ARCH, "kf", n_requests=8)
    got = tlaunch.run(ARCH, "kf", n_requests=8, device="cpu")
    assert got == want and got["n_finished"] == 8
