"""Port congruence: workload profiles, the burst-phase step, injection rates
and materialized scenario rows against the JAX package (bitwise: the rows
are built by the same float32 numpy arithmetic and only compared)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import traffic as jtr
from repro_torch import interop
from repro_torch.core.noc import traffic as ttr


def test_profiles_equal():
    assert sorted(jtr.PROFILES) == sorted(ttr.PROFILES)
    for name, jp in jtr.PROFILES.items():
        assert tuple(jp) == tuple(ttr.PROFILES[name]), name


@pytest.mark.parametrize("name", sorted(jtr.SCENARIOS) + sorted(jtr.PROFILES))
@pytest.mark.parametrize("n_epochs", [12, 120, 7])
def test_resolved_rows_equal(name, n_epochs):
    j = jtr.resolve_source(name, n_epochs)
    t = ttr.resolve_source(name, n_epochs)
    # rows carried across from the JAX side lower to themselves
    c = ttr.resolve_source(interop.epoch_demand(j), n_epochs)
    for f in jtr.WorkloadProfile._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j, f)), getattr(t, f).numpy(), err_msg=f
        )
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      getattr(c, f).numpy(), err_msg=f)


def test_scenario_constructors_equal():
    pairs = [
        (jtr.phase_shift("LIB", "MUM", 0.3), ttr.phase_shift("LIB", "MUM", 0.3)),
        (jtr.shift_scenario("STO", "BFS", 0.25),
         ttr.shift_scenario("STO", "BFS", 0.25)),
        (jtr.rate_ramp("PATH", 0.2, 2.0), ttr.rate_ramp("PATH", 0.2, 2.0)),
        (jtr.program_mix(("LPS", "BFS"), 3), ttr.program_mix(("LPS", "BFS"), 3)),
        (jtr.burst_train("MUM", 5, 7, 2), ttr.burst_train("MUM", 5, 7, 2)),
    ]
    for js, ts in pairs:
        j, t = js.materialize(40), ts.materialize(40)
        for f in jtr.WorkloadProfile._fields:
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy())


def test_resolve_source_rejects_bad_demand():
    bad = ttr.WorkloadProfile(0.1, float("nan"), 0.1, 0.1)
    with pytest.raises(ValueError, match="non-finite"):
        ttr.resolve_source(bad, 4)
    with pytest.raises(ValueError, match="negative"):
        ttr.resolve_source(ttr.WorkloadProfile(-0.1, 0.2, 0.1, 0.1), 4)
    with pytest.raises(ValueError, match="unknown workload"):
        ttr.resolve_source("PATHH", 4)


def test_phase_step_and_injection_rates_equal():
    rng = np.random.default_rng(4)
    nt = np.asarray([0, 1, 2, -1] * 32, np.int32)
    for name in sorted(jtr.PROFILES):
        jp, tp = jtr.PROFILES[name], ttr.PROFILES[name]
        jprof = jtr.WorkloadProfile(*(jnp.float32(x) for x in jp))
        tprof = ttr.WorkloadProfile(*(torch.tensor(x, dtype=torch.float32)
                                      for x in tp))
        # pinned-phase probabilities exercise both transitions
        for pe, px in [(tp.p_enter, tp.p_exit), (1.0, 0.0), (0.0, 1.0)]:
            jq = jprof._replace(p_enter=jnp.float32(pe), p_exit=jnp.float32(px))
            tq = tprof._replace(p_enter=torch.tensor(pe, dtype=torch.float32),
                                p_exit=torch.tensor(px, dtype=torch.float32))
            for phase in (0, 1):
                u = rng.random(64).astype(np.float32)
                u[:4] = [0.0, np.float32(pe), np.float32(px), 0.99999994]
                jph = jtr.step_phase_u(jq, jnp.int32(phase), jnp.asarray(u))
                tph = ttr.step_phase_u(tq, torch.tensor(phase, dtype=torch.int32),
                                       torch.from_numpy(u))
                np.testing.assert_array_equal(np.asarray(jph), tph.numpy())
                jr = jtr.injection_rates(jq, jnp.asarray(nt), jnp.int32(phase))
                tr = ttr.injection_rates(tq, torch.from_numpy(nt),
                                         torch.tensor(phase, dtype=torch.int32))
                np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


def test_stack_profiles_equal():
    names = sorted(jtr.PROFILES)
    j = jtr.stack_profiles([jtr.PROFILES[n] for n in names])
    t = ttr.stack_profiles([ttr.PROFILES[n] for n in names])
    for f in jtr.WorkloadProfile._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
