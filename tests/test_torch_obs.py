"""Port congruence of the flight-recorder path: `repro_torch`
simulate_with_trace on the "ref", "fused" (plain lane engine) and "arb"
engines (device="cpu", JAX-drawn streams) against JAX
`simulate_with_trace(backend="ref")`, on cases whose fault, self-healing
and placement channels are live.  SimTrace integer channels are held
bitwise, its KF floats and z_obs to rtol 1e-5 with NaN == NaN; set-up and
SimResult tolerances are stated in tests/_torch_sim.py."""
import functools

import numpy as np
import pytest
import torch

from _torch_sim import assert_congruent, jax_trace_result, port_result
from repro.obs import probes as jprobes
from repro_torch.core.noc import sim as tsim
from repro_torch.obs import probes as tprobes

ENGINES = ["ref", "fused", "arb"]
CASES = ["kf", "4subnet", "kf_guard_flap", "kf_guard_nan_run",
         "kf_joint_near_mc"]
INT_FIELDS = ("occ_sum", "arb_grant", "arb_deny", "mcq_sum", "mcq_max",
              "kf_rejected", "kf_reset", "kf_healthy", "faults_active",
              "place_cls")
FLOAT_FIELDS = ("kf_innovation", "kf_gain", "kf_cov_trace", "kf_x_pred",
                "z_obs", "kf_nis")
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def traced(case: str, engine: str):
    return port_result(case, engine, traced=True)


def test_trace_fields_match_reference():
    assert tprobes.SimTrace._fields == jprobes.SimTrace._fields
    assert set(INT_FIELDS) | set(FLOAT_FIELDS) == set(tprobes.SimTrace._fields)


def test_cases_exercise_every_channel():
    """The reference's own traces of the chosen cases: guard rejects, NaN
    telemetry in z_obs and NIS, and faults in kf_guard_flap; the reset and
    the fallback in kf_guard_nan_run; relocated tiles in
    kf_joint_near_mc."""
    _, flap = jax_trace_result("kf_guard_flap")
    assert np.asarray(flap.kf_rejected).sum() > 0
    assert np.isnan(np.asarray(flap.z_obs)).any()
    assert np.isnan(np.asarray(flap.kf_nis)).any()
    assert (np.asarray(flap.faults_active) > 0).any()
    _, run = jax_trace_result("kf_guard_nan_run")
    assert np.asarray(run.kf_reset).sum() > 0
    assert (np.asarray(run.kf_healthy) == 0).any()
    _, near = jax_trace_result("kf_joint_near_mc")
    assert (np.diff(np.asarray(near.place_cls), axis=0) != 0).any()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_trace_matches_reference(case, engine):
    jres, jtr = jax_trace_result(case)
    tres, ttr = traced(case, engine)
    assert_congruent(jres, tres)
    for f in INT_FIELDS:
        t = getattr(ttr, f)
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(np.asarray(getattr(jtr, f)), t.numpy(),
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        t = getattr(ttr, f)
        assert t.dtype == torch.float32, f
        np.testing.assert_allclose(np.asarray(getattr(jtr, f)), t.numpy(),
                                   rtol=RTOL, equal_nan=True, err_msg=f)


@pytest.mark.parametrize("case", ["kf", "kf_guard_nan_run",
                                  "kf_joint_near_mc"])
def test_traced_result_is_untraced_result(case):
    """The flight recorder does not perturb the run: the SimResult of
    simulate_with_trace is bitwise simulate's (fused engine)."""
    res, _ = traced(case, "fused")
    plain = port_result(case, "fused")
    for name, a, b in zip(tsim.SimResult._fields, res, plain):
        if name == "counters":
            for x, y in zip(a, b):
                assert torch.equal(x, y), name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["kf_guard_nan_run", "kf_joint_near_mc"])
def test_summarize_trace_matches_reference(case):
    j = jprobes.summarize_trace(jax_trace_result(case)[1])
    t = tprobes.summarize_trace(traced(case, "fused")[1])
    assert j.keys() == t.keys()
    for k, v in j.items():
        if isinstance(v, int):
            assert t[k] == v and isinstance(t[k], int), k
        else:
            np.testing.assert_allclose(t[k], v, rtol=RTOL, equal_nan=True,
                                       err_msg=k)
