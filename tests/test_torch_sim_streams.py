"""Port congruence, end to end, for the kf controller under a second seed,
under JAX-materialized fault and placement streams (FLAP_DURING_SHIFT with
the guard armed: link flaps plus NaN telemetry; GPU_NEAR_MC under joint
control), on all three engines.  Set-up and tolerances are stated in
tests/_torch_sim.py."""
import numpy as np
import pytest

from _torch_sim import (
    E,
    assert_congruent,
    jax_fault_stream,
    jax_placement_stream,
    jax_result,
    port_result,
)
from repro.core.noc.faults import TELEM_NAN

ENGINES = ["ref", "fused", "arb"]
CASES = ["kf_seed1", "kf_guard_flap", "kf_joint_near_mc"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_simulate_streams_match_reference(case, engine):
    j = jax_result(case)
    assert_congruent(j, port_result(case, engine))
    assert (np.diff(np.asarray(j.applied_config)) != 0).any(), (
        f"{case} no longer reconfigures at this size"
    )


def test_fault_stream_is_active_at_this_size():
    flt = jax_fault_stream("FLAP_DURING_SHIFT")
    assert not np.asarray(flt.link_ok).all()
    assert (np.asarray(flt.telem_mode) == TELEM_NAN).any()
    assert np.asarray(flt.link_ok).shape[0] == E


def test_placement_stream_is_active_at_this_size():
    """The boosted plan differs from the base plan, and the controller
    holds config 1 in some epoch, so the relocated plan is really used."""
    plc = jax_placement_stream("GPU_NEAR_MC")
    differs = (np.asarray(plc.cls0) != np.asarray(plc.cls1)).any(axis=1)
    conf = np.asarray(jax_result("kf_joint_near_mc").applied_config)
    assert (differs & (conf > 0)).any()
