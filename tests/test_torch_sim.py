"""Port congruence, end to end: `repro_torch` simulate on the "ref",
"fused" and "arb" engines (device="cpu", JAX-drawn streams) against JAX
`simulate(backend="ref")` for all five modes on seed 0.  Tolerances and
set-up are stated in tests/_torch_sim.py."""
import numpy as np
import pytest

from _torch_sim import assert_congruent, jax_result, port_result
from repro.core.noc import sim as jsim
from repro_torch.core.noc import sim as tsim

ENGINES = ["ref", "fused", "arb"]
MODES = ["baseline", "fair", "static", "kf", "4subnet"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", MODES)
def test_simulate_matches_reference(case, engine):
    j = jax_result(case)
    assert_congruent(j, port_result(case, engine))
    if case == "kf":
        assert (np.diff(np.asarray(j.applied_config)) != 0).any(), (
            "the kf case no longer reconfigures at this size"
        )


def test_summaries_match_reference():
    """summarize / summarize_seeds over congruent results agree to float32
    rounding (means of the same float32 rows, rtol 1e-6)."""
    j = [jax_result(c) for c in ("kf", "kf_seed1")]
    t = [port_result(c, "fused") for c in ("kf", "kf_seed1")]
    for jw, tw in [(jsim.summarize(j[0], 4), tsim.summarize(t[0], 4)),
                   (jsim.summarize_seeds(j, 4), tsim.summarize_seeds(t, 4))]:
        assert jw.keys() == tw.keys()
        for k in jw:
            np.testing.assert_allclose(jw[k], tw[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)
