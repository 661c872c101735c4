"""Port congruence, end to end, with no injected streams: the port's
`simulate(cfg, source)` draws JAX's threefry streams itself
(`sim.threefry_epoch_streams`, jax 0.9.0's default partitionable setting
in both packages) and is held against JAX `simulate` on all three engines,
at tests/_torch_sim.py's size and tolerances."""
import pytest

from _torch_sim import WORKLOAD, assert_congruent, jax_result, port_config
from repro_torch.core.noc import sim as tsim

ENGINES = ["fused", "ref", "arb"]
CASES = ["baseline", "fair", "kf", "4subnet", "kf_seed1"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_simulate_draws_the_reference_streams(case, engine):
    assert_congruent(jax_result(case),
                     tsim.simulate(port_config(case), WORKLOAD, device="cpu",
                                   engine=engine))
