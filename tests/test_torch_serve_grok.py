"""Port congruence: the serving path on grok-1's smoke config (4
experts, top-2, a MoE layer in every block) against the
JAX package: the KF-arbitrated Engine in modes kf, rr and static, and
the serve launcher.

The Engine needs no MoE branch: a MoE block's decode cache is the dense
block's KVCache.  Its statistics are held EQUAL (the reference prefills
all-zero prompts and decodes a token buffer it never updates, so its
schedule depends only on the workload, the EngineConfig and the cache
lengths).  Every slot is decoded each step, idle ones included, so idle
slots compete for expert capacity as in the reference.  The caches a run
leaves are held to the JAX run's within relative L2 1e-2, the model
bound (the reference's prefill and decode are held to it, or to a
witness above it, in tests/test_torch_moe_decode.py); the slots cleared
in the last iteration are zero.  (tests/_torch_moe.py holds the workload
and the comparison, shared with the other MoE arch's file.)
"""
import pytest

from repro.launch import serve as jlaunch
from repro_torch.launch import serve as tlaunch

from _torch_moe import MODES, engine_matches, jax_engine_runs, model

ARCH = "grok-1-314b"


@pytest.fixture(scope="module")
def served():
    m = model(ARCH)
    return m, jax_engine_runs(m)


@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_jax(served, mode):
    engine_matches(*served, mode, 1e-2)


def test_launch_serve_matches_jax():
    """The launcher on the smoke config (its own random weights in each
    package: the statistics do not depend on them)."""
    want = jlaunch.run(ARCH, "kf", n_requests=6)
    got = tlaunch.run(ARCH, "kf", n_requests=6, device="cpu")
    assert got == want and got["n_finished"] == 6
