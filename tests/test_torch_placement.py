"""Port congruence: the placement registry, plans and schedules against the
JAX package.

* the three plan builders on the paper mesh and on other meshes (the
  near-MC ranking's ties break by router id, as numpy's lexsort does in
  the reference);
* every registered scenario, and schedules over both slots, materializes
  bitwise equal to JAX's at E = 12 and 120, through `materialize` and
  `resolve_placement`;
* the validation errors, the near-miss hint and `register_placement` with
  and without ``overwrite`` read as JAX's;
* a named scenario through the port's `simulate` on the three engines
  against JAX's `simulate` of the same name, to `assert_congruent`'s bar."""
import functools

import numpy as np
import pytest
import torch

from _torch_sim import (
    POLICY,
    SIZE,
    WORKLOAD,
    assert_congruent,
    jax_result,
    jax_streams,
)
from repro.core.noc import placement as jp
from repro.core.noc.topology import make_topology as j_topology
from repro_torch import interop
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import placement as tp
from repro_torch.core.noc import sim as tsim
from repro_torch.core.noc.topology import make_topology as t_topology

MESHES = [(6, 6, 8), (4, 4, 4), (8, 8, 8), (5, 3, 3), (8, 4, 6)]

EXTRA = {
    "both_slots": lambda m: m.PlacementSchedule((
        m.PlacementEvent(0.0, 0.4, "swap_classes", "boost"),
        m.PlacementEvent(0.25, 0.75, "gpu_near_mc", "base"),
        m.PlacementEvent(0.6, 1.0, "identity", "boost"),
    )),
    "short_window": lambda m: m.PlacementSchedule((
        m.PlacementEvent(0.51, 0.52, "gpu_near_mc", "base"),
    )),
}


def schedules(m):
    return {**m.PLACEMENTS, **{k: f(m) for k, f in EXTRA.items()}}


NAMES = list(jp.PLACEMENTS) + list(EXTRA)


def assert_stream_equal(j, t):
    assert tuple(t._fields) == tuple(j._fields)
    for f, a, b in zip(j._fields, j, t):
        a = np.asarray(a)
        assert b.device.type == "cpu" and b.numpy().dtype == a.dtype, f
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f)


@pytest.mark.parametrize("plan", list(jp.PLAN_BUILDERS))
@pytest.mark.parametrize("mesh", MESHES)
def test_plan_builders_match_jax(plan, mesh):
    assert list(tp.PLAN_BUILDERS) == list(jp.PLAN_BUILDERS)
    want = jp.PLAN_BUILDERS[plan](j_topology(*mesh))
    got = tp.PLAN_BUILDERS[plan](t_topology(*mesh))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_gpu_near_mc_keeps_counts_and_mcs():
    topo = t_topology()
    plan = tp.PLAN_BUILDERS["gpu_near_mc"](topo)
    nt = np.asarray(topo.node_type)
    for c in (tp.NT_CPU, tp.NT_GPU, tp.NT_MC):
        assert (plan == c).sum() == (nt == c).sum()
    assert (plan[nt == tp.NT_MC] == tp.NT_MC).all()
    assert (plan != nt).any()


@pytest.mark.parametrize("n_epochs", [12, 120])
@pytest.mark.parametrize("name", NAMES)
def test_schedule_materializes_as_jax(name, n_epochs):
    j = schedules(jp)[name].materialize(n_epochs, j_topology())
    t = schedules(tp)[name].materialize(n_epochs, t_topology())
    assert_stream_equal(j, t)
    if name in jp.PLACEMENTS:
        assert_stream_equal(jp.resolve_placement(name, n_epochs),
                            tp.resolve_placement(name, n_epochs))


def test_static_placement_matches_jax():
    assert_stream_equal(jp.static_placement(12), tp.static_placement(12))
    assert_stream_equal(jp.resolve_placement(None, 5, j_topology(4, 4, 4)),
                        tp.resolve_placement(None, 5, t_topology(4, 4, 4)))


BAD_EVENTS = [
    dict(start=0.0, stop=1.0, plan="gpu_far_from_mc"),
    dict(start=0.0, stop=1.0, slot="turbo"),
    dict(start=0.5, stop=0.4),
    dict(start=-0.5, stop=0.4),
    dict(start=0.0, stop=1.01),
]


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("ev", BAD_EVENTS)
def test_validation_errors_match_jax(ev):
    want = _error(lambda: jp.PlacementSchedule((jp.PlacementEvent(**ev),)))
    got = _error(lambda: tp.PlacementSchedule((tp.PlacementEvent(**ev),)))
    assert got == want and got[0] is ValueError


@pytest.mark.parametrize("call", [
    lambda m: m.lookup_placement("GPU_NEAR"),
    lambda m: m.lookup_placement("SWAP"),
    lambda m: m.lookup_placement("qqqq"),
    lambda m: m.resolve_placement(1, 12),
    lambda m: m.resolve_placement(m.static_placement(12), 11),
    lambda m: m.register_placement("X", "SWAP_MID"),
    lambda m: m.register_placement("SWAP_MID", m.PLACEMENTS["GPU_NEAR_MC"]),
])
def test_lookup_and_resolve_errors_match_jax(call):
    want, got = _error(lambda: call(jp)), _error(lambda: call(tp))
    assert got == want


def test_near_miss_hint():
    kind, msg = _error(lambda: tp.lookup_placement("GPU_NEAR"))
    assert kind is ValueError and "did you mean ['GPU_NEAR_MC'" in msg


@pytest.mark.parametrize("overwrite", [False, True])
def test_register_placement(overwrite):
    name = f"TEST_TORCH_PLACEMENT_{overwrite}"
    first = tp.PlacementSchedule((tp.PlacementEvent(0.0, 1.0),))
    second = tp.PlacementSchedule((tp.PlacementEvent(0.0, 0.5, "swap_classes",
                                                     "base"),))
    try:
        tp.register_placement(name, first)
        assert tp.lookup_placement(name) is first
        if overwrite:
            tp.register_placement(name, second, overwrite=True)
            assert tp.lookup_placement(name) is second
            assert torch.equal(tp.resolve_placement(name, 10).cls0,
                               second.materialize(10).cls0)
        else:
            with pytest.raises(ValueError, match="already exists"):
                tp.register_placement(name, second)
            assert tp.lookup_placement(name) is first
    finally:
        tp.PLACEMENTS.pop(name, None)
    assert name not in tp.PLACEMENTS


@functools.lru_cache(maxsize=None)
def named_case(engine: str):
    """kf under joint control with GPU_NEAR_MC, the scenario given by name
    to both packages (tests/_torch_sim.py's "kf_joint_near_mc")."""
    cfg = tsim.NoCConfig(policy=PolicyConfig(*POLICY), **SIZE, mode="kf",
                         control="joint", placement="GPU_NEAR_MC")
    rng = interop.epoch_stream_provider(*jax_streams(cfg.seed))
    return tsim.simulate(cfg, WORKLOAD, device="cpu", rng=rng, engine=engine)


@pytest.mark.parametrize("engine", tsim.ENGINES)
def test_named_placement_scenario_through_simulate(engine):
    assert_congruent(jax_result("kf_joint_near_mc"), named_case(engine))
