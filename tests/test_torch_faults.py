"""Port congruence: the fault registry and schedules against the JAX package.

* every registered scenario, and schedules that reach every fault kind
  (solid and flapping links on named and on all ports, every router, MC
  stalls, each telemetry mode), materializes bitwise equal to JAX's at
  E = 12 and 120, with and without the neighbor table (the reverse link
  direction) and through `resolve_faults`;
* the validation errors, the near-miss hint and `register_faults` with
  and without ``overwrite`` read as JAX's;
* a named scenario through the port's `simulate` on the three engines
  against JAX's `simulate` of the same name, to `assert_congruent`'s bar
  (counters bitwise, float32 quotients to rtol 1e-6)."""
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
from repro.core.noc import faults as jf
from repro.core.noc.topology import make_topology as j_topology
from repro_torch import interop
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import faults as tf
from repro_torch.core.noc import sim as tsim
from repro_torch.core.noc.topology import make_topology as t_topology

# schedules over every kind, written once per package
EXTRA = {
    "every_kind": lambda m: m.FaultSchedule((
        m.FaultEvent(0.0, 0.5, "link", routers=(0, 35), period=1),
        m.FaultEvent(0.25, 1.0, "link", ports=(m.PORT_E, m.PORT_S)),
        m.FaultEvent(0.1, 0.3, "router"),
        m.FaultEvent(0.6, 0.9, "mc", routers=(0, 5, 30), period=4),
        m.FaultEvent(0.2, 0.4, "telem", mode=m.TELEM_SPIKE, mag=-2.5,
                     period=2),
        m.FaultEvent(0.9, 1.0, "telem", mode=m.TELEM_NAN),
    )),
    "edge_links": lambda m: m.FaultSchedule((
        m.FaultEvent(0.3, 0.7, "link", routers=(5, 6, 30, 35),
                     ports=(m.PORT_N, m.PORT_W), period=3),
    )),
}


def schedules(m):
    return {**m.FAULTS, **{k: f(m) for k, f in EXTRA.items()}}


NAMES = list(jf.FAULTS) + list(EXTRA)


def assert_stream_equal(j, t):
    assert tuple(t._fields) == tuple(j._fields)
    for f, a, b in zip(j._fields, j, t):
        a = np.asarray(a)
        assert b.device.type == "cpu" and b.numpy().dtype == a.dtype, f
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f)


@pytest.mark.parametrize("n_epochs", [12, 120])
@pytest.mark.parametrize("neighbors", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_schedule_materializes_as_jax(name, neighbors, n_epochs):
    js, ts = schedules(jf)[name], schedules(tf)[name]
    jt, tt = j_topology(), t_topology()
    jkw = dict(neighbor=jt.neighbor, opposite=jt.opposite) if neighbors else {}
    tkw = dict(neighbor=tt.neighbor, opposite=tt.opposite) if neighbors else {}
    j = js.materialize(n_epochs, 36, **jkw)
    t = ts.materialize(n_epochs, 36, **tkw)
    assert_stream_equal(j, t)
    if name in jf.FAULTS:
        assert_stream_equal(
            jf.resolve_faults(name, n_epochs, **jkw),
            tf.resolve_faults(name, n_epochs, **tkw))


def test_link_fault_is_two_way_with_neighbors():
    """FLAP_BFS masks port N of routers 8 and 9 and, with the neighbor
    table, port S of routers 2 and 3 in the same (flapping) epochs."""
    topo = t_topology()
    one = tf.resolve_faults("FLAP_BFS", 120)
    two = tf.resolve_faults("FLAP_BFS", 120, neighbor=topo.neighbor,
                            opposite=topo.opposite)
    down = ~two.link_ok
    assert torch.equal(down[:, [8, 9], tf.PORT_N], down[:, [2, 3], tf.PORT_S])
    assert not (~one.link_ok)[:, [2, 3], tf.PORT_S].any()
    # on for 2 epochs, off for 2, from round(0.55 * 120) = 66 to 96
    on = down[:, 8, tf.PORT_N].nonzero().flatten().tolist()
    assert on == [e for e in range(66, 96) if (e - 66) // 2 % 2 == 0]


def test_healthy_stream_matches_jax():
    assert_stream_equal(jf.healthy_stream(12), tf.healthy_stream(12))
    assert_stream_equal(jf.resolve_faults(None, 7, 16),
                        tf.resolve_faults(None, 7, 16))


BAD_EVENTS = [
    dict(start=0.0, stop=1.0, kind="cosmic"),
    dict(start=0.5, stop=0.5, kind="router"),
    dict(start=-0.1, stop=0.5, kind="router"),
    dict(start=0.0, stop=1.5, kind="mc"),
    dict(start=0.0, stop=1.0, kind="link", period=-1),
    dict(start=0.0, stop=1.0, kind="telem", mode=0),
    dict(start=0.0, stop=1.0, kind="telem", mode=7),
    dict(start=0.0, stop=1.0, kind="link", ports=(4,)),
    dict(start=0.0, stop=1.0, kind="link", ports=(1, 9)),
]


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("ev", BAD_EVENTS)
def test_validation_errors_match_jax(ev):
    want = _error(lambda: jf.FaultSchedule((jf.FaultEvent(**ev),)))
    got = _error(lambda: tf.FaultSchedule((tf.FaultEvent(**ev),)))
    assert got == want and got[0] is ValueError


@pytest.mark.parametrize("call", [
    lambda m: m.FaultSchedule((m.FaultEvent(0, 1, "router", routers=(36,)),))
    .materialize(12),
    lambda m: m.FaultSchedule((m.FaultEvent(0, 1, "mc", routers=(-1,)),))
    .materialize(12),
    lambda m: m.lookup_faults("FLAP_BF"),
    lambda m: m.lookup_faults("TELEM"),
    lambda m: m.lookup_faults("zzzz"),
    lambda m: m.resolve_faults(3.0, 12),
    lambda m: m.resolve_faults(m.healthy_stream(12), 13),
    lambda m: m.register_faults("X", "FLAP_BFS"),
    lambda m: m.register_faults("FLAP_BFS", m.FAULTS["BROWNOUT"]),
])
def test_lookup_and_resolve_errors_match_jax(call):
    want, got = _error(lambda: call(jf)), _error(lambda: call(tf))
    assert got == want


def test_near_miss_hint():
    kind, msg = _error(lambda: tf.lookup_faults("FLAP_BF"))
    assert kind is ValueError and "did you mean ['FLAP_BFS'" in msg


@pytest.mark.parametrize("overwrite", [False, True])
def test_register_faults(overwrite):
    name = f"TEST_TORCH_FAULTS_{overwrite}"
    first = tf.FaultSchedule((tf.FaultEvent(0.0, 0.5, "router"),))
    second = tf.FaultSchedule((tf.FaultEvent(0.5, 1.0, "mc"),))
    try:
        tf.register_faults(name, first)
        assert tf.lookup_faults(name) is first
        if overwrite:
            tf.register_faults(name, second, overwrite=True)
            assert tf.lookup_faults(name) is second
            assert torch.equal(tf.resolve_faults(name, 10).mc_ok,
                               second.materialize(10).mc_ok)
        else:
            with pytest.raises(ValueError, match="already exists"):
                tf.register_faults(name, second)
            assert tf.lookup_faults(name) is first
    finally:
        tf.FAULTS.pop(name, None)
    assert name not in tf.FAULTS


@functools.lru_cache(maxsize=None)
def named_case(engine: str):
    """kf with the guard under FLAP_DURING_SHIFT, the scenario given by
    name to both packages (tests/_torch_sim.py's "kf_guard_flap")."""
    cfg = tsim.NoCConfig(policy=PolicyConfig(*POLICY), **SIZE, mode="kf",
                         guard=True, faults="FLAP_DURING_SHIFT")
    rng = interop.epoch_stream_provider(*jax_streams(cfg.seed))
    return tsim.simulate(cfg, WORKLOAD, device="cpu", rng=rng, engine=engine)


@pytest.mark.parametrize("engine", tsim.ENGINES)
def test_named_fault_scenario_through_simulate(engine):
    assert_congruent(jax_result("kf_guard_flap"), named_case(engine))


def test_named_fault_scenario_is_its_stream():
    """The name and the JAX-materialized stream carried across give the
    same run: the port's materialization is two-way like JAX's."""
    from _torch_sim import port_result

    got, want = named_case("fused"), port_result("kf_guard_flap", "fused")
    for f, a, b in zip(tsim.SimResult._fields, got, want):
        pairs = zip(a, b) if f == "counters" else [(a, b)]
        for x, y in pairs:
            assert torch.equal(x, y), f
