"""Shared set-up for the end-to-end simulate congruence tests.

One small static spec for every case (12 epochs x 30 cycles), so JAX
compiles its simulator once per test file.  The observation scales and the
hysteresis constants are scaled to that size: at the paper's values
(z_scales per 500-cycle epoch, a 10,000-cycle warmup) the KF could never
act within 360 cycles.  The port runs on JAX-drawn random streams, built
exactly as `repro.core.noc.sim` draws them (epoch keys from
PRNGKey(seed), per-cycle split into three), and carried across with
`repro_torch.interop`; faults and placements are materialized by the JAX
package and carried across the same way.

Counters, applied_config, kf_signal and gpu_vc_quota are held bitwise.
IPC, latency and injection rate are float32 quotients of equal integers,
held to rtol 1e-6.  The traced runs (`simulate_with_trace`) hold the
SimTrace's integer channels bitwise and its KF floats to rtol 1e-5: the
filter's 3-observation update runs in another order of float32 operations
in the two frameworks."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.allocator import PolicyConfig as JPolicyConfig
from repro.core.noc import faults as jfaults
from repro.core.noc import placement as jplacement
from repro.core.noc import sim as jsim
from repro.core.noc.topology import make_topology
from repro_torch import interop
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import sim as tsim

E, L, R, N_MC = 12, 30, 36, 8
SIZE = dict(epoch_len=L, n_epochs=E, z_scales=(18.0, 9.6, 150.0))
POLICY = (60, 30, 120)  # warmup, hold, revert in cycles
WORKLOAD = "SHIFT_PATH_BFS"
RTOL = 1e-6

CASES = {
    "baseline": dict(mode="baseline"),
    "fair": dict(mode="fair"),
    "static": dict(mode="static", static_gpu_vcs=3),
    "kf": dict(mode="kf"),
    "4subnet": dict(mode="4subnet"),
    "kf_seed1": dict(mode="kf", seed=1),
    "kf_guard_flap": dict(mode="kf", guard=True, faults="FLAP_DURING_SHIFT"),
    "kf_joint_near_mc": dict(mode="kf", control="joint",
                             placement="GPU_NEAR_MC"),
    # four NaN-telemetry epochs in a row during a link flap: the guard's
    # watchdog trips, so the covariance reset and the fallback fire at
    # this size too (FLAP_DURING_SHIFT rejects only one epoch here)
    "kf_guard_nan_run": dict(mode="kf", guard=True, faults=jfaults.FaultSchedule((
        jfaults.FaultEvent(0.45, 0.65, "link", routers=(8, 9),
                           ports=(jfaults.PORT_N,), period=3),
        jfaults.FaultEvent(0.5, 0.8, "telem", mode=jfaults.TELEM_NAN),
    ))),
}


@functools.lru_cache(maxsize=None)
def jax_streams(seed: int):
    """(u_phase (E, L), u_gen (E, L, R), d_idx (E, L, R)) as numpy."""

    @jax.jit
    def one(k):
        keys = jax.random.split(k, L)
        k3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        up = jax.vmap(lambda k: jax.random.uniform(k, ()))(k3[:, 0])
        ug = jax.vmap(
            lambda k: jax.random.uniform(k, (R,), jnp.float32)
        )(k3[:, 1])
        di = jax.vmap(lambda k: jax.random.randint(k, (R,), 0, N_MC))(k3[:, 2])
        return up, ug, di

    keys = jax.random.split(jax.random.PRNGKey(seed), E)
    outs = [one(keys[e]) for e in range(E)]
    return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(3))


def jax_fault_stream(name):
    topo = make_topology()
    return jfaults.resolve_faults(name, E, n_routers=R, neighbor=topo.neighbor,
                                  opposite=topo.opposite)


def jax_placement_stream(name):
    return jplacement.resolve_placement(name, E, make_topology())


@functools.lru_cache(maxsize=None)
def jax_result(case: str):
    kw = CASES[case]
    cfg = jsim.NoCConfig(policy=JPolicyConfig(*POLICY), **SIZE, **kw)
    return jsim.simulate(cfg, WORKLOAD, backend="ref")


@functools.lru_cache(maxsize=None)
def jax_trace_result(case: str):
    kw = CASES[case]
    cfg = jsim.NoCConfig(policy=JPolicyConfig(*POLICY), **SIZE, **kw)
    return jsim.simulate_with_trace(cfg, WORKLOAD, backend="ref")


def port_config(case: str) -> tsim.NoCConfig:
    kw = dict(CASES[case])
    if kw.get("faults"):
        kw["faults"] = interop.fault_stream(jax_fault_stream(kw["faults"]))
    if kw.get("placement"):
        kw["placement"] = interop.placement_stream(
            jax_placement_stream(kw["placement"])
        )
    return tsim.NoCConfig(policy=PolicyConfig(*POLICY), **SIZE, **kw)


def port_result(case: str, engine: str, traced: bool = False):
    """The port's run of ``case`` on the CPU; with ``traced`` the
    (SimResult, SimTrace) of `simulate_with_trace`."""
    cfg = port_config(case)
    rng = interop.epoch_stream_provider(*jax_streams(cfg.seed))
    run = tsim.simulate_with_trace if traced else tsim.simulate
    return run(cfg, WORKLOAD, device="cpu", rng=rng, engine=engine)


def assert_congruent(j, t):
    for name, a, b in zip(jsim.EpochCounters._fields, j.counters, t.counters):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"counter {name}")
    for name in ("applied_config", "kf_signal", "gpu_vc_quota"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j, name)), getattr(t, name).numpy(),
            err_msg=name,
        )
    for name in ("gpu_ipc", "cpu_ipc", "avg_latency", "gpu_inj_rate"):
        np.testing.assert_allclose(
            np.asarray(getattr(j, name)), getattr(t, name).numpy(),
            rtol=RTOL, err_msg=name,
        )
    assert t.applied_config.dtype == torch.int32


def assert_tables_close(want, got, path: str = ""):
    """Two drivers' results equal key for key: floats to rtol 1e-6 (atol
    1e-9 for a zero spread), arrays elementwise (integer arrays exactly),
    anything else exactly."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_tables_close(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (float, np.ndarray)):
        want, got = np.asarray(want), np.asarray(got)
        assert got.shape == want.shape, path
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path
