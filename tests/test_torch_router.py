"""Port congruence: the dense router (arbitrate, router_cycle, inject_all)
and the plain lane arbitration against the JAX package, bitwise, on random
states drawn with numpy.  The lane arbitration is held against the JAX B1
Pallas kernel run in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import router as jrt
from repro.core.noc.topology import make_topology as jmake_topology
from repro.kernels.noc_cycle.kernel import noc_cycle_kernel
from repro_torch import interop
from repro_torch.core.noc import router as trt
from repro_torch.core.noc.topology import make_topology as tmake_topology
from repro_torch.kernels.noc_cycle import fused as tfused
from repro_torch.kernels.noc_cycle import ops as tops

P, V, B = 5, 4, 4
PV = P * V


def _random_arbitrate_inputs(rng, lead):
    gm = rng.random(lead[:-1] + (1, V)) < 0.7
    cm = rng.random(lead[:-1] + (1, V)) < 0.7
    return dict(
        valid=rng.random(lead + (PV,)) < 0.5,
        cls=rng.integers(0, 2, lead + (PV,)).astype(np.int32),
        out_port=rng.integers(0, P, lead + (PV,)).astype(np.int32),
        rr_ptr=rng.integers(0, PV, lead + (P,)).astype(np.int32),
        down_count=rng.integers(0, B + 1, lead + (P, V)).astype(np.int32),
        down_exists=rng.random(lead + (P,)) < 0.8,
        gpu_vc_mask=np.broadcast_to(gm, lead + (V,)).copy(),
        cpu_vc_mask=np.broadcast_to(cm, lead + (V,)).copy(),
        sa_pref=rng.integers(-1, 2, lead).astype(np.int32),
        accept=rng.random(lead) < 0.7,
        active=rng.random(lead) < 0.9,
    )


def _random_subnet_state(rng, S=4, R=36):
    dest = rng.integers(0, R, (S, R, P, V, B))
    src = rng.integers(0, R, (S, R, P, V, B))
    cls = rng.integers(0, 2, (S, R, P, V, B))
    return jrt.SubnetState(
        buf_meta=(dest + (src << 6) + (cls << 12)).astype(np.int16),
        buf_binj=rng.integers(0, 5000, (S, R, P, V, B)).astype(np.uint16),
        head=rng.integers(0, B, (S, R, P, V)).astype(np.int8),
        count=rng.integers(0, B + 1, (S, R, P, V)).astype(np.int8),
        rr_ptr=rng.integers(0, PV, (S, R, P)).astype(np.int8),
    )


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(
        np.asarray(a).astype(np.int64), b.numpy().astype(np.int64), err_msg=msg
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lead", [(4, 36), (2, 36), (1, 7)])
def test_arbitrate_matches(seed, lead):
    inp = _random_arbitrate_inputs(np.random.default_rng(seed), lead)
    j = jrt.arbitrate(**{k: jnp.asarray(v) for k, v in inp.items()}, depth=B)
    t = trt.arbitrate(**{k: torch.from_numpy(v) for k, v in inp.items()},
                      depth=B)
    for name, a, b in zip(jrt.Arbitration._fields, j, t):
        _eq(a, b, name)
    # the dense-layout wrapper of the lane path (plain version on the CPU)
    w = tops.arbitrate_lanes(**{k: torch.from_numpy(v) for k, v in inp.items()},
                             depth=B)
    for name, a, b in zip(jrt.Arbitration._fields, j, w):
        _eq(a, b, "lanes " + name)


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_arbitrate_matches_pallas_interpret(seed):
    """Plain `lane_arbitrate` == JAX B1 (`noc_cycle_kernel`, interpret
    mode) on every output, at the paper lane count L = 256."""
    rng = np.random.default_rng(10 + seed)
    L = 256
    rows = dict(
        valid=(rng.random((PV, L)) < 0.5).astype(np.int32),
        cls=rng.integers(0, 2, (PV, L)).astype(np.int32),
        out_port=rng.integers(0, P, (PV, L)).astype(np.int32),
        rr=rng.integers(0, PV, (P, L)).astype(np.int32),
        down=rng.integers(0, B + 1, (P * V, L)).astype(np.int32),
        exists=(rng.random((P, L)) < 0.8).astype(np.int32),
        gmask=(rng.random((V, L)) < 0.7).astype(np.int32),
        cmask=(rng.random((V, L)) < 0.7).astype(np.int32),
        sa=rng.integers(-1, 2, (1, L)).astype(np.int32),
        accept=(rng.random((1, L)) < 0.7).astype(np.int32),
        active=(rng.random((1, L)) < 0.9).astype(np.int32),
    )
    j = noc_cycle_kernel(*(jnp.asarray(x) for x in rows.values()),
                         depth=B, n_vcs=V, interpret=True)
    t = tops.arbitrate_rows(*(torch.from_numpy(x) for x in rows.values()),
                            depth=B)
    for name, a, b in zip(tfused.LaneArb._fields, j, t):
        _eq(a, b.to(torch.int32), name)


@pytest.mark.parametrize("seed", [11, 12])
def test_router_cycle_matches(seed):
    rng = np.random.default_rng(seed)
    S, R = 4, 36
    state = _random_subnet_state(rng)
    gmask = rng.random((S, V)) < 0.7
    cmask = rng.random((S, V)) < 0.7
    accept = rng.random((S, R)) < 0.8
    active = np.asarray([True, True, False, True])
    link_ok = rng.random((R, P)) < 0.9
    router_ok = rng.random(R) < 0.9
    jt = jrt.device_tables(jmake_topology())
    tt = trt.device_tables(tmake_topology())
    js, je = jrt.router_cycle(
        jrt.SubnetState(*(jnp.asarray(x) for x in state)), *jt[:3],
        jnp.asarray(gmask), jnp.asarray(cmask), jnp.int32(1),
        jnp.asarray(accept), jnp.asarray(active),
        link_ok=jnp.asarray(link_ok), router_ok=jnp.asarray(router_ok),
    )
    for arb_fn in (trt.arbitrate, tops.arbitrate_lanes):
        ts, te = trt.router_cycle(
            interop.subnet_state(state), *tt[:3], torch.from_numpy(gmask),
            torch.from_numpy(cmask), torch.tensor(1, dtype=torch.int32),
            torch.from_numpy(accept), torch.from_numpy(active),
            arbitrate_fn=arb_fn, link_ok=torch.from_numpy(link_ok),
            router_ok=torch.from_numpy(router_ok),
        )
        for name, a, b in zip(jrt.SubnetState._fields, js, ts):
            _eq(a, b, name)
        for name, a, b in zip(jrt.CycleEvents._fields, je, te):
            _eq(a, b, name)


@pytest.mark.parametrize("seed", [21, 22])
def test_inject_all_matches(seed):
    rng = np.random.default_rng(seed)
    S, R = 4, 36
    state = _random_subnet_state(rng)
    want = rng.random((S, R)) < 0.6
    dest = rng.integers(0, R, (S, R)).astype(np.int32)
    src = np.broadcast_to(np.arange(R, dtype=np.int32), (S, R)).copy()
    cls = rng.integers(0, 2, (S, R)).astype(np.int32)
    binj = rng.integers(0, 5000, (S, R)).astype(np.int32)
    gmask = rng.random((S, V)) < 0.7
    cmask = rng.random((S, V)) < 0.7
    args = (want, dest, src, cls, binj, gmask, cmask)
    js, jok = jrt.inject_all(jrt.SubnetState(*(jnp.asarray(x) for x in state)),
                             *(jnp.asarray(x) for x in args))
    ts, tok = trt.inject_all(interop.subnet_state(state),
                             *(torch.from_numpy(x) for x in args))
    for name, a, b in zip(jrt.SubnetState._fields, js, ts):
        _eq(a, b, name)
    _eq(jok, tok, "ok")
