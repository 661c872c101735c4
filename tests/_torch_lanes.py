"""Shared helpers for the lane-engine congruence tests: random dense
states packed into lanes, and per-epoch rows + per-cycle xs made with the
JAX package's own helpers from numpy-drawn streams."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.noc import sim as jsim
from repro.core.noc.topology import make_topology as jmake_topology
from repro.kernels.noc_cycle import fused as jf
from repro_torch import interop
from repro_torch.kernels.noc_cycle import fused as tf

S, R, P, V, B, Q = 4, 36, 5, 4, 4, 16


def _dims(mod, stamp_mask=0xFFFF):
    return mod.lane_dims(S=S, R=R, V=V, B=B, Q=Q, width=6,
                         mc_service_period=2, mshr_limit=16, bcap=64,
                         stamp_mask=stamp_mask)


def _random_dense_state(rng):
    dest = rng.integers(0, R, (S, R, P, V, B))
    src = rng.integers(0, R, (S, R, P, V, B))
    cls = rng.integers(0, 2, (S, R, P, V, B))
    subs = jsim.rt.SubnetState(
        buf_meta=(dest + (src << 6) + (cls << 12)).astype(np.int16),
        buf_binj=rng.integers(0, 5000, (S, R, P, V, B)).astype(np.uint16),
        head=rng.integers(0, B, (S, R, P, V)).astype(np.int8),
        count=rng.integers(0, B + 1, (S, R, P, V)).astype(np.int8),
        rr_ptr=rng.integers(0, P * V, (S, R, P)).astype(np.int8),
    )
    q_src = rng.integers(0, R, (R, Q))
    mc = jsim.MCState(
        q_meta=(q_src + (rng.integers(0, 2, (R, Q)) << 6)).astype(np.int8),
        head=rng.integers(0, Q, (R,)).astype(np.int32),
        count=rng.integers(0, Q + 1, (R,)).astype(np.int32),
        timer=rng.integers(0, 3, (R,)).astype(np.int32),
        stage_valid=rng.random((R,)) < 0.5,
        stage_dst=rng.integers(0, R, (R,)).astype(np.int32),
        stage_cls=rng.integers(0, 2, (R,)).astype(np.int32),
    )
    outst = rng.integers(0, 17, (R,)).astype(np.int32)
    backlog = rng.integers(0, 65, (R,)).astype(np.int32)
    return subs, mc, outst, backlog, np.int32(rng.integers(0, 2))


def _epoch_inputs(rng, n_cycles, mode="kf", config=1):
    """Per-epoch rows and per-cycle xs from the JAX package's own helpers
    (random streams from numpy), as numpy arrays."""
    d = _dims(jf)
    topo = jmake_topology()
    mp = jsim.NoCConfig(mode=mode).mode_policy()
    g_vec, c_vec = jsim.class_vc_masks(mp, jnp.int32(config))
    gm, cm = jf.mask_rows(d, g_vec, c_vec)
    prof = jf.prof_rows(jsim.WorkloadProfile(0.1, 0.5, 0.3, 0.2, 0.25))
    route, exists, ntype = jf.run_consts(d, topo)
    link_ok = rng.random((R, P)) < 0.9
    link_rows = jnp.tile(jnp.pad(jnp.asarray(link_ok, jnp.int32).T,
                                 ((0, 0), (0, jf.R_PAD - R))), (1, S))
    ntype_e = jnp.asarray(np.where(topo.node_type == 2, 2,
                                   rng.integers(0, 2, R)).astype(np.int32))
    sub_ids = jnp.arange(S)
    node_cls = jnp.where(ntype_e == 1, 1, 0)
    req_sub = jnp.where(mp.four_subnet, 2 * node_cls, 0)
    req_match = (sub_ids[:, None] == req_sub[None, :]) & mp.sub_enabled[:, None]
    pol_sr, pol_r = jf.policy_rows(
        d, mp.sub_enabled, mp.sub_is_req, mp.sub_enabled & ~mp.sub_is_req,
        req_match, mp.four_subnet, jnp.sum(mp.sub_is_req.astype(jnp.int32)),
    )
    cycles = jnp.arange(60_000, 60_000 + n_cycles, dtype=jnp.int32)
    xi, xf = jf.cycle_xs(
        d, cycles,
        jnp.asarray(rng.random(n_cycles).astype(np.float32)),
        jnp.asarray(rng.random((n_cycles, R)).astype(np.float32)),
        jnp.asarray(topo.mc_ids[rng.integers(0, 8, (n_cycles, R))]),
        jnp.asarray(rng.integers(-1, 2, n_cycles).astype(np.int32)),
        jnp.asarray(rng.random((n_cycles, S)) < 0.8),
        jnp.asarray(rng.random(n_cycles) < 0.9),
        router_ok=jnp.asarray(rng.random(R) < 0.95),
        mc_ok=jnp.asarray(rng.random(R) < 0.9),
    )
    consts = (gm, cm, prof, pol_sr, pol_r, jf.placement_rows(d, ntype_e),
              route, exists * link_rows)
    return np.array(xi), np.array(xf), tuple(np.array(c) for c in consts)


def _lane_states(seed):
    rng = np.random.default_rng(seed)
    subs, mc, outst, backlog, phase = _random_dense_state(rng)
    js = jf.pack_state(_dims(jf), jsim.rt.SubnetState(*map(jnp.asarray, subs)),
                       jsim.MCState(*map(jnp.asarray, mc)), jnp.asarray(outst),
                       jnp.asarray(backlog), jnp.asarray(phase))
    ts = tf.pack_state(_dims(tf), interop.subnet_state(subs),
                       interop.mc_state(mc), torch.from_numpy(outst),
                       torch.from_numpy(backlog), torch.tensor(phase))
    return rng, js, ts


def _assert_lanes_equal(js, ts, msg=""):
    for name, a, b in zip(jf.LaneState._fields, js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg} {name}")


