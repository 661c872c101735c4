"""Port congruence: the plain lane engine (`fused.cycle_step_lanes`, the
plain version of the CUDA whole-cycle kernels) against the JAX B2 and B3
Pallas kernels in interpret mode for one cycle, bitwise on every LaneState
and ProbeLanes field.
States are built the way tests/test_cycle_engine.py builds its stage
states: random subnet and MC state from numpy, packed into lanes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lanes import (
    _assert_lanes_equal, _dims, _epoch_inputs, _lane_states, _random_dense_state,
)
from repro.core.noc import sim as jsim
from repro.kernels.noc_cycle import fused as jf
from repro.kernels.noc_cycle.kernel import fused_cycle_kernel
from repro_torch import interop
from repro_torch.core.noc import sim as tsim
from repro_torch.kernels.noc_cycle import fused as tf
from repro_torch.kernels.noc_cycle import ops as tops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_unpack_roundtrip_and_matches_reference(seed):
    rng, js, ts = _lane_states(seed)
    _assert_lanes_equal(js, ts, "pack")
    subs, mc, outst, backlog, phase = tf.unpack_state(_dims(tf), ts, tsim.MCState)
    rng = np.random.default_rng(seed)
    ref = _random_dense_state(rng)
    for name, a, b in zip(jsim.rt.SubnetState._fields, ref[0], subs):
        np.testing.assert_array_equal(a.astype(np.int64), b.numpy().astype(np.int64),
                                      err_msg=name)
    for name, a, b in zip(jsim.MCState._fields, ref[1], mc):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    np.testing.assert_array_equal(ref[2], outst.numpy())
    np.testing.assert_array_equal(ref[3], backlog.numpy())
    assert int(ref[4]) == int(phase)


@pytest.mark.parametrize("mode,config", [("kf", 1), ("4subnet", 0)])
def test_one_cycle_matches_pallas_interpret(mode, config):
    rng, js, ts = _lane_states(3)
    xi, xf, consts = _epoch_inputs(rng, 1, mode, config)
    j = fused_cycle_kernel(js, jnp.asarray(xi[0]), jnp.asarray(xf[0]),
                           *map(jnp.asarray, consts), dims=_dims(jf),
                           interpret=True)
    # start the port from the JAX-packed state carried across, so this
    # test isolates the cycle step from the packing
    ts = interop.lane_state(js)
    t = tops.fused_cycle_step(_dims(tf), ts, torch.from_numpy(np.asarray(xi[0])),
                              torch.from_numpy(np.asarray(xf[0])),
                              *map(torch.from_numpy, consts))
    _assert_lanes_equal(j, t, mode)


def _random_probe(rng):
    """A non-zero ProbeLanes carry as numpy: random counts on the real
    lanes, 0 on the padded ones (which never accumulate)."""
    d = _dims(jf)

    def rows(n, lanes, hi):
        return rng.integers(0, hi, (n, lanes)).astype(np.int32)

    occ = rows(d.PV, d.lanes_sr, 500)
    arb = rows(2, d.lanes_sr, 300)
    mcq = rows(2, jf.LANES_R, 40)
    for x in (occ, arb):
        x.reshape(x.shape[0], d.S, jf.R_PAD)[:, :, d.R:] = 0
    mcq[:, d.R:] = 0
    return jf.ProbeLanes(occ=occ, arb=arb, mcq=mcq)


def test_one_probed_cycle_matches_pallas_interpret():
    mode, config = "kf", 1
    rng, js, _ = _lane_states(4)
    xi, xf, consts = _epoch_inputs(rng, 1, mode, config)
    pb = _random_probe(rng)
    j, jp = fused_cycle_kernel(
        js, jnp.asarray(xi[0]), jnp.asarray(xf[0]), *map(jnp.asarray, consts),
        dims=_dims(jf), interpret=True,
        probe=jf.ProbeLanes(*map(jnp.asarray, pb)),
    )
    t, tp = tops.fused_cycle_step(
        _dims(tf), interop.lane_state(js), torch.from_numpy(np.asarray(xi[0])),
        torch.from_numpy(np.asarray(xf[0])), *map(torch.from_numpy, consts),
        probe=interop.probe_lanes(pb),
    )
    _assert_lanes_equal(j, t, mode)
    for name, a, b in zip(jf.ProbeLanes._fields, jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{mode} probe {name}")
    # the step added to the carry it was handed
    assert (tp.occ.numpy() >= pb.occ).all() and (tp.occ.numpy() > pb.occ).any()
    # unpacked to the dense accumulators, as the reference unpacks them
    for a, b in zip(jf.unpack_probe(_dims(jf), jp), tf.unpack_probe(_dims(tf), tp)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
