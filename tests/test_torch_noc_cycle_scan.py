"""Port congruence: the plain lane engine stepped 50 cycles against JAX's
jitted `fused.cycle_step_lanes` scan, bitwise on every LaneState field, with
and without the 16-bit stamp mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lanes import _assert_lanes_equal, _dims, _epoch_inputs, _lane_states
from repro.kernels.noc_cycle import fused as jf
from repro_torch.kernels.noc_cycle import fused as tf
from repro_torch.kernels.noc_cycle import ops as tops


@pytest.mark.parametrize("mode,stamp_mask", [("kf", 0xFFFF), ("4subnet", 0)])
def test_fifty_cycles_match_jitted_lane_step(mode, stamp_mask):
    rng, js, ts = _lane_states(4)
    xi, xf, consts = _epoch_inputs(rng, 50, mode, 1)
    jd = _dims(jf, stamp_mask)

    @jax.jit
    def run(st, xi, xf, consts):
        def body(st, x):
            return jf.cycle_step_lanes(jd, st, x[0], x[1], *consts), None
        return jax.lax.scan(body, st, (xi, xf))[0]

    j = run(js, xi, xf, tuple(map(jnp.asarray, consts)))
    t = tops.fused_cycle_step(_dims(tf, stamp_mask), ts,
                              torch.from_numpy(np.asarray(xi)),
                              torch.from_numpy(np.asarray(xf)),
                              *map(torch.from_numpy, consts))
    _assert_lanes_equal(j, t, mode)
    assert int(np.asarray(j.cnt).sum()) > 0
