"""The flight-recorder trace of the NoC simulator.

`sim.simulate_with_trace` returns a `SimTrace` beside its `SimResult`; the
untraced `sim.simulate` computes none of it.  The fabric probes are
accumulated per cycle from END-of-cycle state, so the three cycle engines
("fused", "arb", "ref") agree on them bitwise.

This module imports nothing of the simulator: sim.py imports it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class SimTrace(NamedTuple):
    """Per-epoch introspection stream (leading axis E = n_epochs), on the
    CPU.  S = padded subnets, R = routers, P = ports, V = VCs per subnet."""

    # fabric occupancy: sum over cycles of per-buffer flit count
    occ_sum: Tensor        # (E, S, R, P, V) int32
    # switch allocation: grants and refusals per router, summed over
    # output ports and cycles
    arb_grant: Tensor      # (E, S, R) int32
    arb_deny: Tensor       # (E, S, R) int32
    # memory-controller queue depth, summed / maxed over cycles
    mcq_sum: Tensor        # (E, R) int32
    mcq_max: Tensor        # (E, R) int32
    # KF internals at the epoch boundary (scalar-state, 3-obs filter)
    kf_innovation: Tensor  # (E, 3) float32
    kf_gain: Tensor        # (E, 3) float32
    kf_cov_trace: Tensor   # (E,)   float32
    kf_x_pred: Tensor      # (E,)   float32 one-step demand prediction
    # the normalized observation the filter consumed, AFTER telemetry
    # corruption (NaN in a NaN-telemetry epoch)
    z_obs: Tensor          # (E, 3) float32
    # fault and self-healing channels, one sample per epoch
    kf_nis: Tensor         # (E,)   float32 normalized innovation squared
    kf_rejected: Tensor    # (E,)   int32 {0,1} innovation gate coasted
    kf_reset: Tensor       # (E,)   int32 {0,1} covariance reset fired
    kf_healthy: Tensor     # (E,)   int32 {0,1} watchdog verdict
    faults_active: Tensor  # (E,)   int32 suppressed fabric elements +
    #                        the telemetry-corruption flag
    # the node-class plan applied each epoch (last, as in the reference)
    place_cls: Tensor      # (E, R) int32 node class per router


def summarize_trace(trace: SimTrace) -> dict:
    """Small JSON-friendly digest of a SimTrace."""

    def a(x):
        return np.asarray(torch.as_tensor(x).detach().cpu())

    occ = a(trace.occ_sum)
    healthy = a(trace.kf_healthy)
    return {
        "epochs": int(occ.shape[0]),
        "occ_sum_total": int(occ.sum()),
        "arb_grant_total": int(a(trace.arb_grant).sum()),
        "arb_deny_total": int(a(trace.arb_deny).sum()),
        "mcq_max": int(a(trace.mcq_max).max()),
        "kf_innovation_rms": float(
            np.sqrt(np.mean(np.square(a(trace.kf_innovation))))
        ),
        "kf_cov_trace_last": float(a(trace.kf_cov_trace)[-1]),
        "kf_rejected_total": int(a(trace.kf_rejected).sum()),
        "kf_reset_total": int(a(trace.kf_reset).sum()),
        "fallback_epochs": int((healthy == 0).sum()),
        "fault_epochs": int((a(trace.faults_active) > 0).sum()),
        # router-epochs whose node class differs from the previous epoch's
        "place_moves_total": int(
            (np.diff(a(trace.place_cls), axis=0) != 0).sum()
        ),
    }
