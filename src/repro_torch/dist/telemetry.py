"""Fleet telemetry: the KF scheduler's measurement path.

The paper feeds its filter three normalized NoC counters
(GPU_Stall_Dramfull, GPU_Icnt_Push, GPU_Stall_Icnt-Shader).  At the
training-fleet layer the analogues are:

  z1 dramfull   — HBM demand of the balanced step vs chip capacity
  z2 icnt_push  — collective (fabric) bytes of the balanced step vs the
                  wire budget `comm_scale`
  z3 stall      — fraction of step time spent waiting on input
                  (prefetch starvation), from the live StepTimer

z1/z2 come from a static per-variant cost model (`StaticCosts`); they
measure DEMAND under the balanced schedule, so the signal is stable and the
hysteresis machine, not measurement noise, decides when to revert.  The
observation is a host (CPU) tensor: the filter it feeds runs on the host.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import kalman


@dataclasses.dataclass(frozen=True)
class StaticCosts:
    """Per-step cost of one compiled variant (from dry-run analysis)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0


class StepTimer:
    """Wall-clock step phases: begin -> input ready -> end.

    Exports an EMA of the input-wait fraction (the stall observation) and of
    step time (the straggler signal at pod scale)."""

    def __init__(self, ema: float = 0.8):
        self._ema = ema
        self.wait_frac = 0.0
        self.step_time = None
        self._t0 = None
        self._t_ready = None

    def step_begin(self) -> None:
        self._t0 = time.perf_counter()
        self._t_ready = None

    def mark_input_ready(self) -> None:
        if self._t0 is not None:
            self._t_ready = time.perf_counter()

    def step_end(self) -> None:
        if self._t0 is None:
            # an end without a begin must not leave a ready mark behind to
            # be attributed to the NEXT step's wait time
            self._t_ready = None
            return
        now = time.perf_counter()
        dt = max(now - self._t0, 1e-12)
        # `is not None`: perf_counter() can legitimately be 0.0
        wait = (self._t_ready - self._t0) if self._t_ready is not None else 0.0
        frac = min(max(wait / dt, 0.0), 1.0)
        # the first observed fraction seeds the EMA
        self.wait_frac = (frac if self.step_time is None
                          else self._ema * self.wait_frac
                          + (1 - self._ema) * frac)
        self.step_time = (dt if self.step_time is None
                          else 0.9 * self.step_time + 0.1 * dt)
        self._t0 = self._t_ready = None


@dataclasses.dataclass
class Telemetry:
    """Measurement source for KFScheduler.

    costs_by_variant maps variant index -> StaticCosts; only variant 0 (the
    balanced schedule, which IS the demand) feeds the observations."""

    costs_by_variant: dict
    comm_scale: float = 1e9       # fabric bytes/step considered saturating
    hbm_capacity: float = 16e9    # per-chip HBM budget
    timer: StepTimer = dataclasses.field(default_factory=StepTimer)

    def observe(self) -> torch.Tensor:
        """The 3-vector z on the host, normalized to [-1, 1] (paper §3.2)."""
        demand = self.costs_by_variant.get(0, StaticCosts())
        raw = torch.tensor([
            demand.hbm_bytes / self.hbm_capacity,
            demand.collective_bytes / self.comm_scale,
            self.timer.wait_frac,
        ], dtype=torch.float32)
        hi = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float32)
        return kalman.normalize_observations(raw, torch.zeros(3), hi)
