"""KF scheduler: the paper's control loop at the fleet layer.

Two deployments of the same predictor:

  KFScheduler — ONE filter arbitrating which pre-built train-step variant
    runs next (balanced vs comm-priority), the paper's {equal split,
    GPU-boosted} configuration pair: telemetry -> KF epoch update ->
    binarized signal -> hysteresis machine (core.allocator's
    warmup/hold/revert rules) -> variant index.  It is host control: the
    filter and the policy run on CPU tensors.

  FleetKF — a BANK of filters, one per (pod x traffic-class) link, whose
    state lives on the device and advances in lockstep through the kf_bank
    kernel (B4) each telemetry epoch; emits a per-link throttle(0) /
    boost(1) signal like the paper's per-router VC reallocation.  On the
    card an epoch is ONE launch of B4, which writes the signal too; the
    bank's constants are checked once, when it is built.  The same filter
    as the single-filter core.kalman step (tests/test_torch_kf_bank.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._util import resolve_device
from repro_torch.core import kalman
from repro_torch.core.allocator import (
    PolicyConfig, apply_policy, init_policy_state,
)
from repro_torch.dist.telemetry import StaticCosts, Telemetry  # noqa: F401  (re-export)
from repro_torch.kernels.kf_bank import ops as kf_ops


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Step-scaled analogues of the paper's cycle counts (§3.2)."""

    epoch_steps: int = 10        # KF measurement cadence
    warmup_steps: int = 30       # ignore KF decisions before this step
    hold_steps: int = 20         # freeze after any reallocation
    revert_steps: int = 10_000   # max boosted steps before forced fallback
    kf_q: float = 1e-3           # process noise
    kf_r: float = 1e-1           # observation noise (per counter)


class KFScheduler:
    """Dispatches between pre-built step variants, on the host."""

    def __init__(self, cfg: SchedulerConfig,
                 telemetry: Optional[Telemetry] = None):
        self.cfg = cfg
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry(costs_by_variant={}))
        self.kf_params = kalman.paper_params(q=cfg.kf_q, r=cfg.kf_r)
        self.kf_state = kalman.init_state(1)
        self.policy_cfg = PolicyConfig(
            warmup=cfg.warmup_steps, hold=cfg.hold_steps,
            revert=cfg.revert_steps)
        self.policy = init_policy_state()
        self.step_count = 0
        self.signals: list[int] = []

    @property
    def variant(self) -> int:
        return int(self.policy.config)

    def on_step(self) -> int:
        """Advance one step; at epoch boundaries run the KF + policy."""
        self.step_count += 1
        if self.cfg.epoch_steps > 0 and \
                self.step_count % self.cfg.epoch_steps == 0:
            z = self.telemetry.observe()
            self.kf_state, _, _ = kalman.step(
                self.kf_params, self.kf_state, z)
            signal = kalman.binarize(self.kf_state.x[0])
            self.signals.append(int(signal))
            self.policy = apply_policy(
                self.policy_cfg, self.policy, signal,
                torch.tensor(self.step_count, dtype=torch.int32))
        return self.variant


class FleetKF:
    """Bank of n independent scalar-state filters on the kf_bank kernel.

    One filter per (pod x traffic-class); `epoch` advances every filter one
    predict+correct cycle on the epoch's observation matrix and returns the
    binarized boost signals.  The state lives on ``device`` (the CUDA
    device unless the caller passes another).  Each epoch replaces ``x``
    and ``p`` with fresh tensors, as the reference does."""

    def __init__(self, n: int, cfg: Optional[SchedulerConfig] = None,
                 h: tuple[float, ...] = (1.0, 1.0, 1.0),
                 device: str | torch.device | None = None):
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.n = n
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.h = torch.tensor(h, **f32)
        self.r = torch.full((len(h),), self.cfg.kf_r, **f32)
        # matches core.kalman.init_state(p0=1.0), leaf-for-leaf on n=1
        self.x = torch.zeros((n,), **f32)
        self.p = torch.ones((n,), **f32)
        self._bank = None
        if self.device.type == "cuda":
            from repro_torch.kernels.kf_bank import kernel as kf_kernel

            self._bank = kf_kernel.Bank(n, self.h, self.r, a=1.0,
                                        q=self.cfg.kf_q)

    def epoch(self, z) -> torch.Tensor:
        """z: (n, m) normalized observations -> (n,) int32 boost signals."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        if self._bank is None:
            self.x, self.p, signal = kf_ops.kf_bank_epoch_plain(
                self.x, self.p, z, self.h, self.r, a=1.0, q=self.cfg.kf_q)
        else:
            self.x, self.p, signal = self._bank.epoch(self.x, self.p, z)
        return signal
