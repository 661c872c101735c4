"""Predictor bank for the reconfiguration controller.

Every member (KF / EMA / last-value / always-on / always-off) advances each
epoch; `PredictorPolicy.kind` selects which signal drives the hysteresis
machine.  With ``guard`` armed the KF member gets the self-healing layer:
an innovation gate, a divergence watchdog and a covariance reset.  With the
guard disarmed every gated `where` selects the unguarded value.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._util import tree_map
from repro_torch.core import kalman

Tensor = torch.Tensor

# predictor-kind encoding; `step_probed` stacks the candidates in this order
KF = 0
EMA = 1
LAST = 2
ALWAYS_ON = 3
ALWAYS_OFF = 4

PREDICTORS: dict[str, int] = {
    "kf": KF,
    "ema": EMA,
    "last": LAST,
    "always_on": ALWAYS_ON,
    "always_off": ALWAYS_OFF,
}


class PredictorPolicy(NamedTuple):
    kind: Tensor            # () int32 in [0, 5)
    ema_alpha: Tensor       # () float32
    threshold: Tensor       # () float32 binarization threshold
    guard: Tensor           # () bool — self-healing layer armed
    nis_threshold: Tensor   # () float32 — innovation-gate reject level
    watchdog_limit: Tensor  # () int32 — consecutive rejects before unhealthy
    cov_limit: Tensor       # () float32 — tr(P) divergence ceiling


def predictor_policy(
    name: str = "kf",
    ema_alpha: float = 0.5,
    threshold: float = 0.0,
    guard: bool = False,
    nis_threshold: float = 50.0,
    watchdog_limit: int = 3,
    cov_limit: float = 1e4,
) -> PredictorPolicy:
    if name not in PREDICTORS:
        raise ValueError(
            f"unknown predictor {name!r}; expected one of {sorted(PREDICTORS)}"
        )
    if not 0.0 < ema_alpha <= 1.0:
        raise ValueError(f"ema_alpha={ema_alpha} outside (0, 1]")
    if nis_threshold <= 0.0:
        raise ValueError(f"nis_threshold={nis_threshold} must be positive")
    if watchdog_limit < 1:
        raise ValueError(f"watchdog_limit={watchdog_limit} must be >= 1")
    if cov_limit <= 0.0:
        raise ValueError(f"cov_limit={cov_limit} must be positive")
    f32, i32 = torch.float32, torch.int32
    return PredictorPolicy(
        kind=torch.tensor(PREDICTORS[name], dtype=i32),
        ema_alpha=torch.tensor(ema_alpha, dtype=f32),
        threshold=torch.tensor(threshold, dtype=f32),
        guard=torch.tensor(bool(guard)),
        nis_threshold=torch.tensor(nis_threshold, dtype=f32),
        watchdog_limit=torch.tensor(watchdog_limit, dtype=i32),
        cov_limit=torch.tensor(cov_limit, dtype=f32),
    )


class PredictorState(NamedTuple):
    kf: kalman.KalmanState  # x (1,), p (1, 1)
    ema: Tensor             # () float32
    reject_run: Tensor      # () int32 — consecutive innovation-gate rejects
    healthy: Tensor         # () bool — watchdog verdict after this epoch


def init_state(dtype=torch.float32) -> PredictorState:
    return PredictorState(
        kf=kalman.init_state(1, dtype=dtype),
        ema=torch.zeros((), dtype=dtype),
        reject_run=torch.tensor(0, dtype=torch.int32),
        healthy=torch.tensor(True),
    )


class KFInternals(NamedTuple):
    innovation: Tensor  # (m,) z - H x^
    gain: Tensor        # (m,) gain row K[0]
    cov_trace: Tensor   # () tr(P_k)
    x_pred: Tensor      # () one-step prediction A x_k
    nis: Tensor         # () normalized innovation squared
    rejected: Tensor    # () int32 — innovation gate coasted
    reset: Tensor       # () int32 — covariance reset fired
    healthy: Tensor     # () int32 — watchdog verdict


def step_probed(
    pp: PredictorPolicy,
    kf_params: kalman.KalmanParams,
    state: PredictorState,
    z: Tensor,
) -> tuple[PredictorState, Tensor, KFInternals]:
    """`step` plus the KF internals of the epoch.  ``z`` (m,) steps one
    bank; ``z`` (B, m) steps B banks at once, with every leaf of ``pp`` and
    ``state`` carrying the leading B.  One bank is a batch of one, so a
    bank's bits do not depend on how many step beside it."""
    if z.ndim > 1:
        return _step_rows(pp, kf_params, state, z)
    out = _step_rows(tree_map(lambda x: x[None], pp), kf_params,
                     tree_map(lambda x: x[None], state), z[None])
    return tuple(tree_map(lambda x: x[0], part) for part in out)


def _step_rows(pp, kf_params, state, z):
    kf_post, kf_prior, innovation, s, gain = kalman.batched_update(
        kf_params, state.kf, z)
    m = z.shape[-1]
    zsum = z[:, 0]
    for j in range(1, m):
        zsum = zsum + z[:, j]
    zbar = zsum / m
    ema = pp.ema_alpha * zbar + (1.0 - pp.ema_alpha) * state.ema

    # innovation gate: a NaN observation always rejects (NaN > t is False)
    nis = kalman.batched_nis(s, innovation)
    z_finite = torch.isfinite(z).all(-1)
    reject = pp.guard & (~z_finite | (nis > pp.nis_threshold))
    kf_x = torch.where(reject[:, None], kf_prior.x, kf_post.x)
    kf_p = torch.where(reject[:, None, None], kf_prior.p, kf_post.p)

    # divergence watchdog + covariance reset
    zero_i = torch.zeros((), dtype=torch.int32)
    reject_run = torch.where(reject, state.reject_run + 1, zero_i)
    cov_tr = kalman.batched_trace(kf_p)
    cov_bad = ~torch.isfinite(cov_tr) | (cov_tr > pp.cov_limit)
    run_bad = reject_run >= pp.watchdog_limit
    do_reset = pp.guard & ((reject_run == pp.watchdog_limit) | cov_bad)
    n = kf_params.state_dim
    kf_x = torch.where(
        do_reset[:, None],
        torch.where(torch.isfinite(kf_x), kf_x, torch.zeros_like(kf_x)),
        kf_x,
    )
    kf_p = torch.where(do_reset[:, None, None],
                       torch.eye(n, dtype=kf_p.dtype), kf_p)
    healthy = ~pp.guard | ~(run_bad | cov_bad)
    kf_state = kalman.KalmanState(x=kf_x, p=kf_p)

    x_pred = kalman._mv(kf_params.a, kf_x)[:, 0]       # one_step_prediction
    ones = torch.ones_like(reject_run)
    candidates = torch.stack([
        kalman.binarize(x_pred, pp.threshold),
        kalman.binarize(ema, pp.threshold),
        kalman.binarize(zbar, pp.threshold),
        ones, ones - 1,
    ], dim=-1)
    signal = candidates.gather(-1, pp.kind.long()[:, None])[:, 0]
    internals = KFInternals(
        innovation=innovation,
        gain=gain[:, 0],
        cov_trace=kalman.batched_trace(kf_state.p),
        x_pred=x_pred,
        nis=nis,
        rejected=reject.to(torch.int32),
        reset=do_reset.to(torch.int32),
        healthy=healthy.to(torch.int32),
    )
    new_state = PredictorState(
        kf=kf_state, ema=ema, reject_run=reject_run, healthy=healthy
    )
    return new_state, signal, internals


def step(
    pp: PredictorPolicy,
    kf_params: kalman.KalmanParams,
    state: PredictorState,
    z: Tensor,
) -> tuple[PredictorState, Tensor]:
    """Advance the bank one epoch; returns (new_state, signal () int32, or
    (B,) for B banks)."""
    new_state, signal, _ = step_probed(pp, kf_params, state, z)
    return new_state, signal
