"""Synthetic CPU/GPU chiplet traffic (paper §4.1 workloads, Fig. 4 dynamics).

Each GPU benchmark is a Markov-modulated Bernoulli injection process
(rate_lo, rate_hi, p_enter, p_exit) plus a stable CPU rate.  Every demand
source lowers through `resolve_source` to the canonical `EpochDemand`: a
`WorkloadProfile` whose five leaves are (n_epochs,) float32 tensors, one
parameter row per epoch.  Scenario schedules are materialized with numpy
exactly as the JAX package does, so their rows agree bit for bit.

Recorded traces, their npz schema and the workload registry are not part
of this package yet.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Iterable, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

Tensor = torch.Tensor


class WorkloadProfile(NamedTuple):
    """Injection parameters; leaves are floats or float32 tensors."""

    gpu_rate_lo: float | Tensor
    gpu_rate_hi: float | Tensor
    p_enter: float | Tensor      # low -> high phase transition prob per cycle
    p_exit: float | Tensor       # high -> low
    cpu_rate: float | Tensor = 0.12

    def epoch_demand(self, n_epochs: int) -> "WorkloadProfile":
        """Broadcast stationary rates across the epoch axis (float32)."""

        def lower(x):
            x = torch.as_tensor(x, dtype=torch.float32)
            if x.ndim == 0:
                return x.expand(n_epochs).clone()
            if tuple(x.shape) != (n_epochs,):
                raise ValueError(
                    f"per-epoch profile leaf has shape {tuple(x.shape)}, "
                    f"expected ({n_epochs},)"
                )
            return x

        return WorkloadProfile(*(lower(x) for x in self))


PROFILES: dict[str, WorkloadProfile] = {
    "PATH": WorkloadProfile(0.06, 0.31, 0.00020, 0.00040),
    "LIB": WorkloadProfile(0.08, 0.33, 0.00025, 0.00035),
    "STO": WorkloadProfile(0.12, 0.36, 0.00030, 0.00028),
    "MUM": WorkloadProfile(0.04, 0.38, 0.00025, 0.00020),
    "BFS": WorkloadProfile(0.03, 0.40, 0.00030, 0.00012),
    "LPS": WorkloadProfile(0.10, 0.35, 0.00028, 0.00030),
}


def stack_profiles(profiles: Iterable[WorkloadProfile]) -> WorkloadProfile:
    """Stack profiles into one profile with (B, ...) float32 leaves."""
    rows = list(profiles)
    return WorkloadProfile(*(
        torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in leaves])
        for leaves in zip(*rows)
    ))


def init_phase() -> Tensor:
    """Global burst phase shared by all GPU tiles: 0 = low, 1 = high."""
    return torch.tensor(0, dtype=torch.int32)


def step_phase_u(profile: WorkloadProfile, phase: Tensor, u: Tensor) -> Tensor:
    """Advance the Markov burst phase given a pre-drawn uniform `u`."""
    enter = (phase == 0) & (u < profile.p_enter)
    exit_ = (phase == 1) & (u < profile.p_exit)
    one = torch.ones_like(phase)
    return torch.where(
        enter, one, torch.where(exit_, torch.zeros_like(phase), phase)
    ).to(torch.int32)


def injection_rates(
    profile: WorkloadProfile, node_type: Tensor, phase: Tensor
) -> Tensor:
    """Probability that each node generates a request this cycle."""
    gpu_rate = torch.where(phase == 1, profile.gpu_rate_hi, profile.gpu_rate_lo)
    zero = torch.zeros((), dtype=gpu_rate.dtype, device=gpu_rate.device)
    rates = torch.where(node_type == 1, gpu_rate, zero)
    rates = torch.where(node_type == 0, profile.cpu_rate, rates)
    return rates


# ---------------------------------------------------------------------------
# scenario schedules: piecewise workload programs
# ---------------------------------------------------------------------------

def _resolve_profile(p: str | WorkloadProfile) -> WorkloadProfile:
    return PROFILES[p] if isinstance(p, str) else p


class Segment(NamedTuple):
    """One piece of a scenario, governing epochs in [start, next start)."""

    start: float
    profile: str | WorkloadProfile
    ramp_to: str | WorkloadProfile | None = None
    pin_phase: int | None = None


@dataclasses.dataclass(frozen=True)
class ScenarioSchedule:
    """A piecewise-constant (or ramped) workload program."""

    segments: tuple[Segment, ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("ScenarioSchedule needs at least one segment")
        starts = [s.start for s in self.segments]
        if starts != sorted(starts):
            raise ValueError(f"segment starts must be sorted, got {starts}")
        if starts[0] != 0.0:
            raise ValueError(f"first segment must start at 0.0, got {starts[0]}")
        for s in self.segments:
            if not 0.0 <= s.start < 1.0:
                raise ValueError(f"segment start {s.start} outside [0, 1)")
            if s.pin_phase not in (None, 0, 1):
                raise ValueError(f"pin_phase must be None/0/1, got {s.pin_phase}")

    def materialize(self, n_epochs: int) -> WorkloadProfile:
        bounds = [int(round(s.start * n_epochs)) for s in self.segments]
        bounds.append(n_epochs)
        rows = {f: np.empty((n_epochs,), np.float32)
                for f in WorkloadProfile._fields}
        for seg, lo, hi in zip(self.segments, bounds, bounds[1:]):
            if hi <= lo:
                continue
            base = _resolve_profile(seg.profile)
            tgt = _resolve_profile(seg.ramp_to) if seg.ramp_to is not None else None
            t = (np.arange(hi - lo, dtype=np.float32)
                 / max(hi - lo - 1, 1))
            for f in WorkloadProfile._fields:
                a = np.float32(getattr(base, f))
                if tgt is not None:
                    row = a + t * (np.float32(getattr(tgt, f)) - a)
                else:
                    row = np.full((hi - lo,), a, np.float32)
                rows[f][lo:hi] = row
            if seg.pin_phase is not None:
                rows["p_enter"][lo:hi] = 1.0 if seg.pin_phase == 1 else 0.0
                rows["p_exit"][lo:hi] = 0.0 if seg.pin_phase == 1 else 1.0
        return WorkloadProfile(**{
            f: torch.from_numpy(rows[f]) for f in WorkloadProfile._fields
        })

    def epoch_demand(self, n_epochs: int) -> WorkloadProfile:
        return self.materialize(n_epochs)


def phase_shift(
    a: str | WorkloadProfile = "PATH",
    b: str | WorkloadProfile = "BFS",
    at: float = 0.5,
) -> ScenarioSchedule:
    """Run ``a``, then ``b`` from fraction ``at``."""
    return ScenarioSchedule((Segment(0.0, a), Segment(at, b)))


def scale_rates(p: str | WorkloadProfile, scale: float) -> WorkloadProfile:
    """Scale a profile's GPU injection rates (phase dynamics untouched)."""
    p = _resolve_profile(p)
    return p._replace(
        gpu_rate_lo=float(p.gpu_rate_lo) * scale,
        gpu_rate_hi=float(p.gpu_rate_hi) * scale,
    )


def shift_scenario(
    a: str | WorkloadProfile = "PATH",
    b: str | WorkloadProfile = "BFS",
    dip_scale: float = 0.0,
) -> ScenarioSchedule:
    """The predictor-ablation gate: ``a`` then ``b`` as four 30-epoch
    kernel-phase arcs [calm 12][burst 10][dip 2][burst 6] (fractions of a
    120-epoch run), burst phases pinned."""
    arcs = []
    for arc, prof in ((0, a), (30, a), (60, b), (90, b)):
        base = _resolve_profile(prof)
        arcs += [
            Segment(arc / 120, base, pin_phase=0),
            Segment((arc + 12) / 120, base, pin_phase=1),
            Segment((arc + 22) / 120, scale_rates(base, dip_scale),
                    pin_phase=0),
            Segment((arc + 24) / 120, base, pin_phase=1),
        ]
    return ScenarioSchedule(tuple(arcs))


def rate_ramp(
    base: str | WorkloadProfile = "LIB",
    lo_scale: float = 0.5,
    hi_scale: float = 1.5,
) -> ScenarioSchedule:
    """Linear offered-load ramp across the whole run."""
    base = _resolve_profile(base)
    return ScenarioSchedule((
        Segment(0.0, scale_rates(base, lo_scale),
                ramp_to=scale_rates(base, hi_scale)),
    ))


def program_mix(
    programs: tuple[str | WorkloadProfile, ...] = ("PATH", "STO", "BFS"),
    repeats: int = 2,
) -> ScenarioSchedule:
    """The programs back to back in equal slices, repeated."""
    n = len(programs) * repeats
    return ScenarioSchedule(tuple(
        Segment(i / n, programs[i % len(programs)]) for i in range(n)
    ))


def burst_train(
    base: str | WorkloadProfile = "BFS",
    calm: int = 8,
    burst: int = 10,
    dip: int = 1,
) -> ScenarioSchedule:
    """Deterministic burst train with mid-burst micro-dips on a 64-slot grid."""
    base = _resolve_profile(base)
    if calm + burst + dip + burst > 64:
        raise ValueError("one burst unit must fit the 64-slot grid")
    segs, pos = [], 0
    while pos < 64:
        for length, pin in ((calm, 0), (burst, 1), (dip, 0), (burst, 1)):
            if pos >= 64:
                break
            segs.append(Segment(pos / 64, base, pin_phase=pin))
            pos += length
    return ScenarioSchedule(tuple(segs))


SCENARIOS: dict[str, ScenarioSchedule] = {
    "SHIFT_PATH_BFS": shift_scenario("PATH", "BFS"),
    "SHIFT_SMOOTH": phase_shift("PATH", "BFS", at=0.5),
    "RAMP_LIB": rate_ramp("LIB", 0.5, 1.5),
    "MIX_PATH_STO_BFS": program_mix(("PATH", "STO", "BFS"), repeats=2),
    "BURSTS_BFS": burst_train("BFS"),
}


@runtime_checkable
class TrafficSource(Protocol):
    """Anything with ``epoch_demand(n_epochs) -> EpochDemand``."""

    def epoch_demand(self, n_epochs: int) -> WorkloadProfile:
        ...


EpochDemand = WorkloadProfile

TrafficSourceLike = str | WorkloadProfile | ScenarioSchedule


def lookup_workload(name: str) -> TrafficSource:
    if name in PROFILES:
        return PROFILES[name]
    if name in SCENARIOS:
        return SCENARIOS[name]
    known = sorted({*PROFILES, *SCENARIOS})
    near = difflib.get_close_matches(name, known, n=3, cutoff=0.4)
    hint = f"; did you mean {near}?" if near else ""
    raise ValueError(
        f"unknown workload {name!r}{hint} (known workloads: {known})"
    )


def resolve_source(source: TrafficSourceLike, n_epochs: int) -> EpochDemand:
    """Lower a name, profile, schedule or any TrafficSource to per-epoch
    float32 rows, rejecting non-finite or negative demand."""
    if isinstance(source, str):
        source = lookup_workload(source)
    if not isinstance(source, TrafficSource):
        if isinstance(source, tuple) and len(source) == len(
            WorkloadProfile._fields
        ):
            source = WorkloadProfile(*source)
        else:
            raise TypeError(
                f"cannot resolve demand source of type "
                f"{type(source).__name__}; expected a workload name, "
                "WorkloadProfile, ScenarioSchedule, or any TrafficSource"
            )
    demand = source.epoch_demand(n_epochs)
    for f in WorkloadProfile._fields:
        leaf = getattr(demand, f)
        if tuple(leaf.shape) != (n_epochs,) or leaf.dtype != torch.float32:
            raise ValueError(
                f"source {type(source).__name__} produced leaf {f!r} with "
                f"shape {tuple(leaf.shape)} dtype {leaf.dtype}; EpochDemand "
                f"needs ({n_epochs},) float32"
            )
        if not bool(torch.isfinite(leaf).all()):
            raise ValueError(
                f"source {type(source).__name__} produced non-finite demand "
                f"in leaf {f!r}"
            )
        if bool((leaf < 0).any()):
            raise ValueError(
                f"source {type(source).__name__} produced negative demand "
                f"in leaf {f!r}"
            )
    return demand
