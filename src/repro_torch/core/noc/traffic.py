"""Synthetic CPU/GPU chiplet traffic (paper §4.1 workloads, Fig. 4 dynamics).

Each GPU benchmark is a Markov-modulated Bernoulli injection process
(rate_lo, rate_hi, p_enter, p_exit) plus a stable CPU rate.  Every demand
source lowers through `resolve_source` to the canonical `EpochDemand`: a
`WorkloadProfile` whose five leaves are (n_epochs,) float32 tensors, one
parameter row per epoch.  Scenario schedules are materialized with numpy
exactly as the JAX package does, so their rows agree bit for bit.

A `RecordedTrace` replays per-epoch rows saved in a versioned npz file
(schema ``noc_demand_trace`` v1, no pickling).  The format is the one the
JAX package reads and writes, so a file written by either package loads
and validates in the other.  Named workloads resolve through a registry
first, then PROFILES, then SCENARIOS.
"""
from __future__ import annotations

import dataclasses
import difflib
import json
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

# Versioned npz trace schema.  A trace file is a plain npz (no pickling):
#   schema          — the literal "noc_demand_trace"
#   schema_version  — int, currently 1
#   name            — short trace name (informational)
#   meta_json       — JSON object of provenance
#   demand_<field>  — (T,) float32 row per WorkloadProfile field
TRACE_SCHEMA = "noc_demand_trace"
TRACE_SCHEMA_VERSION = 1

_FIT_MODES = ("exact", "tile", "stretch")


@dataclasses.dataclass(frozen=True)
class RecordedTrace:
    """A replayed per-epoch demand trace (a TrafficSource).

    ``demand`` holds the recorded rows as a ``WorkloadProfile`` of ``(T,)``
    float32 numpy leaves.  ``fit`` says how T rows meet a run of
    ``n_epochs`` epochs:

      * ``"exact"``   — require T == n_epochs (bitwise replay);
      * ``"tile"``    — epoch e reads row e % T;
      * ``"stretch"`` — resample the rows linearly onto n_epochs points
                        (numpy float64, then float32, as the reference).

    When T == n_epochs every mode passes the rows through untouched.
    """

    demand: WorkloadProfile
    fit: str = "exact"
    name: str = "trace"
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.fit not in _FIT_MODES:
            raise ValueError(
                f"fit must be one of {_FIT_MODES}, got {self.fit!r}"
            )
        rows = {}
        length = None
        for f in WorkloadProfile._fields:
            row = np.asarray(getattr(self.demand, f), np.float32)
            if row.ndim == 0:
                raise ValueError(
                    f"RecordedTrace leaf {f!r} is a scalar; recorded demand "
                    "must be per-epoch (T,) rows — use WorkloadProfile for "
                    "stationary sources"
                )
            if row.ndim != 1:
                raise ValueError(
                    f"RecordedTrace leaf {f!r} has shape {row.shape}, "
                    "expected (T,)"
                )
            if length is None:
                length = row.shape[0]
            elif row.shape[0] != length:
                raise ValueError(
                    f"RecordedTrace leaves disagree on length: {f!r} has "
                    f"{row.shape[0]}, expected {length}"
                )
            rows[f] = row
        if length == 0:
            raise ValueError("RecordedTrace needs at least one epoch row")
        object.__setattr__(self, "demand", WorkloadProfile(**rows))

    @property
    def n_epochs_recorded(self) -> int:
        return int(self.demand.gpu_rate_lo.shape[0])

    def epoch_demand(self, n_epochs: int) -> WorkloadProfile:
        """Fit the recorded rows to ``n_epochs`` epochs (float32 tensors)."""
        T = self.n_epochs_recorded
        if T == n_epochs:
            rows = {f: getattr(self.demand, f) for f in WorkloadProfile._fields}
        elif self.fit == "exact":
            raise ValueError(
                f"trace {self.name!r} has {T} recorded epochs but the run "
                f"wants {n_epochs}; use fit='tile' or fit='stretch' to "
                "adapt it"
            )
        elif self.fit == "tile":
            idx = np.arange(n_epochs) % T
            rows = {f: getattr(self.demand, f)[idx]
                    for f in WorkloadProfile._fields}
        else:  # stretch
            src = np.linspace(0.0, 1.0, T, dtype=np.float64)
            dst = np.linspace(0.0, 1.0, n_epochs, dtype=np.float64)
            rows = {
                f: np.interp(
                    dst, src, getattr(self.demand, f).astype(np.float64)
                ).astype(np.float32)
                for f in WorkloadProfile._fields
            }
        return WorkloadProfile(**{
            f: torch.from_numpy(np.array(rows[f], np.float32))
            for f in WorkloadProfile._fields
        })

    def with_fit(self, fit: str) -> "RecordedTrace":
        return dataclasses.replace(self, fit=fit)

    def save(self, path) -> None:
        """Write the trace as a versioned npz file (no pickling)."""
        payload = {
            "schema": TRACE_SCHEMA,
            "schema_version": np.int64(TRACE_SCHEMA_VERSION),
            "name": self.name,
            "meta_json": json.dumps(self.meta, sort_keys=True),
        }
        for f in WorkloadProfile._fields:
            payload[f"demand_{f}"] = getattr(self.demand, f)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path, fit: str = "exact") -> "RecordedTrace":
        """Load a schema-validated trace file."""
        with np.load(path, allow_pickle=False) as data:
            problems = validate_trace_npz(data)
            if problems:
                raise ValueError(
                    f"{path}: not a valid {TRACE_SCHEMA} file: "
                    + "; ".join(problems)
                )
            demand = WorkloadProfile(**{
                f: np.asarray(data[f"demand_{f}"], np.float32)
                for f in WorkloadProfile._fields
            })
            name = str(np.asarray(data["name"]).item())
            meta = json.loads(str(np.asarray(data["meta_json"]).item()))
        return cls(demand=demand, fit=fit, name=name, meta=meta)


def validate_trace_npz(data) -> list[str]:
    """Schema problems of an opened npz mapping ([] when valid)."""
    problems = []
    keys = set(getattr(data, "files", data.keys()))
    for key in ("schema", "schema_version", "name", "meta_json"):
        if key not in keys:
            problems.append(f"missing key {key!r}")
    if "schema" in keys:
        schema = str(np.asarray(data["schema"]).item())
        if schema != TRACE_SCHEMA:
            problems.append(f"schema is {schema!r}, expected {TRACE_SCHEMA!r}")
    if "schema_version" in keys:
        version = int(np.asarray(data["schema_version"]).item())
        if version > TRACE_SCHEMA_VERSION:
            problems.append(
                f"schema_version {version} is newer than supported "
                f"{TRACE_SCHEMA_VERSION}"
            )
    length = None
    for f in WorkloadProfile._fields:
        key = f"demand_{f}"
        if key not in keys:
            problems.append(f"missing key {key!r}")
            continue
        row = np.asarray(data[key])
        if row.ndim != 1 or row.shape[0] == 0:
            problems.append(f"{key} has shape {row.shape}, expected (T,)")
        elif length is None:
            length = row.shape[0]
        elif row.shape[0] != length:
            problems.append(
                f"{key} has length {row.shape[0]}, expected {length}"
            )
        if row.size and not np.all(np.isfinite(row)):
            problems.append(f"{key} contains non-finite values")
        elif row.size and np.any(row < 0):
            problems.append(f"{key} contains negative values")
    if "meta_json" in keys:
        try:
            meta = json.loads(str(np.asarray(data["meta_json"]).item()))
            if not isinstance(meta, dict):
                problems.append("meta_json is not a JSON object")
        except (json.JSONDecodeError, ValueError):
            problems.append("meta_json is not valid JSON")
    return problems


TrafficSourceLike = str | WorkloadProfile | ScenarioSchedule | RecordedTrace

# Registered workloads share one namespace with PROFILES and SCENARIOS and
# win on collision, so a registered trace can shadow a builtin.
_REGISTRY: dict[str, TrafficSource] = {}


def register_workload(
    name: str, source: TrafficSource, overwrite: bool = False
) -> None:
    """Register a named workload (any TrafficSource).  Refuses an existing
    registered or builtin name unless ``overwrite``."""
    if not isinstance(source, TrafficSource):
        raise TypeError(
            f"source for {name!r} does not implement TrafficSource "
            "(needs an epoch_demand(n_epochs) method)"
        )
    if not overwrite and (
        name in _REGISTRY or name in PROFILES or name in SCENARIOS
    ):
        raise ValueError(
            f"workload {name!r} already exists; pass overwrite=True to "
            "replace it"
        )
    _REGISTRY[name] = source


def register_trace(
    name: str, path, fit: str = "exact", overwrite: bool = False
) -> RecordedTrace:
    """Load a trace file and register it as a named workload."""
    trace = RecordedTrace.load(path, fit=fit)
    register_workload(name, trace, overwrite=overwrite)
    return trace


def unregister_workload(name: str) -> None:
    """Remove a registered workload (builtins are untouchable)."""
    _REGISTRY.pop(name, None)


def lookup_workload(name: str) -> TrafficSource:
    """Resolve a name from the registry, PROFILES or SCENARIOS; an unknown
    name raises ValueError listing close matches across all three."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in PROFILES:
        return PROFILES[name]
    if name in SCENARIOS:
        return SCENARIOS[name]
    known = sorted({*PROFILES, *SCENARIOS, *_REGISTRY})
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
                "WorkloadProfile, ScenarioSchedule, RecordedTrace, or any "
                "TrafficSource"
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
