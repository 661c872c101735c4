"""Per-epoch compute-placement plans for the NoC simulator.

A `PlacementStream` carries two (R,) node-class plans per epoch: ``cls0``
(the base layout) and ``cls1`` (the layout the controller relocates to
while it holds config 1 under placement or joint control).  MC tiles are
physical and never relocate.  A `PlacementSchedule` (a tuple of
`PlacementEvent` arcs, each writing a named plan into one slot over a
window of the run) materializes to a stream with numpy; the `PLACEMENTS`
library names three scenarios, and `resolve_placement` lowers a name, a
schedule, a ready stream or ``None`` (the identity stream).
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.noc.topology import (
    NT_CPU, NT_GPU, NT_MC, Topology, make_topology,
)

Tensor = torch.Tensor

_SLOTS = ("base", "boost")


class PlacementStream(NamedTuple):
    cls0: Tensor  # (E, R) int32 — base node class per router (NT_*)
    cls1: Tensor  # (E, R) int32 — boosted/relocated node class per router


class PlacementEvent(NamedTuple):
    """One relocation arc: governs epochs in [start, stop) (run fractions).

    plan — name of a plan builder (`PLAN_BUILDERS`): the (R,) layout
           written over the window.
    slot — "boost" writes ``cls1`` (the controller relocates only while
           the KF holds config 1); "base" writes ``cls0`` (a scheduled
           migration, whatever the controller does).
    """

    start: float
    stop: float
    plan: str = "gpu_near_mc"
    slot: str = "boost"


def _plan_identity(topo: Topology) -> np.ndarray:
    return np.asarray(topo.node_type, np.int32).copy()


def _plan_gpu_near_mc(topo: Topology) -> np.ndarray:
    """The GPU class on the non-MC tiles nearest the MCs.

    Keeps the base layout's GPU / CPU tile counts and ranks the non-MC
    tiles by Manhattan distance to the closest MC, ties broken by router
    id (numpy's lexsort, the reference's own expression)."""
    nt = np.asarray(topo.node_type, np.int32)
    n_gpu = int((nt == NT_GPU).sum())
    w = topo.width
    ids = np.arange(topo.n_routers)
    xy = np.stack([ids % w, ids // w], axis=1)
    mc_xy = xy[np.asarray(topo.mc_ids)]
    dist = np.abs(xy[:, None, :] - mc_xy[None, :, :]).sum(-1).min(-1)
    non_mc = ids[nt != NT_MC]
    order = non_mc[np.lexsort((non_mc, dist[non_mc]))]
    plan = nt.copy()
    plan[order[:n_gpu]] = NT_GPU
    plan[order[n_gpu:]] = NT_CPU
    return plan


def _plan_swap_classes(topo: Topology) -> np.ndarray:
    """Swap the GPU and CPU classes on every non-MC tile."""
    nt = np.asarray(topo.node_type, np.int32)
    plan = nt.copy()
    plan[nt == NT_GPU] = NT_CPU
    plan[nt == NT_CPU] = NT_GPU
    return plan


# (R,) layout builders an event's `plan` names; they only reassign non-MC
# tiles between NT_CPU and NT_GPU
PLAN_BUILDERS: dict[str, Callable[[Topology], np.ndarray]] = {
    "identity": _plan_identity,
    "gpu_near_mc": _plan_gpu_near_mc,
    "swap_classes": _plan_swap_classes,
}


@dataclasses.dataclass(frozen=True)
class PlacementSchedule:
    """A piecewise relocation program.

    ``materialize(n_epochs, topology)`` lowers it to a `PlacementStream`
    on the CPU: epoch ``e`` is inside an event iff ``round(start *
    n_epochs) <= e < round(stop * n_epochs)``.  Outside every event both
    plans are the topology's own layout.
    """

    events: tuple[PlacementEvent, ...]

    def __post_init__(self):
        for ev in self.events:
            if ev.plan not in PLAN_BUILDERS:
                raise ValueError(
                    f"unknown placement plan {ev.plan!r}; expected one of "
                    f"{sorted(PLAN_BUILDERS)}"
                )
            if ev.slot not in _SLOTS:
                raise ValueError(
                    f"placement slot {ev.slot!r} must be one of {_SLOTS}"
                )
            if not 0.0 <= ev.start < ev.stop <= 1.0:
                raise ValueError(
                    f"placement event window [{ev.start}, {ev.stop}) "
                    "outside [0, 1]"
                )

    def materialize(
        self, n_epochs: int, topology: Topology | None = None
    ) -> PlacementStream:
        topo = topology if topology is not None else make_topology()
        base = _plan_identity(topo)
        cls0 = np.tile(base, (n_epochs, 1))
        cls1 = np.tile(base, (n_epochs, 1))
        for ev in self.events:
            lo = int(round(ev.start * n_epochs))
            hi = int(round(ev.stop * n_epochs))
            if hi <= lo:
                continue
            plan = PLAN_BUILDERS[ev.plan](topo)
            if plan.shape != base.shape:
                raise ValueError(
                    f"plan {ev.plan!r} built shape {plan.shape} for a "
                    f"{topo.n_routers}-router topology"
                )
            target = cls1 if ev.slot == "boost" else cls0
            target[lo:hi] = plan
        return PlacementStream(cls0=torch.from_numpy(cls0),
                               cls1=torch.from_numpy(cls1))


def static_placement(
    n_epochs: int, topology: Topology | None = None
) -> PlacementStream:
    """The identity stream: both plans are the topology's own layout."""
    return PlacementSchedule(()).materialize(n_epochs, topology)


PLACEMENTS: dict[str, PlacementSchedule] = {
    # while the controller holds the boost config, GPU compute sits on the
    # tiles nearest the MCs
    "GPU_NEAR_MC": PlacementSchedule((
        PlacementEvent(0.0, 1.0, "gpu_near_mc", "boost"),
    )),
    # the near-MC layout as the base plan for the whole run, whatever the
    # controller does (an ablation baseline)
    "GPU_NEAR_MC_ALWAYS": PlacementSchedule((
        PlacementEvent(0.0, 1.0, "gpu_near_mc", "base"),
    )),
    # a scheduled migration: from mid-run the base plan swaps every GPU /
    # CPU tile
    "SWAP_MID": PlacementSchedule((
        PlacementEvent(0.5, 1.0, "swap_classes", "base"),
    )),
}


def register_placement(
    name: str, schedule: PlacementSchedule, overwrite: bool = False
) -> None:
    """Register a named placement scenario (the ``--placement`` namespace)."""
    if not isinstance(schedule, PlacementSchedule):
        raise TypeError(
            f"placement scenario {name!r} must be a PlacementSchedule, got "
            f"{type(schedule).__name__}"
        )
    if not overwrite and name in PLACEMENTS:
        raise ValueError(
            f"placement scenario {name!r} already exists; pass overwrite=True"
        )
    PLACEMENTS[name] = schedule


def lookup_placement(name: str) -> PlacementSchedule:
    if name in PLACEMENTS:
        return PLACEMENTS[name]
    near = difflib.get_close_matches(name, sorted(PLACEMENTS), n=3, cutoff=0.4)
    hint = f"; did you mean {near}?" if near else ""
    raise ValueError(
        f"unknown placement scenario {name!r}{hint} "
        f"(known: {sorted(PLACEMENTS)})"
    )


# a scenario name, a schedule, a ready stream, or None (identity)
PlacementSourceLike = str | PlacementSchedule | PlacementStream | None


def resolve_placement(
    source: PlacementSourceLike,
    n_epochs: int,
    topology: Topology | None = None,
) -> PlacementStream:
    """Lower any placement source to the shape-checked per-epoch stream."""
    topo = topology if topology is not None else make_topology()
    if source is None:
        stream = static_placement(n_epochs, topo)
    elif isinstance(source, str):
        stream = lookup_placement(source).materialize(n_epochs, topo)
    elif isinstance(source, PlacementSchedule):
        stream = source.materialize(n_epochs, topo)
    elif isinstance(source, PlacementStream):
        stream = source
    else:
        raise TypeError(
            f"cannot resolve placement source of type {type(source).__name__}; "
            "expected a scenario name, PlacementSchedule, PlacementStream, "
            "or None"
        )
    for f in ("cls0", "cls1"):
        leaf = getattr(stream, f)
        if tuple(leaf.shape) != (n_epochs, topo.n_routers):
            raise ValueError(
                f"placement stream leaf {f!r} has shape {tuple(leaf.shape)}, "
                f"expected {(n_epochs, topo.n_routers)}"
            )
    return stream
