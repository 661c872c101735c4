"""Per-epoch compute-placement plans for the NoC simulator.

A `PlacementStream` carries two (R,) node-class plans per epoch: ``cls0``
(the base layout) and ``cls1`` (the layout the controller relocates to
while it holds config 1 under placement or joint control).  MC tiles are
physical and never relocate.  This package resolves ``None`` (the identity
stream) or a ready stream; named placement schedules are materialized by
the JAX package and carried across with `repro_torch.interop`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.noc.topology import Topology, make_topology

Tensor = torch.Tensor


class PlacementStream(NamedTuple):
    cls0: Tensor  # (E, R) int32 — base node class per router (NT_*)
    cls1: Tensor  # (E, R) int32 — boosted/relocated node class per router


def static_placement(
    n_epochs: int, topology: Topology | None = None
) -> PlacementStream:
    """The identity stream: both plans are the topology's own layout."""
    topo = topology if topology is not None else make_topology()
    base = torch.from_numpy(
        np.tile(np.asarray(topo.node_type, np.int32), (n_epochs, 1))
    )
    return PlacementStream(cls0=base, cls1=base.clone())


PlacementSourceLike = PlacementStream | None


def resolve_placement(
    source: PlacementSourceLike,
    n_epochs: int,
    topology: Topology | None = None,
) -> PlacementStream:
    """Lower ``None`` or a `PlacementStream` to the shape-checked stream."""
    topo = topology if topology is not None else make_topology()
    if source is None:
        stream = static_placement(n_epochs, topo)
    elif isinstance(source, PlacementStream):
        stream = source
    else:
        raise TypeError(
            f"cannot resolve placement source of type "
            f"{type(source).__name__}; expected a PlacementStream or None "
            "(named placement schedules are materialized by the JAX package "
            "and converted with repro_torch.interop.placement_stream)"
        )
    for f in ("cls0", "cls1"):
        leaf = getattr(stream, f)
        if tuple(leaf.shape) != (n_epochs, topo.n_routers):
            raise ValueError(
                f"placement stream leaf {f!r} has shape {tuple(leaf.shape)}, "
                f"expected {(n_epochs, topo.n_routers)}"
            )
    return stream
