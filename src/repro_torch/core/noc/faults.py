"""Per-epoch fault masks for the NoC simulator.

A `FaultStream` carries, for every epoch, the link, router and MC masks
and the telemetry-corruption mode.  Faults only ever suppress: masks are
AND-ed into existing gates, and telemetry mode 0 selects the clean
observation vector.  This package resolves ``None`` (the healthy identity
stream) or a ready `FaultStream`; named fault schedules are materialized
by the JAX package and carried across with `repro_torch.interop`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.noc.topology import N_PORTS

Tensor = torch.Tensor

DEFAULT_R = 36

# telemetry-corruption modes (telem_mode values)
TELEM_OK, TELEM_DROP, TELEM_SPIKE, TELEM_NAN = range(4)


class FaultStream(NamedTuple):
    link_ok: Tensor     # (E, R, P) bool — grant allowed through port p
    router_ok: Tensor   # (E, R) bool — router grants anything at all
    mc_ok: Tensor       # (E, R) bool — MC service ticks
    telem_mode: Tensor  # (E,) int32 — TELEM_* corruption mode
    telem_mag: Tensor   # (E,) float32 — spike magnitude


def healthy_stream(
    n_epochs: int, n_routers: int = DEFAULT_R, n_ports: int = N_PORTS
) -> FaultStream:
    """The identity stream: every mask passes, telemetry clean."""
    return FaultStream(
        link_ok=torch.ones((n_epochs, n_routers, n_ports), dtype=torch.bool),
        router_ok=torch.ones((n_epochs, n_routers), dtype=torch.bool),
        mc_ok=torch.ones((n_epochs, n_routers), dtype=torch.bool),
        telem_mode=torch.zeros((n_epochs,), dtype=torch.int32),
        telem_mag=torch.zeros((n_epochs,), dtype=torch.float32),
    )


FaultSourceLike = FaultStream | None


def resolve_faults(
    source: FaultSourceLike,
    n_epochs: int,
    n_routers: int = DEFAULT_R,
    n_ports: int = N_PORTS,
) -> FaultStream:
    """Lower ``None`` or a `FaultStream` to the shape-checked stream."""
    if source is None:
        stream = healthy_stream(n_epochs, n_routers, n_ports)
    elif isinstance(source, FaultStream):
        stream = source
    else:
        raise TypeError(
            f"cannot resolve fault source of type {type(source).__name__}; "
            "expected a FaultStream or None (named fault schedules are "
            "materialized by the JAX package and converted with "
            "repro_torch.interop.fault_stream)"
        )
    expect = {
        "link_ok": (n_epochs, n_routers, n_ports),
        "router_ok": (n_epochs, n_routers),
        "mc_ok": (n_epochs, n_routers),
        "telem_mode": (n_epochs,),
        "telem_mag": (n_epochs,),
    }
    for f, shape in expect.items():
        leaf = getattr(stream, f)
        if tuple(leaf.shape) != shape:
            raise ValueError(
                f"fault stream leaf {f!r} has shape {tuple(leaf.shape)}, "
                f"expected {shape}"
            )
    return stream
