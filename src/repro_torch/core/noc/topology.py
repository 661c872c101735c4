"""Mesh topology, XY routing tables, node-type placement (paper Table 1).

The port's own copy of the numpy table constructors: the tables are built once
with numpy and moved to the run's device by `router.device_tables`.

Ports: 0=N, 1=E, 2=S, 3=W, 4=Local.  Router id r = y * W + x.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

N_PORTS = 5
PORT_N, PORT_E, PORT_S, PORT_W, PORT_L = range(5)
OPPOSITE = np.array([PORT_S, PORT_W, PORT_N, PORT_E, PORT_L], dtype=np.int32)

# node types
NT_CPU, NT_GPU, NT_MC = 0, 1, 2

# router ids ride a 6-bit field of the packet metadata and the lane layout
# pads routers to 64 lanes, so a topology holds at most 64 routers
MAX_ROUTERS = 64


@dataclasses.dataclass(frozen=True)
class Topology:
    width: int
    height: int
    n_routers: int
    route: np.ndarray      # (R, R) int32: output port at router i toward j (XY)
    neighbor: np.ndarray   # (R, P) int32: neighbor through port p (-1 if none)
    opposite: np.ndarray   # (P,) int32: downstream input port of our output
    node_type: np.ndarray  # (R,) int32: 0=CPU, 1=GPU, 2=MC
    mc_ids: np.ndarray     # (n_mc,) router ids hosting memory controllers


def _xy_route(width: int, height: int) -> np.ndarray:
    n = width * height
    route = np.full((n, n), PORT_L, dtype=np.int32)
    for src in range(n):
        sx, sy = src % width, src // width
        for dst in range(n):
            dx, dy = dst % width, dst // width
            if dx > sx:
                route[src, dst] = PORT_E
            elif dx < sx:
                route[src, dst] = PORT_W
            elif dy > sy:
                route[src, dst] = PORT_S
            elif dy < sy:
                route[src, dst] = PORT_N
    return route


def _neighbors(width: int, height: int) -> np.ndarray:
    n = width * height
    nb = np.full((n, N_PORTS), -1, dtype=np.int32)
    for r in range(n):
        x, y = r % width, r // width
        if y > 0:
            nb[r, PORT_N] = r - width
        if x < width - 1:
            nb[r, PORT_E] = r + 1
        if y < height - 1:
            nb[r, PORT_S] = r + width
        if x > 0:
            nb[r, PORT_W] = r - 1
    return nb


def validate_topology_args(width: int, height: int, n_mc: int) -> None:
    """Reject grids that cannot host the MC rows or the CPU/GPU tiling."""
    for name, val in (("width", width), ("height", height), ("n_mc", n_mc)):
        if not isinstance(val, int) or isinstance(val, bool):
            raise ValueError(f"{name} must be an int, got {val!r}")
    if width < 2 or height < 2:
        raise ValueError(
            f"mesh needs width >= 2 and height >= 2 (got {width}x{height}): "
            "MCs live on distinct top and bottom rows and XY routing needs "
            "both dimensions"
        )
    if n_mc < 1:
        raise ValueError(f"n_mc must be >= 1, got {n_mc}")
    if n_mc - n_mc // 2 > width:
        raise ValueError(
            f"n_mc={n_mc} does not fit on the top+bottom rows of a "
            f"width-{width} mesh (max {2 * width}); widen the mesh or drop MCs"
        )
    if width * height - n_mc < 2:
        raise ValueError(
            f"{width}x{height} mesh with n_mc={n_mc} leaves "
            f"{width * height - n_mc} non-MC tile(s); need >= 2 so both a GPU "
            "and a CPU chiplet exist"
        )
    if width * height > MAX_ROUTERS:
        raise ValueError(
            f"{width}x{height} mesh has {width * height} routers; the packed "
            f"lane layout caps at {MAX_ROUTERS} (6-bit router ids in lane "
            "metadata). Use a smaller grid."
        )


@functools.lru_cache(maxsize=None)
def make_topology(width: int = 6, height: int = 6, n_mc: int = 8) -> Topology:
    """6x6 mesh with 8 MCs on the top and bottom rows by default; the other
    tiles alternate CPU / GPU chiplets (14 + 14 on the 6x6)."""
    validate_topology_args(width, height, n_mc)
    n = width * height
    node_type = np.empty((n,), dtype=np.int32)
    per_row = n_mc // 2
    top_cols = np.linspace(0, width - 1, per_row).round().astype(int)
    bot_cols = np.linspace(0, width - 1, n_mc - per_row).round().astype(int)
    mc_ids = sorted(
        {int(c) for c in top_cols}
        | {int((height - 1) * width + c) for c in bot_cols}
    )
    assert len(mc_ids) == n_mc, (width, height, n_mc, mc_ids)
    mc_ids = np.asarray(mc_ids, dtype=np.int32)

    flip = 0
    for r in range(n):
        if r in mc_ids:
            node_type[r] = NT_MC
        else:
            node_type[r] = NT_GPU if flip else NT_CPU
            flip ^= 1

    return Topology(
        width=width,
        height=height,
        n_routers=n,
        route=_xy_route(width, height),
        neighbor=_neighbors(width, height),
        opposite=OPPOSITE,
        node_type=node_type,
        mc_ids=mc_ids,
    )
