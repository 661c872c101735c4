"""Per-epoch fault masks for the NoC simulator.

A `FaultStream` carries, for every epoch, the link, router and MC masks
and the telemetry-corruption mode.  Faults only ever suppress: masks are
AND-ed into existing gates, and telemetry mode 0 selects the clean
observation vector.  A `FaultSchedule` (a tuple of `FaultEvent` arcs over
run fractions) materializes to a stream with numpy; the `FAULTS` library
names four scenarios, and `resolve_faults` lowers a name, a schedule, a
ready stream or ``None`` (the healthy identity stream).

Fault semantics:

  * link    — `link_ok[e, r, p]` False suppresses grants through output
              port `p` of router `r`; with a neighbor table the reverse
              direction of each masked link is masked too (a dead link is
              dead both ways).
  * router  — `router_ok[e, r]` False suppresses every grant at router `r`.
  * mc      — `mc_ok[e, r]` False freezes MC service at router `r`.
  * telem   — `telem_mode[e]` corrupts the normalized observation before
              the predictor bank sees it: 1 drops it to -1, 2 adds
              `telem_mag[e]`, 3 replaces it with NaN.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.noc.topology import (
    N_PORTS, PORT_E, PORT_L, PORT_N, PORT_S, PORT_W,
)

Tensor = torch.Tensor

DEFAULT_R = 36

# telemetry-corruption modes (telem_mode values)
TELEM_OK, TELEM_DROP, TELEM_SPIKE, TELEM_NAN = range(4)

_KINDS = ("link", "router", "mc", "telem")
_NONLOCAL_PORTS = (PORT_N, PORT_E, PORT_S, PORT_W)


class FaultStream(NamedTuple):
    link_ok: Tensor     # (E, R, P) bool — grant allowed through port p
    router_ok: Tensor   # (E, R) bool — router grants anything at all
    mc_ok: Tensor       # (E, R) bool — MC service ticks
    telem_mode: Tensor  # (E,) int32 — TELEM_* corruption mode
    telem_mag: Tensor   # (E,) float32 — spike magnitude


class FaultEvent(NamedTuple):
    """One fault arc: governs epochs in [start, stop) (run fractions).

    kind     — "link" | "router" | "mc" | "telem".
    routers  — affected router ids (empty = every router) for the
               physical kinds; ignored for "telem".
    ports    — affected output ports for kind="link" (empty = all four
               mesh ports; the Local port is never maskable).
    period   — 0 = solid fault; > 0 = flapping: active for `period`
               epochs, released for `period`, repeating from `start`.
    mode/mag — telemetry corruption mode and spike magnitude.
    """

    start: float
    stop: float
    kind: str
    routers: tuple[int, ...] = ()
    ports: tuple[int, ...] = ()
    period: int = 0
    mode: int = TELEM_DROP
    mag: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A piecewise fault program.

    ``materialize(n_epochs)`` lowers it to a `FaultStream` on the CPU:
    epoch ``e`` is inside an event iff ``round(start * n_epochs) <= e <
    round(stop * n_epochs)`` (and, for a flapping event, ``e`` falls in an
    active half-period counted from the event's first epoch).
    """

    events: tuple[FaultEvent, ...]

    def __post_init__(self):
        for ev in self.events:
            if ev.kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r}; expected one of {_KINDS}"
                )
            if not 0.0 <= ev.start < ev.stop <= 1.0:
                raise ValueError(
                    f"fault event window [{ev.start}, {ev.stop}) outside [0, 1]"
                )
            if ev.period < 0:
                raise ValueError(f"fault period {ev.period} must be >= 0")
            if ev.kind == "telem":
                if ev.mode not in (TELEM_DROP, TELEM_SPIKE, TELEM_NAN):
                    raise ValueError(
                        f"telem fault mode {ev.mode} not in "
                        f"{{TELEM_DROP, TELEM_SPIKE, TELEM_NAN}}"
                    )
            if ev.kind == "link":
                bad = [p for p in ev.ports if p not in _NONLOCAL_PORTS]
                if bad:
                    raise ValueError(
                        f"link fault ports {bad} invalid: only the four mesh "
                        f"ports {_NONLOCAL_PORTS} can be masked"
                    )

    def materialize(
        self,
        n_epochs: int,
        n_routers: int = DEFAULT_R,
        n_ports: int = N_PORTS,
        neighbor: np.ndarray | None = None,
        opposite: np.ndarray | None = None,
    ) -> FaultStream:
        link_ok = np.ones((n_epochs, n_routers, n_ports), bool)
        router_ok = np.ones((n_epochs, n_routers), bool)
        mc_ok = np.ones((n_epochs, n_routers), bool)
        telem_mode = np.zeros((n_epochs,), np.int32)
        telem_mag = np.zeros((n_epochs,), np.float32)
        opp = (np.asarray(opposite) if opposite is not None
               else np.asarray([PORT_S, PORT_W, PORT_N, PORT_E, PORT_L]))

        for ev in self.events:
            lo = int(round(ev.start * n_epochs))
            hi = int(round(ev.stop * n_epochs))
            epochs = np.arange(lo, hi)
            if ev.period > 0:  # flap: period on, period off
                epochs = epochs[((epochs - lo) // ev.period) % 2 == 0]
            if epochs.size == 0:
                continue
            routers = (np.arange(n_routers) if not ev.routers
                       else np.asarray(ev.routers, np.int64))
            if routers.size and (routers.min() < 0
                                 or routers.max() >= n_routers):
                raise ValueError(
                    f"fault routers {tuple(ev.routers)} outside [0, {n_routers})"
                )
            if ev.kind == "telem":
                telem_mode[epochs] = ev.mode
                telem_mag[epochs] = np.float32(ev.mag)
            elif ev.kind == "router":
                router_ok[np.ix_(epochs, routers)] = False
            elif ev.kind == "mc":
                mc_ok[np.ix_(epochs, routers)] = False
            else:  # link
                for p in ev.ports or _NONLOCAL_PORTS:
                    link_ok[np.ix_(epochs, routers, [p])] = False
                    if neighbor is None:
                        continue
                    # the reverse direction, at each downstream neighbor
                    for r in routers:
                        nb = int(np.asarray(neighbor)[r, p])
                        if nb >= 0:
                            link_ok[np.ix_(epochs, [nb], [int(opp[p])])] = False
        return FaultStream(
            link_ok=torch.from_numpy(link_ok),
            router_ok=torch.from_numpy(router_ok),
            mc_ok=torch.from_numpy(mc_ok),
            telem_mode=torch.from_numpy(telem_mode),
            telem_mag=torch.from_numpy(telem_mag),
        )


def healthy_stream(
    n_epochs: int, n_routers: int = DEFAULT_R, n_ports: int = N_PORTS
) -> FaultStream:
    """The identity stream: every mask passes, telemetry clean."""
    return FaultSchedule(()).materialize(n_epochs, n_routers, n_ports)


# The fault scenario library.  Windows are phased against the
# SHIFT_PATH_BFS scenario's four 30-epoch arcs (PATH, PATH, BFS, BFS on
# the canonical 120 epochs).
FAULTS: dict[str, FaultSchedule] = {
    # link flaps on the links feeding top-row MCs 2 and 3 (routers 8/9
    # port N and the reverse direction) in 2-epoch bursts over the BFS half
    "FLAP_BFS": FaultSchedule((
        FaultEvent(0.55, 0.80, "link", routers=(8, 9), ports=(PORT_N,),
                   period=2),
    )),
    # a mid-mesh brownout during the second PATH arc: no grants at routers
    # 14/15/20/21 for ~12 epochs
    "BROWNOUT": FaultSchedule((
        FaultEvent(0.30, 0.40, "router", routers=(14, 15, 20, 21)),
    )),
    # telemetry only, network healthy: NaNs across the shift onto BFS, a
    # +8 spike mid-arc, a window dropped to the floor late
    "TELEM_GLITCH": FaultSchedule((
        FaultEvent(0.50, 0.60, "telem", mode=TELEM_NAN),
        FaultEvent(0.70, 0.75, "telem", mode=TELEM_SPIKE, mag=8.0),
        FaultEvent(0.85, 0.90, "telem", mode=TELEM_DROP),
    )),
    # link flaps spanning the PATH->BFS shift while the telemetry NaNs out
    # at the shift point
    "FLAP_DURING_SHIFT": FaultSchedule((
        FaultEvent(0.45, 0.65, "link", routers=(8, 9), ports=(PORT_N,),
                   period=3),
        FaultEvent(0.50, 0.55, "telem", mode=TELEM_NAN),
    )),
}


def register_faults(
    name: str, schedule: FaultSchedule, overwrite: bool = False
) -> None:
    """Register a named fault scenario (the ``--faults`` namespace)."""
    if not isinstance(schedule, FaultSchedule):
        raise TypeError(
            f"fault scenario {name!r} must be a FaultSchedule, got "
            f"{type(schedule).__name__}"
        )
    if not overwrite and name in FAULTS:
        raise ValueError(
            f"fault scenario {name!r} already exists; pass overwrite=True"
        )
    FAULTS[name] = schedule


def lookup_faults(name: str) -> FaultSchedule:
    if name in FAULTS:
        return FAULTS[name]
    near = difflib.get_close_matches(name, sorted(FAULTS), n=3, cutoff=0.4)
    hint = f"; did you mean {near}?" if near else ""
    raise ValueError(
        f"unknown fault scenario {name!r}{hint} "
        f"(known: {sorted(FAULTS)})"
    )


# a scenario name, a schedule, a ready stream, or None (healthy)
FaultSourceLike = str | FaultSchedule | FaultStream | None


def resolve_faults(
    source: FaultSourceLike,
    n_epochs: int,
    n_routers: int = DEFAULT_R,
    n_ports: int = N_PORTS,
    neighbor: np.ndarray | None = None,
    opposite: np.ndarray | None = None,
) -> FaultStream:
    """Lower any fault source to the shape-checked per-epoch stream.  A
    name or schedule is materialized against ``neighbor`` / ``opposite``
    when given, which makes its link faults two-way."""
    if source is None:
        stream = healthy_stream(n_epochs, n_routers, n_ports)
    elif isinstance(source, str):
        stream = lookup_faults(source).materialize(
            n_epochs, n_routers, n_ports, neighbor, opposite)
    elif isinstance(source, FaultSchedule):
        stream = source.materialize(
            n_epochs, n_routers, n_ports, neighbor, opposite)
    elif isinstance(source, FaultStream):
        stream = source
    else:
        raise TypeError(
            f"cannot resolve fault source of type {type(source).__name__}; "
            "expected a scenario name, FaultSchedule, FaultStream, or None"
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
