"""The cross-cutting flags of the torch figure drivers: ``--faults NAME``,
``--placement NAME`` and ``--topology WxH``.

    torch_cli.add_flags(ap)                      # on the driver's parser
    run(..., **torch_cli.shared_overrides(args))

Each flag becomes a `NoCConfig` override that `sweep` forwards to every
row, where it takes precedence over a per-spec value.  Names are checked
against the port's registries (`faults.FAULTS`, `placement.PLACEMENTS`)
and the mesh against `topology.validate_topology_args` when the overrides
are built, so a typo fails at the command line with the registry's
close-match hint.  Imports no JAX.
"""
from __future__ import annotations

import argparse


def add_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--faults", metavar="NAME", default=None,
                    help="inject a registered fault scenario "
                         "(repro_torch.core.noc.faults.FAULTS, e.g. "
                         "FLAP_BFS) into every swept row; default: healthy")
    ap.add_argument("--placement", metavar="NAME", default=None,
                    help="apply a registered placement scenario "
                         "(repro_torch.core.noc.placement.PLACEMENTS, e.g. "
                         "GPU_NEAR_MC) to every swept row; default: the "
                         "static paper layout")
    ap.add_argument("--topology", metavar="WxH", default=None,
                    help="run on a WxH mesh instead of the paper's 6x6 "
                         "(e.g. 4x4, 8x8; at most 64 routers)")
    return ap


def fault_overrides(args) -> dict:
    """``{"faults": NAME}`` for ``--faults`` ({} when it is absent)."""
    name = getattr(args, "faults", None)
    if not name:
        return {}
    from repro_torch.core.noc.faults import lookup_faults

    lookup_faults(name)
    print(f"# --faults: injecting fault scenario {name!r} into every row")
    return {"faults": name}


def placement_overrides(args) -> dict:
    """``{"placement": NAME}`` for ``--placement`` ({} when it is absent)."""
    name = getattr(args, "placement", None)
    if not name:
        return {}
    from repro_torch.core.noc.placement import lookup_placement

    lookup_placement(name)
    print(f"# --placement: applying placement scenario {name!r} to every row")
    return {"placement": name}


def topology_overrides(args) -> dict:
    """``{"width": W, "height": H}`` for ``--topology WxH`` ({} when it is
    absent), the mesh checked against the default MC count."""
    spec = getattr(args, "topology", None)
    if not spec:
        return {}
    try:
        w_s, h_s = spec.lower().split("x")
        width, height = int(w_s), int(h_s)
    except ValueError:
        raise SystemExit(
            f"--topology expects WxH (e.g. 6x6, 4x8), got {spec!r}"
        ) from None
    from repro_torch.core.noc.sim import NoCConfig
    from repro_torch.core.noc.topology import validate_topology_args

    validate_topology_args(width, height, NoCConfig().n_mc)
    print(f"# --topology: running every row on a {width}x{height} mesh")
    return {"width": width, "height": height}


def shared_overrides(args) -> dict:
    """The three overrides in one splat (their keys are disjoint)."""
    return {
        **fault_overrides(args),
        **placement_overrides(args),
        **topology_overrides(args),
    }
