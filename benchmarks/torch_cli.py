"""The cross-cutting flags of the torch figure drivers: ``--faults NAME``,
``--placement NAME``, ``--topology WxH``, ``--profile DIR`` and
``--trace F.npz`` with ``--trace-fit exact|tile|stretch``.

    torch_cli.add_flags(ap)                      # on the driver's parser
    wl = torch_cli.registered_trace(args)        # --trace F.npz -> a name
    res = profiling.profiled_run(args.profile, lambda: run(
        ..., **torch_cli.shared_overrides(args)), label="...")

Each of the first three flags becomes a `NoCConfig` override that `sweep`
forwards to every row, where it takes precedence over a per-spec value.
Names are checked against the port's registries (`faults.FAULTS`,
`placement.PLACEMENTS`) and the mesh against
`topology.validate_topology_args` when the overrides are built, so a typo
fails at the command line with the registry's close-match hint.

``--trace PATH`` registers a recorded demand trace (the
`traffic.RecordedTrace` npz schema) as the workload ``TRACE``, which a
driver then runs in place of its builtin workloads.  The default fit is
"stretch": drivers run at many ``n_epochs``, and a linear resample keeps
any trace usable everywhere (``--trace-fit exact`` insists on a bitwise
replay).  ``--profile DIR`` wraps the driver's run in
`repro_torch.obs.profiling.profiled_run` (a cold and a steady call, each
a Chrome trace).  Imports no JAX.
"""
from __future__ import annotations

import argparse


# The registry name `--trace` files land under: drivers substitute it for
# their builtin workload set when the flag is present.
TRACE_WORKLOAD = "TRACE"


def add_flags(ap: argparse.ArgumentParser,
              trace: bool = True) -> argparse.ArgumentParser:
    """Add the shared flags; ``trace=False`` leaves out ``--trace`` and
    ``--trace-fit`` (drivers whose rows carry their own workloads)."""
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
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture torch.profiler Chrome traces of a cold "
                         "and a steady call of the run into DIR")
    if trace:
        ap.add_argument("--trace", metavar="F.npz", default=None,
                        help="drive the figure with a recorded demand trace "
                             "(the RecordedTrace npz schema) instead of its "
                             "builtin workloads")
        ap.add_argument("--trace-fit", choices=("exact", "tile", "stretch"),
                        default="stretch",
                        help="how a trace of T epochs fits a run of "
                             "n_epochs: exact requires T == n_epochs, tile "
                             "repeats cyclically, stretch resamples "
                             "linearly (default)")
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


def registered_trace(args) -> str | None:
    """Register ``--trace`` (if given) as the workload TRACE_WORKLOAD and
    return that name; None when the flag is absent, so drivers fall back
    to their builtin workloads."""
    path = getattr(args, "trace", None)
    if not path:
        return None
    from repro_torch.core.noc.traffic import register_trace

    trace = register_trace(TRACE_WORKLOAD, path,
                           fit=getattr(args, "trace_fit", "stretch"),
                           overwrite=True)
    print(f"# --trace: registered {path} as workload {TRACE_WORKLOAD!r} "
          f"({trace.n_epochs_recorded} epochs, fit={trace.fit})")
    return TRACE_WORKLOAD
