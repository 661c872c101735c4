"""Fault-injection study on the PyTorch + CUDA port: the self-healing KF
under fabric and telemetry faults.

Every registered fault scenario (`faults.FAULTS`: link flaps, a router
brownout, telemetry NaN / spike / drop glitches, a flap during the phase
shift) runs three arms over the ablation's gate scenario:

  * kf_guarded  — the KF with the self-healing layer armed (innovation
                  gate, divergence watchdog, covariance reset, fair-split
                  fallback while unhealthy);
  * kf          — the same KF unguarded;
  * always_off  — the static fair split (config 0).

Healthy plus every scenario, x arms x seeds, is ONE `sim.sweep` (on the
card: one launch of the fused cycle kernel an epoch for the whole grid).
A healthy guard-on / guard-off pair rides in the grid and must be bitwise
equal: with clean telemetry the gate never fires.  A probed (flight-
recorder) guarded run per scenario counts innovation rejections,
covariance resets and fallback epochs.

Gate: under every fault scenario the guarded KF's mean GPU IPC is >= the
unguarded KF's and >= always_off's, the healthy pair is bitwise, and on
the card the grid took one B2 launch an epoch.

    PYTHONPATH=src python3 benchmarks/torch_fig_faults.py [--gate]
        [--smoke] [--device cpu] [--n-epochs N] [--partitionable 0|1]
        [--faults NAME] [--placement NAME] [--topology WxH] [--profile DIR]

``--partitionable 0`` draws with JAX's original threefry scheme, the one
the JAX package's committed `noc_faults` row in BENCH_noc.json was drawn
with.  The record is printed as JSON, never appended to BENCH_noc.json.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np
import torch

from benchmarks import torch_cli
from benchmarks.torch_fig_ablation import KF_Q_ABLATION
from repro_torch._util import resolve_device
from repro_torch.core import threefry
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import sim
from repro_torch.core.noc.faults import FAULTS, lookup_faults
from repro_torch.core.noc.sim import NoCConfig, SweepSpec, summarize_seeds
from repro_torch.kernels.noc_cycle import ops
from repro_torch.obs import profiling
from repro_torch.obs.probes import summarize_trace

# every registered fault scenario, in registry order
FAULT_SET = tuple(FAULTS)
ARMS = ("kf_guarded", "kf", "always_off")
# the predictor ablation's scenario and KF tuning: does the guard keep the
# ablation's win under faults
GATE_SCENARIO = "SHIFT_PATH_BFS"
SEEDS = (0, 1, 2)
# the healthy control cell's label in the table
HEALTHY = "healthy"
PROBE_KEYS = ("kf_rejected_total", "kf_reset_total", "fallback_epochs",
              "fault_epochs")

# smoke trims seeds and the fault set, never the simulated dims: the fault
# windows are phased against the gate scenario's 120-epoch arcs
SMOKE = dict(seeds=(0,), fault_set=("FLAP_BFS", "TELEM_GLITCH"))


def _arm_spec(arm: str, faults: str | None, seed: int) -> SweepSpec:
    return SweepSpec(
        "kf", GATE_SCENARIO, seed=seed,
        predictor="always_off" if arm == "always_off" else "kf",
        faults=faults, guard=arm == "kf_guarded",
    )


def _leaves(tree):
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def bitwise_equal(a, b) -> bool:
    """Every tensor leaf equal in dtype and value, NaN equal to NaN."""
    return all(
        x.dtype == y.dtype and np.array_equal(
            x.numpy(), y.numpy(), equal_nan=x.is_floating_point())
        for x, y in zip(_leaves(a), _leaves(b))
    )


def run(
    n_epochs: int = 120,
    seeds: tuple[int, ...] = SEEDS,
    fault_set: tuple[str, ...] = FAULT_SET,
    probe: bool = True,
    device=None,
    **overrides,
) -> dict:
    """Sweep (healthy + fault scenarios) x arms x seeds; summarize and probe.

    Returns the per-cell table, the healthy guard-on / guard-off bitwise
    verdict, the sweep's B2 launches (0 on the CPU), the probed guarded
    runs' self-healing counters per scenario, their B3 launches, and
    the host wall of the sweep and of the probed runs."""
    overrides.setdefault("kf_q", KF_Q_ABLATION)
    cells: list[str | None] = [None] + list(fault_set)
    points = [(flt, arm, s) for flt in cells for arm in ARMS for s in seeds]
    specs = [_arm_spec(arm, flt, s) for flt, arm, s in points]
    b2 = ops.LAUNCHES["noc_fused_cycles"]
    t0 = time.time()
    rows = sim.sweep(specs, n_epochs=n_epochs, device=device, **overrides)
    sweep_s = time.time() - t0      # the rows are back on the host
    b2 = ops.LAUNCHES["noc_fused_cycles"] - b2

    by_cell: dict[tuple[str | None, str], list] = {}
    for (flt, arm, _), row in zip(points, rows):
        by_cell.setdefault((flt, arm), []).append(row)

    policy = overrides.get("policy", PolicyConfig())
    epoch_len = overrides.get("epoch_len", 500)
    warmup_epochs = min(math.ceil(policy.warmup / epoch_len), n_epochs - 1)
    table = {
        (flt or HEALTHY): {
            arm: summarize_seeds(by_cell[(flt, arm)],
                                 warmup_epochs=warmup_epochs)
            for arm in ARMS
        }
        for flt in cells
    }
    # arming the guard on a clean fabric must be free, per seed, bitwise
    healthy_bitwise = all(
        bitwise_equal(a, b)
        for a, b in zip(by_cell[(None, "kf_guarded")], by_cell[(None, "kf")])
    )

    probes = {}
    b3 = ops.LAUNCHES["noc_fused_cycles_probed"]
    t0 = time.time()
    if probe:
        for flt in fault_set:
            cfg = NoCConfig(
                mode="kf", n_epochs=n_epochs, seed=seeds[0],
                predictor="kf", faults=flt, guard=True, **overrides,
            )
            _, trace = sim.simulate_with_trace(cfg, GATE_SCENARIO,
                                               device=device)
            s = summarize_trace(trace)
            probes[flt] = {k: s[k] for k in PROBE_KEYS}
    probe_s = time.time() - t0
    b3 = ops.LAUNCHES["noc_fused_cycles_probed"] - b3

    return {
        "table": table,
        "b2_launches": b2,
        "b3_launches": b3,
        "rows": len(rows),
        "sweep_s": sweep_s,
        "probe_s": probe_s,
        "healthy_bitwise": healthy_bitwise,
        "probes": probes,
        "warmup_epochs": warmup_epochs,
    }


def guard_verdict(table: dict, fault_set: tuple[str, ...]) -> dict:
    """Per-scenario guarded-vs-{unguarded, always_off} GPU-IPC margins,
    compared unrounded (only the reported margins are rounded)."""
    margins = {}
    for flt in fault_set:
        cells = table[flt]
        g = cells["kf_guarded"]["gpu_ipc"]
        margins[flt] = {
            "vs_kf": round(g - cells["kf"]["gpu_ipc"], 6),
            "vs_always_off": round(g - cells["always_off"]["gpu_ipc"], 6),
        }
    beats = all(
        table[flt]["kf_guarded"]["gpu_ipc"] >= table[flt][arm]["gpu_ipc"]
        for flt in fault_set for arm in ("kf", "always_off")
    )
    return {"margins": margins, "guard_beats_all": beats}


def record(res: dict, grid: dict, verdict: dict, device: str) -> dict:
    return {
        "bench": "noc_faults",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "device": device,
        "scenario": GATE_SCENARIO,
        "grid": grid,
        "b2_launches": res["b2_launches"],
        "healthy_bitwise": res["healthy_bitwise"],
        "gpu_ipc": {
            flt: {arm: round(cells[arm]["gpu_ipc"], 6) for arm in ARMS}
            for flt, cells in res["table"].items()
        },
        "probes": res["probes"],
        **verdict,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-epochs", type=int, default=120)
    ap.add_argument("--partitionable", type=int, choices=(0, 1), default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="one seed on one physical and one telemetry fault "
                         "scenario at full simulated dims")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 unless the guarded KF >= unguarded KF and "
                         ">= always_off under every fault scenario, the "
                         "healthy pair is bitwise, and on the card the grid "
                         "took one B2 launch an epoch")
    torch_cli.add_flags(ap, trace=False)
    args = ap.parse_args(argv)
    seeds, fault_set = ((SMOKE["seeds"], SMOKE["fault_set"]) if args.smoke
                        else (SEEDS, FAULT_SET))
    if args.faults:
        # here the flag narrows the study to one scenario (each row already
        # carries its own fault source)
        lookup_faults(args.faults)
        fault_set = (args.faults,)
    overrides = {**torch_cli.placement_overrides(args),
                 **torch_cli.topology_overrides(args)}
    dev = resolve_device(args.device)
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        res = profiling.profiled_run(
            args.profile,
            lambda: run(n_epochs=args.n_epochs, seeds=seeds,
                        fault_set=fault_set, device=dev, **overrides),
            label="fig_faults")
    wall = time.time() - t0
    print("faults,arm,gpu_ipc,gpu_ipc_std,cpu_ipc,avg_latency,boost_frac")
    for flt, cells in res["table"].items():
        for arm, s in cells.items():
            print(f"{flt},{arm},{s['gpu_ipc']:.4f},{s['gpu_ipc_std']:.4f},"
                  f"{s['cpu_ipc']:.4f},{s['avg_latency']:.2f},"
                  f"{s['kf_on_frac']:.2f}")

    verdict = guard_verdict(res["table"], fault_set)
    want_b2 = args.n_epochs if dev.type == "cuda" else 0
    print(f"# B2 launches: {res['b2_launches']} (contract on the card: one "
          f"an epoch for the whole grid, {want_b2} here)")
    print(f"# healthy guard-on == guard-off bitwise: "
          f"{res['healthy_bitwise']}")
    for flt, m in verdict["margins"].items():
        p = res["probes"].get(flt, {})
        note = (f" [rejected {p['kf_rejected_total']}, resets "
                f"{p['kf_reset_total']}, fallback {p['fallback_epochs']} "
                f"of {p['fault_epochs']} fault epochs]" if p else "")
        print(f"# {flt}: guarded margin vs kf {m['vs_kf']:+.4f}, "
              f"vs always_off {m['vs_always_off']:+.4f}{note}")
    print(f"# guard_beats_all: {verdict['guard_beats_all']} "
          "(guarded KF >= unguarded KF and >= fair static split under "
          "every fault)")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(f"# {res['rows']} rows x {args.n_epochs} epochs in one sweep and "
          f"{len(res['probes'])} probed runs, wall {wall:.2f} s on {name}")
    grid = {"fault_set": list(fault_set), "arms": list(ARMS),
            "seeds": list(seeds), "n_epochs": args.n_epochs,
            "kf_q": KF_Q_ABLATION, "partitionable": bool(args.partitionable)}
    print(json.dumps(record(res, grid, verdict, name)))

    if args.gate:
        failures = []
        if res["b2_launches"] != want_b2:
            failures.append(f"the fault grid launched B2 "
                            f"{res['b2_launches']} times, expected {want_b2}")
        if not res["healthy_bitwise"]:
            failures.append("healthy guard-on run is not bitwise-equal to "
                            "guard-off (arming the guard must be free on "
                            "clean telemetry)")
        if not verdict["guard_beats_all"]:
            losing = {flt: m for flt, m in verdict["margins"].items()
                      if min(m.values()) < 0}
            failures.append(f"guarded KF lost the robustness ordering on "
                            f"{losing}")
        for f in failures:
            print(f"FAULTS GATE: {f}", file=sys.stderr)
        if failures:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
