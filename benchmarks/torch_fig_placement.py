"""Placement-control ablation on the PyTorch + CUDA port: which lever(s)
the KF's applied config drives, over the scenario library.

  * bandwidth  — the paper's controller: VC boosts only, the static
                 checkerboard layout (the placement lever disarmed);
  * placement  — relocation only: the boost plan is `GPU_NEAR_MC` (GPU
                 tiles moved next to the MCs), the VC split stays fair;
  * joint      — both levers on the same KF signal.

The control x scenario x seed grid plus an identity pair (bandwidth
control with no placement stream) is ONE `sim.sweep` (on the card: one
launch of the fused cycle kernel an epoch for the whole grid).  The
identity pair must be bitwise equal to the bandwidth rows that carry the
GPU_NEAR_MC stream: a disarmed lever may not move a bit.  A probed joint
run on the gate scenario counts the relocations.

Gate: joint's mean GPU IPC >= bandwidth-only's on MIX_PATH_STO_BFS, the
identity pair bitwise, and on the card one B2 launch an epoch.

    PYTHONPATH=src python3 benchmarks/torch_fig_placement.py [--gate]
        [--smoke] [--device cpu] [--n-epochs N] [--partitionable 0|1]
        [--faults NAME] [--placement NAME] [--topology WxH] [--profile DIR]

``--placement NAME`` swaps the plan under ablation.  ``--partitionable 0``
draws with JAX's original threefry scheme, the one the JAX package's
committed `noc_placement` row in BENCH_noc.json was drawn with.  The
record is printed as JSON, never appended to BENCH_noc.json.  Imports no
JAX.
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

import torch

from benchmarks import torch_cli
from benchmarks.torch_fig_ablation import KF_Q_ABLATION
from benchmarks.torch_fig_faults import bitwise_equal
from repro_torch._util import resolve_device
from repro_torch.core import threefry
from repro_torch.core.allocator import CONTROLS, PolicyConfig
from repro_torch.core.noc import sim
from repro_torch.core.noc.placement import lookup_placement
from repro_torch.core.noc.sim import NoCConfig, SweepSpec, summarize_seeds
from repro_torch.kernels.noc_cycle import ops
from repro_torch.obs import profiling
from repro_torch.obs.probes import summarize_trace

ARMS = CONTROLS  # ("bandwidth", "placement", "joint")
# the boost-slot plan every armed row carries
PLACEMENT = "GPU_NEAR_MC"
# the gate binds on the mixed phase program, whose between-phase demand
# shifts are what relocation exploits; the other margins are reported
GATE_SCENARIO = "MIX_PATH_STO_BFS"
SCENARIOS = (
    "SHIFT_PATH_BFS",
    "SHIFT_SMOOTH",
    "RAMP_LIB",
    "MIX_PATH_STO_BFS",
    "BURSTS_BFS",
)
SEEDS = (0, 1, 2)
# the identity pair's label
IDENTITY = "identity"

# smoke trims seeds and scenarios, never the simulated dims: the boost
# windows open only after the policy's warmup (20 of 120 epochs)
SMOKE = dict(seeds=(0,), scenarios=(GATE_SCENARIO,))


def _arm_spec(arm: str, scenario: str, seed: int, plan: str) -> SweepSpec:
    return SweepSpec("kf", scenario, seed=seed, placement=plan, control=arm)


def run(
    n_epochs: int = 120,
    seeds: tuple[int, ...] = SEEDS,
    scenarios: tuple[str, ...] = SCENARIOS,
    probe: bool = True,
    device=None,
    plan: str = PLACEMENT,
    **overrides,
) -> dict:
    """Sweep scenarios x control arms x seeds (+ the identity pair) with
    the placement scenario ``plan``; summarize and probe.

    Returns the per-cell table, the identity-pair bitwise verdict, the
    sweep's B2 launches (0 on the CPU), and the probed joint run's
    relocation counters on the gate scenario with its B3 launches, and
    the host wall of the sweep and of the probed run."""
    overrides.setdefault("kf_q", KF_Q_ABLATION)
    points = [(sc, arm, s) for sc in scenarios for arm in ARMS for s in seeds]
    specs = [_arm_spec(arm, sc, s, plan) for sc, arm, s in points]
    # bandwidth control with no placement stream, in the same sweep
    id_specs = [SweepSpec("kf", GATE_SCENARIO, seed=s, placement=None,
                          control="bandwidth") for s in seeds]
    b2 = ops.LAUNCHES["noc_fused_cycles"]
    t0 = time.time()
    rows = sim.sweep(specs + id_specs, n_epochs=n_epochs, device=device,
                     **overrides)
    sweep_s = time.time() - t0      # the rows are back on the host
    b2 = ops.LAUNCHES["noc_fused_cycles"] - b2
    id_rows = rows[len(specs):]

    by_cell: dict[tuple[str, str], list] = {}
    for (sc, arm, _), row in zip(points, rows):
        by_cell.setdefault((sc, arm), []).append(row)

    policy = overrides.get("policy", PolicyConfig())
    epoch_len = overrides.get("epoch_len", 500)
    warmup_epochs = min(math.ceil(policy.warmup / epoch_len), n_epochs - 1)
    table = {
        sc: {
            arm: summarize_seeds(by_cell[(sc, arm)],
                                 warmup_epochs=warmup_epochs)
            for arm in ARMS
        }
        for sc in scenarios
    }
    # a disarmed lever is free: bandwidth control carrying the plan's
    # stream against no stream at all, per seed, bitwise
    identity_bitwise = all(
        bitwise_equal(a, b)
        for a, b in zip(by_cell[(GATE_SCENARIO, "bandwidth")], id_rows)
    )

    probes = {}
    b3 = ops.LAUNCHES["noc_fused_cycles_probed"]
    t0 = time.time()
    if probe:
        cfg = NoCConfig(
            mode="kf", n_epochs=n_epochs, seed=seeds[0],
            placement=plan, control="joint", **overrides,
        )
        _, trace = sim.simulate_with_trace(cfg, GATE_SCENARIO, device=device)
        s = summarize_trace(trace)
        probes["joint"] = {k: s[k] for k in ("place_moves_total", "epochs")}
    probe_s = time.time() - t0
    b3 = ops.LAUNCHES["noc_fused_cycles_probed"] - b3

    return {
        "table": table,
        "b2_launches": b2,
        "b3_launches": b3,
        "rows": len(rows),
        "sweep_s": sweep_s,
        "probe_s": probe_s,
        "identity_bitwise": identity_bitwise,
        "probes": probes,
        "warmup_epochs": warmup_epochs,
    }


def control_verdict(table: dict, scenarios: tuple[str, ...]) -> dict:
    """Joint-vs-{bandwidth, placement} GPU-IPC margins per scenario; the
    gate binds only on GATE_SCENARIO, compared unrounded."""
    margins = {}
    for sc in scenarios:
        cells = table[sc]
        j = cells["joint"]["gpu_ipc"]
        margins[sc] = {
            "vs_bandwidth": round(j - cells["bandwidth"]["gpu_ipc"], 6),
            "vs_placement": round(j - cells["placement"]["gpu_ipc"], 6),
        }
    gate_cells = table.get(GATE_SCENARIO)
    joint_beats_bandwidth = (
        gate_cells is not None
        and gate_cells["joint"]["gpu_ipc"]
        >= gate_cells["bandwidth"]["gpu_ipc"]
    )
    return {"margins": margins,
            "joint_beats_bandwidth": joint_beats_bandwidth}


def record(res: dict, grid: dict, verdict: dict, device: str,
           plan: str = PLACEMENT) -> dict:
    return {
        "bench": "noc_placement",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "device": device,
        "gate_scenario": GATE_SCENARIO,
        "placement": plan,
        "grid": grid,
        "b2_launches": res["b2_launches"],
        "identity_bitwise": res["identity_bitwise"],
        "gpu_ipc": {
            sc: {arm: round(cells[arm]["gpu_ipc"], 6) for arm in ARMS}
            for sc, cells in res["table"].items()
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
                    help="one seed on the gate scenario at full dims")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 unless joint >= bandwidth-only mean GPU IPC "
                         "on the gate scenario, the identity pair is "
                         "bitwise, and on the card the grid took one B2 "
                         "launch an epoch")
    torch_cli.add_flags(ap, trace=False)
    args = ap.parse_args(argv)
    seeds, scenarios = ((SMOKE["seeds"], SMOKE["scenarios"]) if args.smoke
                        else (SEEDS, SCENARIOS))
    overrides = {**torch_cli.fault_overrides(args),
                 **torch_cli.topology_overrides(args)}
    plan = PLACEMENT
    if args.placement:
        # here the flag swaps the plan under ablation (each row already
        # carries one)
        lookup_placement(args.placement)
        plan = args.placement
        print(f"# --placement: ablating plan {plan!r}")
    dev = resolve_device(args.device)
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        res = profiling.profiled_run(
            args.profile,
            lambda: run(n_epochs=args.n_epochs, seeds=seeds,
                        scenarios=scenarios, device=dev, plan=plan,
                        **overrides),
            label="fig_placement")
    wall = time.time() - t0
    print("scenario,control,gpu_ipc,gpu_ipc_std,cpu_ipc,avg_latency,"
          "boost_frac")
    for sc, cells in res["table"].items():
        for arm, s in cells.items():
            print(f"{sc},{arm},{s['gpu_ipc']:.4f},{s['gpu_ipc_std']:.4f},"
                  f"{s['cpu_ipc']:.4f},{s['avg_latency']:.2f},"
                  f"{s['kf_on_frac']:.2f}")

    verdict = control_verdict(res["table"], scenarios)
    want_b2 = args.n_epochs if dev.type == "cuda" else 0
    print(f"# B2 launches: {res['b2_launches']} (contract on the card: one "
          f"an epoch for the whole grid, {want_b2} here)")
    print(f"# identity pair bitwise (disarmed lever is free): "
          f"{res['identity_bitwise']}")
    for sc, m in verdict["margins"].items():
        print(f"# {sc}: joint margin vs bandwidth {m['vs_bandwidth']:+.4f},"
              f" vs placement {m['vs_placement']:+.4f}")
    p = res["probes"].get("joint", {})
    if p:
        print(f"# joint relocation timeline: {p['place_moves_total']} "
              f"router-moves over {p['epochs']} epochs "
              f"({GATE_SCENARIO}, seed {seeds[0]})")
    print(f"# joint_beats_bandwidth: {verdict['joint_beats_bandwidth']} "
          f"(mean GPU IPC on {GATE_SCENARIO})")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(f"# {res['rows']} rows x {args.n_epochs} epochs in one sweep and "
          f"{len(res['probes'])} probed run, wall {wall:.2f} s on {name}")
    grid = {"scenarios": list(scenarios), "arms": list(ARMS),
            "seeds": list(seeds), "n_epochs": args.n_epochs,
            "kf_q": KF_Q_ABLATION, "partitionable": bool(args.partitionable)}
    print(json.dumps(record(res, grid, verdict, name, plan)))

    if args.gate:
        failures = []
        if res["b2_launches"] != want_b2:
            failures.append(f"the placement grid launched B2 "
                            f"{res['b2_launches']} times, expected {want_b2}")
        if not res["identity_bitwise"]:
            failures.append("bandwidth-control row carrying the placement "
                            "stream is not bitwise-equal to the no-stream "
                            "row (a disarmed lever must be free)")
        if not verdict["joint_beats_bandwidth"]:
            m = verdict["margins"].get(GATE_SCENARIO, {}).get("vs_bandwidth")
            failures.append(f"joint control lost to bandwidth-only on "
                            f"{GATE_SCENARIO} (margin {m})")
        for f in failures:
            print(f"PLACEMENT GATE: {f}", file=sys.stderr)
        if failures:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
