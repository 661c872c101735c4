"""Paper Figs. 9/10 predictor ablation on the PyTorch + CUDA port: the
same hysteresis machine (mode="kf") driven by each member of the predictor
bank (KF / EMA / last-value / always-on / always-off) over the four
non-stationary scenario schedules, every (scenario x predictor x seed)
point in ONE `sim.sweep` (on the card: one launch of the fused cycle
kernel an epoch for all 60 rows).

Gate (paper Fig. 9/10 ordering): on the phase-shift scenario the KF's mean
GPU IPC must be >= every naive predictor's.

    PYTHONPATH=src python3 benchmarks/torch_fig_ablation.py [--gate]
        [--smoke] [--device cpu] [--n-epochs N] [--partitionable 0|1]
        [--faults NAME] [--placement NAME] [--topology WxH]
        [--trace F.npz [--trace-fit exact|tile|stretch]] [--profile DIR]

``--partitionable 0`` draws with JAX's original threefry scheme, the one
the JAX package's committed `noc_ablation` row in BENCH_noc.json was drawn
with; the default (1) is jax 0.9.0's default.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch

from benchmarks import torch_cli
from repro_torch.core import threefry
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc.sim import SweepSpec, summarize_seeds, sweep
from repro_torch.obs import profiling

PREDICTORS = ("kf", "ema", "last", "always_on", "always_off")
SCENARIO_SET = (
    "SHIFT_PATH_BFS", "RAMP_LIB", "MIX_PATH_STO_BFS", "BURSTS_BFS",
)
# the acceptance scenario: KF >= every naive predictor on mean GPU IPC here
GATE_SCENARIO = "SHIFT_PATH_BFS"
SEEDS = (0, 1, 2)
# the ablation's KF process noise, as the JAX driver sets it (a q matched
# to the scenarios' ~30-epoch arcs; fig 12 keeps the default 1e-3)
KF_Q_ABLATION = 2e-2
# smoke trims seeds and scenarios, never the simulated dims
SMOKE = dict(seeds=(0,), scenarios=(GATE_SCENARIO,))


def run(n_epochs: int = 120, seeds: tuple[int, ...] = SEEDS,
        scenarios: tuple[str, ...] = SCENARIO_SET, device=None,
        **overrides) -> dict:
    """Sweep predictors x scenarios x seeds; summarize per cell from the
    first epoch the hysteresis machine may act (warmup / epoch_len)."""
    overrides.setdefault("kf_q", KF_Q_ABLATION)
    specs = [
        SweepSpec("kf", sc, seed=s, predictor=p)
        for sc in scenarios for p in PREDICTORS for s in seeds
    ]
    rows = sweep(specs, n_epochs=n_epochs, device=device, **overrides)
    policy = overrides.get("policy", PolicyConfig())
    epoch_len = overrides.get("epoch_len", 500)
    warmup_epochs = min(math.ceil(policy.warmup / epoch_len), n_epochs - 1)
    by_cell: dict[tuple[str, str], list] = {}
    for sp, row in zip(specs, rows):
        by_cell.setdefault((sp.workload, sp.predictor), []).append(row)
    table = {
        sc: {
            p: summarize_seeds(by_cell[(sc, p)], warmup_epochs=warmup_epochs)
            for p in PREDICTORS
        }
        for sc in scenarios
    }
    return {"table": table, "warmup_epochs": warmup_epochs, "rows": len(rows)}


def kf_verdict(table: dict, scenario: str = GATE_SCENARIO) -> dict:
    """KF-vs-naive margins on the gate scenario's mean GPU IPC, compared
    unrounded (only the reported values are rounded)."""
    cells = table[scenario]
    kf = cells["kf"]["gpu_ipc"]
    margins = {p: kf - cells[p]["gpu_ipc"] for p in PREDICTORS if p != "kf"}
    return {
        "scenario": scenario,
        "kf_gpu_ipc": round(kf, 6),
        "margins": {p: round(m, 6) for p, m in margins.items()},
        "kf_beats_all": all(m >= 0.0 for m in margins.values()),
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
                    help="exit 1 unless KF >= every naive predictor")
    torch_cli.add_flags(ap)
    args = ap.parse_args(argv)
    overrides = torch_cli.shared_overrides(args)
    seeds, scenarios = ((SMOKE["seeds"], SMOKE["scenarios"]) if args.smoke
                        else (SEEDS, SCENARIO_SET))
    trace_wl = torch_cli.registered_trace(args)
    if trace_wl:
        # the replayed trace becomes both the scenario set and the gate
        scenarios = (trace_wl,)
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        res = profiling.profiled_run(
            args.profile,
            lambda: run(n_epochs=args.n_epochs, seeds=seeds,
                        scenarios=scenarios, device=args.device,
                        **overrides),
            label="fig_ablation")
    wall = time.time() - t0
    print("scenario,predictor,gpu_ipc,gpu_ipc_std,cpu_ipc,avg_latency,"
          "boost_frac")
    for sc, cells in res["table"].items():
        for p, s in cells.items():
            print(f"{sc},{p},{s['gpu_ipc']:.4f},{s['gpu_ipc_std']:.4f},"
                  f"{s['cpu_ipc']:.4f},{s['avg_latency']:.2f},"
                  f"{s['kf_on_frac']:.2f}")
    verdict = kf_verdict(res["table"], trace_wl or GATE_SCENARIO)
    print(f"# {verdict['scenario']}: KF gpu_ipc {verdict['kf_gpu_ipc']:.6f}; "
          "margins vs naive: "
          + ", ".join(f"{p} {m:+.6f}" for p, m in verdict["margins"].items()))
    print(f"# kf_beats_all: {verdict['kf_beats_all']} "
          "(paper Fig. 9/10 ordering: KF >= every naive predictor)")
    dev = args.device or torch.cuda.get_device_name(0)
    print(f"# {res['rows']} rows x {args.n_epochs} epochs in one sweep, "
          f"wall {wall:.2f} s on {dev}")
    if args.gate and not verdict["kf_beats_all"]:
        losing = {p: m for p, m in verdict["margins"].items() if m < 0}
        print(f"ABLATION GATE: KF lost to {losing} on "
              f"{verdict['scenario']} mean GPU IPC", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
