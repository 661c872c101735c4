"""Paper Figs. 9/10/11 on the PyTorch + CUDA port: CPU IPC, GPU IPC and
packet latency across the four network configurations (4-subnet, 2-subnet
baseline, 2-subnet fair, KF) over the six workloads, every (workload x
mode x seed) row in ONE `sim.sweep`; each cell is the mean +- std over
the seeds.  Claims: KF reduces packet latency vs baseline; 4-subnet hurts
GPU IPC; KF >= fair on GPU IPC; CPU IPC unaffected.

    PYTHONPATH=src python3 benchmarks/torch_fig9_10_11.py [--device cpu]
        [--n-epochs N] [--seeds 0,1,2] [--partitionable 0|1]
        [--faults NAME] [--placement NAME] [--topology WxH]
        [--trace F.npz [--trace-fit exact|tile|stretch]] [--profile DIR]

Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch

from benchmarks import torch_cli
from repro_torch.core import threefry
from repro_torch.core.noc.sim import SweepSpec, summarize_seeds, sweep
from repro_torch.obs import profiling

WORKLOADS = ("PATH", "LIB", "STO", "MUM", "BFS", "LPS")
MODES = ("4subnet", "baseline", "fair", "kf")
SEEDS = (0, 1, 2)


def run(n_epochs: int = 60, seeds: tuple[int, ...] = SEEDS,
        workloads: tuple[str, ...] = WORKLOADS, device=None,
        **overrides) -> dict:
    specs = [
        SweepSpec(m, wl, seed=s)
        for wl in workloads for m in MODES for s in seeds
    ]
    rows = sweep(specs, n_epochs=n_epochs, device=device, **overrides)
    by_point: dict[tuple[str, str], list] = {}
    for sp, row in zip(specs, rows):
        by_point.setdefault((sp.workload, sp.mode), []).append(row)
    return {
        wl: {m: summarize_seeds(by_point[(wl, m)]) for m in MODES}
        for wl in workloads
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-epochs", type=int, default=60)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--partitionable", type=int, choices=(0, 1), default=1)
    torch_cli.add_flags(ap)
    args = ap.parse_args(argv)
    overrides = torch_cli.shared_overrides(args)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    trace_wl = torch_cli.registered_trace(args)
    workloads = (trace_wl,) if trace_wl else WORKLOADS
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        results = profiling.profiled_run(
            args.profile,
            lambda: run(n_epochs=args.n_epochs, seeds=seeds,
                        workloads=workloads, device=args.device,
                        **overrides),
            label="fig9_10_11")
    wall = time.time() - t0
    print("workload,mode,gpu_ipc,gpu_ipc_std,cpu_ipc,avg_latency,kf_on_frac")
    for wl, row in results.items():
        for m, s in row.items():
            print(f"{wl},{m},{s['gpu_ipc']:.4f},{s['gpu_ipc_std']:.4f},"
                  f"{s['cpu_ipc']:.4f},{s['avg_latency']:.2f},"
                  f"{s['kf_on_frac']:.2f}")
    workloads = list(results)
    lat_wins = sum(results[w]["kf"]["avg_latency"]
                   <= results[w]["baseline"]["avg_latency"]
                   for w in workloads)
    gpu_gains = [results[w]["kf"]["gpu_ipc"]
                 / max(results[w]["baseline"]["gpu_ipc"], 1e-9) - 1
                 for w in workloads]
    cpu_moves = [abs(results[w]["kf"]["cpu_ipc"]
                     / max(results[w]["baseline"]["cpu_ipc"], 1e-9) - 1)
                 for w in workloads]
    print(f"# KF latency <= baseline on {lat_wins}/{len(workloads)} workloads")
    print(f"# KF GPU IPC gain: mean {sum(gpu_gains) / len(gpu_gains):+.1%}, "
          f"max {max(gpu_gains):+.1%} (paper: ~+7% mean, up to +19%)")
    print(f"# CPU IPC max |change| {max(cpu_moves):.1%} (paper: unaffected)")
    dev = args.device or torch.cuda.get_device_name(0)
    print(f"# {len(workloads) * len(MODES) * len(seeds)} rows x "
          f"{args.n_epochs} epochs in one sweep, wall {wall:.2f} s on {dev}")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
