"""Paper Fig. 2/3 on the PyTorch + CUDA port: GPU and CPU IPC vs the
static [GPU:CPU] VC split {1:3, 2:2, 3:1} over the four GPU workloads of
Fig. 2/3 (PATH, LIB, STO, MUM), every (workload x ratio x seed) row in ONE
`sim.sweep`; each cell is the mean +- std over the seeds.  Claim: GPU IPC
rises with more GPU VCs; CPU IPC barely moves.

    PYTHONPATH=src python3 benchmarks/torch_fig2_3.py [--device cpu]
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

WORKLOADS = ("PATH", "LIB", "STO", "MUM")
RATIOS = (1, 2, 3)   # GPU VCs out of 4
SEEDS = (0, 1, 2)


def run(n_epochs: int = 60, seeds: tuple[int, ...] = SEEDS,
        workloads: tuple[str, ...] = WORKLOADS, device=None,
        **overrides) -> dict:
    specs = [
        SweepSpec("static", wl, static_gpu_vcs=g, seed=s)
        for wl in workloads for g in RATIOS for s in seeds
    ]
    rows = sweep(specs, n_epochs=n_epochs, device=device, **overrides)
    by_point = {(sp.workload, sp.static_gpu_vcs): [] for sp in specs}
    for sp, row in zip(specs, rows):
        by_point[(sp.workload, sp.static_gpu_vcs)].append(row)
    return {
        wl: {f"{g}:{4 - g}": summarize_seeds(by_point[(wl, g)])
             for g in RATIOS}
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
            label="fig2_3")
    wall = time.time() - t0
    print("workload,ratio,gpu_ipc,gpu_ipc_std,cpu_ipc,cpu_ipc_std,avg_latency")
    for wl, row in results.items():
        for ratio, s in row.items():
            print(f"{wl},{ratio},{s['gpu_ipc']:.4f},{s['gpu_ipc_std']:.4f},"
                  f"{s['cpu_ipc']:.4f},{s['cpu_ipc_std']:.4f},"
                  f"{s['avg_latency']:.2f}")
    for wl, row in results.items():
        gpu_up = row["3:1"]["gpu_ipc"] >= row["1:3"]["gpu_ipc"]
        print(f"# {wl}: GPU IPC rises with GPU VCs: {gpu_up}")
    dev = args.device or torch.cuda.get_device_name(0)
    print(f"# {len(workloads) * len(RATIOS) * len(seeds)} rows x "
          f"{args.n_epochs} epochs in one sweep, wall {wall:.2f} s on {dev}")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
