"""Paper Fig. 12 on the PyTorch + CUDA port: per-epoch GPU IPC with and
without KF-assisted allocation, and the KF output signal trace.  Both arms
(fair, kf) and every seed run in ONE `simulate_batch`; IPC traces are
averaged over the seeds, the signal and config traces are the first
seed's.  Claim: where 2-subnet-fair dips, the KF run holds IPC up.

    PYTHONPATH=src python3 benchmarks/torch_fig12.py [--device cpu]
        [--workload STO] [--n-epochs N] [--seeds 0,1,2]
        [--partitionable 0|1]
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

import numpy as np
import torch

from benchmarks import torch_cli
from repro_torch.core import threefry
from repro_torch.core.noc.sim import NoCConfig, simulate_batch
from repro_torch.obs import profiling

SEEDS = (0, 1, 2)


def run(workload: str = "STO", n_epochs: int = 120,
        seeds: tuple[int, ...] = SEEDS, device=None, **overrides) -> dict:
    cfgs = [NoCConfig(mode=m, n_epochs=n_epochs, seed=s, **overrides)
            for m in ("fair", "kf") for s in seeds]
    res = simulate_batch(cfgs, workload, device=device)
    n = len(seeds)
    fair_ipc = res.gpu_ipc[:n].numpy()
    kf_ipc = res.gpu_ipc[n:].numpy()
    return {
        "fair_ipc": fair_ipc.mean(axis=0),
        "kf_ipc": kf_ipc.mean(axis=0),
        "fair_ipc_std": fair_ipc.std(axis=0),
        "kf_ipc_std": kf_ipc.std(axis=0),
        # discrete traces are per-seed; report the first seed's trajectory
        "kf_signal": res.kf_signal[n].numpy(),
        "kf_config": res.applied_config[n].numpy(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--workload", default="STO")
    ap.add_argument("--n-epochs", type=int, default=120)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--partitionable", type=int, choices=(0, 1), default=1)
    torch_cli.add_flags(ap)
    args = ap.parse_args(argv)
    overrides = torch_cli.shared_overrides(args)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    workload = torch_cli.registered_trace(args) or args.workload
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        tr = profiling.profiled_run(
            args.profile,
            lambda: run(workload=workload, n_epochs=args.n_epochs,
                        seeds=seeds, device=args.device, **overrides),
            label="fig12")
    wall = time.time() - t0
    print("epoch,fair_gpu_ipc,kf_gpu_ipc,kf_signal,applied_config")
    for i in range(len(tr["fair_ipc"])):
        print(f"{i},{tr['fair_ipc'][i]:.4f},{tr['kf_ipc'][i]:.4f},"
              f"{tr['kf_signal'][i]},{tr['kf_config'][i]}")
    sl = slice(10, None)
    mean_fair = tr["fair_ipc"][sl].mean()
    mean_kf = tr["kf_ipc"][sl].mean()
    # IPC in fair's WORST decile of epochs (the dips)
    fair_tail = tr["fair_ipc"][sl]
    dips = np.argsort(fair_tail)[: max(len(fair_tail) // 10, 1)]
    dip_gain = tr["kf_ipc"][sl][dips].mean() / max(
        fair_tail[dips].mean(), 1e-9) - 1
    print(f"# mean GPU IPC: fair {mean_fair:.4f} kf {mean_kf:.4f} "
          f"({mean_kf / mean_fair - 1:+.1%})")
    print(f"# IPC in fair's dip epochs: KF {dip_gain:+.1%} "
          f"(claim: KF avoids the dips)")
    print(f"# KF engaged in {tr['kf_config'][sl].mean():.0%} of epochs")
    dev = args.device or torch.cuda.get_device_name(0)
    print(f"# {2 * len(seeds)} rows x {args.n_epochs} epochs in one batch, "
          f"wall {wall:.2f} s on {dev}")
    return tr


if __name__ == "__main__":
    main()
    sys.exit(0)
