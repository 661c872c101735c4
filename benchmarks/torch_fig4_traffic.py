"""Paper Fig. 4 on the PyTorch + CUDA port: the dynamic traffic pattern —
GPU injection is bursty, CPU injection is stable, and GPU stalls track
the injection bursts.

Emits the per-epoch traces (GPU injection rate, stall counters, IPC
proxy) that the KF consumes, for one workload run at mode="baseline".
With ``seeds`` given, the seed replicas run as one `simulate_batch` and
the returned traces are the first seed's.  Claim: the GPU injection
rate's coefficient of variation is more than twice the CPU push rate's.

    PYTHONPATH=src python3 benchmarks/torch_fig4_traffic.py
        [--device cpu] [--workload PATH] [--n-epochs N]
        [--partitionable 0|1] [--faults NAME] [--placement NAME]
        [--topology WxH] [--trace F.npz [--trace-fit exact|tile|stretch]]
        [--profile DIR]

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
from repro_torch._util import tree_map
from repro_torch.core import threefry
from repro_torch.core.noc.sim import NoCConfig, run_workload, simulate_batch
from repro_torch.obs import profiling


def run(workload: str = "PATH", n_epochs: int = 120,
        seeds: tuple[int, ...] | None = None, device=None, **overrides):
    if seeds is not None:
        cfgs = [NoCConfig(mode="baseline", n_epochs=n_epochs, seed=s,
                          **overrides) for s in seeds or (0,)]
        res = tree_map(lambda x: x[0],
                       simulate_batch(cfgs, workload, device=device))
    else:
        res = run_workload("baseline", workload, device=device,
                           n_epochs=n_epochs, **overrides)
    c = res.counters
    return {
        "gpu_inj_rate": res.gpu_inj_rate.numpy(),
        "gpu_ipc": res.gpu_ipc.numpy(),
        "gpu_stall_icnt": c.gpu_stall_icnt.numpy(),
        "gpu_stall_dram": c.gpu_stall_dram.numpy(),
        "cpu_push": c.cpu_push.numpy(),
    }


def cov_claim(tr: dict) -> tuple[float, float, bool]:
    """(GPU injection CoV, CPU push CoV, whether the GPU's is > 2x)."""
    gpu_cov = tr["gpu_inj_rate"].std() / max(tr["gpu_inj_rate"].mean(), 1e-9)
    cpu_cov = tr["cpu_push"].std() / max(tr["cpu_push"].mean(), 1e-9)
    return float(gpu_cov), float(cpu_cov), bool(gpu_cov > 2 * cpu_cov)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--workload", default="PATH")
    ap.add_argument("--n-epochs", type=int, default=120)
    ap.add_argument("--partitionable", type=int, choices=(0, 1), default=1)
    torch_cli.add_flags(ap)
    args = ap.parse_args(argv)
    overrides = torch_cli.shared_overrides(args)
    workload = torch_cli.registered_trace(args) or args.workload
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        tr = profiling.profiled_run(
            args.profile,
            lambda: run(workload=workload, n_epochs=args.n_epochs,
                        device=args.device, **overrides),
            label="fig4")
    wall = time.time() - t0
    print("epoch,gpu_inj_rate,gpu_ipc,gpu_stall_icnt,gpu_stall_dram,cpu_push")
    for i in range(len(tr["gpu_ipc"])):
        print(f"{i},{tr['gpu_inj_rate'][i]:.4f},{tr['gpu_ipc'][i]:.4f},"
              f"{tr['gpu_stall_icnt'][i]},{tr['gpu_stall_dram'][i]},"
              f"{tr['cpu_push'][i]}")
    gpu_cov, cpu_cov, holds = cov_claim(tr)
    print(f"# gpu_inj CoV={gpu_cov:.3f} cpu_push CoV={cpu_cov:.3f} "
          f"(claim: gpu >> cpu): {holds}")
    dev = args.device or torch.cuda.get_device_name(0)
    print(f"# {workload} {args.n_epochs} epochs, wall {wall:.2f} s on "
          f"{dev}")
    return tr


if __name__ == "__main__":
    main()
    sys.exit(0)
