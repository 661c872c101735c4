"""Perf-trajectory harness of the port's fleet KF bank.

Times `FleetKF.epoch` (one banked predict + correct cycle; on the card one
launch of the KF-bank kernel, B4, with the boost signal fused in) at fleet
sizes n in {64, 1024} filters over 200 epochs, and appends a
`fleet_kf_epoch` row to the port's ledger (BENCH_noc_torch.json).  The
epoch's time is the host wall over the 200 epochs, which end in one
synchronize, divided by 200; `b4_launches` counts B4 launches in the
timed epochs (0 on the CPU, where the plain version runs).

    PYTHONPATH=src python -m benchmarks.torch_bench_fleet_kf [--no-append]
        [--device cpu] [--bench-json PATH]

Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np
import torch

from benchmarks.torch_bench_sweep import BENCH_PATH, append_record
from repro_torch._util import resolve_device
from repro_torch.dist.kf_scheduler import FleetKF, SchedulerConfig
from repro_torch.kernels.kf_bank import ops as kf_ops

SIZES = (64, 1024)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_epoch(n: int, iters: int = 200, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    fleet = FleetKF(n, SchedulerConfig(kf_q=1e-2, kf_r=1e-1), device=dev)
    zs = torch.as_tensor(
        np.random.default_rng(seed).normal(0, 0.5, (iters, n, 3)),
        dtype=torch.float32, device=dev)
    fleet.epoch(zs[0])   # build + first launch
    _sync(dev)
    before = kf_ops.LAUNCHES["kf_bank"]
    t0 = time.perf_counter()
    for t in range(iters):
        sig = fleet.epoch(zs[t])
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    del sig
    return {
        "n_filters": n,
        "iters": iters,
        "epoch_us": round(dt * 1e6, 2),
        "ns_per_filter": round(dt * 1e9 / n, 1),
        "b4_launches": kf_ops.LAUNCHES["kf_bank"] - before,
    }


def run(sizes=SIZES, device=None) -> list[dict]:
    return [time_epoch(n, device=device) for n in sizes]


def record(points: list[dict], device=None) -> dict:
    return {
        "bench": "fleet_kf_epoch",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "backend": resolve_device(device).type,
        "points": points,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-append", action="store_true",
                    help="print only; don't extend the ledger")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--bench-json", default=BENCH_PATH)
    args = ap.parse_args(argv)
    rec = record(run(device=args.device), device=args.device)
    if not args.no_append:
        rec = append_record(rec, args.bench_json)
    print(json.dumps(rec, indent=2))
    if not args.no_append:
        print(f"appended to {os.path.normpath(args.bench_json)}")
    return rec


if __name__ == "__main__":
    main()
    sys.exit(0)
