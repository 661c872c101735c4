"""Render the port's roofline table from its one-card dry-run records
(results/dryrun_torch, written by `python -m repro_torch.launch.dryrun`):
the twin of the JAX package's `benchmarks/roofline_table.py`.

    PYTHONPATH=src python -m benchmarks.torch_roofline_table [--results DIR]

The terms are roofline bounds at one H100 SXM's published peaks (dense
bf16 989 TFLOP/s, HBM 3.35 TB/s, at its 700 W limit) from FLOPs and bytes
counted on the meta device: no time here was measured.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "results", "dryrun_torch")


def load(mesh: str | None = None, results: str = RESULTS) -> list[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if mesh and r.get("mesh") != mesh:
            continue
        rows.append(r)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    rows = load(results=args.results)
    if not rows:
        print("no dry-run records; run: "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun --all")
        return rows
    hdr = (f"{'mesh':9s}{'arch':26s}{'shape':12s}{'status':7s}"
           f"{'dominant':11s}{'compute_s':>10s}{'memory_s':>10s}"
           f"{'coll_s':>10s}{'useful':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        rl = r.get("roofline", {})
        uf = r.get("useful_flops_ratio")
        print(f"{r['mesh']:9s}{r['arch']:26s}{r['shape']:12s}"
              f"{r['status']:7s}{rl.get('dominant', '-'):11s}"
              f"{rl.get('compute_s', 0):10.4f}{rl.get('memory_s', 0):10.4f}"
              f"{rl.get('collective_s', 0):10.4f}"
              f"{uf if uf is None else format(uf, '.2f')!s:>7s}")
    ok = [r for r in rows if r["status"] == "ok"]
    skip = [r for r in rows if r["status"] == "skip"]
    err = [r for r in rows if r["status"] == "error"]
    print(f"\ncells: {len(ok)} ok, {len(skip)} skip "
          f"(long_500k on full-attention archs), {len(err)} error")
    return rows


if __name__ == "__main__":
    main()
