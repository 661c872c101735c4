"""Generate the dry-run tables (the EXPERIMENTS.md layout) from the port's
one-card records in results/dryrun_torch: the twin of the JAX package's
`benchmarks/gen_experiments_tables.py`, on the "card" mesh (one H100).

    PYTHONPATH=src python -m benchmarks.torch_gen_experiments_tables
        [--results DIR]

A record of the comm-priority variant (`repro_torch.launch.dryrun
--variant 1`, file suffix _v1) is the one perf iteration a card has; it
is rendered against its cell's baseline.  Every term is a roofline bound
at one H100 SXM's published peaks (989 TFLOP/s bf16, 3.35 TB/s, 700 W),
not a measured time.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "results", "dryrun_torch")
MESH = "card"
# (arch, shape, mesh, tags): the perf iterations rendered against the
# baseline record of the cell
PERF_CELLS = [
    ("glm4-9b", "train_4k", MESH, ["v1"]),
    ("falcon-mamba-7b", "train_4k", MESH, ["v1"]),
    ("llama3.2-3b", "train_4k", MESH, ["v1"]),
]


def load(results: str = RESULTS) -> dict:
    rows = {}
    for p in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(p) as f:
            rows[os.path.basename(p)[:-5]] = json.load(f)
    return rows


def baseline_table(rows: dict, mesh: str) -> str:
    out = [
        "| arch | shape | status | compute_s | memory_s | collective_s | "
        "dominant | MODEL/HLO flops | HBM GB/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for name, r in sorted(rows.items()):
        if r.get("mesh") != mesh or "_v" in name:
            continue
        rl = r.get("roofline", {})
        hbm = r.get("memory", {}).get("total_hbm_bytes", 0) / 1e9
        uf = r.get("useful_flops_ratio")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['status']} | "
            f"{rl.get('compute_s', 0):.4f} | {rl.get('memory_s', 0):.4f} | "
            f"{rl.get('collective_s', 0):.4f} | {rl.get('dominant', '—')} | "
            f"{uf:.2f} | {hbm:.1f} |"
            if r["status"] == "ok" else
            f"| {r['arch']} | {r['shape']} | {r['status']} | — | — | — | — "
            f"| — | — |")
    return "\n".join(out)


def perf_table(rows: dict, cells) -> str:
    out = [
        "| cell | config | compute_s | memory_s | collective_s | "
        "step (max) | vs baseline |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch, shape, mesh, tags in cells:
        base_key = f"{mesh}_{arch}_{shape}"
        base = rows.get(base_key)
        if not base or base["status"] != "ok":
            continue
        t0 = base["roofline"]["step_time_s"]
        for label, key in [("baseline", base_key)] + [
                (t, f"{mesh}_{arch}_{shape}_{t}") for t in tags]:
            r = rows.get(key)
            if not r or r.get("status") != "ok":
                continue
            rl = r["roofline"]
            out.append(
                f"| {arch} × {shape} ({mesh}) | {label} | "
                f"{rl['compute_s']:.3f} | {rl['memory_s']:.3f} | "
                f"{rl['collective_s']:.3f} | {rl['step_time_s']:.3f} | "
                f"{t0 / rl['step_time_s']:.2f}x |")
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    rows = load(args.results)
    text = "\n".join([
        "### one card (1 x H100)\n",
        baseline_table(rows, MESH),
        "\n### perf iterations\n",
        perf_table(rows, PERF_CELLS),
    ])
    print(text)
    return text


if __name__ == "__main__":
    main()
