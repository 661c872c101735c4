"""Benchmark aggregator of the PyTorch + CUDA port: one section per paper
table or figure, the serving A/B, the fleet KF bank, the kernel
micro-benches and the roofline table, in the order of the JAX package's
`benchmarks/run.py`, through the torch drivers.

    PYTHONPATH=src python -m benchmarks.torch_run [--fast] [--device cpu]

``--fast`` takes the JAX aggregator's settings: 30-epoch NoC runs and one
seed (60 epochs and seeds 0-2 without it), the sweep engine's smoke grid
and the ablation's smoke set.  Only the sweep section off ``--fast``
appends to the port's ledger (BENCH_noc_torch.json), as the JAX
aggregator does; the kernel micro-benches run without ``--record``.  Each
section prints its wall, and the run ends with every section's wall and
the total, on the device named there.  The roofline table reads the
one-card dry-run records (run `python -m repro_torch.launch.dryrun --all`
first for the whole table).  Everything runs on the CUDA card unless
``--device`` names another.  Imports no JAX.
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

from repro_torch._util import resolve_device


def _section(title):
    print(f"\n{'=' * 72}\n== {title}\n{'=' * 72}", flush=True)


def fig2_3(args, epochs, seeds):
    from benchmarks import torch_fig2_3
    res = torch_fig2_3.run(n_epochs=epochs, seeds=seeds, device=args.device)
    for wl, row in res.items():
        line = "  ".join(
            f"{r}: gpu={s['gpu_ipc']:.3f}±{s['gpu_ipc_std']:.3f} "
            f"cpu={s['cpu_ipc']:.3f}"
            for r, s in row.items())
        print(f"{wl:6s} {line}")


def fig4(args, epochs, seeds):
    from benchmarks import torch_fig4_traffic
    tr = torch_fig4_traffic.run(n_epochs=epochs, device=args.device)
    gpu_cov, cpu_cov, holds = torch_fig4_traffic.cov_claim(tr)
    print(f"gpu_inj CoV={gpu_cov:.3f}  cpu_push CoV={cpu_cov:.3f}  "
          f"bursty-vs-stable: {holds}")


def fig9_10_11(args, epochs, seeds):
    from benchmarks import torch_fig9_10_11
    res = torch_fig9_10_11.run(n_epochs=epochs, seeds=seeds,
                               device=args.device)
    wls = list(res)
    for wl in wls:
        print(f"{wl:5s} " + "  ".join(
            f"{m}: gpu={s['gpu_ipc']:.3f}±{s['gpu_ipc_std']:.3f} "
            f"lat={s['avg_latency']:.1f}"
            for m, s in res[wl].items()))
    lat_wins = sum(res[w]["kf"]["avg_latency"]
                   <= res[w]["baseline"]["avg_latency"] for w in wls)
    gains = [res[w]["kf"]["gpu_ipc"] / max(res[w]["baseline"]["gpu_ipc"], 1e-9)
             - 1 for w in wls]
    print(f"KF latency wins: {lat_wins}/{len(wls)}; GPU IPC gain "
          f"mean {sum(gains)/len(gains):+.1%} max {max(gains):+.1%} "
          f"(paper: +7% mean, +19% max)")


def fig12(args, epochs, seeds):
    from benchmarks import torch_fig12
    tr = torch_fig12.run(n_epochs=max(epochs, 100), seeds=seeds,
                         device=args.device)
    sl = slice(10, None)
    print(f"mean GPU IPC: fair {tr['fair_ipc'][sl].mean():.4f} "
          f"kf {tr['kf_ipc'][sl].mean():.4f}; "
          f"KF engaged {tr['kf_config'][sl].mean():.0%} of epochs")


def sweep_engine(args, epochs, seeds):
    from benchmarks import torch_bench_sweep
    rec = torch_bench_sweep.run(smoke=args.fast, device=args.device)
    if not args.fast:
        torch_bench_sweep.append_record(rec)
    print(f"serial {rec['serial_total_s']:.1f}s "
          f"(first-call excess {rec['serial_compile_s']:.1f}s) vs batched "
          f"{rec['batched_total_s']:.1f}s "
          f"(first-call excess {rec['batched_compile_s']:.1f}s): "
          f"{rec['speedup_end_to_end']:.1f}x end-to-end, "
          f"{rec['speedup_steady']:.1f}x steady-state, "
          f"{rec['batched_launches_per_epoch']:g} cycle-kernel launch(es) "
          f"an epoch")


def ablation(args, epochs, seeds):
    from benchmarks import torch_fig_ablation
    ab = torch_fig_ablation.run(device=args.device,
                                **(torch_fig_ablation.SMOKE if args.fast
                                   else {}))
    for sc, cells in ab["table"].items():
        print(f"{sc}: " + "  ".join(
            f"{p}={s['gpu_ipc']:.3f}" for p, s in cells.items()))
    verdict = torch_fig_ablation.kf_verdict(ab["table"])
    print(f"kf_beats_all={verdict['kf_beats_all']} on "
          f"{verdict['scenario']} ({ab['rows']} rows in one sweep)")


def serving_ab(args, epochs, seeds):
    from benchmarks import torch_kf_scheduler_ab
    res = torch_kf_scheduler_ab.run(device=args.device)
    for mode, s in res.items():
        print(f"{mode:7s} ttft={s['mean_ttft']:.4f} "
              f"p90={s['p90_ttft']:.4f} lat={s['mean_latency']:.4f} "
              f"thr={s['throughput_tok_s']:.1f} "
              f"kf_on={s['kf_on_frac']:.2f}")


def fleet_kf(args, epochs, seeds):
    from benchmarks import torch_bench_fleet_kf
    for r in torch_bench_fleet_kf.run(device=args.device):
        print(f"n={r['n_filters']:5d} epoch={r['epoch_us']:.1f}us "
              f"({r['ns_per_filter']:.0f}ns/filter, "
              f"{r['b4_launches']} B4 launches)")


def kernels(args, epochs, seeds):
    from benchmarks import torch_kernels_bench
    # no --record: aggregator runs never append
    torch_kernels_bench.main([] if args.device is None
                             else ["--device", str(args.device)])


def roofline_table(args, epochs, seeds):
    from benchmarks import torch_roofline_table
    torch_roofline_table.main([])


# (title, section), in the JAX aggregator's order and with its titles
SECTIONS = (
    ("Fig 2/3 — IPC vs static VC allocation ratio", "fig2_3"),
    ("Fig 4 — dynamic traffic pattern (bursty GPU, stable CPU)", "fig4"),
    ("Figs 9/10/11 — four configurations", "fig9_10_11"),
    ("Fig 12 — dynamic GPU IPC, fair vs KF", "fig12"),
    ("Sweep engine — serial vs batched wall-clock", "sweep_engine"),
    ("Predictor ablation — KF vs naive predictors (DESIGN.md §12)",
     "ablation"),
    ("TPU adaptation — KF-arbitrated serving engine A/B", "serving_ab"),
    ("Fleet-KF bank — per-epoch filter-bank timings", "fleet_kf"),
    ("Kernel micro-benches (CUDA kernels against their plain versions)",
     "kernels"),
    ("Roofline table (from dry-run artifacts)", "roofline_table"),
)


def main(argv=None) -> dict:
    """Runs every section; returns {title: wall seconds}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer epochs / one seed for the NoC sims")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    epochs = 30 if args.fast else 60
    seeds = (0,) if args.fast else (0, 1, 2)

    t0 = time.time()
    walls = {}
    for title, name in SECTIONS:
        _section(title)
        ts = time.time()
        globals()[name](args, epochs, seeds)
        walls[title] = time.time() - ts
        print(f"-- section wall {walls[title]:.2f} s", flush=True)

    total = time.time() - t0
    print(f"\n[torch_run] section walls on {where}:")
    for title, wall in walls.items():
        print(f"  {wall:9.2f} s  {title}")
    print(f"[torch_run] done in {total:.1f}s")
    return walls


if __name__ == "__main__":
    main()
    sys.exit(0)
