"""Trace-driven demand replay on the PyTorch + CUDA port: the KF-vs-naive
ordering of the predictor ablation on replayed demand traces.

The predictor ablation (torch_fig_ablation) runs on synthetic scenario
schedules; this driver runs the SAME comparison on replayed demand:

  * by default, the serving trace of the port's own prefill and decode
    steps (`repro_torch.core.noc.trace_adapters`, costs from
    `repro_torch.launch.op_cost`), the first non-synthetic workload
    family;
  * with ``--costs committed``, the JAX package's serving trace rebuilt
    from the committed `noc_trace_replay` row of BENCH_noc.json (its
    `hlo_phases` flops and bytes through the port's `demand_from_costs`),
    so the port replays exactly what the JAX package replayed;
  * with ``--trace F.npz``, any recorded demand trace (e.g. a
    `repro_torch.obs.TraceRecorder` capture, or a trace the JAX package
    saved).

The replayed trace registers as a sweep workload, so the whole predictor
x seed grid is ONE `sim.sweep` (on the card: one launch of the fused
cycle kernel an epoch for every row).  ``--check`` is the record->replay
smoke: a 4-epoch `TraceRecorder` capture of SHIFT_PATH_BFS round-trips
through the npz schema and must replay bitwise-identical to the
originating run.

Gate: KF mean GPU IPC >= every naive predictor on the replayed trace, on
the card one B2 launch an epoch for the whole grid, and the
record->replay check bitwise-green.  The row is printed as JSON and
appended nowhere (BENCH_noc.json holds the JAX package's rows).

    PYTHONPATH=src python3 benchmarks/torch_fig_trace_replay.py [--check]
        [--smoke] [--gate] [--costs port|committed] [--trace F.npz]
        [--save-trace F.npz] [--device cpu] [--n-epochs N]
        [--partitionable 0|1] [--profile DIR]

``--partitionable 0`` draws with JAX's original threefry scheme (the one
the committed rows of BENCH_noc.json were drawn with); the default (1) is
jax 0.9.0's default.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np
import torch

from benchmarks import torch_cli
from benchmarks.torch_fig_ablation import (
    KF_Q_ABLATION,
    PREDICTORS,
    kf_verdict,
    run as ablation_run,
)
from benchmarks.torch_fig_faults import bitwise_equal
from repro_torch._util import resolve_device
from repro_torch.core import threefry
from repro_torch.core.noc import sim, trace_adapters, traffic
from repro_torch.kernels.noc_cycle import ops
from repro_torch.obs import TraceRecorder, ledger, profiling

# Registry name the default serving trace lands under.
HLO_WORKLOAD = "HLO_SERVE"
SEEDS = (0, 1, 2)
SMOKE_SEEDS = (0,)
N_EPOCHS = 120
# The record->replay smoke's capture source and dims: 4 epochs is enough
# to exercise the schema and the replay path while staying cheap.
CHECK_SCENARIO = "SHIFT_PATH_BFS"
CHECK_EPOCHS = 4
REPLAY_BENCH = "noc_trace_replay"
BENCH_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BENCH_noc.json")


def committed_row(path: str = BENCH_PATH) -> dict:
    """The JAX package's committed `noc_trace_replay` row (read-only)."""
    with open(path) as f:
        rows = [r for r in json.load(f) if r.get("bench") == REPLAY_BENCH]
    if len(rows) != 1:
        raise ValueError(f"{path} holds {len(rows)} {REPLAY_BENCH} rows, "
                         f"expected 1")
    return rows[0]


def committed_trace(row: dict | None = None) -> traffic.RecordedTrace:
    """The JAX package's serving trace, rebuilt from the committed row's
    `hlo_phases` flops and bytes through the port's `demand_from_costs`
    (its rates are the row's to the last bit)."""
    row = committed_row() if row is None else row
    costs = {p: {"flops": c["flops"], "bytes": c["bytes"]}
             for p, c in row["hlo_phases"].items()}
    return trace_adapters.demand_from_costs(
        costs, name=HLO_WORKLOAD.lower(), adapter="hlo_cost (committed row)")


def prepare_source(args) -> tuple[str, dict]:
    """Register the demand source; return (workload name, provenance).

    ``--trace F.npz`` wins; otherwise the serving trace from the port's
    own step costs, or with ``--costs committed`` from the JAX package's
    committed row.  A serving trace whose length differs from the run's
    ``--n-epochs`` is stretched onto it.
    """
    name = torch_cli.registered_trace(args)
    if name:
        return name, dict(traffic.lookup_workload(name).meta,
                          path=args.trace)
    if getattr(args, "costs", "port") == "committed":
        trace = committed_trace()
    else:
        trace = trace_adapters.hlo_serving_trace(name=HLO_WORKLOAD.lower())
    if getattr(args, "save_trace", None):
        trace.save(args.save_trace)
        print(f"# saved the serving trace to {args.save_trace}")
    n_epochs = getattr(args, "n_epochs", N_EPOCHS)
    if trace.n_epochs_recorded != n_epochs:
        print(f"# the {trace.n_epochs_recorded}-epoch serving trace is "
              f"stretched onto {n_epochs} epochs")
        trace = trace.with_fit("stretch")
    traffic.register_workload(HLO_WORKLOAD, trace, overwrite=True)
    return HLO_WORKLOAD, trace.meta


def replay_check(save_path: str | None = None, device=None) -> list[str]:
    """Record->save->load->replay round trip; return failures ([] = pass).

    Captures CHECK_EPOCHS epochs of CHECK_SCENARIO with TraceRecorder,
    round-trips the capture through the npz trace schema, replays it, and
    requires (a) a clean schema validation and (b) bitwise equality with
    running the scenario directly, on ``device`` (default: the card).
    """
    failures = []
    cfg = sim.NoCConfig(mode="kf", n_epochs=CHECK_EPOCHS, epoch_len=200)
    own_tmp = save_path is None
    if own_tmp:
        fd, save_path = tempfile.mkstemp(suffix=".npz")
        os.close(fd)
    try:
        TraceRecorder(name="replay_check", observe=False).record_to(
            save_path, cfg, CHECK_SCENARIO)
        with np.load(save_path, allow_pickle=False) as data:
            problems = traffic.validate_trace_npz(data)
        if problems:
            failures.append(f"trace schema: {problems}")
        replayed = traffic.RecordedTrace.load(save_path)
        ref = sim.simulate(cfg, CHECK_SCENARIO, device=device)
        rep = sim.simulate(cfg, replayed, device=device)
        for field, a, b in zip(ref._fields, ref, rep):
            if not bitwise_equal(a, b):
                failures.append(f"replay diverged at {field}")
                break
    finally:
        if own_tmp:
            os.unlink(save_path)
    return failures


def run(source: str, n_epochs: int = N_EPOCHS, seeds=SEEDS, device=None,
        **overrides) -> dict:
    """The predictor x seed grid on ``source`` in one sweep
    (`torch_fig_ablation.run`), with its B2 launches (0 on the CPU)."""
    before = ops.LAUNCHES["noc_fused_cycles"]
    res = ablation_run(n_epochs=n_epochs, seeds=seeds, scenarios=(source,),
                       device=device, **overrides)
    res["b2_launches"] = ops.LAUNCHES["noc_fused_cycles"] - before
    return res


def record(res: dict, verdict: dict, grid: dict, source: str,
           provenance: dict, device: torch.device) -> dict:
    cells = res["table"][source]
    row = {
        "bench": REPLAY_BENCH,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "backend": device.type,
        "source": source,
        "adapter": provenance.get("adapter"),
        "grid": grid,
        "b2_launches": res["b2_launches"],
        "gpu_ipc": {p: round(cells[p]["gpu_ipc"], 6) for p in PREDICTORS},
        **verdict,
    }
    phases = provenance.get("phases")
    if phases:
        # the roofline mapping, for provenance: what each serving phase
        # cost and the injection rate it mapped to
        row["hlo_phases"] = {
            p: {k: c[k] for k in ("flops", "bytes", "intensity", "rate")}
            for p, c in phases.items()
        }
    row.update(ledger.run_stamp())
    problems = ledger.validate_row(row)
    if problems:
        raise ValueError(f"malformed {REPLAY_BENCH} row: {problems}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-epochs", type=int, default=N_EPOCHS)
    ap.add_argument("--partitionable", type=int, choices=(0, 1), default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="one seed on the replayed trace at full dims")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 unless KF >= every naive predictor on the "
                         "replayed trace, on the card the grid took one B2 "
                         "launch an epoch, and the record->replay check is "
                         "bitwise-green")
    ap.add_argument("--check", action="store_true",
                    help=f"record->replay smoke only: capture {CHECK_EPOCHS}"
                         f" epochs of {CHECK_SCENARIO}, round-trip the npz "
                         f"schema, require a bitwise replay")
    ap.add_argument("--costs", choices=("port", "committed"), default="port",
                    help="the serving trace's costs: the port's own steps "
                         "(launch.op_cost, default) or the JAX package's "
                         "committed noc_trace_replay row")
    ap.add_argument("--save-trace", metavar="F.npz", default=None,
                    help="save the serving trace (default source) for reuse "
                         "via --trace")
    torch_cli.add_flags(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.check:
        failures = replay_check(device=dev)
        for f in failures:
            print(f"TRACE REPLAY CHECK: {f}", file=sys.stderr)
        if not failures:
            print(f"replay check OK: {CHECK_EPOCHS}-epoch {CHECK_SCENARIO} "
                  f"capture replays bitwise through the npz schema")
        return 1 if failures else 0

    source, provenance = prepare_source(args)
    seeds = SMOKE_SEEDS if args.smoke else SEEDS
    overrides = torch_cli.shared_overrides(args)
    t0 = time.time()
    with threefry.threefry_partitionable(bool(args.partitionable)):
        res = profiling.profiled_run(
            args.profile,
            lambda: run(source, n_epochs=args.n_epochs, seeds=seeds,
                        device=dev, **overrides),
            label="fig_trace_replay")
    wall = time.time() - t0
    print("source,predictor,gpu_ipc,gpu_ipc_std,cpu_ipc,avg_latency,"
          "boost_frac")
    for p, s in res["table"][source].items():
        print(f"{source},{p},{s['gpu_ipc']:.4f},{s['gpu_ipc_std']:.4f},"
              f"{s['cpu_ipc']:.4f},{s['avg_latency']:.2f},"
              f"{s['kf_on_frac']:.2f}")

    verdict = kf_verdict(res["table"], source)
    replay_failures = replay_check(device=dev)
    want_b2 = args.n_epochs if dev.type == "cuda" else 0
    print(f"# B2 launches: {res['b2_launches']} (contract on the card: one "
          f"an epoch for the whole grid, {want_b2} here)")
    print(f"# {source}: KF gpu_ipc {verdict['kf_gpu_ipc']:.6f}; margins vs "
          "naive: "
          + ", ".join(f"{p} {m:+.6f}" for p, m in verdict["margins"].items()))
    print(f"# kf_beats_all: {verdict['kf_beats_all']} "
          "(KF >= every naive predictor on the replayed trace)")
    print(f"# record->replay bitwise: {not replay_failures}")
    print(f"# {res['rows']} rows x {args.n_epochs} epochs in one sweep, "
          f"wall {wall:.2f} s on {ledger.device_kind()}")
    grid = {"predictors": list(PREDICTORS), "seeds": list(seeds),
            "n_epochs": args.n_epochs, "kf_q": KF_Q_ABLATION,
            "partitionable": bool(args.partitionable)}
    rec = record(res, verdict, grid, source, provenance, dev)
    rec["replay_bitwise"] = not replay_failures
    print(json.dumps(rec))

    if args.gate:
        failures = list(replay_failures)
        if res["b2_launches"] != want_b2:
            failures.append(f"the replay grid launched B2 "
                            f"{res['b2_launches']} times, expected {want_b2}")
        if not verdict["kf_beats_all"]:
            losing = {p: m for p, m in verdict["margins"].items() if m < 0}
            failures.append(f"KF lost to {losing} on {source} mean GPU IPC")
        for f in failures:
            print(f"TRACE REPLAY GATE: {f}", file=sys.stderr)
        if failures:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
