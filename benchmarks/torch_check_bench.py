"""Perf-regression gate of the port over its ledger, BENCH_noc_torch.json:
the twin of the JAX package's `benchmarks/check_bench.py`.

Re-runs the sweep grid (`torch_bench_sweep.run`, the batched arm on the
default "fused" engine) and fails if it regressed against the last
committed `noc_sweep_serial_vs_batched` row on that engine:

  * launches — the batched arm must not launch its cycle kernel more
    often an epoch than the committed row did (1 on "fused": the whole
    grid in one B2 launch an epoch);
  * end-to-end speedup — it must clear an absolute floor AND a fraction
    of the committed row's (a cliff detector, not a noise tripwire);
  * steady-state speedup (full grid only) — likewise, against the
    committed row's steady speedup.

With no committed row on the default engine (a fresh ledger), the gates
fall back to their absolute floors, and the script says so.  `--grid
smoke` runs the tiny grid and skips the steady gate, as the JAX gate
does.  Then every row gate runs over the ledger, each tolerated with a
note while no row of its kind exists: `check_ablation`,
`check_trace_replay_row`, `check_faults_row`, `check_placement_row`,
`check_engine_rows` (the twin of `check_pallas_row`: rows of the sweep
on another engine never become the baseline, and the last of each must
keep its engine's launch contract and record `speedup_steady`),
`check_ledger_schema` and `check_obs_row`.  The defaults are the JAX
gate's.  It writes nothing.

    PYTHONPATH=src python -m benchmarks.torch_check_bench
        [--grid smoke|full] [--bench-json PATH] [--device cpu]

Exit code 0 = within tolerance, 1 = regression (message says which gate).
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmarks import torch_bench_sweep as bench_sweep
from repro_torch.obs import ledger

DEFAULT_MIN_SPEEDUP = 1.5  # absolute end-to-end floor
DEFAULT_FRAC = 0.25  # of the last committed row's end-to-end speedup
DEFAULT_MIN_STEADY = 0.4  # absolute steady floor (full grid)
DEFAULT_STEADY_FRAC = 0.5  # of the last committed row's steady speedup

SWEEP = "noc_sweep_serial_vs_batched"
LAUNCHES = "batched_launches_per_epoch"


def load_records(path: str) -> list:
    with open(path) as f:
        return json.load(f)


def last_committed_row(records: list, bench: str = SWEEP):
    """Last committed row of the default-engine ("fused") trajectory, or
    None when there is none.  Rows on another engine time a different
    batched arm, so they never become the baseline."""
    rows = [r for r in records if r.get("bench") == bench
            and r.get("sim_backend") == bench_sweep.DEFAULT_ENGINE]
    return rows[-1] if rows else None


def launch_contract(row: dict) -> float:
    """Cycle-kernel launches an epoch that a sweep row's batched arm
    should make on its engine: 1 on "fused", one B1 launch per row and
    cycle on "arb", none on "ref" (plain torch) or off the card."""
    if row.get("backend") != "cuda":
        return 0
    engine = row.get("sim_backend")
    if engine == "fused":
        return 1
    if engine == "arb":
        grid = row.get("grid", {})
        return grid.get("n_points", 0) * grid.get("epoch_len", 0)
    return 0


def check_engine_rows(records: list) -> list:
    """Tolerate-then-gate the committed sweep rows on engines other than
    the default (the twin of the JAX gate's `check_pallas_row`): while
    none exists the gate is skipped with a note; the last row of each
    such engine must keep its engine's launch contract
    (`launch_contract`) and record `speedup_steady`."""
    by_engine = {}
    for r in records:
        engine = r.get("sim_backend")
        if r.get("bench") == SWEEP and engine != bench_sweep.DEFAULT_ENGINE:
            by_engine[engine] = r
    if not by_engine:
        print("engine sweeps: no committed row on a non-default engine yet "
              "— tolerated (run benchmarks.torch_bench_sweep --backend "
              "ref|arb non-smoke to add one)")
        return []
    failures = []
    for engine, row in sorted(by_engine.items(), key=lambda kv: str(kv[0])):
        want = launch_contract(row)
        if row.get(LAUNCHES) != want:
            failures.append(
                f"engine regression: committed {engine!r} sweep row launched "
                f"its cycle kernel {row.get(LAUNCHES)}x an epoch (contract: "
                f"{want})")
        if "speedup_steady" not in row:
            failures.append(
                f"engine regression: committed {engine!r} sweep row lacks "
                "speedup_steady (bench must record the honest steady number)")
    return failures


def check_ledger_schema(records: list) -> list:
    """Validate every row against the ledger schema: rows stamped with
    `ledger_version` are hard-gated on the full schema, unstamped rows
    that miss the core schema are tolerated with a note."""
    failures, legacy_bad = [], 0
    for i, row in enumerate(records):
        stamped = isinstance(row, dict) and "ledger_version" in row
        problems = ledger.validate_row(row)
        if not problems:
            continue
        if stamped:
            failures += [f"ledger schema: row {i} "
                         f"({row.get('bench', '?')}): {p}" for p in problems]
        else:
            legacy_bad += 1
    if legacy_bad:
        print(f"ledger schema: {legacy_bad} unstamped row(s) with core-"
              "schema gaps — tolerated (no ledger_version stamp)")
    return failures


def _last(records: list, bench: str):
    rows = [r for r in records if r.get("bench") == bench]
    if not rows:
        print(f"{bench}: no committed record yet — tolerated")
        return None
    return rows[-1]


def check_obs_row(records: list) -> list:
    """Tolerate-then-gate the `noc_obs` flight-recorder row: a positive
    probe_overhead_steady, and one kernel per probe setting (the JAX
    row's one program per setting): the probes-off runs launch no B3 and
    the probes-on runs no B2 (`launches_off` / `launches_on`)."""
    row = _last(records, "noc_obs")
    if row is None:
        return []
    failures = []
    overhead = row.get("probe_overhead_steady")
    if not isinstance(overhead, (int, float)) or overhead <= 0:
        failures.append(
            "obs regression: committed noc_obs row lacks a positive "
            f"probe_overhead_steady (got {overhead!r})")
    for field, other in (("launches_off", "noc_fused_cycles_probed"),
                         ("launches_on", "noc_fused_cycles")):
        got = row.get(field)
        if not isinstance(got, dict) or got.get(other, 0) != 0:
            failures.append(
                f"obs regression: committed noc_obs row has {field}="
                f"{got!r} (contract: one kernel per probe setting, no "
                f"{other})")
    return failures


def _launches(row: dict, bench: str, what: str) -> list:
    """The one-program contract of a grid row, on the card: its B2
    launches are one an epoch for the whole grid (0 on the CPU)."""
    b2 = row.get("b2_launches")
    n = row.get("grid", {}).get("n_epochs")
    if b2 is not None and n is not None and b2 not in (0, n):
        return [f"{what} regression: committed {bench} row launched B2 "
                f"{b2}x over {n} epochs (contract: one launch an epoch)"]
    return []


def check_ablation(records: list) -> list:
    """Tolerate-then-gate the `noc_ablation` row: KF >= every naive
    predictor (kf_beats_all) from a grid of one B2 launch an epoch."""
    row = _last(records, "noc_ablation")
    if row is None:
        return []
    failures = _launches(row, "noc_ablation", "ablation")
    if row.get("kf_beats_all") is not True:
        failures.append(
            "ablation regression: committed noc_ablation row no longer "
            f"shows KF >= every naive predictor on {row.get('scenario')!r} "
            f"(margins: {row.get('margins')})")
    return failures


def check_trace_replay_row(records: list) -> list:
    """Tolerate-then-gate the `noc_trace_replay` row: KF >= every naive
    predictor on the replayed trace, one B2 launch an epoch, a bitwise
    round trip."""
    row = _last(records, "noc_trace_replay")
    if row is None:
        return []
    failures = _launches(row, "noc_trace_replay", "trace-replay")
    if row.get("kf_beats_all") is not True:
        failures.append(
            "trace-replay regression: committed noc_trace_replay row no "
            "longer shows KF >= every naive predictor on the replayed "
            f"trace {row.get('source')!r} (margins: {row.get('margins')})")
    if row.get("replay_bitwise") is not True:
        failures.append(
            "trace-replay regression: committed noc_trace_replay row's "
            "record->replay round trip was not bitwise-identical")
    return failures


def check_faults_row(records: list) -> list:
    """Tolerate-then-gate the `noc_faults` row: guarded KF >= unguarded KF
    and >= always_off under every fault, a bitwise-free healthy guard, a
    grid of one B2 launch an epoch."""
    row = _last(records, "noc_faults")
    if row is None:
        return []
    failures = _launches(row, "noc_faults", "faults")
    if row.get("guard_beats_all") is not True:
        failures.append(
            "faults regression: committed noc_faults row no longer shows "
            "guarded KF >= unguarded KF and >= always_off under every "
            f"fault scenario (margins: {row.get('margins')})")
    if row.get("healthy_bitwise") is not True:
        failures.append(
            "faults regression: committed noc_faults row's healthy "
            "guard-on run was not bitwise-equal to guard-off (arming the "
            "guard must be free on clean telemetry)")
    return failures


def check_placement_row(records: list) -> list:
    """Tolerate-then-gate the `noc_placement` row: joint control >=
    bandwidth-only on the gate scenario, a bitwise-free disarmed lever, a
    grid of one B2 launch an epoch."""
    row = _last(records, "noc_placement")
    if row is None:
        return []
    failures = _launches(row, "noc_placement", "placement")
    if row.get("joint_beats_bandwidth") is not True:
        failures.append(
            "placement regression: committed noc_placement row no longer "
            "shows joint control >= bandwidth-only mean GPU IPC on "
            f"{row.get('gate_scenario')!r} (margins: {row.get('margins')})")
    if row.get("identity_bitwise") is not True:
        failures.append(
            "placement regression: committed noc_placement row's "
            "bandwidth-control run carrying a placement stream was not "
            "bitwise-equal to the no-stream run (a disarmed lever must "
            "be free)")
    return failures


def check(rec: dict, baseline: dict, min_speedup: float, frac: float,
          min_steady: float = DEFAULT_MIN_STEADY,
          steady_frac: float = DEFAULT_STEADY_FRAC,
          gate_steady: bool = True) -> list:
    """Return the list of violated gates (empty = pass).  A baseline
    field that is absent (an empty baseline: no committed row) drops the
    relative term of its gate, leaving the absolute floor."""
    failures = []
    allowed = baseline.get(LAUNCHES, 1)
    got = rec[LAUNCHES]
    if got > allowed:
        failures.append(
            f"launch regression: batched arm launched its cycle kernel "
            f"{got}x an epoch (committed row: {allowed}x)")

    base_e2e = baseline.get("speedup_end_to_end")
    floor = (max(min_speedup, frac * base_e2e) if base_e2e is not None
             else min_speedup)
    speedup = rec["speedup_end_to_end"]
    if speedup < floor:
        failures.append(
            f"speedup regression: end-to-end {speedup}x < floor {floor:.2f}x "
            f"(committed row: {base_e2e}x, frac {frac}, abs min "
            f"{min_speedup})")

    if gate_steady:
        base_steady = baseline.get("speedup_steady")
        steady_floor = (max(min_steady, steady_frac * base_steady)
                        if base_steady is not None else min_steady)
        committed = (f"committed row: {base_steady}x, frac {steady_frac}, "
                     if base_steady is not None
                     else "no committed steady speedup, ")
        steady = rec["speedup_steady"]
        if steady < steady_floor:
            failures.append(
                f"steady-state regression: {steady}x < floor "
                f"{steady_floor:.2f}x ({committed}abs min {min_steady})")
    return failures


ROW_GATES = (check_ablation, check_trace_replay_row, check_faults_row,
             check_placement_row, check_engine_rows, check_ledger_schema,
             check_obs_row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", choices=("full", "smoke"), default="full",
                    help="full: default bench grid, all gates incl. steady; "
                         "smoke: tiny grid, steady gate skipped (noise)")
    ap.add_argument("--min-speedup", type=float, default=DEFAULT_MIN_SPEEDUP)
    ap.add_argument("--frac", type=float, default=DEFAULT_FRAC)
    ap.add_argument("--min-steady", type=float, default=DEFAULT_MIN_STEADY)
    ap.add_argument("--steady-frac", type=float, default=DEFAULT_STEADY_FRAC)
    ap.add_argument("--bench-json", default=bench_sweep.BENCH_PATH)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    records = (load_records(args.bench_json)
               if os.path.exists(args.bench_json) else [])
    baseline = last_committed_row(records)
    if baseline is None:
        print(f"no committed {bench_sweep.DEFAULT_ENGINE!r} {SWEEP} row in "
              f"{args.bench_json}: gating on the absolute floors alone "
              f"(end-to-end {args.min_speedup}x, steady {args.min_steady}x, "
              f"launches an epoch 1)")
    rec = bench_sweep.run(smoke=args.grid == "smoke", device=args.device)
    print(json.dumps(rec, indent=2))

    failures = check(
        rec, baseline or {}, args.min_speedup, args.frac,
        min_steady=args.min_steady, steady_frac=args.steady_frac,
        gate_steady=args.grid == "full",
    )
    for gate in ROW_GATES:
        failures += gate(records)
    if failures:
        for failure in failures:
            print(f"BENCH REGRESSION: {failure}", file=sys.stderr)
        return 1
    steady_note = (f", steady {rec['speedup_steady']}x"
                   if args.grid == "full"
                   else " (steady not gated on smoke)")
    committed = (f"{baseline.get('speedup_end_to_end')}x on "
                 f"{baseline['grid']['n_points']} points" if baseline
                 else "none")
    print(f"bench gate OK: {rec[LAUNCHES]:g} launch(es) an epoch, "
          f"{rec['speedup_end_to_end']}x end-to-end{steady_note} "
          f"(committed: {committed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
