"""The port's benchmark drivers on the CPU, against the JAX package's:

  * gates — `benchmarks/torch_check_bench.py`'s gates give the verdict of
    `benchmarks/check_bench.py`'s, gate by gate, on the committed
    BENCH_noc.json rows and on copies that each break one gate, after the
    rows go through `to_port` (the mapping of field and engine names
    below); with no baseline row JAX raises SystemExit and the port gates
    on the absolute floors;
  * the sweep bench — its grids are JAX's; its smoke grid runs here with
    the "ref" engine, the batched rows bitwise the serial rows, and the
    ledger's `validate_row` accepts the row, whose fields are the JAX
    row's as mapped;
  * the fleet and kernel benches run here at their sizes; the kernel
    bench's CSV names are `kernels_bench.py`'s with ``plain`` for
    ``interp``, its `--record` row has the JAX row's fields;
  * the aggregator prints `run.py`'s section titles in order (its
    sections stubbed), with `run.py`'s epochs and seeds under --fast.

The mapping, JAX row -> port row (`to_port`):
  * sim_backend: absent / "ref" (JAX's default engine) -> "fused" (the
    port's); "pallas" / "pallas_arb" (another engine) -> "arb";
  * backend: -> "cuda" (the committed rows were taken on the CPU; the
    port's launch contracts are the card's);
  * batched_traces t -> batched_launches_per_epoch t x the port engine's
    launch contract (JAX's one program ~ the engine's launches an epoch);
  * traces t (a grid row) -> b2_launches t x grid.n_epochs (one B2 launch
    an epoch for the grid);
  * traces_off / traces_on t -> launches_off / launches_on: the setting's
    own kernel launched, and the other setting's kernel t - 1 times."""
import copy
import json
import os
import re

import pytest

from benchmarks import bench_sweep as jbench_sweep
from benchmarks import check_bench as jcheck
from benchmarks import torch_bench_fleet_kf, torch_bench_sweep, torch_run
from benchmarks import torch_check_bench as tcheck
from benchmarks import torch_kernels_bench
from repro.core.noc.traffic import PROFILES
from repro_torch.obs import ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "BENCH_noc.json")) as _f:
    COMMITTED = json.load(_f)


def to_port(row: dict) -> dict:
    """A JAX BENCH row as the port's gates read it (module docstring)."""
    row = copy.deepcopy(row)
    if row.get("bench") == "noc_sweep_serial_vs_batched":
        engine = row.get("sim_backend", "ref")
        row["sim_backend"] = "fused" if engine == "ref" else "arb"
        row["backend"] = "cuda"
        if "batched_traces" in row:
            row["batched_launches_per_epoch"] = (
                row.pop("batched_traces") * tcheck.launch_contract(row))
    if "traces" in row and "n_epochs" in row.get("grid", {}):
        row["b2_launches"] = row.pop("traces") * row["grid"]["n_epochs"]
    for field, own, other in (
            ("traces_off", "noc_fused_cycles", "noc_fused_cycles_probed"),
            ("traces_on", "noc_fused_cycles_probed", "noc_fused_cycles")):
        if field in row:
            t = row.pop(field)
            row[field.replace("traces", "launches")] = {
                own: row.get("n_epochs", 1), other: t - 1}
    return row


def last(rows, bench, **match):
    return max(i for i, r in enumerate(rows) if r.get("bench") == bench
               and all(r.get(k) == v for k, v in match.items()))


def broken(field, value, bench, **match):
    """A copy of the committed rows whose last `bench` row has ``field``
    set to ``value`` (deleted for value None)."""
    rows = copy.deepcopy(COMMITTED)
    row = rows[last(rows, bench, **match)]
    if value is None:
        row.pop(field, None)
    else:
        row[field] = value
    return rows


def without(bench):
    return [r for r in COMMITTED if r.get("bench") != bench]


GATES = {
    "ablation": (jcheck.check_ablation, tcheck.check_ablation),
    "trace_replay": (jcheck.check_trace_replay_row,
                     tcheck.check_trace_replay_row),
    "faults": (jcheck.check_faults_row, tcheck.check_faults_row),
    "placement": (jcheck.check_placement_row, tcheck.check_placement_row),
    "engines": (jcheck.check_pallas_row, tcheck.check_engine_rows),
    "schema": (jcheck.check_ledger_schema, tcheck.check_ledger_schema),
    "obs": (jcheck.check_obs_row, tcheck.check_obs_row),
}
CASES = {
    "committed": (None, COMMITTED),
    "ablation_loses": ("ablation", broken("kf_beats_all", False,
                                          "noc_ablation")),
    "ablation_traces": ("ablation", broken("traces", 2, "noc_ablation")),
    "ablation_absent": (None, without("noc_ablation")),
    "replay_loses": ("trace_replay", broken("kf_beats_all", False,
                                            "noc_trace_replay")),
    "replay_not_bitwise": ("trace_replay", broken(
        "replay_bitwise", False, "noc_trace_replay")),
    "replay_traces": ("trace_replay", broken("traces", 3,
                                             "noc_trace_replay")),
    "replay_absent": (None, without("noc_trace_replay")),
    "faults_guard": ("faults", broken("guard_beats_all", False,
                                      "noc_faults")),
    "faults_healthy": ("faults", broken("healthy_bitwise", False,
                                        "noc_faults")),
    "faults_traces": ("faults", broken("traces", 2, "noc_faults")),
    "faults_absent": (None, without("noc_faults")),
    "placement_joint": ("placement", broken(
        "joint_beats_bandwidth", False, "noc_placement")),
    "placement_identity": ("placement", broken(
        "identity_bitwise", False, "noc_placement")),
    "placement_traces": ("placement", broken("traces", 2, "noc_placement")),
    "placement_absent": (None, without("noc_placement")),
    "engine_traces": ("engines", broken(
        "batched_traces", 2, "noc_sweep_serial_vs_batched",
        sim_backend="pallas")),
    "engine_no_steady": ("engines", broken(
        "speedup_steady", None, "noc_sweep_serial_vs_batched",
        sim_backend="pallas")),
    "engine_absent": (None, [r for r in COMMITTED
                                  if r.get("sim_backend") != "pallas"]),
    "schema_stamped_bad": ("schema", broken("git_sha", 7, "noc_obs")),
    "schema_legacy_bad": (None, broken("backend", None,
                                           "fleet_kf_epoch")),
    "obs_overhead": ("obs", broken("probe_overhead_steady", 0, "noc_obs")),
    "obs_traces": ("obs", broken("traces_on", 2, "noc_obs")),
    "obs_absent": (None, without("noc_obs")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_gates_give_the_jax_verdict(case, capsys):
    """CASES: (the one gate the rows break, or None where every gate
    passes or tolerates them, rows)."""
    breaks, rows = CASES[case]
    port_rows = [to_port(r) for r in rows]
    for gate, (jgate, tgate) in GATES.items():
        want = jgate(rows)
        got = tgate(port_rows)
        assert len(got) == len(want), (gate, got, want)
        assert bool(want) == (gate == breaks), (gate, want)


SWEEP = "noc_sweep_serial_vs_batched"
BASE = COMMITTED[last(COMMITTED, SWEEP, sim_backend="ref")]
RECS = {
    "same": {},
    "slow_e2e": {"speedup_end_to_end": 1.2},
    "under_frac": {"speedup_end_to_end": 0.2 * BASE["speedup_end_to_end"]},
    "slow_steady": {"speedup_steady": 0.3},
    "steady_under_frac": {"speedup_steady": 0.45},
    "more_programs": {"batched_traces": 2},
}


@pytest.mark.parametrize("gate_steady", [True, False])
@pytest.mark.parametrize("case", sorted(RECS))
def test_sweep_gate_gives_the_jax_verdict(case, gate_steady):
    rec = {**BASE, **RECS[case]}
    for baseline in (BASE, {}):
        want = jcheck.check(rec, baseline, jcheck.DEFAULT_MIN_SPEEDUP,
                            jcheck.DEFAULT_FRAC, gate_steady=gate_steady)
        got = tcheck.check(to_port(rec), to_port(baseline) if baseline
                           else {}, tcheck.DEFAULT_MIN_SPEEDUP,
                           tcheck.DEFAULT_FRAC, gate_steady=gate_steady)
        assert len(got) == len(want), (got, want)


def test_gate_defaults_and_baseline_are_jaxs():
    for name in ("DEFAULT_MIN_SPEEDUP", "DEFAULT_FRAC", "DEFAULT_MIN_STEADY",
                 "DEFAULT_STEADY_FRAC"):
        assert getattr(tcheck, name) == getattr(jcheck, name)
    port_rows = [to_port(r) for r in COMMITTED]
    assert tcheck.last_committed_row(port_rows) == to_port(
        jcheck.last_committed_row(COMMITTED))
    assert tcheck.last_committed_row(without(SWEEP)) is None
    with pytest.raises(SystemExit):
        jcheck.last_committed_row(without(SWEEP))


@pytest.mark.parametrize("speedup,rc", [(3.0, 0), (1.2, 1)])
def test_check_bench_without_baseline_gates_on_floors(
        tmp_path, monkeypatch, capsys, speedup, rc):
    rec = {**to_port(BASE), "speedup_end_to_end": speedup,
           "batched_launches_per_epoch": 1}
    calls = []
    monkeypatch.setattr(tcheck.bench_sweep, "run",
                        lambda **kw: calls.append(kw) or rec)
    path = str(tmp_path / "BENCH_noc_torch.json")
    assert tcheck.main(["--grid", "smoke", "--bench-json", path,
                        "--device", "cpu"]) == rc
    assert calls == [{"smoke": True, "device": "cpu"}]
    assert "absolute floors" in capsys.readouterr().out
    assert not os.path.exists(path)


def test_sweep_grids_are_jaxs():
    for smoke in (False, True):
        kw = dict(n_epochs=4, epoch_len=50) if smoke else dict(
            n_epochs=8, epoch_len=100)
        wl = ("PATH", "LIB") if smoke else ("PATH", "LIB", "STO", "MUM")
        ratios = (1, 3) if smoke else (1, 2, 3)
        seeds = (0,) if smoke else (0, 1)
        jc, jp = jbench_sweep._grid(wl, ratios, seeds, **kw)
        tc, tp = torch_bench_sweep.grid(wl, ratios, seeds, **kw)
        assert [(c.mode, c.static_gpu_vcs, c.seed, c.n_epochs, c.epoch_len)
                for c in tc] == [(c.mode, c.static_gpu_vcs, c.seed,
                                  c.n_epochs, c.epoch_len) for c in jc]
        assert all(a is PROFILES[b] for a, b in zip(jp, tp, strict=True))


def test_sweep_smoke_on_cpu_bitwise_and_valid():
    rec = torch_bench_sweep.run(smoke=True, sim_backend="ref", device="cpu")
    assert ledger.validate_row(rec) == []
    assert rec["batched_bitwise_serial"] is True
    assert rec["batched_launches_per_epoch"] == 0
    assert rec["grid"] == {"workloads": ["PATH", "LIB"], "ratios": [1, 3],
                           "seeds": [0], "n_epochs": 4, "epoch_len": 50,
                           "n_points": 4}
    assert (rec["backend"], rec["sim_backend"], rec["smoke"]) == (
        "cpu", "ref", True)
    jax_fields = set(BASE) - {"cycle_unroll", "batched_traces"}
    assert set(rec) == jax_fields | {"batched_launches_per_epoch",
                                     "batched_bitwise_serial"}
    for arm in ("serial", "batched"):   # from the unrounded times
        assert abs(rec[f"{arm}_compile_s"] - max(
            rec[f"{arm}_total_s"] - rec[f"{arm}_steady_s"], 0.0)) <= 1.5e-3


def test_sweep_mismatch_finds_a_differing_row():
    import torch

    from repro_torch.core.noc import sim
    cfg = sim.NoCConfig(mode="static", n_epochs=1, epoch_len=5)
    row = sim.simulate(cfg, "PATH", device="cpu", engine="ref")
    batch = sim.simulate_batch([cfg, cfg], "PATH", device="cpu",
                               engine="ref")
    assert torch_bench_sweep.mismatch([row, row], batch) is None
    other = row._replace(counters=row.counters._replace(
        gpu_push=row.counters.gpu_push + 1))
    assert torch_bench_sweep.mismatch([row, other], batch) \
        == "row 1 field gpu_push"


def test_fleet_bench_on_cpu():
    assert torch_bench_fleet_kf.SIZES == (64, 1024)
    points = torch_bench_fleet_kf.run(device="cpu")
    assert [p["n_filters"] for p in points] == [64, 1024]
    for p in points:
        assert set(p) == {"n_filters", "iters", "epoch_us", "ns_per_filter",
                          "b4_launches"}
        assert p["iters"] == 200 and p["b4_launches"] == 0
        assert p["epoch_us"] > 0
    rec = torch_bench_fleet_kf.record(points, device="cpu")
    assert ledger.validate_row(rec) == []
    committed = COMMITTED[last(COMMITTED, "fleet_kf_epoch")]
    assert set(committed) <= set(rec)


def jax_kernel_names() -> list[str]:
    """The CSV names `kernels_bench.py` prints, ``interp`` for its mode."""
    with open(os.path.join(ROOT, "benchmarks", "kernels_bench.py")) as f:
        src = f.read()
    names = []
    for raw in re.findall(r'print\(f"([a-z_0-9{}\[\]\']+),', src):
        if "{n}" in raw:
            names += [raw.replace("{n}", str(n))
                      for n in torch_kernels_bench.KF_SIZES]
        else:
            names.append(raw.replace("{noc['mode']}", "interp"))
    return names


def test_kernel_bench_on_cpu_names_and_record(tmp_path, capsys):
    path = str(tmp_path / "BENCH_noc_torch.json")
    rows = torch_kernels_bench.main(["--device", "cpu", "--record",
                                     "--bench-json", path])
    want = [n.replace("_interp", "_plain") for n in jax_kernel_names()]
    assert len(want) == 7
    assert [r["name"] for r in rows] == want
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in out[1:8]] == want
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    with open(path) as f:
        rec, = json.load(f)
    assert ledger.validate_row(rec) == []
    committed = COMMITTED[last(COMMITTED, "noc_cycle_kernels")]
    assert set(committed) <= set(rec)
    assert (rec["mode"], rec["sim_cycles"], rec["arb_shapes"]) == (
        "plain", committed["sim_cycles"], committed["arb_shapes"])


def test_kernel_bench_mismatch_exits_nonzero():
    import torch
    with pytest.raises(SystemExit, match="differs from its plain version"):
        torch_kernels_bench.held("x", torch.ones(3), torch.zeros(3), 1e-3)
    assert torch_kernels_bench.held("x", torch.ones(3),
                                    torch.ones(3) + 1e-6, 2e-5) > 0


def jax_section_titles() -> list[str]:
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        return re.findall(r'_section\("([^"]+)"\)', f.read())


# the one title that changes: the port's micro-benches run the CUDA
# kernels on the card, not Pallas in interpret mode
TITLE_MAP = {"Kernel micro-benches (interpret mode)":
             "Kernel micro-benches (CUDA kernels against their plain "
             "versions)"}


@pytest.mark.parametrize("fast", [True, False])
def test_aggregator_sections_in_jax_order(monkeypatch, capsys, fast):
    calls = []
    for _, name in torch_run.SECTIONS:
        monkeypatch.setattr(
            torch_run, name,
            lambda args, epochs, seeds, name=name: calls.append(
                (name, args.fast, args.device, epochs, seeds)))
    walls = torch_run.main(["--device", "cpu"] + (["--fast"] if fast else []))
    titles = re.findall(r"^== (.+)$", capsys.readouterr().out, re.M)
    want = [TITLE_MAP.get(t, t) for t in jax_section_titles()]
    assert len(want) == 10
    assert titles == want == list(walls)
    epochs, seeds = (30, (0,)) if fast else (60, (0, 1, 2))
    assert calls == [(name, fast, "cpu", epochs, seeds)
                     for _, name in torch_run.SECTIONS]
