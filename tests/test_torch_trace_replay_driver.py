"""The port's trace-replay driver (benchmarks/torch_fig_trace_replay.py),
the torch figure drivers' ``--trace`` / ``--profile`` flags
(benchmarks/torch_cli.py) and `repro_torch.obs.profiling`, on the CPU:

  * ``--check`` (record -> npz -> replay, bitwise) exits 0;
  * the predictor grid on the committed serving trace through the driver's
    `run` equals the JAX package's `fig_ablation.run` on the same trace
    bit for bit in every cell's mean GPU IPC, and in the verdict
    (tests/_torch_sim.py's 30-cycle epochs and policy, 6 epochs, one
    seed; the trace stretched onto 6 epochs in both packages);
  * ``--trace F.npz`` registers the file through `torch_cli` as the
    workload the figure driver then runs (its `run` stubbed: the wiring,
    not the simulation, is under test), and ``--profile DIR`` calls the
    run twice;
  * `profiled_run` calls its function once without an outdir and twice
    with one, writing a Chrome trace for each call."""
import json
import os

import numpy as np
import pytest

from _torch_sim import POLICY, SIZE, JPolicyConfig
from benchmarks import fig_ablation as jabl
from benchmarks import torch_cli, torch_fig12
from benchmarks import torch_fig_trace_replay as rep
from repro.core.noc import trace_adapters as jta
from repro.core.noc import traffic as jtraffic
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import traffic
from repro_torch.obs import profiling

E = 6
KW = {k: v for k, v in SIZE.items() if k != "n_epochs"}
WL = "HLO_SERVE_TEST"


def test_check_exits_zero(capsys):
    assert rep.main(["--check", "--device", "cpu"]) == 0
    assert "replay check OK" in capsys.readouterr().out


def test_committed_trace_rates_are_the_rows():
    row = rep.committed_row()
    trace = rep.committed_trace(row)
    for p, c in row["hlo_phases"].items():
        assert trace.meta["phases"][p]["rate"] == c["rate"]
        assert trace.meta["phases"][p]["intensity"] == c["intensity"]
    assert trace.n_epochs_recorded == row["grid"]["n_epochs"]


def test_grid_equals_jax_ablation_on_the_same_trace():
    costs = {p: {"flops": c["flops"], "bytes": c["bytes"]}
             for p, c in rep.committed_row()["hlo_phases"].items()}
    jtraffic.register_workload(
        WL, jta.demand_from_costs(costs).with_fit("stretch"), overwrite=True)
    traffic.register_workload(WL, rep.committed_trace().with_fit("stretch"),
                              overwrite=True)
    try:
        want = jabl.run(n_epochs=E, seeds=(0,), scenarios=(WL,),
                        policy=JPolicyConfig(*POLICY), **KW)
        got = rep.run(WL, n_epochs=E, seeds=(0,), device="cpu",
                      policy=PolicyConfig(*POLICY), **KW)
    finally:
        jtraffic.unregister_workload(WL)
        traffic.unregister_workload(WL)
    assert got["b2_launches"] == 0 and got["rows"] == 5
    assert got["warmup_epochs"] == want["warmup_epochs"]
    assert list(got["table"][WL]) == list(want["table"][WL])
    for p, cell in want["table"][WL].items():
        assert got["table"][WL][p]["gpu_ipc"] == cell["gpu_ipc"], p
    assert rep.kf_verdict(got["table"], WL) == jabl.kf_verdict(
        want["table"], WL)


@pytest.fixture
def stub_fig12(monkeypatch):
    calls = []

    def run(workload="STO", n_epochs=120, seeds=(0,), device=None, **kw):
        calls.append(workload)
        z = np.zeros(n_epochs)
        return {"fair_ipc": z + 1.0, "kf_ipc": z + 1.0, "fair_ipc_std": z,
                "kf_ipc_std": z, "kf_signal": z.astype(np.int32),
                "kf_config": z.astype(np.int32)}

    monkeypatch.setattr(torch_fig12, "run", run)
    return calls


def test_trace_flag_registers_the_file_for_a_figure_driver(tmp_path,
                                                           stub_fig12):
    path = str(tmp_path / "serve.npz")
    rep.committed_trace().save(path)
    try:
        torch_fig12.main(["--device", "cpu", "--trace", path,
                          "--trace-fit", "tile"])
        assert stub_fig12 == [torch_cli.TRACE_WORKLOAD]
        trace = traffic.lookup_workload(torch_cli.TRACE_WORKLOAD)
        assert trace.fit == "tile" and trace.n_epochs_recorded == 120
        np.testing.assert_array_equal(
            trace.demand.gpu_rate_lo,
            rep.committed_trace().demand.gpu_rate_lo)
    finally:
        traffic.unregister_workload(torch_cli.TRACE_WORKLOAD)
    torch_fig12.main(["--device", "cpu"])
    assert stub_fig12[-1] == "STO"


def test_profile_flag_runs_twice_and_writes_traces(tmp_path, stub_fig12):
    torch_fig12.main(["--device", "cpu", "--profile", str(tmp_path)])
    assert stub_fig12 == ["STO", "STO"]
    for phase in ("cold", "steady"):
        assert os.path.exists(tmp_path / f"fig12-{phase}" /
                              profiling.TRACE_FILE)


def test_profiled_run_calls(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return len(calls)

    assert profiling.profiled_run(None, fn) == 1
    assert len(calls) == 1
    assert profiling.profiled_run(str(tmp_path), fn, label="x") == 3
    assert len(calls) == 3
    for phase in ("cold", "steady"):
        path = tmp_path / f"x-{phase}" / profiling.TRACE_FILE
        with open(path) as f:
            assert "traceEvents" in json.load(f)
