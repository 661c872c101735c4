"""The port's paper-figure drivers (benchmarks/torch_fig*.py) on the CPU at
a small size: each `run()` over one seed and one workload (30-cycle
epochs) returns its table with the reference driver's keys and finite
cells, and each `main()` prints that table and its summary lines; the
ablation's `--gate` exits 1 exactly when KF loses to a naive predictor on
the gate scenario; `benchmarks/torch_cli.py`'s flags become overrides
checked against the port's registries.  The numbers themselves are held
against the JAX drivers in tests/test_torch_fig_twins.py (and the fault,
placement and Fig. 4 twins)."""
import argparse
import functools
import math

import pytest

from benchmarks import torch_cli, torch_fig2_3, torch_fig9_10_11, torch_fig12
from benchmarks import torch_fig_ablation as abl

SMALL = dict(epoch_len=30, seeds=(0,), device="cpu")
SUMMARY_KEYS = {"gpu_ipc", "cpu_ipc", "avg_latency", "kf_on_frac"}
SUMMARY_KEYS |= {k + "_std" for k in SUMMARY_KEYS}


@functools.lru_cache(maxsize=None)
def small_run(name: str):
    if name == "fig2_3":
        return torch_fig2_3.run(n_epochs=2, workloads=("STO",), **SMALL)
    if name == "fig9_10_11":
        return torch_fig9_10_11.run(n_epochs=2, workloads=("STO",), **SMALL)
    if name == "fig12":
        return torch_fig12.run(workload="STO", n_epochs=12, **SMALL)
    return abl.run(n_epochs=2, scenarios=(abl.GATE_SCENARIO,), **SMALL)


MODULES = {"fig2_3": torch_fig2_3, "fig9_10_11": torch_fig9_10_11,
           "fig12": torch_fig12, "ablation": abl}


def _cells_ok(table: dict, rows: tuple, cols: tuple):
    assert list(table) == list(rows)
    for r in rows:
        assert list(table[r]) == list(cols)
        for c in cols:
            assert set(table[r][c]) == SUMMARY_KEYS, (r, c)
            assert all(math.isfinite(v) for v in table[r][c].values()), (r, c)


def test_fig2_3_table():
    _cells_ok(small_run("fig2_3"), ("STO",), ("1:3", "2:2", "3:1"))


def test_fig9_10_11_table():
    _cells_ok(small_run("fig9_10_11"), ("STO",), torch_fig9_10_11.MODES)


def test_fig12_traces():
    tr = small_run("fig12")
    assert set(tr) == {"fair_ipc", "kf_ipc", "fair_ipc_std", "kf_ipc_std",
                       "kf_signal", "kf_config"}
    for k, v in tr.items():
        assert v.shape == (12,), k
    assert set(tr["kf_signal"].tolist()) <= {0, 1}


def test_ablation_table():
    res = small_run("ablation")
    assert res["rows"] == len(abl.PREDICTORS)
    assert res["warmup_epochs"] == 1     # min(ceil(warmup / 30), 2 - 1)
    _cells_ok(res["table"], (abl.GATE_SCENARIO,), abl.PREDICTORS)
    verdict = abl.kf_verdict(res["table"])
    assert set(verdict["margins"]) == set(abl.PREDICTORS) - {"kf"}


@pytest.mark.parametrize("name", list(MODULES))
def test_main_prints_table(name, monkeypatch, capsys):
    """Each driver's `main` on its small table (run() stubbed to return
    it): the CSV header, one line per cell and the summary lines."""
    mod = MODULES[name]
    monkeypatch.setattr(mod, "run", lambda **kw: small_run(name))
    argv = ["--device", "cpu", "--n-epochs", "12" if name == "fig12" else "2"]
    mod.main(argv)
    out = capsys.readouterr().out.splitlines()
    body = [ln for ln in out if not ln.startswith("#")]
    n_cells = {"fig2_3": 3, "fig9_10_11": len(torch_fig9_10_11.MODES),
               "fig12": 12, "ablation": len(abl.PREDICTORS)}[name]
    assert "," in body[0] and len(body) == 1 + n_cells, out
    assert any("wall" in ln for ln in out if ln.startswith("#")), out


@pytest.mark.parametrize("kf_wins", [True, False])
def test_ablation_gate_exit_code(kf_wins, monkeypatch):
    """`--gate` exits 1 exactly when KF's mean GPU IPC on the gate scenario
    is below a naive predictor's."""
    res = small_run("ablation")
    cells = {p: dict(s) for p, s in res["table"][abl.GATE_SCENARIO].items()}
    naive = [s["gpu_ipc"] for p, s in cells.items() if p != "kf"]
    cells["kf"]["gpu_ipc"] = (max(naive) + 0.01 if kf_wins
                              else min(naive) - 0.01)
    table = {abl.GATE_SCENARIO: cells}
    monkeypatch.setattr(abl, "run", lambda **kw: {**res, "table": table})
    rc = abl.main(["--gate", "--smoke", "--device", "cpu"])
    assert rc == (0 if kf_wins else 1)


def _cli_args(argv):
    return torch_cli.add_flags(argparse.ArgumentParser()).parse_args(argv)


def test_cli_flags_become_overrides(capsys):
    args = _cli_args(["--faults", "BROWNOUT", "--placement", "SWAP_MID",
                      "--topology", "4x8"])
    assert torch_cli.shared_overrides(args) == {
        "faults": "BROWNOUT", "placement": "SWAP_MID", "width": 4,
        "height": 8}
    assert torch_cli.shared_overrides(_cli_args([])) == {}
    assert "--faults: injecting" in capsys.readouterr().out


@pytest.mark.parametrize("argv,err", [
    (["--faults", "BROWN_OUT"], "did you mean ['BROWNOUT']"),
    (["--placement", "SWAP"], "unknown placement scenario 'SWAP'"),
    (["--topology", "9x9"], "caps at 64"),
    (["--topology", "six"], "expects WxH"),
])
def test_cli_flags_rejected_at_the_command_line(argv, err):
    with pytest.raises((ValueError, SystemExit)) as e:
        torch_cli.shared_overrides(_cli_args(argv))
    assert err in str(e.value)


def test_driver_takes_cli_overrides(monkeypatch):
    """A driver's main forwards the flags to its run()."""
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return small_run("fig2_3")

    monkeypatch.setattr(torch_fig2_3, "run", fake_run)
    torch_fig2_3.main(["--device", "cpu", "--faults", "FLAP_BFS",
                       "--placement", "GPU_NEAR_MC"])
    assert seen["faults"] == "FLAP_BFS" and seen["placement"] == "GPU_NEAR_MC"
