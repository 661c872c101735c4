"""`benchmarks/torch_fig_placement.py` and `torch_fig4_traffic.py` against
their JAX twins `benchmarks/fig_placement.py` and `fig4_traffic.py` on the
CPU, at tests/_torch_sim.py's size (12 epochs x 30 cycles, its POLICY and
z_scales), one seed.  The placement tables are equal cell for cell (rtol
1e-6), and so are the identity-pair bitwise verdict, the probed joint
run's relocation counters and the control verdict; the Fig. 4 traces are
equal (counters exactly).

At this size the gate scenario MIX_PATH_STO_BFS does not tell the arms
apart (all three read the same, and the probed joint run moves no tile),
so the grid also runs SHIFT_PATH_BFS, where the three arms part ways."""
import functools

import jax
import numpy as np
import pytest

from _torch_sim import POLICY, SIZE, JPolicyConfig, assert_tables_close
from benchmarks import fig4_traffic as j4
from benchmarks import fig_placement as jdrv
from benchmarks import torch_fig4_traffic as t4
from benchmarks import torch_fig_placement as tdrv
from repro_torch.core.allocator import PolicyConfig

E = SIZE["n_epochs"]
KW = {k: v for k, v in SIZE.items() if k != "n_epochs"}
SCENARIOS = ("SHIFT_PATH_BFS", "MIX_PATH_STO_BFS")


@functools.lru_cache(maxsize=None)
def runs():
    # the JAX driver counts its retraces of `simulate`; a sweep compiled
    # earlier in this process (another file on the same worker) would
    # make it read 0, so the driver starts from an empty jit cache
    jax.clear_caches()
    want = jdrv.run(n_epochs=E, seeds=(0,), scenarios=SCENARIOS,
                    policy=JPolicyConfig(*POLICY), **KW)
    got = tdrv.run(n_epochs=E, seeds=(0,), scenarios=SCENARIOS,
                   device="cpu", policy=PolicyConfig(*POLICY), **KW)
    return want, got


def test_constants_match_jax():
    assert (tdrv.ARMS, tdrv.PLACEMENT, tdrv.GATE_SCENARIO, tdrv.SCENARIOS,
            tdrv.SEEDS, tdrv.IDENTITY, tdrv.SMOKE) == \
        (jdrv.ARMS, jdrv.PLACEMENT, jdrv.GATE_SCENARIO, jdrv.SCENARIOS,
         jdrv.SEEDS, jdrv.IDENTITY, jdrv.SMOKE)


def test_table_equals_jax():
    want, got = runs()
    assert got["warmup_epochs"] == want["warmup_epochs"]
    assert_tables_close(want["table"], got["table"])


def test_shift_scenario_arms_differ():
    _, got = runs()
    ipc = [got["table"]["SHIFT_PATH_BFS"][a]["gpu_ipc"] for a in tdrv.ARMS]
    assert len(set(ipc)) == 3, ipc


def test_verdicts_and_probes_equal_jax():
    want, got = runs()
    assert want["traces"] == 1 and got["b2_launches"] == 0   # no card here
    assert got["identity_bitwise"] is True
    assert got["identity_bitwise"] == want["identity_bitwise"]
    assert got["probes"] == want["probes"]
    jv = jdrv.control_verdict(want["table"], SCENARIOS)
    tv = tdrv.control_verdict(got["table"], SCENARIOS)
    assert tv["joint_beats_bandwidth"] == jv["joint_beats_bandwidth"]
    for sc, m in jv["margins"].items():
        for k, v in m.items():
            assert abs(tv["margins"][sc][k] - v) <= 2e-6, (sc, k)


@pytest.mark.parametrize("seeds", [None, (0, 1)])
def test_fig4_traces_equal_jax(seeds):
    want = j4.run(n_epochs=E, seeds=seeds, **KW)
    got = t4.run(n_epochs=E, seeds=seeds, device="cpu", **KW)
    assert_tables_close({k: np.asarray(v) for k, v in want.items()}, got)
    g = t4.cov_claim(got)
    w = t4.cov_claim({k: np.asarray(v) for k, v in want.items()})
    np.testing.assert_allclose(g[:2], w[:2], rtol=1e-5)
    assert g[2] == w[2]


@pytest.mark.parametrize("joint_wins", [True, False])
def test_gate_exit_code(joint_wins, monkeypatch, capsys):
    """`--gate` exits 1 exactly when joint loses to bandwidth-only on the
    gate scenario."""
    _, got = runs()
    table = {s: {a: dict(c) for a, c in cells.items()}
             for s, cells in got["table"].items()}
    g = table[tdrv.GATE_SCENARIO]
    g["joint"]["gpu_ipc"] = g["bandwidth"]["gpu_ipc"] + (
        0.01 if joint_wins else -0.01)
    monkeypatch.setattr(tdrv, "run", lambda **kw: {**got, "table": table})
    monkeypatch.setattr(tdrv, "SCENARIOS", SCENARIOS)
    rc = tdrv.main(["--gate", "--device", "cpu", "--n-epochs", str(E)])
    out = capsys.readouterr()
    assert rc == (0 if joint_wins else 1), out.err
    assert '"bench": "noc_placement"' in out.out


def test_fig4_main_prints_traces(monkeypatch, capsys):
    got = t4.run(n_epochs=4, device="cpu", **KW)
    monkeypatch.setattr(t4, "run", lambda **kw: got)
    t4.main(["--device", "cpu", "--n-epochs", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("epoch,gpu_inj_rate") and len(out) == 1 + 4 + 2
    assert out[5].startswith("# gpu_inj CoV=")
