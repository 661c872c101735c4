"""`benchmarks/torch_fig_faults.py` against its JAX twin
`benchmarks/fig_faults.py` on the CPU: one seed, every registered fault
scenario, tests/_torch_sim.py's size (12 epochs x 30 cycles, its POLICY
and z_scales).  The tables are equal cell for cell (rtol 1e-6), and so are
the healthy guard-on / guard-off bitwise verdict, the probed guarded runs'
integer counters and the guard verdict.  Both packages draw their own
threefry streams (jax 0.9.0's default scheme).  At this size the guarded
and unguarded arms part ways on TELEM_GLITCH and FLAP_DURING_SHIFT, so
the comparison is not between equal columns."""
import functools

import jax
import pytest

from _torch_sim import POLICY, SIZE, JPolicyConfig, assert_tables_close
from benchmarks import fig_faults as jdrv
from benchmarks import torch_fig_faults as tdrv
from repro_torch.core.allocator import PolicyConfig

E = SIZE["n_epochs"]
KW = {k: v for k, v in SIZE.items() if k != "n_epochs"}


@functools.lru_cache(maxsize=None)
def runs():
    # the JAX driver counts its retraces of `simulate`; a sweep compiled
    # earlier in this process (another file on the same worker) would
    # make it read 0, so the driver starts from an empty jit cache
    jax.clear_caches()
    want = jdrv.run(n_epochs=E, seeds=(0,),
                    policy=JPolicyConfig(*POLICY), **KW)
    got = tdrv.run(n_epochs=E, seeds=(0,), device="cpu",
                   policy=PolicyConfig(*POLICY), **KW)
    return want, got


def test_constants_match_jax():
    assert tdrv.FAULT_SET == jdrv.FAULT_SET
    assert (tdrv.ARMS, tdrv.GATE_SCENARIO, tdrv.SEEDS, tdrv.HEALTHY) == \
        (jdrv.ARMS, jdrv.GATE_SCENARIO, jdrv.SEEDS, jdrv.HEALTHY)
    assert tdrv.SMOKE == jdrv.SMOKE and tdrv.KF_Q_ABLATION == \
        jdrv.KF_Q_ABLATION


def test_table_equals_jax():
    want, got = runs()
    assert got["warmup_epochs"] == want["warmup_epochs"]
    assert_tables_close(want["table"], got["table"])


def test_verdicts_and_probes_equal_jax():
    want, got = runs()
    assert want["traces"] == 1 and got["b2_launches"] == 0   # no card here
    assert got["healthy_bitwise"] is True
    assert got["healthy_bitwise"] == want["healthy_bitwise"]
    assert got["probes"] == want["probes"]
    assert got["probes"]["TELEM_GLITCH"]["kf_rejected_total"] == 2
    jv = jdrv.guard_verdict(want["table"], jdrv.FAULT_SET)
    tv = tdrv.guard_verdict(got["table"], tdrv.FAULT_SET)
    assert tv["guard_beats_all"] == jv["guard_beats_all"]
    for flt, m in jv["margins"].items():
        for k, v in m.items():
            assert abs(tv["margins"][flt][k] - v) <= 2e-6, (flt, k)


@pytest.mark.parametrize("flt", ["TELEM_GLITCH", "FLAP_DURING_SHIFT"])
def test_guarded_and_unguarded_arms_part_ways(flt):
    _, got = runs()
    cells = got["table"][flt]
    assert cells["kf_guarded"]["gpu_ipc"] != cells["kf"]["gpu_ipc"]


@pytest.mark.parametrize("beats", [True, False])
def test_gate_exit_code(beats, monkeypatch, capsys):
    """`--gate` exits 1 exactly when the guarded KF loses an ordering."""
    _, got = runs()
    table = {f: {a: dict(s) for a, s in c.items()}
             for f, c in got["table"].items()}
    if not beats:
        table["BROWNOUT"]["kf_guarded"]["gpu_ipc"] -= 1.0
    monkeypatch.setattr(tdrv, "run",
                        lambda **kw: {**got, "table": table})
    rc = tdrv.main(["--gate", "--device", "cpu", "--n-epochs", str(E)])
    out = capsys.readouterr()
    assert rc == (0 if beats else 1), out.err
    assert out.out.startswith("faults,arm,gpu_ipc")
    assert '"bench": "noc_faults"' in out.out
