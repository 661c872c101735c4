"""The port's paper-figure drivers against their JAX twins on the CPU:
`torch_fig2_3`, `torch_fig9_10_11`, `torch_fig12` and `torch_fig_ablation`
each run with one seed and one workload at tests/_torch_sim.py's size (12
epochs x 30 cycles, its POLICY and z_scales), as does the JAX driver; the
tables are equal cell for cell (float32 quotients to rtol 1e-6, integer
traces exactly), and so are the ablation's verdict and warmup.  Both
packages draw their own threefry streams (jax 0.9.0's default scheme)."""
import functools

import numpy as np
import pytest

from _torch_sim import POLICY, SIZE, JPolicyConfig, assert_tables_close
from benchmarks import fig2_3_vc_sweep as j2_3
from benchmarks import fig9_10_11_configs as j9
from benchmarks import fig12_dynamic_kf as j12
from benchmarks import fig_ablation as jabl
from benchmarks import torch_fig2_3, torch_fig9_10_11, torch_fig12
from benchmarks import torch_fig_ablation as tabl
from repro_torch.core.allocator import PolicyConfig

SEEDS = (0,)
E = SIZE["n_epochs"]
KW = {k: v for k, v in SIZE.items() if k != "n_epochs"}


def jkw():
    return dict(KW, policy=JPolicyConfig(*POLICY))


def tkw():
    return dict(KW, policy=PolicyConfig(*POLICY), device="cpu")


RUNS = {
    "fig2_3": (lambda: j2_3.run(n_epochs=E, seeds=SEEDS, workloads=("MUM",),
                                **jkw()),
               lambda: torch_fig2_3.run(n_epochs=E, seeds=SEEDS,
                                        workloads=("MUM",), **tkw())),
    "fig9_10_11": (lambda: j9.run(n_epochs=E, seeds=SEEDS,
                                  workloads=("PATH",), **jkw()),
                   lambda: torch_fig9_10_11.run(n_epochs=E, seeds=SEEDS,
                                                workloads=("PATH",), **tkw())),
    "fig12": (lambda: j12.run(workload="STO", n_epochs=E, seeds=SEEDS,
                              **jkw()),
              lambda: torch_fig12.run(workload="STO", n_epochs=E, seeds=SEEDS,
                                      **tkw())),
    "ablation": (lambda: jabl.run(n_epochs=E, seeds=SEEDS,
                                  scenarios=(jabl.GATE_SCENARIO,), **jkw()),
                 lambda: tabl.run(n_epochs=E, seeds=SEEDS,
                                  scenarios=(tabl.GATE_SCENARIO,), **tkw())),
}


@functools.lru_cache(maxsize=None)
def pair(name: str):
    j, t = RUNS[name]
    return j(), t()


@pytest.mark.parametrize("name", ["fig2_3", "fig9_10_11", "fig12"])
def test_driver_table_equals_jax(name):
    want, got = pair(name)
    assert_tables_close(want, got)


def test_fig12_traces_are_integers_of_the_reference():
    want, got = pair("fig12")
    for k in ("kf_signal", "kf_config"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_ablation_table_and_verdict_equal_jax():
    want, got = pair("ablation")
    assert got["warmup_epochs"] == want["warmup_epochs"]
    assert_tables_close(want["table"], got["table"])
    jv = jabl.kf_verdict(want["table"])
    tv = tabl.kf_verdict(got["table"])
    assert tv["kf_beats_all"] == jv["kf_beats_all"]
    assert tv["scenario"] == jv["scenario"]
    for p, m in jv["margins"].items():
        assert abs(tv["margins"][p] - m) <= 2e-6, p
