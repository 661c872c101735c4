"""Port congruence for the paper sweep, at tests/_torch_sim.py's size:

* `simulate_batch` of mixed modes and seeds equal to standalone
  `simulate`, bitwise in every field, with a ragged tile;
* the port's `sweep` against JAX's `sweep` on a 2-mode x 2-workload x
  2-seed grid, and its `summarize_seeds` to float32 rounding;
* named fault and placement scenarios through both packages' `sweep`.

The rows draw their own streams (JAX's threefry, jax 0.9.0's default
partitionable setting in both packages); tests/test_torch_sim_threefry.py
holds those standalone runs against JAX `simulate`."""
import functools

import numpy as np
import pytest
import torch

from _torch_sim import (
    POLICY,
    SIZE,
    WORKLOAD,
    JPolicyConfig,
    assert_congruent,
    port_config,
)
from repro.core.noc import sim as jsim
from repro_torch.core.noc import sim as tsim

@functools.lru_cache(maxsize=None)
def port_plain(case: str, engine: str):
    return tsim.simulate(port_config(case), WORKLOAD, device="cpu",
                         engine=engine)


def assert_rows_equal(batch: tsim.SimResult, b: int, row: tsim.SimResult):
    for f, x, y in zip(tsim.SimResult._fields, batch, row):
        pairs = zip(x, y) if f == "counters" else [(x, y)]
        for xx, yy in pairs:
            assert xx[b].dtype == yy.dtype and torch.equal(xx[b], yy), (
                f"row {b}: {f} differs from the standalone run")


@pytest.mark.parametrize("engine,tile,cases", [
    ("fused", 3, ("kf", "fair", "4subnet", "kf_seed1")),
    ("ref", None, ("kf_seed1", "4subnet", "fair")),
])
def test_batch_rows_equal_standalone(engine, tile, cases):
    """Mixed modes and seeds in tiles of 3 (four rows: a ragged tail of
    one, padded) on the fused engine, or as one batch whose epochs walk
    the rows on the dense one: every row bitwise its standalone run.
    (`sweep` below runs its rows as one tile.)"""
    res = tsim.simulate_batch([port_config(c) for c in cases], WORKLOAD,
                              batch_tile=tile, device="cpu", engine=engine)
    assert res.gpu_ipc.shape == (len(cases), SIZE["n_epochs"])
    for b, c in enumerate(cases):
        assert_rows_equal(res, b, port_plain(c, engine))


def test_batch_takes_per_row_sources_and_seeds():
    """Seeds given apart from the configs, one source per row: row 1 is
    the standalone run of its own workload and seed."""
    cfg = port_config("kf")
    res = tsim.simulate_batch([cfg, cfg], [WORKLOAD, "STO"], seeds=[0, 1],
                              device="cpu")
    assert_rows_equal(res, 0, port_plain("kf", "fused"))
    alone = tsim.simulate(tsim.NoCConfig(**{**cfg.__dict__, "seed": 1}),
                          "STO", device="cpu")
    assert_rows_equal(res, 1, alone)


GRID = [("kf", wl, s) for wl in (WORKLOAD, "STO") for s in (0, 1)] + [
    ("fair", wl, s) for wl in (WORKLOAD, "STO") for s in (0, 1)]


@functools.lru_cache(maxsize=None)
def sweeps():
    kw = dict(SIZE)
    jrows = jsim.sweep([jsim.SweepSpec(m, wl, seed=s) for m, wl, s in GRID],
                       policy=JPolicyConfig(*POLICY), **kw)
    trows = tsim.sweep([tsim.SweepSpec(m, wl, seed=s) for m, wl, s in GRID],
                       device="cpu", policy=tsim.PolicyConfig(*POLICY), **kw)
    return jrows, trows


@pytest.mark.parametrize("i", range(len(GRID)))
def test_sweep_matches_reference(i):
    jrows, trows = sweeps()
    assert len(trows) == len(GRID)
    assert_congruent(jrows[i], trows[i])


def test_sweep_summaries_match_reference():
    jrows, trows = sweeps()
    for lo in range(0, len(GRID), 2):   # each point over its two seeds
        jw = jsim.summarize_seeds(jrows[lo:lo + 2], 4)
        tw = tsim.summarize_seeds(trows[lo:lo + 2], 4)
        assert jw.keys() == tw.keys()
        for k in jw:
            np.testing.assert_allclose(jw[k], tw[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)


NAMED = [("kf", WORKLOAD, dict(faults="FLAP_DURING_SHIFT", guard=True)),
         ("kf", WORKLOAD, dict(faults="TELEM_GLITCH")),
         ("kf", WORKLOAD, dict(placement="GPU_NEAR_MC", control="joint")),
         ("kf", "STO", dict(placement="SWAP_MID", control="placement")),
         ("fair", WORKLOAD, dict(faults="BROWNOUT",
                                 placement="GPU_NEAR_MC_ALWAYS"))]


def test_named_scenarios_sweep_matches_reference():
    """Named fault and placement scenarios in one sweep (one batch: they
    share the static spec) against JAX's sweep of the same names, row for
    row to assert_congruent's bar."""
    kw = dict(SIZE)
    jrows = jsim.sweep([jsim.SweepSpec(m, wl, **x) for m, wl, x in NAMED],
                       policy=JPolicyConfig(*POLICY), **kw)
    trows = tsim.sweep([tsim.SweepSpec(m, wl, **x) for m, wl, x in NAMED],
                       device="cpu", policy=tsim.PolicyConfig(*POLICY), **kw)
    assert len(trows) == len(NAMED)
    for j, t in zip(jrows, trows):
        assert_congruent(j, t)
