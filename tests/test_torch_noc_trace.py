"""The port's flight-recorder renderer (benchmarks/torch_noc_trace.py)
against the JAX package's (benchmarks/noc_trace.py) on the CPU: on the same
small capture (PATH, kf, 4 epochs x 60 cycles, as both `check`s take it)
the ASCII timeline and the CSV rows are the JAX renderer's text line for
line, for the JAX package's capture and for the port's; a capture saved by
either package loads in the other with every array and key equal; the
port's `check` passes.  (`record`, the probe-overhead row, runs on the
card in chip_smoke.py's [trace] phase.)  The pure half of the port's
ledger (`repro_torch.obs.ledger`) judges every committed BENCH_noc.json
row, and some malformed ones, as the JAX package's does, and hashes and
stamps alike."""
import functools
import json
import os

import numpy as np
import pytest

from benchmarks import noc_trace as jnt
from benchmarks import torch_noc_trace as tnt
from repro.obs import ledger as jledger
from repro_torch.obs import ledger as tledger
from repro_torch.core.noc import sim as tsim

SMALL = dict(workload="PATH", mode="kf", n_epochs=4, epoch_len=60)


@functools.lru_cache(maxsize=None)
def captures():
    return {"jax": jnt.capture(**SMALL, backend="ref"),
            "port": tnt.capture(**SMALL, backend="ref", device="cpu")}


@pytest.mark.parametrize("which", ["jax", "port"])
@pytest.mark.parametrize("view", ["render_ascii", "render_csv"])
def test_render_text_equals_jax(which, view):
    cap = captures()[which]
    got = getattr(tnt, view)(cap)
    assert got == getattr(jnt, view)(cap)
    assert len(got) == SMALL["n_epochs"] + (2 if view == "render_ascii"
                                            else 1)


def test_port_capture_keys_are_the_jax_captures():
    jcap, tcap = captures()["jax"], captures()["port"]
    assert set(tcap) == set(jcap)
    for k, v in jcap.items():
        if isinstance(v, np.ndarray):
            assert (tcap[k].shape, tcap[k].dtype) == (v.shape, v.dtype), k


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_capture_loads_in_the_other_package(tmp_path, saved_by):
    save, load = ((jnt.save, tnt.load) if saved_by == "jax"
                  else (tnt.save, jnt.load))
    cap = captures()[saved_by]
    path = str(tmp_path / "cap.npz")
    save(cap, path)
    back = load(path)
    assert set(back) == set(cap)
    for k, v in cap.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v),
                                      err_msg=k)
    assert tnt.render_csv(back) == jnt.render_csv(cap)


def test_check_passes_on_the_cpu(capsys):
    assert tnt.check(device="cpu") == 0
    assert "noc_trace check OK" in capsys.readouterr().out


def test_engine_names_map_to_the_port():
    # the JAX renderer's --backend choices name the port's three engines
    assert {tnt.ENGINE_OF[b] for b in ("ref", "pallas", "pallas_arb")} == \
        set(tsim.ENGINES)


def test_ledger_pure_half_equals_jax():
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "BENCH_noc.json")
    with open(bench) as f:
        rows = json.load(f)
    malformed = ["not a row", {"bench": 1},
                 {"bench": "x", "timestamp": "t", "backend": "cpu",
                  "ledger_version": 9, "git_sha": 3}]
    for row in rows + malformed:
        assert tledger.validate_row(row) == jledger.validate_row(row)
        assert tledger.validate_row(row, stamped=True) == \
            jledger.validate_row(row, stamped=True)
        if isinstance(row, dict):
            assert tledger.config_hash(row) == jledger.config_hash(row)
    assert all(not tledger.validate_row(r) for r in rows)
    assert tledger.git_sha() == jledger.git_sha()
    stamp = tledger.run_stamp()
    assert stamp["device_kind"] == "cpu"
    assert not tledger.validate_row(
        dict(bench="x", timestamp="t", backend="cpu", **stamp))
