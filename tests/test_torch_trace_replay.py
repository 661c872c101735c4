"""Port congruence of the trace-file half of the traffic layer and of the
recorder: `RecordedTrace` fits, the `noc_demand_trace` v1 npz schema, the
workload registry and `TraceRecorder` record -> save -> load -> replay.

Rows are float32 numpy arithmetic in both packages (the stretch fit
resamples in float64 and casts), so they are held bitwise; schema problems
and error messages are held string-equal.  The npz file is the crossing
point: a file written by either package must load and validate in the
other."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.noc import sim as jsim
from repro.core.noc import traffic as jtr
from repro.obs import recorder as jrec
from repro_torch import interop
from repro_torch.core.noc import sim as tsim
from repro_torch.core.noc import traffic as ttr
from repro_torch.obs import TraceRecorder, capture_demand, summarize_trace

FIELDS = ttr.WorkloadProfile._fields
SMALL = dict(n_epochs=4, epoch_len=30)


def _rows(T, seed=0):
    """Random non-negative float32 rows (T,) per field, from numpy."""
    rng = np.random.default_rng(seed)
    return {f: rng.random(T).astype(np.float32) * 0.4 for f in FIELDS}


def _pair(T, fit="exact", name="trace", meta=None, seed=0):
    rows = _rows(T, seed)
    meta = meta or {}
    j = jtr.RecordedTrace(demand=jtr.WorkloadProfile(**rows), fit=fit,
                          name=name, meta=meta)
    return j, interop.recorded_trace(j)


def _assert_rows_equal(j, t):
    for f in FIELDS:
        a = np.asarray(getattr(j, f))
        b = getattr(t, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("fit,T,n", [
    ("exact", 6, 6), ("tile", 4, 10), ("tile", 7, 3), ("stretch", 4, 7),
    ("stretch", 9, 5), ("stretch", 5, 5),
])
def test_fit_modes_match_reference(fit, T, n):
    j, t = _pair(T, fit, seed=T * 31 + n)
    demand = t.epoch_demand(n)
    assert all(isinstance(getattr(demand, f), torch.Tensor) for f in FIELDS)
    _assert_rows_equal(j.epoch_demand(n), demand)
    # the port resolves its own trace to the same rows
    _assert_rows_equal(j.epoch_demand(n), ttr.resolve_source(t, n))


def _message(fn):
    with pytest.raises((ValueError, TypeError)) as ei:
        fn()
    return type(ei.value), str(ei.value)


def test_construction_guards_match_reference():
    j, t = _pair(4)
    assert t.with_fit("stretch").fit == j.with_fit("stretch").fit == "stretch"
    cases = [
        lambda m, tr: tr.epoch_demand(5),                       # exact mismatch
        lambda m, tr: tr.with_fit("nearest"),                   # unknown fit
        lambda m, tr: m.RecordedTrace(demand=m.PROFILES["PATH"]),  # scalar
        lambda m, tr: m.RecordedTrace(demand=tr.demand._replace(
            cpu_rate=np.zeros(5, np.float32))),                 # ragged
        lambda m, tr: m.RecordedTrace(demand=m.WorkloadProfile(
            *(np.asarray(x)[:0] for x in tr.demand))),          # empty
    ]
    for case in cases:
        assert _message(lambda: case(jtr, j)) == _message(lambda: case(ttr, t))


def _valid_payload(T=4):
    payload = {
        "schema": np.asarray(ttr.TRACE_SCHEMA),
        "schema_version": np.asarray(ttr.TRACE_SCHEMA_VERSION),
        "name": np.asarray("t"),
        "meta_json": np.asarray("{}"),
    }
    for f in FIELDS:
        payload[f"demand_{f}"] = np.zeros(T, np.float32)
    return payload


def _missing(p):
    del p["schema_version"], p["demand_cpu_rate"]


def _schema(p):
    p["schema"] = np.asarray("not_a_trace")
    p["schema_version"] = np.asarray(ttr.TRACE_SCHEMA_VERSION + 1)


def _ragged(p):
    p["demand_p_exit"] = np.zeros(6, np.float32)
    bad = np.zeros(4, np.float32)
    bad[2] = np.nan
    p["demand_cpu_rate"] = bad


def _scalar_meta(p):
    p["demand_gpu_rate_lo"] = np.float32(0.1)
    p["meta_json"] = np.asarray("{not json")


def _negative(p):
    bad = np.zeros(4, np.float32)
    bad[1] = -0.25
    p["demand_gpu_rate_hi"] = bad
    p["meta_json"] = np.asarray("[1, 2]")


@pytest.mark.parametrize("corrupt", [None, _missing, _schema, _ragged,
                                     _scalar_meta, _negative])
def test_schema_problems_match_reference(corrupt, tmp_path):
    payload = _valid_payload()
    if corrupt is not None:
        corrupt(payload)
    problems = ttr.validate_trace_npz(payload)
    assert problems == jtr.validate_trace_npz(payload)
    assert (problems == []) == (corrupt is None)
    # the same payload on disk: load refuses it with the reference's text
    path = tmp_path / "t.npz"
    np.savez(path, **payload)
    if corrupt is None:
        assert ttr.RecordedTrace.load(path).n_epochs_recorded == 4
    else:
        assert (_message(lambda: ttr.RecordedTrace.load(path))
                == _message(lambda: jtr.RecordedTrace.load(path)))


def test_npz_crosses_both_ways(tmp_path):
    meta = {"source": "unit", "nested": {"a": [1, 2.5, "s"]}}
    j, t = _pair(5, name="cross", meta=meta, seed=7)
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    j.save(jpath)
    t.save(tpath)
    for path in (jpath, tpath):
        with np.load(path, allow_pickle=False) as data:
            assert jtr.validate_trace_npz(data) == []
            assert ttr.validate_trace_npz(data) == []
        jl = jtr.RecordedTrace.load(path, fit="tile")
        tl = ttr.RecordedTrace.load(path, fit="tile")
        assert (tl.name, tl.fit, tl.meta) == (jl.name, jl.fit, jl.meta)
        assert tl.meta == meta
        _assert_rows_equal(jl.demand, tl.demand)
        _assert_rows_equal(j.demand, tl.demand)
    # byte-identical payloads, key for key
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_registry_collision_overwrite_and_near_miss(tmp_path):
    jt, t = _pair(4, name="reg")
    for name in ("PATH", "SHIFT_PATH_BFS"):  # a builtin profile, scenario
        msg = _message(lambda: ttr.register_workload(name, t))
        assert msg == _message(lambda: jtr.register_workload(name, jt))
        assert "already exists" in msg[1]
    assert (_message(lambda: ttr.register_workload("BAD_WL", object()))
            == _message(lambda: jtr.register_workload("BAD_WL", object())))
    try:
        ttr.register_workload("PATH", t, overwrite=True)
        assert ttr.lookup_workload("PATH") is t  # the registry wins
        _assert_rows_equal(t.demand, ttr.resolve_source("PATH", 4))
    finally:
        ttr.unregister_workload("PATH")
    assert ttr.lookup_workload("PATH") is ttr.PROFILES["PATH"]
    # near misses and the known list, as the reference words them
    for name in ("SHIFT_PATH_BSF", "zzzzqqqq"):
        assert (_message(lambda: ttr.lookup_workload(name))
                == _message(lambda: jtr.lookup_workload(name)))
    path = tmp_path / "reg.npz"
    t.save(path)
    try:
        reg = ttr.register_trace("REG_FILE_WL", path, fit="tile")
        assert reg.fit == "tile" and ttr.lookup_workload("REG_FILE_WL") is reg
        with pytest.raises(ValueError, match=r"did you mean \['REG_FILE_WL'\]"):
            ttr.lookup_workload("REG_FILE_W")
    finally:
        ttr.unregister_workload("REG_FILE_WL")
    with pytest.raises(ValueError, match="unknown workload"):
        ttr.lookup_workload("REG_FILE_WL")


def _gen():
    return torch.Generator().manual_seed(5)


def _assert_results_equal(a, b):
    for name, x, y in zip(tsim.SimResult._fields, a, b):
        if name == "counters":
            for u, v in zip(x, y):
                assert torch.equal(u, v), name
        else:
            assert torch.equal(x, y), name


def test_record_save_load_replay_bitwise(tmp_path):
    """TraceRecorder(observe=True) on the CPU: the rows are the source's,
    the meta carries the reference's keys plus the observed digest, and
    the npz replays through simulate bitwise."""
    cfg = tsim.NoCConfig(mode="kf", **SMALL)
    path = tmp_path / "capture.npz"
    trace = TraceRecorder(name="rr").record_to(
        path, cfg, "SHIFT_PATH_BFS", device="cpu", rng=_gen()
    )
    jcfg = jsim.NoCConfig(mode="kf", **SMALL)
    jtrace = jrec.TraceRecorder(name="rr", observe=False).record(
        jcfg, "SHIFT_PATH_BFS")
    _assert_rows_equal(jtrace.demand, trace.demand)
    assert set(trace.meta) == set(jtrace.meta) | {"observed", "result"}
    assert trace.meta["backend"] == "fused"
    _, tr = tsim.simulate_with_trace(cfg, "SHIFT_PATH_BFS", device="cpu",
                                     rng=_gen())
    assert trace.meta["observed"] == summarize_trace(tr)
    loaded = ttr.RecordedTrace.load(path)
    assert loaded.meta == trace.meta and loaded.fit == "exact"
    ref = tsim.simulate(cfg, "SHIFT_PATH_BFS", device="cpu", rng=_gen())
    rep = tsim.simulate(cfg, loaded, device="cpu", rng=_gen())
    _assert_results_equal(ref, rep)
    assert trace.meta["result"] == tsim.summarize(ref)
    # the reference loads the port's capture and validates it
    with np.load(path, allow_pickle=False) as data:
        assert jtr.validate_trace_npz(data) == []


def test_capture_demand_rows_only(tmp_path):
    cfg = tsim.NoCConfig(mode="baseline", seed=7, **SMALL)
    path = tmp_path / "one.npz"
    trace = capture_demand(cfg, "BFS", path=path, name="one")
    jtrace = jrec.capture_demand(jsim.NoCConfig(mode="baseline", seed=7,
                                                **SMALL), "BFS", name="one")
    assert trace.meta == dataclasses.replace(
        jtrace, meta={**jtrace.meta, "backend": "fused"}).meta
    _assert_rows_equal(jtrace.demand, ttr.RecordedTrace.load(path).demand)
