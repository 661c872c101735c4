"""The port's NoC trace adapter (`core.noc.trace_adapters`, its costs from
`launch.op_cost` on the meta device) against the JAX package's
(`repro.core.noc.trace_adapters`, costs from XLA):

  * `ChipletRoofline`'s cases hold in both packages;
  * `demand_from_costs` gives the JAX package's rows bit for bit, and its
    meta apart from ``adapter`` (which names the cost source), for unit
    costs and for the committed `noc_trace_replay` row's `hlo_phases`;
  * the unknown-phase and unknown-kind errors read as the JAX package's;
  * the port's `step_cost` of the tiny serving steps against the JAX
    package's trip-count-correct `hlo_cost.analyze_hlo` of the same steps
    compiled: FLOPs within 2%, bytes within 2x (eager torch writes every
    elementwise result, where XLA fuses a chain into one write); prefill
    intensity under 0.5, decode intensity 1.0;
  * a serving trace the JAX package saved loads in the port and replays
    through the port's `simulate` bitwise equal to the JAX package's
    `simulate` of the same file (tests/_torch_sim.py's 12 x 30 size, the
    120 rows stretched onto 12 epochs in both)."""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest

from _torch_sim import POLICY, SIZE, JPolicyConfig
from repro.core.noc import sim as jsim
from repro.core.noc import trace_adapters as jta
from repro.core.noc.traffic import RecordedTrace as JRecordedTrace
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import analyze_hlo
from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import sim as tsim
from repro_torch.core.noc import trace_adapters as tta
from repro_torch.core.noc.traffic import RecordedTrace, WorkloadProfile

PACKAGES = {"jax": jta, "port": tta}
UNIT = {
    "prefill": {"flops": 4096.0, "bytes": 64.0},   # 16x balance
    "decode": {"flops": 1.0, "bytes": 1024.0},     # memory-bound
}
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BENCH_noc.json")


def committed_costs() -> dict:
    with open(BENCH) as f:
        row, = [r for r in json.load(f) if r["bench"] == "noc_trace_replay"]
    return {p: {"flops": c["flops"], "bytes": c["bytes"]}
            for p, c in row["hlo_phases"].items()}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_roofline_mapping(pkg):
    r = PACKAGES[pkg].ChipletRoofline()
    balance = r.peak_flops_per_cycle / r.peak_hbm_bytes_per_cycle
    # memory-bound: intensity saturates at 1, rate at peak
    assert r.intensity(flops=1.0, bytes_moved=1e6) == pytest.approx(1.0)
    assert r.gpu_rate(1.0, 1e6) == pytest.approx(r.peak_rate)
    # exactly at machine balance: still fully memory-bound
    assert r.intensity(balance * 64.0, 64.0) == pytest.approx(1.0)
    # compute-bound at 4x balance: quarter intensity
    assert r.intensity(4 * balance * 64.0, 64.0) == pytest.approx(0.25)
    assert r.intensity(0.0, 0.0) == 0.0
    assert dataclasses.asdict(r) == dataclasses.asdict(jta.ChipletRoofline())


@pytest.mark.parametrize("case", ["unit", "unit_schedule", "committed"])
def test_demand_from_costs_equals_jax(case):
    costs = committed_costs() if case == "committed" else UNIT
    args = ((("prefill", 3), ("decode", 2), ("sync", 1)),) \
        if case == "unit_schedule" else ()
    want = jta.demand_from_costs(costs, *args, name=case)
    got = tta.demand_from_costs(costs, *args, name=case)
    for f in WorkloadProfile._fields:
        a = np.asarray(getattr(want.demand, f))
        b = getattr(got.demand, f)
        assert b.dtype == a.dtype == np.float32, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (got.fit, got.name) == (want.fit, want.name)
    assert got.n_epochs_recorded == want.n_epochs_recorded
    gm, wm = dict(got.meta), dict(want.meta)
    assert (gm.pop("adapter"), wm.pop("adapter")) == ("op_cost", "hlo_cost")
    assert json.dumps(gm, sort_keys=True) == json.dumps(wm, sort_keys=True)


def test_unknown_phase_error_matches_jax():
    msgs = []
    for pkg in (jta, tta):
        with pytest.raises(ValueError, match="no cost entry") as e:
            pkg.demand_from_costs({"prefill": {"flops": 1.0, "bytes": 1.0}},
                                  (("warmup", 2),))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_unknown_kind_error_matches_jax():
    msgs = []
    for pkg in (jta, tta):
        with pytest.raises(ValueError, match="unknown phase kind") as e:
            pkg.step_cost("training")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@functools.lru_cache(maxsize=None)
def analyzed(kind: str, batch: int):
    """`analyze_hlo` of the JAX package's tiny step, compiled."""
    cfg = jta._tiny_serving_config()
    params = jspecs.abstract_params(cfg)
    cell = jspecs.ShapeCell(f"adapter_{kind}", 256, batch, kind)
    if kind == "prefill":
        lowered = jax.jit(jspecs.make_prefill_step(cfg)).lower(
            params, jspecs.batch_struct(cfg, cell))
    else:
        token, state = jspecs.abstract_decode_inputs(cfg, cell)
        lowered = jax.jit(jspecs.make_serve_step(cfg)).lower(
            params, token, state)
    return analyze_hlo(lowered.compile().as_text())


@pytest.mark.parametrize("kind,batch", [("prefill", 2), ("decode", 4)])
def test_step_cost_against_analyze_hlo(kind, batch):
    """Flops within 2% of `analyze_hlo`; bytes held to a band around the
    ratio the eager byte policy gives (prefill 1.647, decode 0.968), since
    the bytes alone set the prefill rate of the port's HLO_SERVE trace:
    prefill in [1.5, 1.8], decode in [0.9, 1.05]."""
    got = tta.step_cost(kind, batch=batch)
    want = analyzed(kind, batch)
    assert {k: got[k] for k in ("kind", "seq", "batch", "model")} == {
        "kind": kind, "seq": 256, "batch": batch,
        "model": jta._tiny_serving_config().name}
    assert abs(got["flops"] / want.flops - 1.0) <= 0.02, (got, want)
    lo, hi = {"prefill": (1.5, 1.8), "decode": (0.9, 1.05)}[kind]
    assert lo <= got["bytes"] / want.bytes <= hi, (got, want)
    r = tta.ChipletRoofline()
    intensity = r.intensity(got["flops"], got["bytes"])
    if kind == "prefill":
        assert intensity < 0.5
    else:
        assert intensity == 1.0


def test_jax_saved_serving_trace_replays_bitwise(tmp_path):
    path = str(tmp_path / "hlo_serve.npz")
    jta.hlo_serving_trace().save(path)
    want_trace = JRecordedTrace.load(path, fit="stretch")
    got_trace = RecordedTrace.load(path, fit="stretch")
    assert got_trace.meta == want_trace.meta
    assert got_trace.meta["adapter"] == "hlo_cost"
    jcfg = jsim.NoCConfig(mode="kf", policy=JPolicyConfig(*POLICY), **SIZE)
    tcfg = tsim.NoCConfig(mode="kf", policy=PolicyConfig(*POLICY), **SIZE)
    want = jsim.simulate(jcfg, want_trace)
    got = tsim.simulate(tcfg, got_trace, device="cpu")
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        pairs = zip(a._fields, a, b) if name == "counters" else [(name, a, b)]
        for field, x, y in pairs:
            x, y = np.asarray(x), y.numpy()
            assert (y.shape, y.dtype) == (x.shape, x.dtype), field
            np.testing.assert_array_equal(y, x, err_msg=field)
