"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips when no CUDA device is present (decided
inside the test, never at import).  chip_smoke.py runs the same checks at
the paper shapes; run these on a card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.allocator import PolicyConfig
from repro_torch.core.noc import sim, traffic
from repro_torch.kernels.noc_cycle import fused, ops


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_arbitration_kernel_matches_plain():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    L, PV, V = 256, 20, 4

    def ri(lo, hi, rows):
        return torch.randint(lo, hi, (rows, L), generator=g, device="cuda",
                             dtype=torch.int32)

    for _ in range(4):
        ins = (ri(0, 2, PV), ri(0, 2, PV), ri(0, 5, PV), ri(0, PV, 5),
               ri(0, 5, PV), ri(0, 2, 5), ri(0, 2, V), ri(0, 2, V),
               ri(-1, 2, 1), ri(0, 2, 1), ri(0, 2, 1))
        k = ops.arbitrate_rows(*ins, depth=4)
        v, c, o, rr, dn, ex, gm, cm, sa, acc, act = ins
        p = fused.lane_arbitrate(v != 0, c, o, rr, dn, ex != 0, gm != 0,
                                 cm != 0, sa, acc != 0, act != 0, depth=4)
        for name, a, b in zip(fused.LaneArb._fields, k, p):
            assert torch.equal(a.to(torch.int32), b.to(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kf", "4subnet"])
def test_engines_agree_on_card(mode):
    _need_cuda()
    cfg = sim.NoCConfig(mode=mode, n_epochs=4, epoch_len=100,
                        policy=PolicyConfig(warmup=200, hold=100, revert=300))
    res = [
        sim.simulate(cfg, "SHIFT_PATH_BFS", device="cuda", engine=e,
                     rng=torch.Generator(device="cuda").manual_seed(3))
        for e in ("fused", "arb", "ref")
    ]
    for r in res[1:]:
        for a, b in zip(res[0].counters, r.counters):
            assert torch.equal(a, b)
        assert torch.equal(res[0].applied_config, r.applied_config)


def _small_cfg(mode, **kw):
    return sim.NoCConfig(mode=mode, n_epochs=4, epoch_len=100,
                         policy=PolicyConfig(warmup=200, hold=100, revert=300),
                         **kw)


@pytest.mark.cuda
def test_probed_kernel_matches_plain():
    """B3 against `cycle_steps_lanes(..., probe=...)` from a non-zero
    carry, after 1 and 50 cycles, bitwise on every field."""
    _need_cuda()
    dev = torch.device("cuda")
    run = sim.run_inputs(_small_cfg("kf"), "SHIFT_PATH_BFS", device=dev,
                         rng=torch.Generator(device=dev).manual_seed(1))
    tables = sim.lane_tables(run)
    d = tables[0]
    subs, mc, outst, backlog = sim.init_sim_state(run.stc, dev)
    st = fused.pack_state(d, subs, mc, outst, backlog,
                          traffic.init_phase().to(dev))
    ep = sim.epoch_inputs(run, 0, torch.tensor(1, dtype=torch.int32), 0)
    xi, xf, consts = sim.lane_inputs(run, tables, ep)
    st = ops.fused_cycle_step(d, st, xi[:60], xf[:60], *consts)  # fill
    pb = fused.zero_probe(d, dev)
    _, pb = ops.fused_cycle_step(d, st, xi[:7], xf[:7], *consts, probe=pb)
    for n in (1, 50):
        k, kp = ops.fused_cycle_step(d, st, xi[60:60 + n], xf[60:60 + n],
                                     *consts, probe=pb)
        p, pp = fused.cycle_steps_lanes(d, st, xi[60:60 + n], xf[60:60 + n],
                                        *consts, probe=pb)
        for name, a, b in zip(fused.LaneState._fields, k, p):
            assert torch.equal(a, b), (n, name)
        for name, a, b in zip(fused.ProbeLanes._fields, kp, pp):
            assert torch.equal(a, b), (n, "probe", name)


@pytest.mark.cuda
def test_engines_agree_on_trace_on_card():
    _need_cuda()
    cfg = _small_cfg("kf", guard=True)
    outs = {
        e: sim.simulate_with_trace(
            cfg, "SHIFT_PATH_BFS", device="cuda", engine=e,
            rng=torch.Generator(device="cuda").manual_seed(3))
        for e in ("fused", "arb", "ref")
    }
    _, tf = outs["fused"]
    for e in ("arb", "ref"):
        _, t = outs[e]
        for name, a, b in zip(tf._fields, tf, t):
            assert torch.equal(a, b) or torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True), (e, name)
