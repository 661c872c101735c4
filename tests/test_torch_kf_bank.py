"""Port congruence: the fleet KF path — the KF bank (B4's plain version),
FleetKF, KFScheduler and the telemetry — against the JAX package on the
same numpy inputs.  The JAX bank runs as its own tests run it on the CPU
(`kf_bank_step` picks interpret mode off a TPU).

Tolerances:
  * plain B4 vs JAX B4: atol 1e-6, rtol 1e-6.  Not bitwise: XLA:CPU
    contracts the kernel's `a*a*p + q` and its two sums over M into fused
    multiply-adds (checked term by term), while the port rounds every
    product, as its CUDA kernel does (held bitwise to the plain version on
    the card, tests/test_torch_cuda.py).  The difference is an ulp of the
    largest term (|terms| < 8, ulp < 1e-6).
  * information form vs paper form (Eqs. 3-5): the JAX package's own
    bound, atol 1e-5 / rtol 1e-4 on x and atol 1e-6 / rtol 1e-4 on p.
  * signals and the variant sequence: equal.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import kf_scheduler as jks
from repro.dist import telemetry as jtel
from repro.kernels.kf_bank import ops as jops
from repro.kernels.kf_bank import ref as jref
from repro_torch.core import kalman as tkalman
from repro_torch.dist import kf_scheduler as tks
from repro_torch.dist import telemetry as ttel
from repro_torch.kernels.kf_bank import ops as tops
from repro_torch.kernels.kf_bank import ref as tref

BANK = dict(atol=1e-6, rtol=1e-6)


def _bank_inputs(b, m, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=b).astype(f), rng.uniform(0.1, 2.0, b).astype(f),
            rng.normal(size=(b, m)).astype(f),
            rng.uniform(0.5, 1.5, m).astype(f),
            rng.uniform(0.05, 0.5, m).astype(f))


@pytest.mark.parametrize("b,m,a,q", [
    (1024, 3, 1.0, 1e-3), (4096, 3, 0.9, 1e-2), (100, 5, 0.95, 1e-3),
    (7, 3, 1.0, 1e-4),
])
def test_plain_bank_matches_jax_and_paper_form(b, m, a, q):
    ins = _bank_inputs(b, m)
    jx, jp = (np.asarray(t) for t in
              jops.kf_bank_step(*map(jnp.asarray, ins), a=a, q=q))
    tins = [torch.from_numpy(x) for x in ins]
    tops.reset_launches()
    tx, tp = tops.kf_bank_step(*tins, a=a, q=q)
    assert tops.LAUNCHES["kf_bank"] == 0        # CPU tensors: plain version
    assert tx.shape == (b,) and tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), jx, **BANK)
    np.testing.assert_allclose(tp.numpy(), jp, **BANK)
    # the information form is the paper form (the port's own oracle) ...
    rx, rp = tref.kf_bank_ref(*tins, a=a, q=q)
    np.testing.assert_allclose(tx.numpy(), rx.numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tp.numpy(), rp.numpy(), atol=1e-6, rtol=1e-4)
    # ... and the port's paper-form oracle is the reference's: rtol 1e-5 as
    # in tests/test_torch_control.py (two LAPACK builds solve the system),
    # atol 1e-6 for x near 0, where x = x_prior + K * innovation cancels
    jrx, jrp = (np.asarray(t) for t in
                jref.kf_bank_ref(*map(jnp.asarray, ins), a=a, q=q))
    np.testing.assert_allclose(rx.numpy(), jrx, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(rp.numpy(), jrp, atol=1e-7, rtol=1e-5)


def test_plain_bank_takes_any_length():
    """No padding to a block multiple: the B-length result of a ragged bank
    is the head of a longer one's."""
    ins = [torch.from_numpy(x) for x in _bank_inputs(1031, 3)]
    x, p = tops.kf_bank_step(*ins)
    x7, p7 = tops.kf_bank_step(ins[0][:7], ins[1][:7], ins[2][:7], *ins[3:])
    assert torch.equal(x7, x[:7]) and torch.equal(p7, p[:7])


@pytest.mark.parametrize("n", [1, 64])
def test_fleet_kf_matches_jax(n):
    cfg_j = jks.SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    cfg_t = tks.SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    jf = jks.FleetKF(n, cfg_j)
    tf = tks.FleetKF(n, cfg_t, device="cpu")
    zs = np.random.default_rng(7).normal(0, 0.7, (25, n, 3)).astype(np.float32)
    flips = 0
    for t in range(25):
        js = np.asarray(jf.epoch(jnp.asarray(zs[t])))
        ts = tf.epoch(zs[t])
        assert ts.dtype == torch.int32
        np.testing.assert_array_equal(ts.numpy(), js, err_msg=f"epoch {t}")
        np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **BANK)
        np.testing.assert_allclose(tf.p.numpy(), np.asarray(jf.p), **BANK)
        flips += int((ts.numpy() != (tf.x.numpy() > 0)).sum())
    assert flips == 0


@pytest.mark.parametrize("n", [7, 1000, 1025])
@pytest.mark.parametrize("m", [3, 5])
def test_fleet_kf_epochs_match_jax(n, m):
    """FleetKF on the CPU (the card epoch's plain route,
    `kf_bank_epoch_plain`) against the JAX FleetKF over 6 epochs.

    Tolerances: the signals and p bitwise; x within atol 1e-6 / rtol 1e-6
    (BANK): XLA:CPU contracts the innovation sum into fused multiply-adds,
    about an ulp of its largest term (ROADMAP C).  p is bitwise because
    FleetKF's h is all ones and a = 1: every product in p's update is exact,
    so a contraction cannot move it."""
    cfg_j = jks.SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    cfg_t = tks.SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    h = (1.0,) * m
    jf = jks.FleetKF(n, cfg_j, h=h)
    tf = tks.FleetKF(n, cfg_t, h=h, device="cpu")
    zs = np.random.default_rng(n + m).normal(0, 0.7, (6, n, m))
    zs = zs.astype(np.float32)
    boosted = 0
    for t in range(6):
        js = np.asarray(jf.epoch(jnp.asarray(zs[t])))
        ts = tf.epoch(torch.from_numpy(zs[t]))
        assert ts.dtype == torch.int32 and ts.shape == (n,)
        np.testing.assert_array_equal(ts.numpy(), js, err_msg=f"epoch {t}")
        np.testing.assert_array_equal(tf.p.numpy(), np.asarray(jf.p),
                                      err_msg=f"p at epoch {t}")
        np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **BANK)
        boosted += int(ts.sum())
    assert 0 < boosted < 6 * n


def test_epoch_plain_is_step_then_signal():
    """`kf_bank_epoch_plain` = `kf_bank_step_plain`, then x_post > 0 as
    int32 (`kalman.binarize` at threshold 0), and it leaves its inputs
    alone."""
    ins = [torch.from_numpy(x) for x in _bank_inputs(257, 3, seed=5)]
    keep = [t.clone() for t in ins]
    x, p, sig = tops.kf_bank_epoch_plain(*ins, a=0.9, q=1e-2)
    sx, sp = tops.kf_bank_step_plain(*ins, a=0.9, q=1e-2)
    assert torch.equal(x, sx) and torch.equal(p, sp)
    assert sig.dtype == torch.int32
    assert torch.equal(sig, tkalman.binarize(sx))
    assert all(torch.equal(a, b) for a, b in zip(ins, keep))


def _telemetries():
    costs = {0: dict(hbm_bytes=12e9, collective_bytes=1.5e9, flops=1e15),
             1: dict(hbm_bytes=9e9, collective_bytes=0.4e9)}
    return (jtel.Telemetry({k: jtel.StaticCosts(**v) for k, v in costs.items()}),
            ttel.Telemetry({k: ttel.StaticCosts(**v) for k, v in costs.items()}))


def test_kf_scheduler_matches_jax():
    """200 on_step calls: the KF signals at every epoch and the variant
    after every step are equal; the stall observation moves over time."""
    kw = dict(epoch_steps=5, warmup_steps=20, hold_steps=10, revert_steps=40)
    jtl, ttl = _telemetries()
    js = jks.KFScheduler(jks.SchedulerConfig(**kw), jtl)
    ts = tks.KFScheduler(tks.SchedulerConfig(**kw), ttl)
    wait = np.random.default_rng(11).uniform(0.0, 1.0, 200)
    jv, tv = [], []
    for step in range(200):
        jtl.timer.wait_frac = ttl.timer.wait_frac = float(wait[step])
        jv.append(js.on_step())
        tv.append(ts.on_step())
    assert ts.signals == js.signals and len(ts.signals) == 40
    assert tv == jv
    assert 0 < sum(tv) < len(tv)          # boosted, reverted, re-boosted
    np.testing.assert_allclose(ts.kf_state.x.numpy(),
                               np.asarray(js.kf_state.x), rtol=1e-5, atol=1e-7)


def _drive(timer, clock, phases):
    """begin -> ready -> end on a fake clock; phases: (wait, step) pairs,
    None for a step with no ready mark."""
    for wait, step in phases:
        timer.step_begin()
        if wait is not None:
            clock[0] += wait
            timer.mark_input_ready()
            clock[0] += step - wait
        else:
            clock[0] += step
        timer.step_end()


def test_step_timer_matches_jax(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    phases = [(0.25, 1.0), (0.75, 1.0), (None, 2.0), (0.0, 0.5), (0.9, 1.0)]
    jt, tt = jtel.StepTimer(ema=0.8), ttel.StepTimer(ema=0.8)
    _drive(jt, clock, phases)
    clock[0] = 0.0
    _drive(tt, clock, phases)
    assert (tt.wait_frac, tt.step_time) == (jt.wait_frac, jt.step_time)
    # an end without a begin clears a stale ready mark in both
    for t in (jt, tt):
        t._t_ready = 123.0
        t.step_end()
        assert t._t_ready is None and t._t0 is None


@pytest.mark.parametrize("wait", [0.0, 0.5, 1.0])
def test_telemetry_observe_matches_jax(wait):
    jtl, ttl = _telemetries()
    empty_j, empty_t = jtel.Telemetry({}), ttel.Telemetry({})
    for j, t in ((jtl, ttl), (empty_j, empty_t)):
        j.timer.wait_frac = t.timer.wait_frac = wait
        z = t.observe()
        assert z.dtype == torch.float32 and z.device.type == "cpu"
        np.testing.assert_array_equal(z.numpy(), np.asarray(j.observe()))
