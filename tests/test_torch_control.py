"""Port congruence: the epoch-boundary control plane (KF, predictor bank,
hysteresis policy, VC masks) against the JAX package on seeded inputs.

Signals, configurations and masks are held bitwise.  KF floats (x, P, gain,
innovation, NIS) are held to rtol 1e-5: the 3x3 measurement solve runs in
two LAPACK builds, which may round the last bits differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocator as jal
from repro.core import kalman as jkf
from repro.core import predictor as jpr
from repro_torch.core import allocator as tal
from repro_torch.core import kalman as tkf
from repro_torch.core import predictor as tpr

RTOL = 1e-5
MODES = ["baseline", "fair", "static", "kf", "4subnet"]


def _close(a, b, err=""):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b.detach(), np.float64),
        rtol=RTOL, atol=1e-7, err_msg=err,
    )


def _obs_sequence(seed, n=40, nan_at=(), spike_at=()):
    rng = np.random.default_rng(seed)
    zs = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    for e in nan_at:
        zs[e] = np.nan
    for e in spike_at:
        zs[e] += np.float32(8.0)
    return zs


@pytest.mark.parametrize("q,r", [(1e-3, 2e-1), (1e-2, 1e-1), (1e-4, 1.0)])
def test_kalman_steps_match(q, r):
    jp, tp = jkf.paper_params(q=q, r=r), tkf.paper_params(q=q, r=r)
    js, ts = jkf.init_state(1), tkf.init_state(1)
    for e, z in enumerate(_obs_sequence(1)):
        jpost, jprior, jinn = jkf.step(jp, js, jnp.asarray(z))
        tpost, tprior, tinn = tkf.step(tp, ts, torch.from_numpy(z))
        _close(jpost.x, tpost.x, f"x@{e}")
        _close(jpost.p, tpost.p, f"p@{e}")
        _close(jinn, tinn, f"innovation@{e}")
        _close(jkf.kalman_gain(jp, jprior), tkf.kalman_gain(tp, tprior))
        _close(jkf.innovation_nis(jp, jprior, jnp.asarray(z)),
               tkf.innovation_nis(tp, tprior, torch.from_numpy(z)))
        _close(jkf.one_step_prediction(jp, jpost),
               tkf.one_step_prediction(tp, tpost))
        assert int(jkf.binarize(jpost.x[0])) == int(tkf.binarize(tpost.x[0]))
        js, ts = jpost, tpost


def test_breakdown_coast_matches_reference():
    """At q=1, r=1e-7 the update breaks down and coasts every step: after
    20 steps both filters hold x = 0 and P = 21.  NIS at that point is NaN
    in the reference (the coasted prior is ill-conditioned); the port gives
    the same non-finite value."""
    jp, tp = jkf.paper_params(q=1.0, r=1e-7), tkf.paper_params(q=1.0, r=1e-7)
    js, ts = jkf.init_state(1), tkf.init_state(1)
    z = np.asarray([0.5, -0.25, 0.75], np.float32)
    for _ in range(20):
        js, jprior, _ = jkf.step(jp, js, jnp.asarray(z))
        ts, tprior, _ = tkf.step(tp, ts, torch.from_numpy(z))
    assert float(js.x[0]) == float(ts.x[0]) == 0.0
    assert float(js.p[0, 0]) == float(ts.p[0, 0]) == 21.0
    jn = float(jkf.innovation_nis(jp, jprior, jnp.asarray(z)))
    tn = float(tkf.innovation_nis(tp, tprior, torch.from_numpy(z)))
    assert np.isfinite(jn) == np.isfinite(tn)
    if np.isfinite(jn):
        np.testing.assert_allclose(jn, tn, rtol=RTOL)


def test_normalize_observations_match():
    rng = np.random.default_rng(2)
    raw = rng.uniform(0, 3000, (50, 3)).astype(np.float32)
    hi = np.asarray([300.0, 160.0, 2500.0], np.float32)
    for row in raw:
        j = jkf.normalize_observations(jnp.asarray(row), jnp.zeros(3), jnp.asarray(hi))
        t = tkf.normalize_observations(torch.from_numpy(row), torch.zeros(3),
                                       torch.from_numpy(hi))
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("name", sorted(jpr.PREDICTORS))
@pytest.mark.parametrize("guard", [False, True])
def test_predictor_bank_matches(name, guard):
    """Every bank member over a sequence with NaN and spike epochs; with
    the guard armed this drives the innovation gate, the watchdog and the
    covariance reset."""
    jp, tp = jkf.paper_params(q=1e-3, r=2e-1), tkf.paper_params(q=1e-3, r=2e-1)
    jpp = jpr.predictor_policy(name, ema_alpha=0.3, guard=guard)
    tpp = tpr.predictor_policy(name, ema_alpha=0.3, guard=guard)
    js, ts = jpr.init_state(), tpr.init_state()
    zs = _obs_sequence(3, nan_at=(10, 11, 12, 13), spike_at=(20, 27))
    seen_reject = seen_reset = False
    for e, z in enumerate(zs):
        js, jsig, ji = jpr.step_probed(jpp, jp, js, jnp.asarray(z))
        ts, tsig, ti = tpr.step_probed(tpp, tp, ts, torch.from_numpy(z))
        assert int(jsig) == int(tsig), f"signal@{e}"
        assert bool(js.healthy) == bool(ts.healthy), f"healthy@{e}"
        assert int(js.reject_run) == int(ts.reject_run), f"reject_run@{e}"
        for f in ("rejected", "reset", "healthy"):
            assert int(getattr(ji, f)) == int(getattr(ti, f)), f"{f}@{e}"
        _close(js.kf.x, ts.kf.x, f"x@{e}")
        _close(js.kf.p, ts.kf.p, f"p@{e}")
        _close(js.ema, ts.ema, f"ema@{e}")
        seen_reject |= bool(ji.rejected)
        seen_reset |= bool(ji.reset)
    assert seen_reject == guard and seen_reset == guard


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("control", ["bandwidth", "placement", "joint"])
def test_mode_policy_and_masks_match(mode, control):
    kw = dict(n_subnets=4, active_vcs=2 if mode == "4subnet" else 4,
              control=control)
    jm = jal.mode_policy(mode, 4, 3, **kw)
    tm = tal.mode_policy(mode, 4, 3, **kw)
    for f in jal.ModePolicy._fields:
        if f == "predictor":
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(jm, f)), getattr(tm, f).numpy(), err_msg=f
        )
    cls0 = np.arange(36, dtype=np.int32) % 3
    cls1 = (cls0 + 1) % 3
    cycles = np.arange(1000, 1011, dtype=np.int32)
    for config in (0, 1):
        for a, b in zip(jal.class_vc_masks(jm, jnp.int32(config)),
                        tal.class_vc_masks(tm, torch.tensor(config, dtype=torch.int32))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(
            np.asarray(jal.placement_class(jm, jnp.int32(config),
                                           jnp.asarray(cls0), jnp.asarray(cls1))),
            tal.placement_class(tm, torch.tensor(config), torch.from_numpy(cls0),
                                torch.from_numpy(cls1)).numpy(),
        )
        np.testing.assert_array_equal(
            np.asarray(jal.epoch_sa_prefs(jm, jnp.int32(config), jnp.asarray(cycles))),
            tal.epoch_sa_prefs(tm, torch.tensor(config, dtype=torch.int32),
                               torch.from_numpy(cycles)).numpy(),
        )


@pytest.mark.parametrize("pcfg", [(10_000, 5_000, 10_000), (60, 30, 120), (0, 0, 10**9)])
def test_hysteresis_policy_matches(pcfg):
    """Random signals through apply_policy_gated + degrade_policy."""
    rng = np.random.default_rng(sum(pcfg) % 97)
    jc = jal.PolicyConfig(*pcfg)
    tc = tal.PolicyConfig(*pcfg)
    jm, tm = jal.mode_policy("kf"), tal.mode_policy("kf")
    js, ts = jal.init_policy_state(), tal.init_policy_state()
    epoch = max(pcfg[1], 30)
    for e in range(120):
        sig = int(rng.integers(0, 2))
        healthy = bool(rng.random() > 0.1)
        cyc = (e + 1) * epoch
        js = jal.apply_policy_gated(jc, jm, js, jnp.int32(sig), jnp.int32(cyc))
        js = jal.degrade_policy(js, jnp.asarray(healthy))
        ts = tal.apply_policy_gated(tc, tm, ts, torch.tensor(sig, dtype=torch.int32),
                                    torch.tensor(cyc, dtype=torch.int32))
        ts = tal.degrade_policy(ts, torch.tensor(healthy))
        for f in jal.PolicyState._fields:
            assert int(getattr(js, f)) == int(getattr(ts, f)), f"{f}@{e}"
