"""The training loop and checkpoints on the port, on the CPU: the five
behaviours of tests/test_train_loop.py (loss goes down, crash-restart is
bit-identical from the restore point, the KF scheduler switches variants
with hysteresis, the comm-priority variant lands where the balanced one
does, stragglers are detected) and the cases of tests/test_ckpt.py
(round trip, a corrupt checkpoint skipped, a partial write never visible,
keep_last, the async saver), plus bf16 through a checkpoint without
ml_dtypes and the launcher's `main`.  No JAX: these are the reference's
behaviours, held on the port's own numbers."""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch._util import map_tree, tree_leaves
from repro_torch.ckpt import io as ckpt_io
from repro_torch.data import synthetic
from repro_torch.dist.kf_scheduler import KFScheduler, SchedulerConfig
from repro_torch.dist.telemetry import StaticCosts, Telemetry
from repro_torch.launch import train as launch_train
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

from _torch_train import one_thread  # noqa: F401  (autouse fixture)

ARCH = "llama3.2-3b"


def _setup(total_steps=30, seed=0):
    cfg = configs.smoke(ARCH)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=5,
                                      total_steps=total_steps)
    state = step_lib.init_train_state(torch.Generator().manual_seed(seed),
                                      cfg, opt_cfg)
    ds = synthetic.make_dataset(cfg, seq_len=32, global_batch=2, seed=seed,
                                device="cpu")
    return cfg, state, {0: step_lib.make_train_step(cfg, opt_cfg)}, ds


def test_loss_decreases():
    _, state, steps, ds = _setup(total_steps=40)
    res = loop_lib.run(loop_lib.LoopConfig(total_steps=40, log_every=0),
                       state, steps, ds.batch, log=lambda s: None)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


def test_crash_restart_is_bit_identical(tmp_path):
    """Run A: 0..30 uninterrupted.  Run B: crash at 18, restart from the
    step-15 checkpoint, continue to 30.  The losses after the restore and
    the final state equal run A's bit for bit."""
    cfgdir = str(tmp_path / "ck")
    _, state, steps, ds = _setup()
    full = loop_lib.run(
        loop_lib.LoopConfig(total_steps=30, log_every=0),
        state, steps, ds.batch, log=lambda s: None)

    _, state_b, steps_b, ds_b = _setup()
    with pytest.raises(loop_lib.SimulatedFailure):
        loop_lib.run(
            loop_lib.LoopConfig(total_steps=30, ckpt_dir=cfgdir,
                                ckpt_every=15, log_every=0),
            state_b, steps_b, ds_b.batch, fail_at=18, log=lambda s: None)
    _, state_c, steps_c, ds_c = _setup()
    resumed = loop_lib.run(
        loop_lib.LoopConfig(total_steps=30, ckpt_dir=cfgdir,
                            ckpt_every=15, log_every=0),
        state_c, steps_c, ds_c.batch, log=lambda s: None)
    assert resumed.restored_from == 15
    assert resumed.losses == full.losses[15:]
    for (p, a), (_, b) in zip(tree_leaves(resumed.state),
                              tree_leaves(full.state)):
        assert torch.equal(a, b), p


def test_kf_scheduler_switches_variants():
    cfg, state, steps, ds = _setup(total_steps=60)
    steps[1] = steps[0]  # same step; the dispatch path is what's tested
    telemetry = Telemetry(costs_by_variant={
        0: StaticCosts(flops=0, hbm_bytes=20e9, collective_bytes=2e9),
        1: StaticCosts(flops=0, hbm_bytes=20e9, collective_bytes=5e8),
    }, comm_scale=1e9)
    sched = KFScheduler(SchedulerConfig(
        epoch_steps=5, warmup_steps=10, hold_steps=5, revert_steps=1000),
        telemetry)
    res = loop_lib.run(loop_lib.LoopConfig(total_steps=60, log_every=0),
                       state, steps, ds.batch, sched, log=lambda s: None)
    # pressure is high (hbm 20/16GB) -> KF must engage the boost
    assert 1 in res.variants
    # and hysteresis: no flapping every epoch
    flips = sum(1 for a, b in zip(res.variants, res.variants[1:]) if a != b)
    assert flips <= 6


def test_comm_priority_singlepod_matches_balanced():
    """Microbatched gradient accumulation == single-batch gradients (the
    same update within the reference test's tolerance)."""
    cfg = configs.smoke(ARCH)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                      total_steps=10)
    states = [step_lib.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, opt_cfg) for _ in range(2)]
    batch = synthetic.make_dataset(cfg, seq_len=32, global_batch=4,
                                   device="cpu").batch(0)
    new0, m0 = step_lib.make_train_step(cfg, opt_cfg, variant=0)(
        states[0], batch)
    new1, m1 = step_lib.make_train_step(cfg, opt_cfg, variant=1)(
        states[1], batch)
    np.testing.assert_allclose(float(m0["loss"]), float(m1["loss"]),
                               rtol=2e-2)
    d0 = next(tree_leaves(new0.params))[1].float()
    d1 = next(tree_leaves(new1.params))[1].float()
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), atol=2e-2, rtol=2e-2)


def test_straggler_detection():
    """The watchdog counts a step that takes far longer than its EMA.  The
    steps are timed sleeps (the model's own step time varies too much on a
    loaded host to give the EMA a steady baseline); the loop around them
    is the one under test."""
    _, state, _, ds = _setup(total_steps=12)
    calls = {"n": 0}

    def slow_step(s, b):
        calls["n"] += 1
        # the 9th step is the straggler
        time.sleep(1.0 if calls["n"] == 9 else 0.02)
        return s, {"loss": torch.tensor(1.0)}

    res = loop_lib.run(
        loop_lib.LoopConfig(total_steps=12, log_every=0,
                            straggler_factor=2.5),
        state, {0: slow_step}, ds.batch, log=lambda s: None)
    assert res.straggler_events >= 1


def test_unported_variants_raise():
    cfg = configs.smoke(ARCH)
    opt_cfg = opt_lib.OptimizerConfig()
    with pytest.raises(NotImplementedError, match="A9"):
        step_lib.make_train_step(cfg, opt_cfg, mesh=object(), variant=1)
    with pytest.raises(NotImplementedError, match="A9"):
        step_lib.init_train_state(torch.Generator(), cfg, opt_cfg,
                                  with_residuals=True)
    with pytest.raises(ValueError, match="encoder-decoder"):
        step_lib.make_loss_fn(configs.smoke("seamless-m4t-large-v2"),
                              use_kernel=True)


def test_launcher_main_trains_on_the_cpu(capsys):
    res = launch_train.main(["--size", "smoke", "--device", "cpu",
                             "--steps", "3", "--seq-len", "16",
                             "--global-batch", "2", "--kf"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert "[train] llama3.2-3b (smoke) 3 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-2b"])
def test_launcher_trains_the_encdec_and_the_vlm(arch, capsys):
    """The encoder-decoder (`encdec.encdec_loss`) and the vision prefix
    (the batch's embeds) train through the launcher on the CPU."""
    res = launch_train.main(["--arch", arch, "--size", "smoke", "--device",
                             "cpu", "--steps", "3", "--seq-len", "32",
                             "--global-batch", "2"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert f"[train] {arch} (smoke) 3 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_launcher_trains_the_ssms_at_a_cut_depth(arch, capsys):
    """The SSMs train through the launcher (on the card through B7 and
    B7-bwd; here the reference's chunked body); ``--n-layers`` cuts the
    depth, as falcon-mamba-7b's 64 layers need on one card."""
    cfg = configs.smoke(arch)
    n = cfg.shared_attn_period or 1
    state, *_, built = launch_train.build(arch, "smoke", 16, 2,
                                          device="cpu", n_layers=n)
    assert built == dataclasses.replace(cfg, n_layers=n)
    assert sum(len(stack) for stack in state.params["blocks"]) == n
    res = launch_train.main(["--arch", arch, "--size", "smoke", "--device",
                             "cpu", "--steps", "2", "--seq-len", "16",
                             "--global-batch", "2", "--n-layers", str(n)])
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert f"[train] {arch} (smoke) 2 steps" in capsys.readouterr().out


def test_smoke_config_widens_heads_only_for_the_card():
    """B5 has no instantiation for the smoke config's 8-wide heads: on a
    CUDA device the launcher widens them to 64 and changes nothing else;
    on the CPU, and for an arch without attention, the config is the
    reference's."""
    cpu = launch_train.smoke_config("llama3.2-3b", torch.device("cpu"))
    card = launch_train.smoke_config("llama3.2-3b", torch.device("cuda"))
    assert cpu == configs.smoke("llama3.2-3b") and cpu.head_dim == 8
    assert card.head_dim == 64
    assert dataclasses.replace(card, head_dim=cpu.head_dim) == cpu
    mamba = configs.smoke("falcon-mamba-7b")
    assert launch_train.smoke_config("falcon-mamba-7b",
                                     torch.device("cuda")) == mamba


# -------------------------------------------------------------- checkpoints

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.arange(6, dtype=torch.int32),
                   "c": [torch.ones((2,)), torch.zeros((3, 3))],
                   "w": torch.randn((5, 3), generator=g).bfloat16()},
    }


def _assert_equal(a, b):
    for (p, x), (q, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert p == q and x.dtype == y.dtype and torch.equal(x, y), p


def _zeros(tree, dtype=None):
    """A template of zeros (restore writes into it in place)."""
    return map_tree(lambda t: torch.zeros_like(
        t, dtype=dtype if dtype and t.is_floating_point() else t.dtype),
        tree)


def test_save_restore_roundtrip(tmp_path, monkeypatch):
    """Bit for bit, bf16 included, with ml_dtypes made unimportable."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    tree = _tree()
    ckpt_io.save(str(tmp_path), 7, tree)
    step, restored = ckpt_io.restore_latest(str(tmp_path), _zeros(tree))
    assert step == 7
    _assert_equal(tree, restored)
    with open(os.path.join(str(tmp_path), "step_00000007",
                           "manifest.json")) as f:
        meta = json.load(f)["arrays"]
    assert meta["nested/w"]["dtype"] == "bfloat16"   # stored as its bits
    with np.load(os.path.join(str(tmp_path), "step_00000007",
                              "arrays.npz")) as z:
        assert z["nested/w"].dtype == np.uint16


def test_corrupt_checkpoint_skipped(tmp_path):
    tree = _tree()
    ckpt_io.save(str(tmp_path), 1, tree)
    ckpt_io.save(str(tmp_path), 2, map_tree(lambda x: x + 1, tree))
    npz = os.path.join(str(tmp_path), "step_00000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    step, restored = ckpt_io.restore_latest(str(tmp_path), _zeros(tree))
    assert step == 1  # fell back to the older valid checkpoint
    _assert_equal(tree, restored)


def test_partial_write_never_visible(tmp_path):
    tree = _tree()
    tmp_dir = os.path.join(str(tmp_path), "step_00000009.tmp")
    os.makedirs(tmp_dir)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump({"step": 9, "arrays": {}}, f)
    assert ckpt_io.restore_latest(str(tmp_path), tree) is None
    ckpt_io.save(str(tmp_path), 3, tree)
    step, _ = ckpt_io.restore_latest(str(tmp_path), tree)
    assert step == 3


def test_keep_last_gc(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in range(6):
        ckpt_io.save(str(tmp_path), s, tree, keep_last=2)
    dirs = sorted(d for d in os.listdir(str(tmp_path))
                  if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]


def test_async_saver(tmp_path):
    tree = _tree(3)
    saver = ckpt_io.AsyncSaver()
    saver.save(str(tmp_path), 11, tree)
    saved = map_tree(torch.clone, tree)
    for _, t in tree_leaves(tree):   # the snapshot was taken at save()
        t.add_(1)
    saver.wait()
    step, restored = ckpt_io.restore_latest(str(tmp_path), tree)
    assert step == 11
    _assert_equal(saved, restored)


def test_restore_keeps_the_template_types_and_refuses_shardings(tmp_path):
    tree = _tree()
    ckpt_io.save(str(tmp_path), 4, tree)
    template = _zeros(tree, torch.float64)
    _, restored = ckpt_io.restore_latest(str(tmp_path), template)
    assert restored["a"].dtype == torch.float64
    assert torch.equal(restored["a"], tree["a"].double())
    with pytest.raises(NotImplementedError, match="A9"):
        ckpt_io.restore_latest(str(tmp_path), tree, shardings=tree)


def test_restore_writes_into_the_template(tmp_path):
    """One state on the device: the restored leaves are the template's
    own tensors, overwritten."""
    tree = _tree()
    ckpt_io.save(str(tmp_path), 5, tree)
    template = _zeros(tree)
    ptrs = [t.data_ptr() for _, t in tree_leaves(template)]
    step, restored = ckpt_io.restore_latest(str(tmp_path), template)
    assert step == 5 and restored is template
    assert [t.data_ptr() for _, t in tree_leaves(restored)] == ptrs
    _assert_equal(tree, template)


def test_restore_skips_checkpoints_that_do_not_fit(tmp_path):
    """A newer checkpoint whose shapes differ from the template's is
    skipped before any leaf is written; with none that fits, the
    template is left as it was."""
    tree = _tree()
    ckpt_io.save(str(tmp_path), 1, tree)
    ckpt_io.save(str(tmp_path), 2, {**tree, "a": torch.ones((4, 9))})
    step, restored = ckpt_io.restore_latest(str(tmp_path), _zeros(tree))
    assert step == 1
    _assert_equal(tree, restored)
    other = {**_zeros(tree), "a": torch.zeros((3, 8))}
    assert ckpt_io.restore_latest(str(tmp_path), other) is None
    _assert_equal(other, {**_zeros(tree), "a": torch.zeros((3, 8))})
