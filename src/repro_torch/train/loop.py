"""Fault-tolerant training loop with the KF scheduler choosing each step.

Composition per step:
  prefetcher (latency class) -> telemetry.mark_input_ready
  -> dispatch the KF-selected step variant (bandwidth class)
  -> scheduler.on_step() (KF epoch update at epoch boundaries)
  -> async checkpoint every `ckpt_every` (atomic, crash-safe)

Fault tolerance:
  * restart-safe: data is a pure function of (seed, step); restore_latest +
    the step counter reproduce the exact stream (tested bit-identical);
  * crash injection: `fail_at` raises mid-run for the restart tests;
  * straggler detection: EMA step-time watchdog counts outliers
    (> straggler_factor x EMA), logged and exported in the result.

``float(metrics["loss"])`` is the one host sync a step, as in the
reference.  The step functions update the state in place
(`optimizer.update`); a checkpoint copies it to host memory before the
next step runs, and a restore writes into the state it is given, so one
training state lives on the card throughout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.ckpt import io as ckpt_io
from repro_torch.data.prefetch import Prefetcher
from repro_torch.dist.kf_scheduler import KFScheduler
from repro_torch.train.step import TrainState


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    prefetch_depth: int = 2


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    losses: list
    variants: list
    straggler_events: int
    restored_from: Optional[int]


def run(
    cfg: LoopConfig,
    state: TrainState,
    step_fns: dict[int, Callable],      # variant -> step
    make_batch: Callable[[int], dict],
    scheduler: Optional[KFScheduler] = None,
    *,
    fail_at: Optional[int] = None,
    log: Callable[[str], None] = print,
) -> LoopResult:
    start_step = 0
    restored_from = None
    if cfg.ckpt_dir:
        restored = ckpt_io.restore_latest(cfg.ckpt_dir, state)
        if restored is not None:
            start_step, state = restored
            restored_from = start_step
            log(f"[loop] restored checkpoint at step {start_step}")

    saver = ckpt_io.AsyncSaver()
    prefetch = Prefetcher(make_batch, depth=cfg.prefetch_depth,
                          start_step=start_step)
    losses, variants = [], []
    straggler_events = 0
    ema_dt = None
    variant = scheduler.variant if scheduler else 0

    try:
        for step in range(start_step, cfg.total_steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")

            timer = scheduler.telemetry.timer if scheduler else None
            if timer:
                timer.step_begin()
            fetched_step, batch = prefetch.get()
            assert fetched_step == step, (fetched_step, step)
            if timer:
                timer.mark_input_ready()

            t0 = time.perf_counter()
            state, metrics = step_fns[variant](state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if timer:
                timer.step_end()

            # straggler watchdog (the first step pays the kernels' build
            # and the allocator's warm-up: it must not seed the baseline)
            if step == start_step:
                pass
            elif ema_dt is None:
                ema_dt = dt
            else:
                if dt > cfg.straggler_factor * ema_dt:
                    straggler_events += 1
                    log(f"[loop] straggler: step {step} took {dt:.3f}s "
                        f"(EMA {ema_dt:.3f}s)")
                ema_dt = 0.9 * ema_dt + 0.1 * dt

            losses.append(loss)
            variants.append(variant)
            if scheduler:
                variant = scheduler.on_step()
                if variant not in step_fns:
                    variant = 0

            if cfg.log_every and step % cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} "
                    f"variant {variant} dt {dt * 1e3:.1f}ms")

            if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                saver.save(cfg.ckpt_dir, step + 1, state,
                           keep_last=cfg.keep_last)
    finally:
        prefetch.close()
        saver.wait()

    return LoopResult(
        state=state,
        losses=losses,
        variants=variants,
        straggler_events=straggler_events,
        restored_from=restored_from,
    )
