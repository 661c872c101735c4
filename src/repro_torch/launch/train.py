"""End-to-end training launcher with the KF scheduler in the loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --size smoke --steps 200 --kf --ckpt-dir CKPT_DIR [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch falcon-mamba-7b --size full --n-layers 16 --seq-len 2048 \
        --global-batch 4

`--size smoke` trains the reduced config (on the card with its attention
heads widened to 64, the narrowest head dim B5 is built for: see
`smoke_config`); `--size full` the published config on one card
(llama3.2-3b: 3.21 B parameters, 38.6 GB of training state with f32
moments; zamba2-2.7b: all 54 layers fit; falcon-mamba-7b's 64 layers,
~87 GB of state, do not, so ``--n-layers`` cuts the depth;
seamless-m4t-large-v2 trains through `encdec.encdec_loss`, internvl2-2b
with the batch's image-prefix embeds).  Both build the two step variants
(balanced / comm-priority) up front and let the KF scheduler dispatch
between them — the paper's pre-defined configuration model.  The model trains on the
CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch._util import resolve_device
from repro_torch.data import synthetic
from repro_torch.dist.kf_scheduler import KFScheduler, SchedulerConfig
from repro_torch.dist.telemetry import StaticCosts, Telemetry
from repro_torch.kernels.flash_attn.kernel import HEAD_DIMS
from repro_torch.models.config import ModelConfig
from repro_torch.train import loop as loop_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


def make_scheduler() -> KFScheduler:
    """The launcher's KF scheduler: the reference's static costs and
    epoch / warmup / hold / revert steps."""
    telemetry = Telemetry(costs_by_variant={
        0: StaticCosts(flops=0, hbm_bytes=0, collective_bytes=1e9),
        1: StaticCosts(flops=0, hbm_bytes=0, collective_bytes=2.5e8),
    })
    return KFScheduler(SchedulerConfig(
        epoch_steps=10, warmup_steps=30, hold_steps=20,
        revert_steps=60), telemetry)


def smoke_config(arch: str, device: torch.device) -> ModelConfig:
    """The arch's reduced config.  Its attention heads (8 wide for
    llama3.2-3b) have no B5 instantiation, so on CUDA they are widened
    to the narrowest head dim B5 is built for; elsewhere the config is
    the reference's."""
    cfg = configs.smoke(arch)
    if (device.type == "cuda" and cfg.n_heads
            and cfg.head_dim not in HEAD_DIMS):
        cfg = dataclasses.replace(cfg, head_dim=min(HEAD_DIMS))
    return cfg


def build(arch: str, size: str, seq_len: int, global_batch: int,
          lr: float = 3e-4, total_steps: int = 1000, seed: int = 0,
          use_kf: bool = True, device: str | torch.device | None = None,
          n_layers: int | None = None):
    """Returns (state, step_fns, make_batch, scheduler, cfg); the
    reference also returns its mesh, which one card does not have.
    ``n_layers`` cuts the config's depth (a whole number of its
    super-blocks)."""
    dev = resolve_device(device)
    cfg = smoke_config(arch, dev) if size == "smoke" else configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    opt_cfg = opt_lib.OptimizerConfig(
        lr=lr, total_steps=total_steps,
        moment_dtype=cfg.optimizer_dtype)
    state = step_lib.init_train_state(
        torch.Generator(device=dev).manual_seed(seed), cfg, opt_cfg)
    ds = synthetic.make_dataset(cfg, seq_len, global_batch, seed=seed,
                                device=dev)
    step_fns = {variant: step_lib.make_train_step(cfg, opt_cfg,
                                                  variant=variant)
                for variant in (step_lib.BALANCED, step_lib.COMM_PRIORITY)}
    scheduler = make_scheduler() if use_kf else None
    return state, step_fns, ds.batch, scheduler, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kf", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    state, step_fns, make_batch, scheduler, cfg = build(
        args.arch, args.size, args.seq_len, args.global_batch,
        lr=args.lr, total_steps=args.steps, seed=args.seed,
        use_kf=args.kf, device=args.device, n_layers=args.n_layers)
    loop_cfg = loop_lib.LoopConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    result = loop_lib.run(loop_cfg, state, step_fns, make_batch,
                          scheduler, fail_at=args.fail_at)
    losses = result.losses
    widened = (f", heads widened to {cfg.head_dim} for B5"
               if cfg.head_dim != configs.smoke(args.arch).head_dim
               and args.size == "smoke" else "")
    print(f"[train] {args.arch} ({args.size}{widened}) {len(losses)} steps: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(min {np.min(losses):.4f}); "
          f"stragglers={result.straggler_events}; "
          f"variants used={sorted(set(result.variants))}")
    return result


if __name__ == "__main__":
    main()
