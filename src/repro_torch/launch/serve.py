"""Serving launcher: continuous batching with KF-arbitrated scheduling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --mode kf --requests 48 [--device cpu]

Runs the reduced (smoke) config of a dense decoder arch, of
falcon-mamba-7b, of zamba2-2.7b (``--arch zamba2-2.7b``: mamba2 layers
and the shared attention block) or of a MoE decoder (``--arch
grok-1-314b``: 8 experts at full size, top-2; ``--arch
llama4-maverick-400b-a17b``: 128 experts, top-1, a shared expert, MoE
every second layer) with the bursty synthetic workload and prints the
latency/throughput summary (virtual clock) for the chosen arbitration
mode (rr | static | kf).  The model runs on the CUDA device unless ``--device``
names another; there the smoke config's attention heads are widened to a
head dim the flash kernel is built for (`launch.train.smoke_config`).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch._util import resolve_device
from repro_torch.launch.train import smoke_config
from repro_torch.models import lm
from repro_torch.serve import batching
from repro_torch.serve.engine import Engine, EngineConfig


def run(arch: str, mode: str, n_requests: int = 48, seed: int = 0,
        max_slots: int = 8, max_len: int = 128, budget: int = 128,
        device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    cfg = smoke_config(arch, dev)
    if cfg.is_encoder_decoder:
        raise SystemExit("the serve launcher targets decoder LMs; "
                         "seamless decode is covered by the dry-run")
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(seed), cfg)
    wl = batching.WorkloadConfig(n_requests=n_requests, mean_prompt=48,
                                 mean_gen=12, seed=seed)
    ecfg = EngineConfig(mode=mode, max_slots=max_slots, max_len=max_len,
                        budget_tokens=budget)
    engine = Engine(params, cfg, ecfg, seed=seed, device=dev)
    stats = engine.run(batching.generate(wl))
    return stats.summary()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="a decoder arch: a dense one, falcon-mamba-7b, "
                         "zamba2-2.7b, grok-1-314b or "
                         "llama4-maverick-400b-a17b (its smoke config runs)")
    ap.add_argument("--mode", default="kf", choices=["rr", "static", "kf"])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    summary = run(args.arch, args.mode, args.requests, args.seed,
                  device=args.device)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
