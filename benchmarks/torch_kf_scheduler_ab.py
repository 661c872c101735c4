"""Serving A/B on the PyTorch + CUDA port: the KF-arbitrated Engine against
static policies.

Prefill is the bursty bandwidth class, decode the steady latency class;
the KF predicts decode pressure and switches the token-budget split and
interleave pattern (50/50 P,D <-> 75/25 P,P,D) under the paper's
hysteresis rules.  Reports TTFT, latency and throughput (on the Engine's
virtual clock) for the rr, static and kf modes on a bursty workload, with
the smoke config of the model and random weights from a seeded generator
(on the card with its heads widened to one B5 is built for:
`launch.train.smoke_config`).

    PYTHONPATH=src python3 benchmarks/torch_kf_scheduler_ab.py
        [--arch llama3.2-3b] [--requests 48] [--seed 0] [--device cpu]

Imports no JAX.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._util import resolve_device
from repro_torch.launch.train import smoke_config
from repro_torch.models import lm
from repro_torch.serve import batching
from repro_torch.serve.engine import Engine, EngineConfig

MODES = ("rr", "static", "kf")


def run(arch: str = "llama3.2-3b", n_requests: int = 48, seed: int = 0,
        device=None) -> dict:
    dev = resolve_device(device)
    cfg = smoke_config(arch, dev)
    params = lm.make_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    wl = batching.WorkloadConfig(
        n_requests=n_requests, mean_prompt=40, mean_gen=10,
        burst_rate=6.0, calm_rate=0.2, seed=seed)
    out = {}
    for mode in MODES:
        ecfg = EngineConfig(mode=mode, max_slots=4, max_len=96,
                            budget_tokens=96, warmup_iters=3)
        eng = Engine(params, cfg, ecfg, seed=seed, device=dev)
        out[mode] = eng.run(batching.generate(wl), max_iters=2000).summary()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    results = run(args.arch, args.requests, args.seed, device=args.device)
    print("mode,n_finished,mean_ttft,p90_ttft,mean_latency,"
          "throughput_tok_s,kf_on_frac")
    for mode, s in results.items():
        print(f"{mode},{s['n_finished']},{s['mean_ttft']:.4f},"
              f"{s['p90_ttft']:.4f},{s['mean_latency']:.4f},"
              f"{s['throughput_tok_s']:.2f},{s['kf_on_frac']:.2f}")
    kf, rr = results["kf"], results["rr"]
    print(f"# kf vs rr: mean_latency "
          f"{kf['mean_latency'] / rr['mean_latency'] - 1:+.1%}, "
          f"throughput {kf['throughput_tok_s'] / rr['throughput_tok_s'] - 1:+.1%}")
    return results


if __name__ == "__main__":
    main()
