"""Request workload generator: Markov-modulated bursty arrivals (a copy of
the JAX package's pure-numpy module, so the port stands alone).

The paper's GPU traffic (Fig. 4) is bursty — phases of heavy injection
alternating with calm — while CPU traffic is steady.  The serving analogue:
prefill demand (new requests, bandwidth-bound) arrives in bursts; decode
demand (active sequences, latency-sensitive) is steady.  The generator
reproduces that shape so the KF has real dynamics to track.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float          # virtual-clock arrival time
    prompt_len: int
    gen_len: int
    # measured by the engine:
    t_first_token: float = -1.0
    t_done: float = -1.0
    tokens_out: int = 0

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.arrival

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 64
    mean_prompt: int = 96
    mean_gen: int = 24
    burst_rate: float = 2.5      # arrivals per unit time in a burst
    calm_rate: float = 0.25
    p_enter_burst: float = 0.15  # per-arrival phase-switch probabilities
    p_exit_burst: float = 0.3
    seed: int = 0


def generate(cfg: WorkloadConfig) -> list[Request]:
    rng = np.random.default_rng(cfg.seed)
    reqs = []
    t = 0.0
    burst = False
    for rid in range(cfg.n_requests):
        if burst and rng.random() < cfg.p_exit_burst:
            burst = False
        elif not burst and rng.random() < cfg.p_enter_burst:
            burst = True
        rate = cfg.burst_rate if burst else cfg.calm_rate
        t += rng.exponential(1.0 / rate)
        prompt = max(8, int(rng.gamma(4.0, cfg.mean_prompt / 4.0)))
        gen = max(4, int(rng.gamma(2.0, cfg.mean_gen / 2.0)))
        reqs.append(Request(rid=rid, arrival=t, prompt_len=prompt,
                            gen_len=gen))
    return reqs
