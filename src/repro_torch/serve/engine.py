"""Continuous-batching engine with KF-arbitrated prefill/decode scheduling.

The paper, transplanted to the serving layer of a shared accelerator:

  traffic classes   prefill (new requests)   = bursty, bandwidth-bound (GPU)
                    decode  (active slots)   = steady, latency-sensitive (CPU)
  VC partition      per-iteration token budget split between the classes
                    config 0: 50/50          config 1: 75/25 prefill-boosted
  switch arbiter    interleave ORDER within an iteration
                    config 0: alternate P,D  config 1: P,P,D (Fig. 8's 2:1)
  KF telemetry      z = [kv_occupancy (dramfull), prefill_backlog_tokens
                    (icnt_push), decode_queue_wait (stall_icnt)]
  hysteresis        the same warmup/hold/revert machine (core.allocator)

Modes: 'rr' (static 50/50, the paper's baseline), 'static' (fixed split),
'kf' (full technique).  Time is a virtual clock advanced by a calibrated
cost model (tokens processed), so runs are deterministic.

The model (prefill through the flash kernel B5 on a dense decoder, the
fused scan kernel B7 on falcon-mamba, or both on zamba2, decode) runs on
``device``,
the CUDA device unless the caller passes another.  The KF and the
hysteresis policy run on host CPU tensors, so the control decisions on the
card are comparable with a CPU run.

Two behaviours of the reference are kept as they are: prompts are
prefilled as all-zero token ids, and decode feeds a token buffer that is
never updated.  So `EngineStats` depends only on the workload, the
`EngineConfig` and the cache lengths, never on the model's numbers.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch._util import resolve_device
from repro_torch.core import kalman
from repro_torch.core.allocator import (
    PolicyConfig, apply_policy, init_policy_state,
)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serve import cache as cache_lib
from repro_torch.serve.batching import Request


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    mode: str = "kf"             # rr | static | kf
    max_slots: int = 8
    max_len: int = 256
    budget_tokens: int = 256     # per engine iteration
    static_prefill_frac: float = 0.5
    # KF + hysteresis (iteration-scaled analogues of the paper's cycles)
    warmup_iters: int = 4
    hold_iters: int = 2
    revert_iters: int = 8
    kf_q: float = 1e-3
    kf_r: float = 2e-1
    # virtual-clock cost model: seconds per token (prefill is batched ->
    # cheaper per token; decode pays per-step launch overhead)
    c_prefill: float = 1.0e-4
    c_decode: float = 2.5e-4
    c_iter: float = 1.0e-3


@dataclasses.dataclass
class EngineStats:
    finished: list
    iters: int
    clock: float
    kf_signals: list
    configs: list

    def summary(self) -> dict:
        ttfts = [r.ttft for r in self.finished]
        lats = [r.latency for r in self.finished]
        toks = sum(r.tokens_out for r in self.finished)
        return {
            "n_finished": len(self.finished),
            "mean_ttft": float(np.mean(ttfts)) if ttfts else 0.0,
            "p90_ttft": float(np.percentile(ttfts, 90)) if ttfts else 0.0,
            "mean_latency": float(np.mean(lats)) if lats else 0.0,
            "throughput_tok_s": toks / self.clock if self.clock else 0.0,
            "kf_on_frac": float(np.mean(self.configs)) if self.configs else 0.0,
        }


class Engine:
    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 temperature: float = 0.0, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        have = params["embed"]["table"].device
        if have.type != self.device.type:
            raise ValueError(f"params lie on {have}, the engine runs on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.state = lm.init_decode_state(ecfg.max_slots, ecfg.max_len, cfg,
                                          self.device)
        self.slots: list[Optional[Request]] = [None] * ecfg.max_slots
        self.queue: deque[Request] = deque()
        self.clock = 0.0
        self.seed = seed
        self.temperature = temperature
        # KF + policy (paper §3.2 rules, iteration-scaled), on the host
        self.kf_params = kalman.paper_params(q=ecfg.kf_q, r=ecfg.kf_r)
        self.kf_state = kalman.init_state(1)
        self.policy_cfg = PolicyConfig(
            warmup=ecfg.warmup_iters, hold=ecfg.hold_iters,
            revert=ecfg.revert_iters,
        )
        self.policy = init_policy_state()
        self.iter = 0
        self.decode_wait_ema = 0.0
        self._tokens = torch.zeros((ecfg.max_slots, 1), dtype=torch.int64,
                                   device=self.device)
        self.stats = EngineStats([], 0, 0.0, [], [])

    # ---- class telemetry (the paper's three counters) ----
    def _observe(self) -> torch.Tensor:
        backlog = sum(r.prompt_len for r in self.queue)
        occ = cache_lib.kv_occupancy(self.state, self.ecfg.max_len)
        raw = torch.tensor([
            occ,                                   # dramfull analogue
            backlog / self.ecfg.budget_tokens,     # icnt_push analogue
            self.decode_wait_ema,                  # stall_icnt analogue
        ], dtype=torch.float32)
        hi = torch.tensor([1.0, 4.0, 4.0], dtype=torch.float32)
        return kalman.normalize_observations(raw, torch.zeros(3), hi)

    def _config(self) -> int:
        if self.ecfg.mode == "rr":
            return 0
        if self.ecfg.mode == "static":
            return 1 if self.ecfg.static_prefill_frac > 0.5 else 0
        return int(self.policy.config)

    # ---- engine iteration ----
    def submit(self, req: Request):
        # context-window admission: prompt + generation must fit the slot
        limit = self.ecfg.max_len - req.gen_len - 1
        if req.prompt_len > limit:
            req.prompt_len = max(limit, 1)
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _prefill_one(self, req: Request, slot: int):
        tokens = torch.zeros((1, req.prompt_len), dtype=torch.int64,
                             device=self.device)
        prefilled = lm.prefill_caches(
            self.params, tokens, self.cfg, self.ecfg.max_len)
        self.state = cache_lib.insert_request(self.state, prefilled, slot)
        self.slots[slot] = req
        self.clock += req.prompt_len * self.ecfg.c_prefill
        req.t_first_token = self.clock
        req.tokens_out = 1

    def _decode_batch(self):
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        _, self.state = lm.decode_step(
            self.params, self._tokens, self.state, self.cfg)
        self.clock += (len(active) * self.ecfg.c_decode + self.ecfg.c_iter)
        for i in active:
            r = self.slots[i]
            r.tokens_out += 1
            if r.tokens_out >= r.gen_len:
                r.t_done = self.clock
                self.stats.finished.append(r)
                self.slots[i] = None
                self.state = cache_lib.clear_slot(self.state, i)

    def step(self):
        """One engine iteration under the active configuration."""
        config = self._config()
        budget = self.ecfg.budget_tokens
        prefill_frac = 0.75 if config == 1 else 0.5
        prefill_budget = int(budget * prefill_frac)
        # arbitration pattern (paper Fig. 8): config 0 alternates P,D;
        # config 1 issues P,P,D
        pattern = ["P", "P", "D"] if config == 1 else ["P", "D"]
        decode_due = any(r is not None for r in self.slots)
        t_wait_start = self.clock
        did_work = False
        did_prefill = False

        for phase in pattern * 4:   # a few rounds per iteration
            if phase == "P":
                free = self._free_slots()
                # budget caps ADDITIONAL prefills; the first one always
                # proceeds (deadlock-free even when prompt > budget share)
                if (self.queue and free
                        and self.queue[0].arrival <= self.clock
                        and (not did_prefill
                             or self.queue[0].prompt_len <= prefill_budget)):
                    req = self.queue.popleft()
                    prefill_budget -= req.prompt_len
                    self._prefill_one(req, free[0])
                    did_work = did_prefill = True
            else:
                if any(r is not None for r in self.slots):
                    self._decode_batch()
                    did_work = True
        # decode-wait telemetry: how long decode waited behind prefills
        if decode_due:
            self.decode_wait_ema = (0.8 * self.decode_wait_ema
                                    + 0.2 * (self.clock - t_wait_start))
        # idle: advance the virtual clock to the next arrival
        if not did_work and self.queue:
            self.clock = max(self.clock, self.queue[0].arrival)
        self.iter += 1

        if self.ecfg.mode == "kf":
            z = self._observe()
            self.kf_state, _, _ = kalman.step(self.kf_params, self.kf_state, z)
            signal = kalman.binarize(self.kf_state.x[0])
            self.policy = apply_policy(
                self.policy_cfg, self.policy, signal,
                torch.tensor(self.iter, dtype=torch.int32))
        self.stats.kf_signals.append(int(self._config()))
        self.stats.configs.append(config)
        self.stats.iters = self.iter
        self.stats.clock = self.clock

    def run(self, requests: list[Request], max_iters: int = 1000) -> EngineStats:
        for r in requests:
            self.submit(r)
        while (self.queue or any(self.slots)) and self.iter < max_iters:
            self.step()
        return self.stats
