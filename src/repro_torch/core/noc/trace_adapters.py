"""Step-cost -> chiplet NoC demand adapter.

The first non-synthetic workload family: instead of Markov-modulated
Bernoulli stand-ins for ISPASS benchmarks, demand rows are derived from
what the port's own models move through memory.  For each serving phase
the real step function (`repro_torch.launch.specs` prefill/decode
builders over `repro_torch.models` architectures) runs on the meta device
under `repro_torch.launch.op_cost`, which counts its FLOPs and bytes op
by op with nothing executed (every layer counted).  A phase's FLOPs and
bytes-moved then map to chiplet NoC injection through a roofline
argument:

    cycles      = max(flops / peak_flops_per_cycle,
                      bytes / peak_hbm_bytes_per_cycle)
    bytes/cycle = bytes / cycles
    intensity   = (bytes/cycle) / peak_hbm_bytes_per_cycle   in (0, 1]
    gpu rate    = peak_rate * intensity        packets/node/cycle

so a memory-bound phase (decode: every token re-reads the weights and KV
cache) saturates the fabric at `peak_rate` (calibrated to the simulated
network's contention knee, the same ~0.38 regime the synthetic BFS bursts
hit) while a compute-bound phase (prefill: hundreds of tokens amortize
each weight read) injects at a small fraction of it.  ``sync`` epochs
(request-wave barriers / queue drains) carry zero GPU fabric demand; the
CPU class keeps its stable omnetpp-like 0.12 throughout.

Rows are emitted deterministic (``gpu_rate_lo == gpu_rate_hi``, burst
phase pinned low) so the replayed trace is a pure function of the costs
(no Markov dynamics), and the result is packaged as a
`traffic.RecordedTrace`, making an LLM-serving demand stream a
first-class sweep workload via `traffic.register_workload`.  Given the
same cost dicts, `demand_from_costs` gives the JAX package's rows and
meta bit for bit, except ``meta["adapter"]``, which names the cost source
("op_cost" here).

This module imports `repro_torch.launch` / `repro_torch.models` lazily
inside the phase builders: the NoC package stays importable without the
model stack.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.noc.traffic import RecordedTrace, WorkloadProfile

# the cost source `step_cost` reads, stamped on every trace's meta
ADAPTER = "op_cost"


@dataclasses.dataclass(frozen=True)
class ChipletRoofline:
    """The GPU chiplet's machine balance, in per-cycle units.

    Table-1-scale defaults: a 2-SM GPU chiplet sustains 256 MAC-flops per
    cycle; its share of MC ingress is one 64-byte line per cycle.  Machine
    balance is therefore 4 flops/byte: phases with lower arithmetic
    intensity are memory-bound and saturate the fabric.  ``peak_rate`` is
    the injection rate a fully memory-bound phase maps to: 0.38
    packets/node/cycle puts 14 GPU tiles at rho ~ 0.95 of the 8 pkt/cycle
    MC ingress, the queueing knee where VC allocation matters (the same
    regime the synthetic BFS bursts are tuned to).
    """

    peak_flops_per_cycle: float = 256.0
    peak_hbm_bytes_per_cycle: float = 64.0
    peak_rate: float = 0.38
    cpu_rate: float = 0.12

    def intensity(self, flops: float, bytes_moved: float) -> float:
        """Memory-boundedness of a phase in (0, 1]: bytes/cycle fraction."""
        if bytes_moved <= 0.0:
            return 0.0
        cycles = max(flops / self.peak_flops_per_cycle,
                     bytes_moved / self.peak_hbm_bytes_per_cycle)
        if cycles <= 0.0:
            return 0.0
        return (bytes_moved / cycles) / self.peak_hbm_bytes_per_cycle

    def gpu_rate(self, flops: float, bytes_moved: float) -> float:
        return self.peak_rate * self.intensity(flops, bytes_moved)


# The model the serving phases are costed on: a small but real attention
# LM (repro_torch.models.lm), so the adapter stays cheap (a meta run,
# nothing executes) while the step still holds the full prefill/decode
# structure (QKV matmuls, KV-cache update, logits).  d_model=768 puts
# prefill well on the compute side of the 4 flops/byte machine balance
# (intensity ~0.1: the calm regime) while decode stays fully memory-bound
# (rate = peak 0.38).  That contrast is the property the schedule
# geometry relies on.
def _tiny_serving_config():
    from repro_torch.models.config import ModelConfig

    return ModelConfig(name="noc-hlo-tiny", n_layers=2, d_model=768,
                       n_heads=8, n_kv_heads=4, d_ff=3072, vocab_size=512)


def step_cost(kind: str, cfg=None, *, seq: int = 256,
              batch: int = 4) -> dict:
    """FLOPs / bytes-moved of one real step, from `launch.op_cost`.

    kind: "prefill" (forward over `seq` prompt tokens) or "decode" (one
    new token against a `seq`-deep KV cache).  `cfg` defaults to the tiny
    serving config.  Nothing is executed: the step runs on meta tensors
    and is counted op by op.
    """
    from repro_torch.launch import op_cost, specs

    if cfg is None:
        cfg = _tiny_serving_config()
    cell = specs.ShapeCell(f"adapter_{kind}", seq, batch, kind)
    if kind == "prefill":
        params = specs.abstract_params(cfg)
        _, cost = op_cost.count(specs.make_prefill_step(cfg), params,
                                specs.batch_struct(cfg, cell))
    elif kind == "decode":
        params = specs.abstract_params(cfg)
        token, state = specs.abstract_decode_inputs(cfg, cell)
        _, cost = op_cost.count(specs.make_serve_step(cfg), params, token,
                                state)
    else:
        raise ValueError(f"unknown phase kind {kind!r}; expected "
                         "'prefill' or 'decode'")
    return {
        "kind": kind,
        "flops": float(cost.flops),
        "bytes": float(cost.bytes),
        "seq": seq,
        "batch": batch,
        "model": cfg.name,
    }


# Default serving schedule: four request waves, each
# [prefill 12][decode 10][sync 2][decode 6] epochs: prompt ingestion
# (compute-bound, low fabric demand), a token-generation burst
# (memory-bound, saturating), an inter-wave barrier/queue drain, and the
# wave's decode tail.  120 epochs at the canonical run length; the arc
# shape matches the hysteresis-aware geometry the predictor gate is sized
# against (traffic.shift_scenario): the sync gap lands past the hold
# window, so reactive predictors un-boost on it and pay the lockout for
# the second decode burst while the KF's posterior rides the gap.
SERVE_SCHEDULE: tuple[tuple[str, int], ...] = (
    ("prefill", 12), ("decode", 10), ("sync", 2), ("decode", 6),
) * 4


def demand_from_costs(
    phase_costs: dict,
    schedule: tuple[tuple[str, int], ...] = SERVE_SCHEDULE,
    roofline: ChipletRoofline = ChipletRoofline(),
    name: str = "hlo_serve",
    adapter: str = ADAPTER,
) -> RecordedTrace:
    """Assemble per-epoch demand rows from per-phase costs.

    phase_costs: {phase_name: cost dict with "flops" and "bytes", as
    `step_cost` gives}; the schedule may additionally reference the
    builtin zero-demand phase "sync".  Rows are deterministic: rate_lo ==
    rate_hi, Markov phase pinned low.  ``adapter`` names the cost source
    in the meta.
    """
    rates = {"sync": 0.0}
    for phase, cost in phase_costs.items():
        rates[phase] = roofline.gpu_rate(cost["flops"], cost["bytes"])
    n_epochs = sum(n for _, n in schedule)
    gpu = np.empty((n_epochs,), np.float32)
    pos = 0
    for phase, n in schedule:
        if phase not in rates:
            raise ValueError(
                f"schedule phase {phase!r} has no cost entry; have "
                f"{sorted(rates)}"
            )
        gpu[pos:pos + n] = rates[phase]
        pos += n
    rows = WorkloadProfile(
        gpu_rate_lo=gpu,
        gpu_rate_hi=gpu.copy(),
        p_enter=np.zeros((n_epochs,), np.float32),
        p_exit=np.ones((n_epochs,), np.float32),
        cpu_rate=np.full((n_epochs,), roofline.cpu_rate, np.float32),
    )
    meta = {
        "adapter": adapter,
        "roofline": dataclasses.asdict(roofline),
        "schedule": [[p, int(n)] for p, n in schedule],
        "phases": {
            p: dict(c, rate=float(rates[p]),
                    intensity=float(roofline.intensity(c["flops"],
                                                       c["bytes"])))
            for p, c in phase_costs.items()
        },
    }
    return RecordedTrace(demand=rows, fit="exact", name=name, meta=meta)


def hlo_serving_trace(
    cfg=None,
    schedule: tuple[tuple[str, int], ...] = SERVE_SCHEDULE,
    roofline: ChipletRoofline = ChipletRoofline(),
    *,
    seq: int = 256,
    prefill_batch: int = 2,
    decode_batch: int = 4,
    name: str = "hlo_serve",
) -> RecordedTrace:
    """The end-to-end adapter: count the port's own prefill/decode steps
    and emit the serving-demand trace."""
    costs = {
        "prefill": step_cost("prefill", cfg, seq=seq, batch=prefill_batch),
        "decode": step_cost("decode", cfg, seq=seq, batch=decode_batch),
    }
    return demand_from_costs(costs, schedule, roofline, name=name)


def register_hlo_workload(name: str = "HLO_SERVE", overwrite: bool = False,
                          **kwargs) -> RecordedTrace:
    """Build the serving trace and register it as a named sweep workload."""
    from repro_torch.core.noc.traffic import register_workload

    trace = hlo_serving_trace(name=name.lower(), **kwargs)
    register_workload(name, trace, overwrite=overwrite)
    return trace
