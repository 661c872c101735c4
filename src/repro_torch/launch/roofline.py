"""Roofline terms of one step on one card: the pure half of the JAX
package's `launch/roofline.py`.

    compute_s    = FLOPs / peak FLOP/s
    memory_s     = bytes / peak HBM bytes/s
    collective_s = wire bytes / link bytes/s   (0 on one card)

`analyze` takes the peaks as arguments.  The defaults are one H100 SXM's
published dense bf16 rate and HBM rate (NVIDIA H100 datasheet, at its
700 W limit): the figures chip_smoke.py's kernel bounds use.  The FLOPs
and bytes come from `launch.op_cost.count` of the step on meta tensors
(`launch.dryrun`).  One card has no collectives: `CollectiveStats` stays
empty and `collective_s` is 0.  The JAX package's `parse_collectives`
reads XLA's HLO text, which the port does not have; it belongs with the
multi-device paths (ROADMAP queue A, A9b).

`model_flops` (6·N·D) and `count_params` are the reference's, formula for
formula.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# one H100 SXM (NVIDIA H100 datasheet): dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s, HBM capacity
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_CAP = 80e9
LINK_BW = 450e9   # NVLink 4, bytes/s each way; unused on one card


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0                 # per chip
    by_kind: dict = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, wire: float):
        self.wire_bytes += wire
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + wire
        self.count += 1


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: overlapped model = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """How close the cell is to the compute roofline (1.0 = compute
        bound at peak): compute_s / max(all terms)."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "compute_fraction": self.compute_fraction,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "n_chips": self.n_chips,
        }


def analyze(cost: dict, collectives: CollectiveStats, n_chips: int, *,
            peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            link_bw: float = LINK_BW) -> Roofline:
    """``cost``: {"flops", "bytes accessed"} of one chip's step."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / peak_flops,
        memory_s=hbm / hbm_bw,
        collective_s=collectives.wire_bytes / link_bw,
        flops_per_chip=flops,
        hbm_bytes_per_chip=hbm,
        wire_bytes_per_chip=collectives.wire_bytes,
        n_chips=n_chips,
    )


def model_flops(cfg, cell, n_tokens: Optional[int] = None) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for the cell's token count;
    x3 total for train (fwd+bwd), x1 for prefill, per-token for decode."""
    n_params = count_params(cfg, active_only=True)
    if n_tokens is None:
        n_tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    fwd = 2.0 * n_params * n_tokens
    return 3.0 * fwd if cell.kind == "train" else fwd


def _attention(cfg) -> float:
    d = cfg.d_model
    return d * cfg.n_heads * cfg.head_dim * 2 \
        + d * cfg.n_kv_heads * cfg.head_dim * 2


def count_params(cfg, active_only: bool = False) -> float:
    """Parameter count from the config (embedding included once), by the
    reference's formula."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    total = v * d * (1 if cfg.tie_embeddings else 2)
    moe_mask = cfg.moe_layer_mask()
    for i in range(cfg.n_layers):
        if cfg.is_ssm or cfg.is_hybrid:
            di, ds = cfg.d_inner, cfg.ssm_state
            if cfg.ssm_variant == "mamba1":
                r = -(-cfg.d_model // 16)
                total += d * 2 * di + cfg.ssm_conv * di + di * (r + 2 * ds) \
                    + r * di + di * ds + di * d
            else:
                nh = di // cfg.ssm_head_dim
                total += d * (2 * di + 2 * ds + nh) \
                    + cfg.ssm_conv * (di + 2 * ds) + di * d + di
        elif moe_mask[i]:
            e_active = cfg.n_experts_active if active_only else cfg.n_experts
            moe = 3 * d * f * e_active + d * cfg.n_experts  # + router
            if cfg.n_shared_experts:
                moe += 3 * d * f * cfg.n_shared_experts
            total += _attention(cfg) + moe
        else:
            total += _attention(cfg) + 3 * d * f
    if cfg.is_hybrid:
        # one shared attention+MLP block (counted once; applied n/period x)
        total += _attention(cfg) + 3 * d * cfg.d_ff
    if cfg.is_encoder_decoder:
        enc = cfg.n_encoder_layers * (_attention(cfg) + 3 * d * f)
        dec_cross = cfg.n_layers * _attention(cfg)
        total += enc + dec_cross
    return float(total)
