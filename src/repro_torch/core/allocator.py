"""Reconfiguration policy (paper §3.2 hysteresis rules + §3.3 allocation).

The predictor's binary signal becomes an applied configuration under the
warmup / hold / revert rules; `ModePolicy` holds, as tensors, everything a
network mode means to the simulator (VC masks per configuration, subnet
structure, the predictor selection and the control levers).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.predictor import PredictorPolicy, predictor_policy

Tensor = torch.Tensor
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    warmup: int = 10_000     # cycles before the KF may act
    hold: int = 5_000        # min cycles between reallocations
    revert: int = 10_000     # max cycles to stay boosted before fallback
    n_configs: int = 2       # {0: equal, 1: GPU-boosted}


class PolicyState(NamedTuple):
    config: Tensor          # () int32 — applied configuration
    last_change: Tensor     # () int32 — cycle of the last reallocation
    boosted_since: Tensor   # () int32 — cycle config became nonzero (-1 if not)


def _i32(v: int) -> Tensor:
    return torch.tensor(v, dtype=_I32)


def init_policy_state() -> PolicyState:
    return PolicyState(
        config=_i32(0), last_change=_i32(-(10**9)), boosted_since=_i32(-1)
    )


def apply_policy(
    cfg: PolicyConfig, state: PolicyState, kf_signal: Tensor, cycle: Tensor
) -> PolicyState:
    """Advance the hysteresis machine by one epoch."""
    desired = torch.clamp(kf_signal, 0, cfg.n_configs - 1)
    in_warmup = cycle < cfg.warmup
    in_hold = (cycle - state.last_change) < cfg.hold
    boosted = state.config > 0
    over_revert = boosted & (state.boosted_since >= 0) & (
        (cycle - state.boosted_since) > cfg.revert
    )
    want = torch.where(over_revert, _i32(0), desired)
    blocked = in_warmup | (in_hold & ~over_revert)
    new_config = torch.where(blocked, state.config, want)
    changed = new_config != state.config
    new_last_change = torch.where(changed, cycle, state.last_change)
    new_boosted_since = torch.where(
        (new_config > 0) & ~boosted,
        cycle,
        torch.where(new_config > 0, state.boosted_since, _i32(-1)),
    )
    return PolicyState(
        config=new_config.to(_I32),
        last_change=new_last_change.to(_I32),
        boosted_since=new_boosted_since.to(_I32),
    )


class ModePolicy(NamedTuple):
    gpu_mask0: Tensor   # (V,) bool — VCs GPU packets may occupy, config 0
    cpu_mask0: Tensor   # (V,) bool
    gpu_mask1: Tensor   # (V,) bool — masks when boosted (config 1)
    cpu_mask1: Tensor   # (V,) bool
    sa_enable: Tensor   # () bool — Fig. 8 SA preference pattern
    kf_enable: Tensor   # () bool — hysteresis machine drives config
    four_subnet: Tensor  # () bool — class-segregated routing (Fig. 9)
    sub_enabled: Tensor  # (S,) bool — live rows of the padded subnet axis
    sub_is_req: Tensor   # (S,) bool — request-direction subnets
    predictor: PredictorPolicy
    bw_enable: Tensor    # () bool — config drives the VC/SA lever
    place_enable: Tensor  # () bool — config drives compute placement


CONTROLS = ("bandwidth", "placement", "joint")


def mode_policy(
    mode: str,
    n_vcs: int = 4,
    static_gpu_vcs: int = 2,
    *,
    n_subnets: int | None = None,
    active_vcs: int | None = None,
    predictor: str = "kf",
    ema_alpha: float = 0.5,
    guard: bool = False,
    control: str = "bandwidth",
) -> ModePolicy:
    """Policy tensors for baseline | fair | static | kf | 4subnet."""
    if control not in CONTROLS:
        raise ValueError(
            f"unknown control {control!r}; expected one of {CONTROLS}"
        )
    if n_subnets is None:
        n_subnets = 4 if mode == "4subnet" else 2
    if active_vcs is None:
        active_vcs = n_vcs
    if not 0 < active_vcs <= n_vcs:
        raise ValueError(f"active_vcs={active_vcs} outside (0, {n_vcs}]")
    avail = torch.arange(n_vcs) < active_vcs
    if mode in ("baseline", "4subnet"):
        g0, c0 = avail, avail
    elif mode in ("fair", "kf"):
        g0, c0 = vc_partition(_i32(0), active_vcs)
    elif mode == "static":
        g0 = (torch.arange(n_vcs) < static_gpu_vcs) & avail
        c0 = avail & ~g0
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "kf":
        g1, c1 = vc_partition(_i32(1), active_vcs)
    else:
        g1, c1 = g0, c0

    def pad_v(m: Tensor) -> Tensor:
        if m.shape[0] == n_vcs:
            return m
        return torch.cat([m, torch.zeros((n_vcs - m.shape[0],), dtype=torch.bool)])

    sub = torch.arange(n_subnets)
    if mode == "4subnet":
        if n_subnets != 4:
            raise ValueError("4subnet mode needs a 4-row subnet axis, got "
                             f"{n_subnets}")
        sub_enabled = torch.ones((n_subnets,), dtype=torch.bool)
        sub_is_req = sub % 2 == 0
    else:
        if n_subnets < 2:
            raise ValueError(f"2-subnet modes need n_subnets >= 2, got "
                             f"{n_subnets}")
        sub_enabled = sub < 2
        sub_is_req = sub == 0
    is_kf = mode == "kf"
    return ModePolicy(
        gpu_mask0=pad_v(g0), cpu_mask0=pad_v(c0),
        gpu_mask1=pad_v(g1), cpu_mask1=pad_v(c1),
        sa_enable=torch.tensor(is_kf), kf_enable=torch.tensor(is_kf),
        four_subnet=torch.tensor(mode == "4subnet"),
        sub_enabled=sub_enabled,
        sub_is_req=sub_is_req,
        predictor=predictor_policy(predictor, ema_alpha=ema_alpha,
                                   guard=guard),
        bw_enable=torch.tensor(control != "placement"),
        place_enable=torch.tensor(control != "bandwidth"),
    )


def class_vc_masks(policy: ModePolicy, config: Tensor) -> tuple[Tensor, Tensor]:
    """(V,) GPU/CPU VC masks for the applied configuration; (B, V) for a
    (B,) config under a ModePolicy with (B, ...) leaves."""
    boosted = ((config > 0) & policy.bw_enable)[..., None]
    gpu = torch.where(boosted, policy.gpu_mask1, policy.gpu_mask0)
    cpu = torch.where(boosted, policy.cpu_mask1, policy.cpu_mask0)
    return gpu, cpu


def placement_class(
    policy: ModePolicy, config: Tensor, cls0: Tensor, cls1: Tensor
) -> Tensor:
    """(R,) node-class plan for the applied configuration ((B, R) for a
    batch, as in `class_vc_masks`)."""
    boosted = ((config > 0) & policy.place_enable)[..., None]
    return torch.where(boosted, cls1, cls0)


def apply_policy_gated(
    cfg: PolicyConfig,
    policy: ModePolicy,
    state: PolicyState,
    kf_signal: Tensor,
    cycle: Tensor,
) -> PolicyState:
    """`apply_policy` under the traced enable flag (no-op unless kf_enable)."""
    new = apply_policy(cfg, state, kf_signal, cycle)
    return PolicyState(*(
        torch.where(policy.kf_enable, n, o) for n, o in zip(new, state)
    ))


def degrade_policy(state: PolicyState, healthy: Tensor) -> PolicyState:
    """While the watchdog reports unhealthy, revert to config 0 and clear
    the boost timer; `last_change` is kept."""
    fallback = PolicyState(
        config=_i32(0), last_change=state.last_change, boosted_since=_i32(-1)
    )
    return PolicyState(*(
        torch.where(healthy, o, f) for f, o in zip(fallback, state)
    ))


def epoch_sa_prefs(policy: ModePolicy, config: Tensor, cycles: Tensor) -> Tensor:
    """(len(cycles),) int32 SA preference per cycle, -1 for round-robin
    ((B, len(cycles)) for a batch, as in `class_vc_masks`)."""
    pattern = sa_priority_pattern(config[..., None], cycles)
    return torch.where(
        (policy.sa_enable & policy.bw_enable)[..., None], pattern, _i32(-1)
    ).to(_I32)


def vc_partition(config: Tensor, n_vcs: int = 4) -> tuple[Tensor, Tensor]:
    """config 0: equal split at n/2; config 1: GPU boost to n-1."""
    idx = torch.arange(n_vcs)
    gpu_hi = torch.where(config > 0, n_vcs - 1, n_vcs // 2)
    gpu_mask = idx < gpu_hi
    return gpu_mask, ~gpu_mask


def sa_priority_pattern(config: Tensor, phase: Tensor) -> Tensor:
    """Preferred class per cycle: GPU, GPU, CPU when boosted, else -1."""
    pattern = torch.tensor([1, 1, 0], dtype=_I32)[(phase % 3).long()]
    return torch.where(config > 0, pattern, _i32(-1))
