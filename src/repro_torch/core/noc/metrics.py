"""IPC proxy models for the NoC simulation.

* GPU IPC follows the fraction of issued memory transactions completed per
  epoch (served / demand, capped at 1; a zero-demand epoch scores 1).
* CPU IPC follows an Amdahl-style penalty in network latency beyond the
  no-load latency: 1 / (1 + k * max(0, lat - L0)).
"""
from __future__ import annotations

import torch

GPU_BASE_IPC = 1.0
CPU_NOLOAD_LAT = 14.0
CPU_LAT_SENSITIVITY = 0.01


def gpu_ipc_proxy(served: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    frac = torch.clamp(served / torch.clamp(demand, min=1e-9), max=1.0)
    return GPU_BASE_IPC * torch.where(demand > 0, frac, torch.ones_like(frac))


def cpu_ipc_proxy(avg_latency: torch.Tensor) -> torch.Tensor:
    pen = torch.clamp(avg_latency - CPU_NOLOAD_LAT, min=0.0)
    return 1.0 / (1.0 + CPU_LAT_SENSITIVITY * pen)
