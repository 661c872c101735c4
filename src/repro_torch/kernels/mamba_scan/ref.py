"""Plain oracle of the selective-scan kernel: the naive O(L) recurrence
(reference: src/repro/kernels/mamba_scan/ref.py).  It is B6's plain
version: one multiply and one add per step, each rounded, which is what
the CUDA kernel computes, so the two agree bitwise on the card."""
from __future__ import annotations

import torch


def scan_ref(
    a: torch.Tensor,   # (B, L, D, S)
    b: torch.Tensor,
    h0: torch.Tensor,  # (B, D, S)
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t over t -> (hs (B, L, D, S), h_last)."""
    h = h0
    hs = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                     dtype=torch.result_type(a, b), device=b.device)
    for t in range(hs.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h
