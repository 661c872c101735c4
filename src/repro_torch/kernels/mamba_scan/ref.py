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


def scan_ref_bwd(
    a: torch.Tensor,        # (B, L, D, S)
    hs: torch.Tensor,       # (B, L, D, S), scan_ref's states
    h0: torch.Tensor,       # (B, D, S)
    g_hs: torch.Tensor,     # (B, L, D, S)
    g_hlast: torch.Tensor | None = None,   # (B, D, S), zero when None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `scan_ref` walked back over t: lam_t = g_hs_t +
    a_{t+1} lam_{t+1} (g_hlast in place of a_L lam_L), da_t = lam_t h_{t-1}
    (h_{-1} = h0), db_t = lam_t, dh0 = a_0 lam_0 -> (da, db, dh0).  One
    rounding per product and sum, in autograd's operand order, so it is
    bitwise autograd's gradient of `scan_ref` and B6-bwd's."""
    da, db = torch.empty_like(hs), torch.empty_like(hs)
    carry = torch.zeros_like(h0) if g_hlast is None else g_hlast
    for t in reversed(range(hs.shape[1])):
        lam = g_hs[:, t] + carry
        db[:, t] = lam
        da[:, t] = lam * (hs[:, t - 1] if t else h0)
        carry = lam * a[:, t]
    return da, db, carry
