"""Oracle for the KF-bank kernel: the PAPER-FORM update (Eqs. 1-5) of
`repro_torch.core.kalman`, over the bank with the batch written out, which
shows that the kernel's information-form update is the same filter."""
from __future__ import annotations

import torch

from repro_torch.core import kalman


def kf_bank_ref(
    x: torch.Tensor,   # (B,)
    p: torch.Tensor,   # (B,)
    z: torch.Tensor,   # (B, M)
    h: torch.Tensor,   # (M,)
    r: torch.Tensor,   # (M,)
    *,
    a: float = 1.0,
    q: float = 1e-3,
) -> tuple[torch.Tensor, torch.Tensor]:
    m = z.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    params = kalman.KalmanParams(
        a=torch.full((1, 1), a, **f32),
        b=torch.zeros((1, 1), **f32),
        h=h.reshape(m, 1).to(torch.float32),
        q=torch.full((1, 1), q, **f32),
        r=torch.diag(r.to(torch.float32)),
    )
    states = kalman.KalmanState(x=x[:, None], p=p[:, None, None])
    post, _, _ = kalman.batched_step(params, states, z)
    return post.x[:, 0], post.p[:, 0, 0]
