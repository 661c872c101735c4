"""Kalman Filter (paper Eqs. 1-5) on torch tensors.

    time update:         x^_k = A x_{k-1} + B u_{k-1}           (Eq. 1)
                         P^_k = A P_{k-1} A^T + Q               (Eq. 2)
    measurement update:  K_k  = P^_k H^T (H P^_k H^T + R)^-1    (Eq. 3)
                         x_k  = x^_k + K_k (z_k - H x^_k)       (Eq. 4)
                         P_k  = (I - K_k H) P^_k                (Eq. 5)

Plain functions over a `KalmanState` NamedTuple, float32 by default.  The
expressions follow `repro.core.kalman` term for term, so the only source
of difference is the 3x3 solve inside two LAPACK builds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class KalmanState(NamedTuple):
    x: Tensor  # (n,)   posterior state estimate
    p: Tensor  # (n, n) posterior error covariance


class KalmanParams(NamedTuple):
    """Model matrices. Shapes: A (n,n), B (n,u), H (m,n), Q (n,n), R (m,m)."""

    a: Tensor
    b: Tensor
    h: Tensor
    q: Tensor
    r: Tensor

    @property
    def state_dim(self) -> int:
        return self.a.shape[0]

    @property
    def obs_dim(self) -> int:
        return self.h.shape[0]


def _solve(a: Tensor, b: Tensor) -> Tensor:
    """LU solve that, like jnp.linalg.solve, returns non-finite values for a
    singular system instead of raising (the coast below handles them)."""
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def init_state(n: int, p0: float = 1.0, dtype=torch.float32) -> KalmanState:
    return KalmanState(
        x=torch.zeros((n,), dtype=dtype), p=torch.eye(n, dtype=dtype) * p0
    )


def make_params(a, b, h, q, r, dtype=torch.float32) -> KalmanParams:
    """`KalmanParams` from scalars, lists or arrays, each made at least
    2-D (a scalar becomes (1, 1), a length-k vector (1, k))."""
    return KalmanParams(*(
        torch.atleast_2d(torch.as_tensor(m, dtype=dtype))
        for m in (a, b, h, q, r)
    ))


def time_update(
    params: KalmanParams, state: KalmanState, u: Tensor | None = None
) -> KalmanState:
    """Eqs. (1)-(2): a-priori estimate (x^_k, P^_k)."""
    x, p = state
    x_prior = params.a @ x
    if u is not None:
        x_prior = x_prior + params.b @ u
    p_prior = params.a @ p @ params.a.T + params.q
    return KalmanState(x=x_prior, p=p_prior)


def measurement_update(params: KalmanParams, prior: KalmanState, z: Tensor):
    """Eqs. (3)-(5): posterior (x_k, P_k) given observation z (m,).

    A non-finite or negative-variance posterior from a FINITE observation
    coasts on the prior (the numerical-breakdown coast); a NaN observation
    still poisons an unguarded filter.
    """
    x_prior, p_prior = prior
    h = params.h
    s = h @ p_prior @ h.T + params.r
    k = _solve(s, h @ p_prior.T).T  # (n, m)
    innovation = z - h @ x_prior
    x_post = x_prior + k @ innovation
    n = params.state_dim
    p_post = (torch.eye(n, dtype=p_prior.dtype) - k @ h) @ p_prior
    p_post = 0.5 * (p_post + p_post.T)
    broke = ~(torch.isfinite(x_post).all()
              & torch.isfinite(p_post).all()
              & (torch.diagonal(p_post) > 0.0).all())
    coast = broke & torch.isfinite(z).all()
    x_post = torch.where(coast, x_prior, x_post)
    p_post = torch.where(coast, p_prior, p_post)
    return KalmanState(x=x_post, p=p_post), innovation


def kalman_gain(params: KalmanParams, prior: KalmanState) -> Tensor:
    """The gain K = P^ H^T S^-1 of the measurement update, (n, m)."""
    h = params.h
    s = h @ prior.p @ h.T + params.r
    return _solve(s, h @ prior.p.T).T


def innovation_nis(
    params: KalmanParams, prior: KalmanState, z: Tensor
) -> Tensor:
    """Normalized innovation squared nu^T S^-1 nu, a () scalar (NaN for a
    NaN observation)."""
    h = params.h
    s = h @ prior.p @ h.T + params.r
    nu = z - h @ prior.x
    return nu @ _solve(s, nu)


def step(
    params: KalmanParams, state: KalmanState, z: Tensor,
    u: Tensor | None = None,
):
    """One predict+correct cycle. Returns (posterior, prior, innovation)."""
    prior = time_update(params, state, u)
    posterior, innovation = measurement_update(params, prior, z)
    return posterior, prior, innovation


def filter_trace(params: KalmanParams, state0: KalmanState, zs: Tensor):
    """Run the KF along a trace ``zs`` of shape (T, m), one `step` per row.

    Returns (final_state, (xs_post, xs_prior)), the xs of shape (T, n)."""
    state, post_xs, prior_xs = state0, [], []
    for z in zs:
        state, prior, _ = step(params, state, z)
        post_xs.append(state.x)
        prior_xs.append(prior.x)
    return state, (torch.stack(post_xs), torch.stack(prior_xs))


def paper_params(
    q: float = 1e-3,
    r: float = 1e-1,
    h: tuple[float, float, float] = (1.0, 1.0, 1.0),
    dtype=torch.float32,
) -> KalmanParams:
    """Scalar IPC-pressure state, 3 normalized NoC observations, random
    walk (A = 1, no control)."""
    return KalmanParams(
        a=torch.eye(1, dtype=dtype),
        b=torch.zeros((1, 1), dtype=dtype),
        h=torch.tensor(h, dtype=dtype).reshape(3, 1),
        q=torch.eye(1, dtype=dtype) * q,
        r=torch.eye(3, dtype=dtype) * r,
    )


def one_step_prediction(params: KalmanParams, state: KalmanState) -> Tensor:
    """The forecast for the next epoch's state, `A x_k`."""
    return params.a @ state.x


def normalize_observations(raw: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Scale raw counters into [-1, 1] (paper §3.2 preprocessing)."""
    mid = 0.5 * (hi + lo)
    half = torch.clamp(0.5 * (hi - lo), min=1e-9)
    return torch.clamp((raw - mid) / half, -1.0, 1.0)


def binarize(x_post: Tensor, threshold: float | Tensor = 0.0) -> Tensor:
    """Paper §3.2: KF output > 0 => IPC will decline => reconfigure (1)."""
    return (x_post > threshold).to(torch.int32)


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """a (..., i, k) @ b (..., k, j) with each k-sum taken in index order,
    one multiply and one add at a time: the same bits at every batch size
    (a batched matmul may pick its order by the batch)."""
    if a.shape[-1] == 1:
        return a * b                    # one product per element, no sum
    terms = (a.unsqueeze(-1) * b.unsqueeze(-3)).unbind(-2)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _mv(a: Tensor, v: Tensor) -> Tensor:
    return _mm(a, v[..., None])[..., 0]


def _innovation_cov(params: KalmanParams, p_prior: Tensor) -> Tensor:
    h = params.h
    return _mm(_mm(h, p_prior), h.T) + params.r


def batched_step(
    params: KalmanParams, states: KalmanState, z: Tensor,
    u: Tensor | None = None,
):
    """`step` over a bank of independent filters sharing ``params``: states
    x (B, n), p (B, n, n), observations z (B, m), controls u (B, u) or None.
    The batch dimension is written out (the JAX package vmaps `step`) and
    every product sums in index order (`_mm`), so a filter's bits do not
    depend on the bank's size; the coast is decided per filter.  Returns
    (posterior, prior, innovation), each with the leading B."""
    return batched_update(params, states, z, u)[:3]


def batched_update(
    params: KalmanParams, states: KalmanState, z: Tensor,
    u: Tensor | None = None,
):
    """`batched_step` that also returns the innovation covariance S (B, m,
    m) and the gain K (B, n, m) it used, for the callers that need them
    (`innovation_nis`, `kalman_gain`) without forming them again."""
    x, p = states
    a, h = params.a, params.h
    x_prior = _mv(a, x)
    if u is not None:
        x_prior = x_prior + _mv(params.b, u)
    p_prior = _mm(_mm(a, p), a.T) + params.q
    s = _innovation_cov(params, p_prior)                    # (B, m, m)
    k = _solve(s, _mm(h, p_prior.transpose(-1, -2))).transpose(-1, -2)
    innovation = z - _mv(h, x_prior)                        # (B, m)
    x_post = x_prior + _mv(k, innovation)
    n = params.state_dim
    eye = torch.eye(n, dtype=p_prior.dtype, device=p_prior.device)
    p_post = _mm(eye - _mm(k, h), p_prior)
    p_post = 0.5 * (p_post + p_post.transpose(-1, -2))
    broke = ~(torch.isfinite(x_post).all(-1)
              & torch.isfinite(p_post).all((-2, -1))
              & (torch.diagonal(p_post, dim1=-2, dim2=-1) > 0.0).all(-1))
    coast = broke & torch.isfinite(z).all(-1)
    x_post = torch.where(coast[:, None], x_prior, x_post)
    p_post = torch.where(coast[:, None, None], p_prior, p_post)
    return (KalmanState(x=x_post, p=p_post), KalmanState(x=x_prior, p=p_prior),
            innovation, s, k)


def batched_nis(s: Tensor, innovation: Tensor) -> Tensor:
    """`innovation_nis` over a bank from `batched_update`'s S (B, m, m) and
    innovation (B, m): (B,), sums in index order."""
    sol = _solve(s, innovation[..., None])[..., 0]
    return _mm(innovation[..., None, :], sol[..., None])[..., 0, 0]


def batched_trace(p: Tensor) -> Tensor:
    """tr(P) over a bank (B, n, n) -> (B,), summed in index order."""
    diag = torch.diagonal(p, dim1=-2, dim2=-1).unbind(-1)
    acc = diag[0]
    for d in diag[1:]:
        acc = acc + d
    return acc


def batched_filter_trace(params: KalmanParams, states0: KalmanState,
                         zs: Tensor):
    """`filter_trace` over a bank: ``zs`` (T, B, m), ``states0`` leaves with
    the leading B.  Each row steps through `batched_step`, so a filter's
    bits do not depend on B.  Returns (final_states, (xs_post, xs_prior)),
    the xs of shape (T, B, n)."""
    states, post_xs, prior_xs = states0, [], []
    for z in zs:
        states, prior, _ = batched_step(params, states, z)
        post_xs.append(states.x)
        prior_xs.append(prior.x)
    return states, (torch.stack(post_xs), torch.stack(prior_xs))
