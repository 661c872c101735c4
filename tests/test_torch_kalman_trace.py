"""Port congruence: the KF trace helpers (`make_params`, `filter_trace`,
`batched_filter_trace`) against the JAX package's, on the same numpy
inputs.

JAX's helpers are `lax.scan`s, and XLA keeps excess float32 precision
inside a compiled scan, so the port is held first against the reference
run eagerly (`jax.disable_jit()`), then against the compiled one:

* eager, the scalar filter (n = m = 1) agrees bitwise: every product is
  one multiply and the solve one division, in the same order;
* eager, other shapes (the paper's n = 1, m = 3 among them) agree to
  atol 2e-6 + rtol 1e-5: the m x m LU solve and the dot sums run in other
  orders in the two LAPACK / XLA builds (observed below 1e-6 over 40
  steps);
* compiled, every shape to the same atol 2e-6 + rtol 1e-5 (observed
  below 1e-6; the scalar filter below 1e-7).

`batched_filter_trace` steps through `batched_step`, whose sums run in
index order, so a filter's bits do not depend on the bank's size: each
row of a bank equals that filter run as a bank of one, bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kalman as jk
from repro_torch.core import kalman as tk

T, B = 16, 5
ATOL, RTOL = 2e-6, 1e-5
SHAPES = [(1, 1), (1, 3), (2, 3), (3, 2)]   # (n, m)


def model(n: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = (np.eye(n) * 0.9 + 0.01 * rng.standard_normal((n, n))).astype(
        np.float32)
    b = np.zeros((n, 1), np.float32)
    h = rng.standard_normal((m, n)).astype(np.float32)
    q = (np.eye(n) * 1e-2).astype(np.float32)
    r = (np.eye(m) * 0.2).astype(np.float32)
    zs = rng.standard_normal((T, B, m)).astype(np.float32)
    return (a, b, h, q, r), zs


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def t_np(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(t_np(x) for x in tree)) if hasattr(
            tree, "_fields") else tuple(t_np(x) for x in tree)
    return tree.numpy()


def check(want, got, bitwise: bool):
    for w, g in zip(jax.tree.leaves(as_np(want)), jax.tree.leaves(t_np(got))):
        assert w.shape == g.shape and w.dtype == g.dtype
        if bitwise:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("args", [
    (1.0, 0.0, 1.0, 1e-3, 0.2),
    ([1.0, 0.5], [0.0], [[1.0], [2.0], [3.0]], [2e-2], np.eye(3) * 0.1),
    (np.eye(2), np.zeros((2, 1)), np.ones((3, 2)), np.eye(2), np.eye(3)),
])
def test_make_params_matches_jax(args):
    want = jk.make_params(*args)
    got = tk.make_params(*args)
    for f in ("a", "b", "h", "q", "r"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.state_dim, got.obs_dim) == (want.state_dim, want.obs_dim)


def test_make_params_dtype():
    p = tk.make_params(1, 0, 1, 1, 1, dtype=torch.float64)
    assert all(x.dtype == torch.float64 and x.shape == (1, 1) for x in p)


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("n,m", SHAPES)
def test_filter_trace_matches_jax(n, m, compiled):
    mats, zs = model(n, m)
    z = zs[:, 0]
    jp, tp = jk.make_params(*mats), tk.make_params(*mats)
    if compiled:
        want = jk.filter_trace(jp, jk.init_state(n), jnp.asarray(z))
    else:
        with jax.disable_jit():
            want = jk.filter_trace(jp, jk.init_state(n), jnp.asarray(z))
    got = tk.filter_trace(tp, tk.init_state(n), torch.from_numpy(z))
    final, (xs_post, xs_prior) = got
    assert xs_post.shape == xs_prior.shape == (T, n)
    check(want, got, bitwise=(n, m) == (1, 1) and not compiled)


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("n,m", SHAPES)
def test_batched_filter_trace_matches_jax(n, m, compiled):
    mats, zs = model(n, m, seed=1)
    jp, tp = jk.make_params(*mats), tk.make_params(*mats)
    js0 = jk.KalmanState(x=jnp.zeros((B, n)),
                         p=jnp.tile(jnp.eye(n)[None], (B, 1, 1)))
    ts0 = tk.KalmanState(x=torch.zeros(B, n),
                         p=torch.eye(n).expand(B, n, n).clone())
    if compiled:
        want = jax.jit(jk.batched_filter_trace)(jp, js0, jnp.asarray(zs))
    else:
        with jax.disable_jit():
            want = jk.batched_filter_trace(jp, js0, jnp.asarray(zs))
    got = tk.batched_filter_trace(tp, ts0, torch.from_numpy(zs))
    assert got[1][0].shape == (T, B, n)
    check(want, got, bitwise=(n, m) == (1, 1) and not compiled)


@pytest.mark.parametrize("n,m", SHAPES)
def test_batched_filter_rows_do_not_depend_on_bank_size(n, m):
    mats, zs = model(n, m, seed=2)
    tp = tk.make_params(*mats)
    x0 = torch.linspace(-0.5, 0.5, B * n).reshape(B, n)
    p0 = torch.eye(n).expand(B, n, n) * torch.linspace(0.5, 2.0, B)[:, None,
                                                                     None]
    bank = tk.batched_filter_trace(tp, tk.KalmanState(x=x0, p=p0.clone()),
                                   torch.from_numpy(zs))
    for i in range(B):
        one = tk.batched_filter_trace(
            tp, tk.KalmanState(x=x0[i:i + 1], p=p0[i:i + 1].clone()),
            torch.from_numpy(zs[:, i:i + 1]))
        assert torch.equal(bank[0].x[i], one[0].x[0])
        assert torch.equal(bank[0].p[i], one[0].p[0])
        assert torch.equal(bank[1][0][:, i], one[1][0][:, 0])
        assert torch.equal(bank[1][1][:, i], one[1][1][:, 0])


def test_paper_filter_on_noc_observations():
    """The paper's filter (n = 1, m = 3) over a clipped random walk of
    observations in [-1, 1], 48 epochs: eager and compiled JAX both within
    the stated tolerance, and the signs the controller binarizes equal."""
    rng = np.random.default_rng(3)
    zs = np.clip(np.cumsum(rng.normal(0, 0.2, (48, 3)), 0), -1, 1).astype(
        np.float32)
    jp, tp = jk.paper_params(q=2e-2, r=0.2), tk.paper_params(q=2e-2, r=0.2)
    got = tk.filter_trace(tp, tk.init_state(1), torch.from_numpy(zs))
    with jax.disable_jit():
        eager = jk.filter_trace(jp, jk.init_state(1), jnp.asarray(zs))
    compiled = jk.filter_trace(jp, jk.init_state(1), jnp.asarray(zs))
    for want in (eager, compiled):
        check(want, got, bitwise=False)
        np.testing.assert_array_equal(
            tk.binarize(got[1][0]).numpy(),
            np.asarray(jk.binarize(want[1][0])))
