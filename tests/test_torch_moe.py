"""Port congruence: the MoE layer (`repro_torch.models.moe`) against the
JAX package's `repro.models.moe` on the same numpy inputs and the same
carried weights, at both MoE smoke configs (grok-1: 4 experts, top-2,
gelu; llama4-maverick: 4 experts, top-1 without renormalization, silu,
one shared expert).

Cases: the config as it is; a zero router, where every probability ties
and both packages send every token to experts 0..k-1 and drop the
overflow; a forced overflow (capacity factor 0.5); two dispatch groups
(`moe_groups = 2`, the reference's vmap).

Tolerances and why:
  * Routing is discrete and held exactly: expert choices, slot-major
    capacity positions and the keep mask equal the reference's own
    arrays (read from its `_moe_group` by a spy); the gates within 1e-6
    (the f32 router's sums run in another order).
  * The aux terms (f_e, lb, zl) within 1e-6, relative and absolute.
  * The output, with ONE GEMM for both packages' expert products
    (tests/_torch_moe.py): relative L2 <= 1e-6.  With each package's own
    GEMMs the gap is their summation order: within twice the port's drift
    from itself when its expert products sum k in reversed order.
  * The port's index-form dispatch and combine equal, bitwise, a dense
    one-hot version of the same function (the reference's formulation,
    the bf16 gate cast included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

from _torch_hybrid import rel_l2, reversed_k_matmul, to_np
from _torch_moe import ARCHS, moe_params, one_gemm, reference_routes

CASES = {"as_is": {}, "zero_router": {}, "overflow":
         dict(capacity_factor=0.5), "groups": dict(moe_groups=2)}
AUX = dict(rtol=1e-6, atol=1e-6)
EXACT = 1e-6


def _layer(arch, case, seed=1):
    """(p, cfg_j, tp, cfg_t) of one MoE layer for ``case``."""
    kw = CASES[case]
    cfg_j = dataclasses.replace(jconfigs.smoke(arch), **kw)
    cfg_t = dataclasses.replace(tconfigs.smoke(arch), **kw)
    p = jmoe.make_moe(jax.random.PRNGKey(seed), cfg_j, jnp.bfloat16)
    if case == "zero_router":
        p["router"] = jnp.zeros_like(p["router"])
    return p, cfg_j, moe_params(p), cfg_t


def _x(seed, b=2, s=16, d=64):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_moe_tree_matches_jax(arch):
    """Names, shapes and types: the router f32, the experts (E, d, f) /
    (E, f, d) in the parameter type, maverick's shared expert an MLP of
    f x n_shared."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    want = jmoe.make_moe(jax.random.PRNGKey(0), cfg_j, jnp.bfloat16)
    got = tmoe.make_moe(torch.Generator().manual_seed(0), cfg_t,
                        torch.bfloat16)

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                v = tree[k]
                yield (f"{prefix}{k}", tuple(v.shape),
                       str(v.dtype).split(".")[-1])

    assert list(leaves(got)) == list(leaves(want))
    assert got["router"].dtype == torch.float32
    assert ("shared" in got) == bool(cfg_t.n_shared_experts)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_routes_and_aux_match_jax(arch, case):
    """Expert choices, slot-major positions and the keep mask exactly, the
    gates within 1e-6, and f_e, lb, zl within 1e-6 of the reference's."""
    p, cfg_j, tp, cfg_t = _layer(arch, case)
    x = _x(2)
    t = x.shape[0] * x.shape[1]
    g = tmoe.n_groups(t, cfg_t)
    assert g == jmoe.n_groups(t, cfg_j) == (2 if case == "groups" else 1)
    cap = tmoe._capacity(t // g, cfg_t)
    assert cap == jmoe._capacity(t // g, cfg_j)
    xt = x.reshape(g, t // g, -1)
    r, f_e, lb, zl = tmoe._route(tp, interop.tensor(xt), cfg_t, cap)
    for i in range(g):
        expert, gate, pos, keep = reference_routes(p, xt[i], cfg_j)
        np.testing.assert_array_equal(r.expert[i].numpy(), expert)
        np.testing.assert_array_equal(r.pos[i].numpy(), pos)
        np.testing.assert_array_equal(r.keep[i].numpy(), keep)
        np.testing.assert_allclose(r.gate[i].numpy(), gate, rtol=0,
                                   atol=1e-6)
    k = cfg_t.n_experts_active
    if case == "zero_router":
        # every probability ties: experts 0..k-1, lower index first
        want = np.repeat(np.arange(k), t // g)
        for i in range(g):
            np.testing.assert_array_equal(r.expert[i].numpy(), want)
        assert r.keep.sum().item() == k * cap
    if case == "overflow":
        assert not r.keep.all()
    with jax.disable_jit():
        _, aux = jmoe.apply_moe(p, x, cfg_j)
    got = (lb.mean(), zl.mean(), f_e.mean(dim=0))
    for name, a, b in zip(aux._fields, got, aux):
        np.testing.assert_allclose(to_np(a), to_np(b), **AUX, err_msg=name)
    # each token routes k times: the loads of a group sum to k
    np.testing.assert_allclose(f_e.sum(dim=-1).numpy(), k, rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_output_matches_jax_on_one_gemm(arch, case):
    """With one GEMM for both packages' expert products (and the shared
    expert's), the layer's output within 1e-6 relative L2 of the
    reference run eagerly, and its aux as above."""
    p, cfg_j, tp, cfg_t = _layer(arch, case)
    x = _x(3)
    with one_gemm():
        with jax.disable_jit():
            want, want_aux = jmoe.apply_moe(p, x, cfg_j)
        got, got_aux = tmoe.apply_moe(tp, interop.tensor(x), cfg_t)
    err = rel_l2(got, want)
    print(f"{arch} {case}: one GEMM, relative L2 {err:.3e}")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert err <= EXACT
    for name, a, b in zip(want_aux._fields, got_aux, want_aux):
        np.testing.assert_allclose(to_np(a), to_np(b), **AUX, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_output_gap_is_the_gemm_order(arch):
    """Each package on its own GEMMs (the reference compiled, as it runs):
    the port's output is as close to the reference's as to itself with
    only its GEMMs' summation order changed (within twice that witness).
    A flip of a bf16 rounding is rare (~1e-5 of the rounded elements), so
    the input is one group of 2,048 tokens: both distances then count tens
    of flipped elements, and the witness is not zero."""
    p, cfg_j, tp, cfg_t = _layer(arch, "as_is", seed=4)
    x = _x(5, b=16, s=128)
    xt = interop.tensor(x)
    want, _ = jax.jit(lambda p, x: jmoe.apply_moe(p, x, cfg_j))(p, x)
    got, _ = tmoe.apply_moe(tp, xt, cfg_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "matmul", reversed_k_matmul)
        witness = rel_l2(tmoe.apply_moe(tp, xt, cfg_t)[0], got)
    err = rel_l2(got, want)
    print(f"{arch}: own GEMMs, relative L2 {err:.3e}; the port against "
          f"itself with k reversed in its GEMMs {witness:.3e}")
    assert 0 < witness and err <= 2 * witness


def _dense_group(p, xg, cfg):
    """The reference's formulation in torch: one-hot dispatch and combine
    tensors (G, E, cap + 1, Tg), contracted in f32 (the combine with its
    gates cast to the activation type first), around the port's routes
    and expert MLPs."""
    g, t, d = xg.shape
    e = cfg.n_experts
    k = cfg.n_experts_active
    cap = tmoe._capacity(t, cfg)
    r, f_e, lb, zl = tmoe._route(p, xg, cfg, cap)
    grp = torch.arange(g)[:, None].expand(g, k * t)
    tok = torch.arange(t).repeat(k)[None, :].expand(g, k * t)
    idx = (grp, r.expert, r.pos, tok)
    disp = torch.zeros((g, e, cap + 1, t), dtype=xg.dtype)
    disp = disp.index_put(idx, torch.ones(()).to(xg.dtype),
                          accumulate=True)[:, :, :cap]
    xe = torch.einsum("gect,gtd->gecd", disp.float(), xg.float()).to(
        xg.dtype)
    ye = tmoe._experts(p, xe.transpose(0, 1).reshape(e, g * cap, d), cfg, r)
    ye = ye.view(e, g, cap, d).transpose(0, 1)
    comb = torch.zeros((g, e, cap + 1, t), dtype=torch.float32)
    comb = comb.index_put(idx, r.gate, accumulate=True)[:, :, :cap]
    out = torch.einsum("gect,gecd->gtd", comb.to(xg.dtype).float(),
                       ye.float()).to(xg.dtype)
    return out, f_e, lb, zl


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_index_dispatch_equals_dense_one_hot(arch, case):
    """`_moe_group` (index form) bitwise equal to the dense one-hot
    version of the same function."""
    _, _, tp, cfg_t = _layer(arch, case)
    x = interop.tensor(_x(6))
    t = x.shape[0] * x.shape[1]
    g = tmoe.n_groups(t, cfg_t)
    xg = x.reshape(g, t // g, -1)
    got = tmoe._moe_group(tp, xg, cfg_t)
    want = _dense_group(tp, xg, cfg_t)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0].abs().sum() > 0


def test_logsumexp_is_torch_logsumexp():
    """The reference's expansion of logsumexp against torch.logsumexp:
    within 1e-6 on router-sized logits, and its inf handling."""
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 3, (64, 128)).astype(np.float32))
    np.testing.assert_allclose(tmoe._logsumexp(x).numpy(),
                               torch.logsumexp(x, dim=-1).numpy(),
                               rtol=1e-6, atol=1e-6)
    inf = torch.tensor([[-np.inf, -np.inf], [np.inf, 0.0]])
    np.testing.assert_array_equal(
        tmoe._logsumexp(inf).numpy(),
        np.asarray(jax.nn.logsumexp(jnp.asarray(inf.numpy()), axis=-1)))
