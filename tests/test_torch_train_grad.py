"""Port congruence of the training path's pieces below the loss: remat
"full" and "dots" against "none" (bitwise: recomputing changes no
number), the set of weight-decayed leaves against the reference's, flash
attention's backward (`flash_attention_plain_bwd`, and autograd through
the CPU path) against `jax.vjp` of the reference's `attend_ref` in f32
(relative L2 1e-5), and the scans' CPU paths staying differentiable."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch._util import tree_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from _torch_train import one_thread  # noqa: F401  (autouse fixture)


def rel_l2(a, b) -> float:
    a = np.asarray(a.detach().double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def model():
    cfg = tconfigs.smoke("llama3.2-3b")
    return dict(cfg=cfg,
                params_t=tlm.make_lm(torch.Generator().manual_seed(0), cfg),
                batch_t=tsyn.make_dataset(cfg, 32, 2, device="cpu").batch(0))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_number(model, remat):
    cfg = model["cfg"]
    base = dataclasses.replace(cfg, remat="none")
    out = {}
    for c in (base, dataclasses.replace(cfg, remat=remat)):
        m, g = tstep.value_and_grad(tstep.make_loss_fn(c), model["params_t"],
                                    model["batch_t"])
        out[c.remat] = (m["loss"], dict(tree_leaves(g)))
    assert torch.equal(out["none"][0], out[remat][0])
    for p, g in out["none"][1].items():
        assert torch.equal(g, out[remat][1][p]), p


def test_remat_recomputes_in_the_backward(model):
    """Under "full" the checkpointed super-blocks run twice (forward and
    recompute) when gradients are taken, once under no_grad."""
    cfg = model["cfg"]
    calls = []
    orig = tlm._apply_block

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tlm._apply_block = counting
    try:
        tstep.value_and_grad(tstep.make_loss_fn(cfg), model["params_t"],
                             model["batch_t"])
        n_grad = len(calls)
        calls.clear()
        with torch.no_grad():
            tlm.lm_loss(model["params_t"], model["batch_t"], cfg)
    finally:
        tlm._apply_block = orig
    assert n_grad == 2 * cfg.n_layers and len(calls) == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b",
                                  "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b"])
def test_decayed_leaves_are_the_references(arch):
    """The reference decays its leaves with ndim >= 2, stacked over
    n_super: a block's norm scale is decayed, the final norm's is not.
    The port's per-layer leaves decay exactly the same set."""
    cfg_j, cfg_t = jconfigs.smoke(arch), tconfigs.smoke(arch)
    shapes = jax.eval_shape(lambda k: jlm.make_lm(k, cfg_j)[0],
                            jax.random.PRNGKey(0))
    pattern, n_super = tlm.layer_pattern(cfg_t)
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(getattr(p, "key", getattr(p, "idx", None))
                     for p in path)
        if len(leaf.shape) < 2:
            continue
        if keys[0] == "blocks":
            want |= {(keys[0], keys[1], i, *keys[2:])
                     for i in range(n_super)}
        else:
            want.add(keys)
    params = tlm.make_lm(torch.Generator().manual_seed(0), cfg_t)
    mask = {p: topt.decays(p, t) for p, t in tree_leaves(params)}
    assert {p for p, d in mask.items() if d} == want
    assert mask[("blocks", 0, 0, "ln" if cfg_t.ssm_state else "ln1",
                 "scale")]
    assert not mask[("final_norm", "scale")]


@pytest.mark.parametrize("causal,window,cap,h,kv,d", [
    (True, None, None, 6, 2, 64),
    (True, 16, None, 8, 8, 80),
    (True, None, 30.0, 6, 1, 128),
    (False, None, None, 10, 2, 128),
])
def test_plain_backward_matches_jax_grad(causal, window, cap, h, kv, d):
    """`flash_attention_plain_bwd` against `jax.vjp` of the reference's
    `attend_ref`, f32, relative L2 1e-5; autograd through the port's
    plain forward (the CPU path) gives the same."""
    rng = np.random.default_rng(h + d)
    b, s = 2, 45
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in
                   ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out, vjp = jax.vjp(lambda q, k, v: jattn.attend_ref(q, k, v, **kw),
                       q, k, v)
    want = vjp(do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = fa_ops.flash_attention_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5,
                               rtol=1e-5)
    got = fa_ops.flash_attention_plain_bwd(tq, tk, tv, o, tdo, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fa_ops.flash_attention(*leaves, **kw).backward(tdo)
    for name, g, a, w in zip("qkv", got, leaves, want):
        assert rel_l2(g, w) <= 1e-5, (name, rel_l2(g, w))
        assert rel_l2(a.grad, w) <= 1e-5, (name, rel_l2(a.grad, w))


def test_scans_stay_differentiable_on_the_cpu():
    """B6's and B7's entry points on CPU tensors run plain torch, which
    autograd differentiates (the guard refuses only CUDA tensors)."""
    from repro_torch.kernels.mamba_scan import fused

    g = torch.Generator().manual_seed(0)
    a = torch.rand((1, 8, 4, 2), generator=g).requires_grad_()
    b = torch.randn((1, 8, 4, 2), generator=g).requires_grad_()
    hs, last = ms_ops.mamba_chunk_scan(a, b, torch.zeros((1, 4, 2)))
    (hs.sum() + last.sum()).backward()
    assert a.grad is not None and b.grad is not None
    dt = torch.rand((1, 6, 4), generator=g).requires_grad_()
    y, _ = fused.fused_mamba_scan(dt, torch.randn((1, 6, 4), generator=g),
                                  torch.randn((1, 6, 2), generator=g),
                                  torch.randn((1, 6, 2), generator=g),
                                  -torch.rand((4, 2), generator=g))
    y.sum().backward()
    assert dt.grad is not None and bool(torch.isfinite(dt.grad).all())


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b",
                                  "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b"])
def test_every_leaf_receives_a_gradient(arch):
    """`value_and_grad` refuses a leaf without a gradient; on each
    ported architecture's smoke config every leaf reaches the loss, so a
    step takes no such leaf for granted."""
    cfg = tconfigs.smoke(arch)
    params = tlm.make_lm(torch.Generator().manual_seed(0), cfg)
    batch = tsyn.make_dataset(cfg, 16, 2, device="cpu").batch(0)
    metrics, grads = tstep.value_and_grad(tstep.make_loss_fn(cfg), params,
                                          batch)
    assert np.isfinite(float(metrics["loss"]))
    for (p, g), (_, t) in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.shape == t.shape and g.dtype == t.dtype, p


def test_a_leaf_without_gradient_raises():
    """An output computed outside autograd (as a kernel's written through
    ctypes would be) leaves the weights behind it without a gradient:
    `value_and_grad` names them instead of training them on zeros."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 4), generator=g),
              "blocks": [{"v": torch.randn((4,), generator=g)}]}

    def loss_fn(p, batch):
        loss = (batch["x"] @ p["w"]).sum() + p["blocks"][0]["v"].detach().sum()
        return loss, {"loss": loss}

    with pytest.raises(RuntimeError, match="blocks/0/v"):
        tstep.value_and_grad(loss_fn, params, {"x": torch.ones((2, 3))})
