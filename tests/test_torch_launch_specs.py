"""The port's `launch.specs` against the JAX package's: the shape cells and
their applicability are equal; `abstract_params` and
`abstract_decode_inputs` build meta tensors whose shapes and dtypes are
the leaves of JAX's `eval_shape` of the same builders, for every
architecture in `configs.ARCH_IDS` at its full size (the port's per-layer
blocks stacked over their layers, as `interop.lm_params` carries the
reference's across); and the prefill / serve steps run on meta tensors and
give the logits' shapes.  Nothing is allocated or drawn on either side,
so the full-size configs are cheap."""
import jax
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import lm

STACKED = ("enc_blocks", "dec_blocks")


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(x.dtype)


def _jax_leaves(tree) -> dict:
    """{path: (shape, dtype)} of a JAX tree of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", None))) for k in path)
        out[key] = (tuple(leaf.shape), _dtype(leaf))
    return out


def _port_leaves(params: dict) -> dict:
    """{path: (shape, dtype)} of the port's parameter tree in the
    reference's layout: each pattern position's per-layer blocks (and an
    encoder-decoder's block lists) stacked over their layers."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(node.shape), _dtype(node))

    def stacked(blocks, path):
        per = [_port_leaves(b) for b in blocks]
        for p, (shape, dt) in per[0].items():
            assert all(q[p] == (shape, dt) for q in per), path + p
            out[path + p] = ((len(per),) + shape, dt)

    for k, v in params.items():
        if k == "blocks":
            for j, layers in enumerate(v):
                stacked(layers, (k, j))
        elif k in STACKED:
            stacked(v, (k,))
        else:
            walk(v, (k,))
    return out


def test_cells_equal_jax():
    assert list(specs.SHAPES) == list(jspecs.SHAPES)
    for name, cell in specs.SHAPES.items():
        want = jspecs.SHAPES[name]
        assert (cell.name, cell.seq, cell.batch, cell.kind) == (
            want.name, want.seq, want.batch, want.kind)
    assert specs.LONG_CTX_ARCHS == jspecs.LONG_CTX_ARCHS
    assert specs.all_cells() == jspecs.all_cells()
    for arch, shape in jspecs.all_cells():
        assert specs.applicable(arch, shape) == jspecs.applicable(arch, shape)


def test_configs_list_equal_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_params_match_eval_shape(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = specs.abstract_params(cfg)
    leaves = _port_leaves(got)
    assert {str(t.device) for t in _leaf_tensors(got)} == {"meta"}
    want = _jax_leaves(jspecs.abstract_params(jcfg))
    assert sorted(leaves) == sorted(want)
    for path, (shape, dt) in want.items():
        assert leaves[path][0] == shape, path
        # the mamba mixers' f32 leaves: the port makes them as its
        # interop carries the reference's across (MAMBA1_F32 / MAMBA2_F32)
        if dt != leaves[path][1]:
            assert "mixer" in path, (path, leaves[path][1], dt)


def _leaf_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaf_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _state_leaves(state) -> list:
    """The port's decode state's leaves in jax.tree.leaves' order."""
    if isinstance(state, lm.DecodeState):
        state = (state.caches, state.shared_kv, state.length)
    return _leaf_tensors(state)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_decode_inputs_match_eval_shape(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    cell = specs.SHAPES["decode_32k"]
    token, state = specs.abstract_decode_inputs(cfg, cell)
    jtoken, jstate = jspecs.abstract_decode_inputs(
        jcfg, jspecs.SHAPES["decode_32k"])
    assert (tuple(token.shape), _dtype(token)) == (
        tuple(jtoken.shape), _dtype(jtoken))
    got = [(tuple(t.shape), _dtype(t), t.device.type)
           for t in _state_leaves(state)]
    want = [(tuple(x.shape), _dtype(x), "meta")
            for x in jax.tree.leaves(jstate)]
    assert got == want


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_steps_give_logits_shapes_on_meta(arch):
    cfg = configs.smoke(arch)
    params = specs.abstract_params(cfg)
    seq = max(64, cfg.frontend_len + 16) if not cfg.is_encoder_decoder \
        else 64
    cell = specs.ShapeCell("t", seq, 2, "prefill")
    logits = specs.make_prefill_step(cfg)(params,
                                          specs.batch_struct(cfg, cell))
    assert logits.device.type == "meta"
    assert (tuple(logits.shape), logits.dtype) == (
        (2, seq, cfg.vocab_size), torch.float32)
    token, state = specs.abstract_decode_inputs(
        cfg, specs.ShapeCell("d", seq, 2, "decode"))
    logits, _ = specs.make_serve_step(cfg)(params, token, state)
    assert logits.device.type == "meta"
    assert (tuple(logits.shape), logits.dtype) == (
        (2, 1, cfg.vocab_size), torch.float32)


def test_default_opt_cfg_reads_the_config():
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        assert specs.default_opt_cfg(cfg).moment_dtype == \
            jspecs.default_opt_cfg(jconfigs.get(arch)).moment_dtype
