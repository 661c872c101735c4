"""The port's roofline model and one-card dry run against the JAX
package's:

  * `launch.roofline`: `analyze` (peaks passed in: the JAX package's),
    `model_flops` and `count_params` equal the JAX package's on all ten
    configs and the four shapes;
  * `specs.abstract_train_state`: meta tensors, as many bytes as the JAX
    package's abstract parameters and moments;
  * `launch.dryrun` at the tiny serving config (2 layers, d_model 768,
    vocab 512): for a prefill (B 2 x 256), a decode (B 4, 256-deep cache)
    and a train cell (B 2 x 256, remat "full"), the record's FLOPs equal
    `op_cost.count` of the same step, and sit within 2% of
    `repro.launch.hlo_cost.analyze_hlo` of the JAX package's compiled step
    at that config (read: prefill 1.00007x, decode 0.99997x, train
    0.99949x: the train count sees the backward and the remat recompute,
    as XLA's HLO does);
  * skip and error records as the JAX dry run writes them; the records
    render through both table drivers;
  * no new module of this slice imports `jax` or `repro`."""
import ast
import dataclasses
import functools
import json
import os

import jax
import pytest

import repro.configs as jconfigs
import repro_torch.configs as configs
from benchmarks import torch_gen_experiments_tables, torch_roofline_table
from repro.core.noc import trace_adapters as jta
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import analyze_hlo
from repro.train import step as jstep
from repro_torch.core.noc import trace_adapters as tta
from repro_torch.launch import dryrun, op_cost, roofline, specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAKS = dict(peak_flops=jroofline.PEAK_FLOPS, hbm_bw=jroofline.HBM_BW,
             link_bw=jroofline.LINK_BW)
TINY = {"prefill": (256, 2), "decode": (256, 4), "train": (256, 2)}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_roofline_model_equals_jax(arch):
    assert list(configs.ARCH_IDS) == list(jconfigs.ARCH_IDS)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for active in (False, True):
        assert roofline.count_params(cfg, active) == \
            jroofline.count_params(jcfg, active)
    for shape in specs.SHAPES:
        cell, jcell = specs.SHAPES[shape], jspecs.SHAPES[shape]
        assert (cell.seq, cell.batch, cell.kind) == (
            jcell.seq, jcell.batch, jcell.kind)
        assert specs.applicable(arch, shape) == jspecs.applicable(arch, shape)
        assert roofline.model_flops(cfg, cell) == \
            jroofline.model_flops(jcfg, jcell)
        assert roofline.model_flops(cfg, cell, 1000) == \
            jroofline.model_flops(jcfg, jcell, 1000)
        mf = roofline.model_flops(cfg, cell)
        cost = {"flops": 3.0 * mf, "bytes accessed": mf / 7.0}
        for wire in (0.0, 1e9):
            got = roofline.analyze(cost, roofline.CollectiveStats(wire), 4,
                                   **PEAKS)
            want = jroofline.analyze(cost, jroofline.CollectiveStats(wire), 4)
            assert got.to_dict() == want.to_dict()


def test_roofline_defaults_are_one_h100():
    rl = roofline.analyze({"flops": 989e12, "bytes accessed": 6.7e12},
                          roofline.CollectiveStats(), 1)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (1.0, 2.0, 0.0)
    assert (rl.dominant, rl.step_time_s, rl.compute_fraction) == (
        "memory", 2.0, 0.5)


def test_abstract_train_state_is_meta_and_sized_like_jax():
    cfg, jcfg = configs.smoke("zamba2-2.7b"), jconfigs.smoke("zamba2-2.7b")
    state = specs.abstract_train_state(cfg, specs.default_opt_cfg(cfg))
    jstate, _ = jspecs.abstract_train_state(jcfg,
                                            jspecs.default_opt_cfg(jcfg))
    leaves = dryrun.tensors(state)
    assert leaves and all(t.device.type == "meta" for t in leaves)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in dryrun.tensors(
            tree))

    def jbytes(tree):
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))

    assert nbytes(state.params) == jbytes(jstate.params)
    assert nbytes(state.opt) == jbytes(jstate.opt)


@functools.lru_cache(maxsize=None)
def jax_cost(kind: str) -> float:
    """`analyze_hlo` FLOPs of the JAX package's tiny step, compiled."""
    cfg = jta._tiny_serving_config()
    seq, batch = TINY[kind]
    cell = jspecs.ShapeCell(f"tiny_{kind}", seq, batch, kind)
    if kind == "train":
        opt_cfg = jspecs.default_opt_cfg(cfg)
        state, _ = jspecs.abstract_train_state(cfg, opt_cfg)
        lowered = jax.jit(jstep.make_train_step(cfg, opt_cfg)).lower(
            state, jspecs.batch_struct(cfg, cell))
    elif kind == "prefill":
        lowered = jax.jit(jspecs.make_prefill_step(cfg)).lower(
            jspecs.abstract_params(cfg), jspecs.batch_struct(cfg, cell))
    else:
        token, st = jspecs.abstract_decode_inputs(cfg, cell)
        lowered = jax.jit(jspecs.make_serve_step(cfg)).lower(
            jspecs.abstract_params(cfg), token, st)
    return analyze_hlo(lowered.compile().as_text()).flops


def tiny_record(kind, out_dir):
    seq, batch = TINY[kind]
    cell = specs.ShapeCell(f"tiny_{kind}", seq, batch, kind)
    return dryrun.run_cell("llama3.2-3b", cell.name, out_dir=str(out_dir),
                           cfg=tta._tiny_serving_config(), cell=cell), cell


@pytest.mark.parametrize("kind", sorted(TINY))
def test_dryrun_record_counts_the_step(kind, tmp_path):
    rec, cell = tiny_record(kind, tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    step, args, cfg, _ = dryrun.build_cell("llama3.2-3b", cell.name,
                                           cfg=tta._tiny_serving_config(),
                                           cell=cell)
    _, cost = op_cost.count(step, *args)
    rl = rec["roofline"]
    assert rl["flops_per_chip"] == cost.flops
    assert rl["hbm_bytes_per_chip"] == cost.bytes
    assert rl == roofline.analyze(
        {"flops": cost.flops, "bytes accessed": cost.bytes},
        roofline.CollectiveStats(), 1).to_dict()
    assert (rl["collective_s"], rl["n_chips"], rec["mesh"]) == (0.0, 1,
                                                                "card")
    assert abs(cost.flops / jax_cost(kind) - 1.0) <= 0.02
    mf = roofline.model_flops(cfg, cell)
    assert rec["model_flops_global"] == mf
    assert rec["useful_flops_ratio"] == mf / cost.flops
    mem = rec["memory"]
    assert mem["fits_one_card"] is True
    assert mem["total_hbm_bytes"] == (mem["argument_size_in_bytes"]
                                      + mem["output_size_in_bytes"]
                                      - mem["alias_size_in_bytes"])
    if kind == "decode":
        # the KV cache (2 x 2 layers x B x 256 x 4 kv heads x 96, bf16)
        # is an argument, written in place
        cache = 2 * 2 * cell.batch * cell.seq * 4 * 96 * 2
        assert mem["alias_size_in_bytes"] >= cache
        assert mem["argument_size_in_bytes"] > cache + 2 * 512 * 768
    if kind == "train":
        # the optimizer writes parameters and moments in place: all but
        # the batch (tokens, labels, mask) and the int32 step counter
        assert mem["argument_size_in_bytes"] - mem["alias_size_in_bytes"] \
            == 3 * cell.batch * cell.seq * 4 + 4
    path = tmp_path / f"card_llama3.2-3b_tiny_{kind}.json"
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rec, default=float))


def test_dryrun_skip_and_error_records(tmp_path):
    skip = dryrun.run_cell("llama3.2-3b", "long_500k", out_dir=str(tmp_path))
    assert skip["status"] == "skip" and "skipped" in skip["reason"]
    bad = dataclasses.replace(tta._tiny_serving_config(), remat="bogus")
    err = dryrun.run_cell("llama3.2-3b", "tiny_train", out_dir=str(tmp_path),
                          cfg=bad, cell=specs.ShapeCell("tiny_train", 16, 2,
                                                        "train"))
    assert err["status"] == "error"
    assert "remat" in err["error"] and "Traceback" in err["traceback"]
    assert sorted(os.listdir(tmp_path)) == [
        "card_llama3.2-3b_long_500k.json", "card_llama3.2-3b_tiny_train.json"]


def test_records_render_through_both_tables(tmp_path, capsys):
    for kind in ("decode", "train"):
        tiny_record(kind, tmp_path)
    dryrun.run_cell("llama3.2-3b", "long_500k", out_dir=str(tmp_path))
    rows = torch_roofline_table.main(["--results", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(rows) == 3
    assert "cells: 2 ok, 1 skip" in out
    assert "llama3.2-3b               tiny_train  ok     memory" in out
    text = torch_gen_experiments_tables.main(["--results", str(tmp_path)])
    lines = [line for line in text.splitlines()
             if line.startswith("| llama3.2-3b |")]
    assert len(lines) == 3
    assert any("| tiny_decode | ok |" in line and line.count("|") == 10
               for line in lines)
    assert any("| long_500k | skip | — |" in line for line in lines)


NEW_MODULES = (
    "src/repro_torch/obs/ledger.py", "src/repro_torch/launch/roofline.py",
    "src/repro_torch/launch/dryrun.py", "src/repro_torch/launch/specs.py",
    "benchmarks/torch_bench_sweep.py", "benchmarks/torch_bench_fleet_kf.py",
    "benchmarks/torch_kernels_bench.py", "benchmarks/torch_check_bench.py",
    "benchmarks/torch_run.py", "benchmarks/torch_roofline_table.py",
    "benchmarks/torch_gen_experiments_tables.py", "chip_smoke.py",
)


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_repro(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            if node.module == "benchmarks":
                names += [f"benchmarks.{a.name}" for a in node.names]
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, names
    benches = {n for n in names if n.startswith("benchmarks")}
    assert all(n == "benchmarks" or n.startswith("benchmarks.torch_")
               for n in benches), benches
    assert "import jax" not in open(os.path.join(ROOT, path)).read()
