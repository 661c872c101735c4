"""The one-card dry run: every (architecture x input-shape) cell's step
built on the meta device, its FLOPs and bytes counted op by op, and its
roofline on one H100.  Nothing runs on the card and nothing is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

For each cell (`specs.all_cells()`, or one ``--arch`` / ``--shape``):
`specs.applicable` decides "skip"; the step is built on meta tensors
(`specs.make_prefill_step`, `specs.make_serve_step`, or
`train.step.make_train_step` over `specs.abstract_train_state` and
`specs.batch_struct`); `launch.op_cost.count` runs it under its dispatch
mode and gives the FLOPs and bytes (every layer, the kernels' plain
versions, a train step's backward and remat recompute included);
`roofline.analyze` turns them into the three terms at one H100's peaks.
`memory` holds the bytes of the step's argument and output trees (the
output tensors the step writes in place counted as aliases), their
total beside the card's 80 GB, and ``fits_one_card``; the step's
temporaries are not counted (a meta run holds no buffers).  Records land
in results/dryrun_torch/card_<arch>_<shape>.json; an inapplicable cell
is recorded as "skip" and a failing one as "error" with its traceback,
as the JAX package's dry run records them.  The mesh is "card": one chip.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

import repro_torch.configs as configs
from repro_torch.launch import op_cost, roofline, specs
from repro_torch.train import step as step_lib

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESH = "card"


def build_cell(arch: str, shape: str, *, cfg=None, cell=None,
               variant: int = step_lib.BALANCED):
    """(step, args, cfg, cell) of one cell on the meta device; ``cfg`` /
    ``cell`` override the arch's published config and the named shape.
    Raises ValueError naming "skipped" on an inapplicable cell."""
    cfg = configs.get(arch) if cfg is None else cfg
    cell = specs.SHAPES[shape] if cell is None else cell
    if not specs.applicable(arch, shape):
        raise ValueError(f"{arch} x {shape}: skipped (sub-quadratic "
                         "long-context decode only)")
    if cell.kind == "train":
        opt_cfg = specs.default_opt_cfg(cfg)
        step = step_lib.make_train_step(cfg, opt_cfg, variant=variant)
        args = (specs.abstract_train_state(cfg, opt_cfg),
                specs.batch_struct(cfg, cell))
    elif cell.kind == "prefill":
        step = specs.make_prefill_step(cfg)
        args = (specs.abstract_params(cfg), specs.batch_struct(cfg, cell))
    else:
        step = specs.make_serve_step(cfg)
        args = (specs.abstract_params(cfg),
                *specs.abstract_decode_inputs(cfg, cell))
    return step, args, cfg, cell


def tensors(tree) -> list:
    """The tensor leaves of a tree of dicts, sequences, NamedTuples and
    dataclasses (`lm.DecodeState` is a dataclass)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for part in tree for t in tensors(part)]
    return []


def _nbytes(ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def memory(args, out) -> dict:
    """Argument and output bytes of a step's meta trees; an output tensor
    that is one of the arguments (written in place) is an alias."""
    ins = tensors(args)
    outs = tensors(out)
    in_ids = {id(t) for t in ins}
    alias = [t for t in outs if id(t) in in_ids]
    mem = {
        "argument_size_in_bytes": _nbytes(ins),
        "output_size_in_bytes": _nbytes(outs),
        "alias_size_in_bytes": _nbytes(alias),
    }
    mem["total_hbm_bytes"] = (mem["argument_size_in_bytes"]
                              + mem["output_size_in_bytes"]
                              - mem["alias_size_in_bytes"])
    mem["card_hbm_bytes"] = roofline.HBM_CAP
    mem["fits_one_card"] = mem["total_hbm_bytes"] <= roofline.HBM_CAP
    return mem


def record_name(arch: str, shape: str, variant: int = 0) -> str:
    return f"{MESH}_{arch}_{shape}" + (f"_v{variant}" if variant else "") \
        + ".json"


def run_cell(arch: str, shape: str, *, out_dir: str = RESULTS_DIR,
             variant: int = step_lib.BALANCED, cfg=None,
             cell=None) -> dict:
    t0 = time.time()
    record: dict = {
        "arch": arch, "shape": shape, "mesh": MESH, "mesh_shape": [1],
        "variant": variant, "options": {},
    }
    try:
        step, args, cfg, cell = build_cell(arch, shape, cfg=cfg, cell=cell,
                                           variant=variant)
        t_build = time.time() - t0
        out, cost = op_cost.count(step, *args)
        t_count = time.time() - t0 - t_build
        rl = roofline.analyze(
            {"flops": cost.flops, "bytes accessed": cost.bytes},
            roofline.CollectiveStats(), 1)
        mf = roofline.model_flops(cfg, cell)
        record.update({
            "status": "ok",
            "build_s": round(t_build, 2),
            "count_s": round(t_count, 2),
            "cost": {"flops": cost.flops, "bytes accessed": cost.bytes},
            "memory": memory(args, out),
            "collectives": {"wire_bytes_per_chip": 0.0, "count": 0,
                            "by_kind": {}},
            "roofline": rl.to_dict(),
            "model_flops_global": mf,
            "model_flops_per_chip": mf,
            "useful_flops_ratio": (mf / rl.flops_per_chip
                                   if rl.flops_per_chip else None),
        })
        del out, args
    except ValueError as e:
        if "skipped" in str(e):
            record.update({"status": "skip", "reason": str(e)})
        else:
            record.update({"status": "error", "error": str(e),
                           "traceback": traceback.format_exc()})
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        record.update({"status": "error", "error": str(e)[:2000],
                       "traceback": traceback.format_exc()[-4000:]})

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, record_name(arch, shape, variant)),
              "w") as f:
        json.dump(record, f, indent=1, default=float)
    return record


def summary(rec: dict) -> str:
    line = f"[dryrun] {MESH} {rec['arch']} {rec['shape']}: {rec['status']}"
    if rec["status"] == "ok":
        rl, mem = rec["roofline"], rec["memory"]
        line += (f" dom={rl['dominant']} t={rl['step_time_s']:.4f}s "
                 f"flops={rl['flops_per_chip']:.3e} "
                 f"bytes={rl['hbm_bytes_per_chip']:.3e} "
                 f"hbm={mem['total_hbm_bytes'] / 1e9:.1f}GB "
                 f"fits={mem['fits_one_card']} count={rec['count_s']:.1f}s")
    elif rec["status"] == "error":
        line += f" {rec['error'][:200]}"
    return line


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch/--shape required unless --all")
    cells = specs.all_cells() if args.all else [(args.arch, args.shape)]
    recs = []
    for arch, shape in cells:
        rec = run_cell(arch, shape, out_dir=args.out, variant=args.variant)
        print(summary(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
