"""One paper-grid run of the PyTorch + CUDA port — `sim.simulate` of kf on
SHIFT_PATH_BFS, 120 epochs x 500 cycles, fused engine, a batch of one —
timed for two trees in alternating turns on one card.

    python3 benchmarks/torch_paper_ab.py --ab OTHER_ROOT [--pairs 12] \
        [--out results/paper_ab.json]

Starts one worker process per tree (each imports its own src/, builds its
kernels with nvcc into its own build/ and runs once to warm up), then for
each pair asks one worker and then the other for one timed run (the order
flips every pair: other/this, this/other, ...), so that both trees see the
same drift of the host's speed; only one worker runs at a time.  Each turn
times two runs, each ending in a sync: on a seeded torch.Generator's
streams (the same streams in both trees; their counters must agree) and on
the tree's default streams.  Then, in turns other, this, this, other,
each tree splits a shared-stream run's host time an epoch over the steps
of its epoch loop (each step wrapped in a timer).  Prints each turn, per
tree the median and spread of each wall, per pair the difference this -
other, and the split; writes all of it to --out.  Needs a CUDA card;
imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("shared", "default")


def worker(src: str) -> None:
    """Serve timed runs of the package under ``src``: one line of stdin
    ("shared" or "default") -> one JSON line on stdout."""
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch.core.noc import sim
    from repro_torch.kernels import _build
    from repro_torch.kernels.noc_cycle import kernel, ops

    assert os.path.realpath(repro_torch.__file__).startswith(
        os.path.realpath(src)), repro_torch.__file__
    if not torch.cuda.is_available():
        raise SystemExit("torch_paper_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.build_all([("noc_cycle", kernel.SOURCES)])

    def run(mode: str) -> dict:
        rng = (torch.Generator(device=dev).manual_seed(0)
               if mode == "shared" else None)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        res = sim.simulate(sim.NoCConfig(mode="kf"), "SHIFT_PATH_BFS",
                           device=dev, rng=rng)
        torch.cuda.synchronize()
        return dict(mode=mode, wall_s=time.time() - t0,
                    launches=ops.LAUNCHES["noc_fused_cycles"],
                    digest=[int(x.to(torch.int64).sum())
                            for x in res.counters])

    def split() -> dict:
        """Host wall ms an epoch in each step of the epoch loop (each
        wrapped in a timer, no sync added), median of 3 shared-stream
        runs; "rest" is the run's wall less the steps (the loop's own
        Python, the result bookkeeping and the wait on B2 before the
        counter copy)."""
        from repro_torch.core import predictor
        from repro_torch.core.noc import router as rt
        from repro_torch.kernels.noc_cycle import fused

        spent: dict[str, float] = {}
        steps = [(sim, "epoch_inputs"), (rt, "inject_all"),
                 (sim, "lane_inputs"), (fused, "pack_state"),
                 (ops, "fused_cycle_step"), (fused, "unpack_state"),
                 (predictor, "step_probed"), (sim, "apply_policy_gated"),
                 (sim, "degrade_policy")]
        real = [getattr(mod, name) for mod, name in steps]

        def timed(fn, name):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spent[name] = spent.get(name, 0.0) + (
                        time.perf_counter() - t0)
            return call

        reps = []
        try:
            for (mod, name), fn in zip(steps, real):
                setattr(mod, name, timed(fn, name))
            for _ in range(3):
                spent.clear()
                wall = run("shared")["wall_s"]
                row = {k: v * 1e3 / 120 for k, v in spent.items()}
                row["rest"] = wall * 1e3 / 120 - sum(row.values())
                reps.append(row)
        finally:
            for (mod, name), fn in zip(steps, real):
                setattr(mod, name, fn)
        return dict(mode="split", split_ms={
            k: statistics.median(r[k] for r in reps) for k in reps[0]})

    for mode in MODES:
        run(mode)
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        mode = line.strip()
        print(json.dumps(split() if mode == "split" else run(mode)),
              flush=True)


def _reply(proc) -> dict:
    """The worker's next JSON line (other output skipped); raises if the
    worker ended."""
    for line in proc.stdout:
        if line.startswith("{"):
            return json.loads(line)
    raise SystemExit(f"torch_paper_ab: a worker ended ({proc.wait()})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--out", default=os.path.join(HERE, "results",
                                                  "paper_ab.json"))
    ap.add_argument("--worker", metavar="SRC", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker)
        return 0
    if not a.ab:
        ap.error("--ab OTHER_ROOT is required")
    roots = {"other": os.path.abspath(a.ab), "this": HERE}
    procs = {
        tag: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.join(root, "src")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for tag, root in roots.items()
    }
    try:
        for p in procs.values():
            _reply(p)

        def turn(tag: str, modes) -> list[dict]:
            out = []
            for mode in modes:
                procs[tag].stdin.write(mode + "\n")
                procs[tag].stdin.flush()
                row = _reply(procs[tag])
                row.update(tag=tag)
                print(json.dumps(row), flush=True)
                out.append(row)
            return out

        rows = []
        for i in range(a.pairs):
            order = ("other", "this") if i % 2 == 0 else ("this", "other")
            for tag in order:
                rows += [dict(r, pair=i) for r in turn(tag, MODES)]
        splits = [turn(tag, ("split",))[0]
                  for tag in ("other", "this", "this", "other")]
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=60)

    table = {}
    for mode in MODES:
        walls = {tag: [r["wall_s"] for r in rows
                       if r["tag"] == tag and r["mode"] == mode]
                 for tag in roots}
        diffs = [t - o for t, o in zip(walls["this"], walls["other"])]
        table[mode] = dict(
            walls=walls,
            median={tag: statistics.median(w) for tag, w in walls.items()},
            spread={tag: (min(w), max(w)) for tag, w in walls.items()},
            diff_median=statistics.median(diffs),
            this_slower=sum(d > 0 for d in diffs), pairs=len(diffs))
        m = table[mode]
        print(f"{mode:8s} other {m['median']['other']:.4f} s "
              f"[{m['spread']['other'][0]:.4f}, {m['spread']['other'][1]:.4f}]"
              f"  this {m['median']['this']:.4f} s "
              f"[{m['spread']['this'][0]:.4f}, {m['spread']['this'][1]:.4f}]"
              f"  this - other: median {m['diff_median']:+.4f} s, this "
              f"slower in {m['this_slower']} of {m['pairs']} pairs")
    split = {tag: {k: statistics.mean(r["split_ms"][k] for r in splits
                                      if r["tag"] == tag)
                   for k in splits[0]["split_ms"]} for tag in roots}
    print("host ms an epoch, one shared-stream paper run (mean of the two "
          "turns of each tree):")
    for k in split["this"]:
        print(f"  {k:20s} other {split['other'][k]:8.4f}  this "
              f"{split['this'][k]:8.4f}  ({split['this'][k] - split['other'][k]:+.4f})")
    digests = {r["tag"]: r["digest"] for r in rows if r["mode"] == "shared"}
    same = digests["this"] == digests["other"]
    launches = {r["launches"] for r in rows}
    print(f"shared-stream counters equal between the trees: {same}; B2 "
          f"launches per run: {sorted(launches)}")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(dict(rows=rows, table=table, split=split, splits=splits,
                       counters_equal=same), f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
