"""The launch paths of B1 (switch arbitration) and B4 (the KF bank) of the
PyTorch + CUDA port, measured on one card, for one tree or two in turns.

    python3 benchmarks/torch_launch_ab.py [--src DIR] [--epochs N]
    python3 benchmarks/torch_launch_ab.py --ab OTHER_ROOT [--epochs N] \
        [--out results/launch_ab.json]

The first form measures the package under ``--src`` (default: this tree's
src/) in this process and prints one JSON line.  The second runs the first
form in a process of its own for OTHER_ROOT's src/ and for this tree, in
the turns other, this, this, other, prints each line and a table of the
medians, and writes them all to --out.  Each tree builds its own kernels
(nvcc, into its build/).  Needs a CUDA card; imports no JAX.

What it measures, through the public entry points that both trees have:
  floor     a one-element torch op (add_): events ms per call, device ms
  fleet     FleetKF(65,536).epoch, M = 3: wall ms per epoch over 200
            epochs (median of 3 runs, each ending in a sync; the signals are
            not kept), events ms per call of one epoch, and under
            torch.profiler over 20 epochs (`per_call`) the kernels launched,
            the device records and their device ms per epoch
  kf_bank   kf_bank_step at n = 1,048,576, M = 3: events ms per call,
            `per_call` over 50 calls, and the bytes it must move
  arb       arbitrate_lanes on the dense operands router_cycle builds (4 x
            36 lanes): events ms per call, `per_call` over 20 calls
  engine    the wall of simulate_with_trace(engine="arb") over N epochs x
            500 cycles for the four cases of chip_smoke.py's phase 4, and
            a digest of each run's counters (equal between trees that
            agree)
            (--epochs 0 skips it)
  paper     the wall of one paper-grid simulate (kf, SHIFT_PATH_BFS, 120 x
            500 cycles, fused engine; median of 3) on a seeded
            torch.Generator's streams (counters equal between trees that
            agree) and on the tree's default streams, and one such run
            under torch.profiler: kernels launched, device records, their
            device ms and B2's
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


def per_call(cs, fn, n: int) -> dict:
    """``n`` calls of ``fn`` under torch.profiler (chip_smoke's
    `device_launches`): kernels launched per call (the host's launch
    calls), device records per call (kernels, memsets and copies the card's
    tracing recorded) and their summed device ms per call, and whether the
    tracing recorded at least as many records as launches (when it did not,
    the two device numbers are low)."""
    launches, records = cs.device_launches(fn, n)
    return dict(launches=launches / n, records=len(records) / n,
                dev_ms=sum(ms for _, ms in records) / n,
                complete=len(records) >= launches,
                names=sorted({k[:60] for k, _ in records}))


def measure(src: str, epochs: int, tag: str) -> dict:
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch.core.allocator import PolicyConfig
    from repro_torch.core.noc import sim
    from repro_torch.core.noc.topology import make_topology
    from repro_torch.dist.kf_scheduler import FleetKF, SchedulerConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.kf_bank import kernel as kf_kernel
    from repro_torch.kernels.kf_bank import ops as kf_ops
    from repro_torch.kernels.noc_cycle import kernel, ops

    assert os.path.realpath(repro_torch.__file__).startswith(
        os.path.realpath(src)), repro_torch.__file__
    # the timing and profiling helpers and the phase-4 streams (imported
    # after the package, so the package stays the one under --src)
    sys.path.insert(1, HERE)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("torch_launch_ab: no CUDA device")
    dev = torch.device("cuda")
    t0 = time.time()
    _build.build_all([("noc_cycle", kernel.SOURCES),
                      ("kf_bank", kf_kernel.SOURCES)])
    out = dict(tag=tag, src=src, device=cs.smi_line(),
               build_s=time.time() - t0)

    one = torch.zeros(1, device=dev)
    out["floor_ms"] = cs.cuda_ms(lambda: one.add_(1), 200)
    out["floor_dev_ms"] = per_call(cs, lambda: one.add_(1), 50)["dev_ms"]

    # the fleet epoch
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    n, n_epochs = 65_536, 200
    zs = 0.7 * torch.randn((n_epochs, n, 3), generator=g, device=dev)
    cfg = SchedulerConfig(kf_q=3e-3, kf_r=2e-1)
    walls = []
    for _ in range(3):
        fleet = FleetKF(n, cfg)
        fleet.epoch(zs[0])
        torch.cuda.synchronize()
        t0 = time.time()
        for t in range(n_epochs):
            fleet.epoch(zs[t])
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3 / n_epochs)
    out["fleet_epoch_wall_ms"] = statistics.median(walls)
    out["fleet_epoch_walls_ms"] = walls
    out["fleet_epoch_ms"] = cs.cuda_ms(lambda: fleet.epoch(zs[1]), 200)
    out["fleet"] = per_call(cs, lambda: fleet.epoch(zs[2]), 20)

    # the bank step at n = 1,048,576
    big = 1_048_576
    ins = (torch.randn(big, generator=g, device=dev),
           0.1 + 1.9 * torch.rand(big, generator=g, device=dev),
           torch.randn((big, 3), generator=g, device=dev),
           torch.ones(3, device=dev), torch.full((3,), 0.2, device=dev))
    out["kf_bank_1m_ms"] = cs.cuda_ms(
        lambda: kf_ops.kf_bank_step(*ins), 200)
    out["kf_bank_1m"] = per_call(cs, lambda: kf_ops.kf_bank_step(*ins), 50)
    out["kf_bank_1m_bytes"] = 7 * 4 * big

    # arbitration on the dense operands, as the "arb" engine calls it
    args, depth = cs.dense_operands(cs.SEED + 10, dev)

    def entry():
        return ops.arbitrate_lanes(*args, depth=depth)

    out["arb_ms"] = cs.cuda_ms(entry, 200)
    out["arb"] = per_call(cs, entry, 20)

    # the "arb" engine over chip_smoke.py's phase-4 cases
    topo = make_topology()
    short = dict(n_epochs=epochs, epoch_len=500,
                 policy=PolicyConfig(warmup=1000, hold=500, revert=1500))
    faults = cs.fault_stream(topo, max(epochs, 6))
    place = cs.placement_stream(topo, max(epochs, 6))
    live = sim.NoCConfig(
        mode="kf", guard=True, control="joint",
        faults=type(faults)(*(x[:epochs] for x in faults)),
        placement=type(place)(*(x[:epochs] for x in place)), **short)
    cases = (("kf", sim.NoCConfig(mode="kf", **short), "SHIFT_PATH_BFS"),
             ("kf+guard+joint+faults+placement", live, "SHIFT_PATH_BFS"),
             ("4subnet", sim.NoCConfig(mode="4subnet", **short), "STO"),
             ("fair", sim.NoCConfig(mode="fair", **short), "STO"))
    engine = {}
    for label, c, wl in cases if epochs > 0 else ():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        res, _ = sim.simulate_with_trace(
            c, wl, device=dev, engine="arb",
            rng=torch.Generator(device=dev).manual_seed(cs.SEED))
        torch.cuda.synchronize()
        engine[label] = dict(
            wall_s=time.time() - t0,
            launches=ops.LAUNCHES["noc_arbitrate"],
            digest=[int(x.to(torch.int64).sum()) for x in res.counters])
    out["engine"] = engine

    # one paper-grid run (kf on SHIFT_PATH_BFS, 120 x 500 cycles) through
    # the fused engine: with a seeded torch.Generator (the same streams in
    # both trees) and with the tree's default streams
    paper = {}
    for label, rng in (("generator", True), ("default", False)):
        def run_once():
            return sim.simulate(
                sim.NoCConfig(mode="kf"), "SHIFT_PATH_BFS", device=dev,
                rng=torch.Generator(device=dev).manual_seed(cs.SEED)
                if rng else None)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            res = run_once()
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        # one run under torch.profiler: the device's busy ms, B2's share
        launches, recs = cs.device_launches(run_once, 1)
        paper[label] = dict(
            wall_s=statistics.median(walls), walls_s=walls,
            digest=[int(x.to(torch.int64).sum()) for x in res.counters],
            launches=launches, records=len(recs),
            dev_ms=sum(ms for _, ms in recs),
            b2_dev_ms=sum(ms for k, ms in recs if "noc_fused" in k))
    out["paper"] = paper
    return out


def summarize(rows: list[dict]) -> dict:
    """Median of each number per tag."""
    keys = ["floor_ms", "floor_dev_ms", "fleet_epoch_wall_ms",
            "fleet_epoch_ms", "kf_bank_1m_ms", "arb_ms"]
    profiled = ("fleet", "kf_bank_1m", "arb")
    table = {}
    for tag in dict.fromkeys(r["tag"] for r in rows):
        mine = [r for r in rows if r["tag"] == tag]
        med = {k: statistics.median(r[k] for r in mine) for k in keys}
        for k in profiled:
            for f in ("launches", "records", "dev_ms"):
                med[f"{k} {f}"] = statistics.median(r[k][f] for r in mine)
        for label in mine[0]["engine"]:
            med[f"engine {label} s"] = statistics.median(
                r["engine"][label]["wall_s"] for r in mine)
        for label in mine[0]["paper"]:
            for f, unit in (("wall_s", "s"), ("dev_ms", "device ms"),
                            ("b2_dev_ms", "B2 device ms"),
                            ("launches", "launches")):
                med[f"paper {label} {unit}"] = statistics.median(
                    r["paper"][label][f] for r in mine)
        table[tag] = med
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--ab", metavar="OTHER_ROOT")
    ap.add_argument("--out", default=os.path.join(HERE, "results",
                                                  "launch_ab.json"))
    a = ap.parse_args()
    if not a.ab:
        print(json.dumps(measure(os.path.abspath(a.src), a.epochs, a.tag)))
        return 0
    rows = []
    for tag, root in (("other", a.ab), ("this", HERE), ("this", HERE),
                      ("other", a.ab)):
        cmd = [sys.executable, os.path.abspath(__file__), "--src",
               os.path.join(os.path.abspath(root), "src"), "--tag", tag,
               "--epochs", str(a.epochs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"torch_launch_ab: {tag} run failed "
                             f"({proc.returncode})")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row))
        sys.stdout.flush()
        rows.append(row)
    table = summarize(rows)
    for key in table["this"]:
        print(f"{key:40s} other {table['other'][key]:10.4f}  this "
              f"{table['this'][key]:10.4f}")
    digests = {r["tag"]: ({k: v["digest"] for k, v in r["engine"].items()},
                          r["paper"]["generator"]["digest"]) for r in rows}
    same = digests["this"] == digests["other"]
    print("device records complete in every profiled session: "
          + str(all(r[k]["complete"] for r in rows for k in
                    ("fleet", "kf_bank_1m", "arb"))))
    print(f"engine counters equal between the trees: {same}")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(dict(rows=rows, medians=table, counters_equal=same), f,
                  indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
