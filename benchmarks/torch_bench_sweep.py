"""Perf-trajectory harness of the PyTorch + CUDA port: serial against
batched NoC sweeps, appended to the port's ledger (BENCH_noc_torch.json).

Times the Fig. 2/3-style grid (workloads x static VC ratios x seeds):

  * serial  — one `simulate` per grid point on the dense "ref" engine
              (plain torch, hundreds of launches a simulated cycle), one
              point after another: every row's baseline stays the same
              engine whatever the batched arm runs;
  * batched — `sim.simulate_batch` of the whole grid on ``sim_backend``:
              on the default "fused" engine each epoch is ONE launch of
              the fused cycle kernel (B2) whose grid is the batch.

Each arm is run twice and both calls are timed: the first call
(`*_total_s`) and the steady one (`*_steady_s`); `*_compile_s` is the
first call's excess over the steady one.  The kernels are built before
either arm is timed, so nvcc's first-use build is charged to neither.
The batched arm's rows are held bitwise against the serial arm's before
any time is reported.  `batched_launches_per_epoch` counts launches of
the engine's cycle kernel over the batched arm's first call, per epoch:
1 on "fused" (the whole grid in one B2 launch), n_points x epoch_len on
"arb" (B1 once per row and cycle), 0 on "ref" and on the CPU (the plain
versions launch nothing).  The device-sharded arm of the JAX package's
bench is left out: on one card the batch is the grid.

    PYTHONPATH=src python -m benchmarks.torch_bench_sweep [--smoke]
        [--epochs N] [--epoch-len N] [--seeds N] [--backend fused|ref|arb]
        [--device cpu] [--bench-json PATH] [--profile DIR]

Non-smoke rows are appended through `repro_torch.obs.ledger.append`.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch

from repro_torch._util import resolve_device
from repro_torch.core.noc import sim
from repro_torch.kernels.noc_cycle import ops as noc_ops
from repro_torch.obs import ledger, profiling

BENCH_PATH = ledger.BENCH_PATH
DEFAULT_ENGINE = sim.NoCConfig().engine   # "fused"


def grid(workloads, ratios, seeds, **overrides) -> tuple[list, list]:
    cfgs, profs = [], []
    for wl in workloads:
        for g in ratios:
            for s in seeds:
                cfgs.append(sim.NoCConfig(
                    mode="static", static_gpu_vcs=g, seed=s, **overrides))
                profs.append(wl)
    return cfgs, profs


def build_kernels(dev: torch.device) -> None:
    """Build and load the NoC kernels' library (nvcc on first use) so that
    no timed arm pays for it; nothing on the CPU."""
    if dev.type == "cuda":
        from repro_torch.kernels.noc_cycle import kernel

        kernel.library()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_serial(cfgs, profs, dev) -> tuple[float, list]:
    """One `simulate` per point on the "ref" engine, one after another."""
    _sync(dev)
    t0 = time.perf_counter()
    rows = [sim.simulate(cfg, prof, device=dev, engine="ref")
            for cfg, prof in zip(cfgs, profs)]
    _sync(dev)
    return time.perf_counter() - t0, rows


def time_batched(cfgs, profs, dev, engine: str) -> tuple[float, object]:
    """The whole grid as one `simulate_batch` on ``engine``."""
    _sync(dev)
    t0 = time.perf_counter()
    res = sim.simulate_batch(cfgs, profs, device=dev, engine=engine)
    _sync(dev)
    return time.perf_counter() - t0, res


def cycle_launches() -> int:
    """Launches of the NoC cycle kernels (B1, B2, B3) so far (the
    counters are read, never reset, so a caller's own count stands)."""
    return sum(noc_ops.LAUNCHES.values())


def mismatch(rows: list, batched) -> str | None:
    """The first SimResult field where a batched row differs from its
    serial row, bitwise, or None."""
    for b, row in enumerate(rows):
        for name in row._fields:
            x, y = getattr(row, name), getattr(batched, name)
            pairs = (zip(x._fields, x, y) if name == "counters"
                     else [(name, x, y)])
            for field, a, c in pairs:
                if not torch.equal(a, c[b]):
                    return f"row {b} field {field}"
    return None


def state_bytes(stc) -> int:
    """Per-row carry footprint of the cycle engine's state (bytes)."""
    leaves = []
    for part in sim.init_sim_state(stc):
        leaves += list(part) if isinstance(part, tuple) else [part]
    return int(sum(x.numel() * x.element_size() for x in leaves))


def run(n_epochs: int = 8, epoch_len: int = 100, seeds=(0, 1),
        smoke: bool = False, sim_backend: str = DEFAULT_ENGINE,
        device=None) -> dict:
    """Default grid: PATH / LIB / STO / MUM x ratios 1-3 x seeds 0-1, 24
    points x 800 cycles; smoke: PATH / LIB x ratios 1, 3 x seed 0, 4 x 50.

    Raises RuntimeError if a batched row differs from its serial row."""
    if sim_backend not in sim.ENGINES:
        raise ValueError(f"unknown cycle engine {sim_backend!r}; expected "
                         f"one of {sim.ENGINES}")
    dev = resolve_device(device)
    workloads = ("PATH", "LIB") if smoke else ("PATH", "LIB", "STO", "MUM")
    ratios = (1, 3) if smoke else (1, 2, 3)
    if smoke:
        n_epochs, epoch_len, seeds = 4, 50, (0,)
    cfgs, profs = grid(workloads, ratios, seeds, n_epochs=n_epochs,
                       epoch_len=epoch_len, engine=sim_backend)
    build_kernels(dev)

    serial_total, serial_rows = time_serial(cfgs, profs, dev)

    before = cycle_launches()
    batched_first, batched_res = time_batched(cfgs, profs, dev, sim_backend)
    launches = cycle_launches() - before
    where = mismatch(serial_rows, batched_res)
    if where is not None:
        raise RuntimeError(f"batched {sim_backend!r} arm differs from the "
                           f"serial ref arm at {where}")
    batched_steady, _ = time_batched(cfgs, profs, dev, sim_backend)
    serial_steady, _ = time_serial(cfgs, profs, dev)

    return {
        "bench": "noc_sweep_serial_vs_batched",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "backend": dev.type,
        "sim_backend": sim_backend,
        "state_bytes": state_bytes(cfgs[0].static_spec()),
        "smoke": smoke,
        "grid": {"workloads": list(workloads), "ratios": list(ratios),
                 "seeds": list(seeds), "n_epochs": n_epochs,
                 "epoch_len": epoch_len, "n_points": len(cfgs)},
        "serial_total_s": round(serial_total, 3),
        "serial_steady_s": round(serial_steady, 3),
        "serial_compile_s": round(max(serial_total - serial_steady, 0.0), 3),
        "batched_total_s": round(batched_first, 3),
        "batched_steady_s": round(batched_steady, 3),
        "batched_compile_s": round(max(batched_first - batched_steady, 0.0),
                                   3),
        "batched_launches_per_epoch": launches / n_epochs,
        "batched_bitwise_serial": True,   # checked above
        "speedup_end_to_end": round(serial_total / max(batched_first, 1e-9),
                                    2),
        "speedup_steady": round(serial_steady / max(batched_steady, 1e-9), 2),
    }


def append_record(rec: dict, path: str = BENCH_PATH) -> dict:
    """Append a bench row through the port's ledger
    (`repro_torch.obs.ledger.append`: stamped, validated, mirrored to
    LEDGER_noc_torch.jsonl beside ``path``); returns the stamped row."""
    return ledger.append(rec, path=path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid for CI (no ledger append)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--epoch-len", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--backend", choices=sim.ENGINES, default=DEFAULT_ENGINE,
                    help="cycle engine of the batched arm (the serial arms "
                         "always run the dense ref engine)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--bench-json", default=BENCH_PATH,
                    help="the ledger a non-smoke row is appended to")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture one torch.profiler trace of the whole "
                         "run into DIR")
    args = ap.parse_args(argv)
    with profiling.trace(args.profile, "bench_sweep"):
        rec = run(n_epochs=args.epochs, epoch_len=args.epoch_len,
                  seeds=tuple(range(args.seeds)), smoke=args.smoke,
                  sim_backend=args.backend, device=args.device)
    if not args.smoke:
        rec = append_record(rec, args.bench_json)
    print(json.dumps(rec, indent=2))
    if not args.smoke:
        print(f"appended to {os.path.normpath(args.bench_json)}")
    print(f"end-to-end speedup over the serial ref path: "
          f"{rec['speedup_end_to_end']:.1f}x (steady-state "
          f"{rec['speedup_steady']:.1f}x, "
          f"{rec['batched_launches_per_epoch']:g} cycle-kernel launch(es) "
          f"an epoch, batched rows bitwise the serial rows)")
    return rec


if __name__ == "__main__":
    main()
    sys.exit(0)
