"""Flight-recorder replay on the PyTorch + CUDA port: probe captures ->
per-epoch ASCII/CSV timelines.

Runs any workload or scenario from the traffic library with the probes on
(`sim.simulate_with_trace`: on the card the probed fused cycle kernel, B3,
one launch an epoch) and renders the capture as a per-epoch timeline:
occupancy heat per subnet, arbitration grant/deny, MC queue depth, and the
KF's decision annotations (observation, innovation, gain, one-step
prediction, emitted signal, applied config): the "why did the KF flip the
VC allocation at epoch e" view.  The renderers' text is the JAX package's
(`benchmarks/noc_trace.py`) on the same capture, and a capture saved by
either package loads in the other.

    PYTHONPATH=src python3 benchmarks/torch_noc_trace.py
        [--workload SHIFT_PATH_BFS] [--mode kf] [--epochs 24]
        [--epoch-len 200] [--seed 0] [--backend fused|ref|arb]
        [--device cpu] [--csv] [--save F.npz] [--load F.npz]

The JAX package's backend names are accepted too (pallas -> fused,
pallas_arb -> arb).  Special modes:

  --check    self-validation: tiny probes-on capture (one B3 launch an
             epoch on the card), invariant checks, save/load round-trip,
             both renderers.  Exit 0 = OK.
  --record   measure the probe overhead (steady wall-clock ratio probes-on
             / probes-off: B3 against B2 on the card) and print the
             `noc_obs`-shaped row as JSON; nothing is appended.

Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

if __package__ in (None, ""):   # run as a file: make `benchmarks` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np
import torch

from repro_torch._util import resolve_device
from repro_torch.core.noc import sim
from repro_torch.kernels.noc_cycle import ops
from repro_torch.obs import ledger, probes

HEAT = " .:-=+*#%@"

# capture metadata keys stored alongside the SimTrace arrays in the npz
META_KEYS = ("workload", "mode", "n_epochs", "epoch_len", "seed", "backend")

# steady calls a side of the probe-overhead measurement takes the median of
RECORD_REPEATS = 5

# the JAX package's cycle-engine names -> the port's
ENGINE_OF = {"fused": "fused", "ref": "ref", "arb": "arb",
             "pallas": "fused", "pallas_arb": "arb"}


def capture(workload: str = "SHIFT_PATH_BFS", mode: str = "kf",
            n_epochs: int = 24, epoch_len: int = 200, seed: int = 0,
            backend: str = "fused", faults: str | None = None,
            guard: bool = False, placement: str | None = None,
            control: str = "bandwidth", device=None) -> dict:
    """Probes-on run -> flat dict of numpy arrays + run metadata."""
    engine = ENGINE_OF[backend]
    cfg = sim.NoCConfig(mode=mode, n_epochs=n_epochs, epoch_len=epoch_len,
                        seed=seed, faults=faults, guard=guard,
                        placement=placement, control=control)
    res, trace = sim.simulate_with_trace(cfg, workload, device=device,
                                         engine=engine)
    cap = {f: v.numpy() for f, v in zip(probes.SimTrace._fields, trace)}
    cap["kf_signal"] = res.kf_signal.numpy()
    cap["applied_config"] = res.applied_config.numpy()
    cap["gpu_ipc"] = res.gpu_ipc.numpy()
    cap["avg_latency"] = res.avg_latency.numpy()
    cap.update(workload=workload, mode=mode, n_epochs=n_epochs,
               epoch_len=epoch_len, seed=seed, backend=engine)
    return cap


def save(cap: dict, path: str) -> None:
    np.savez(path, **cap)


def load(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        cap = {k: f[k] for k in f.files}
    for k in META_KEYS:  # 0-d string/int arrays back to scalars
        if k in cap:
            cap[k] = cap[k].item() if cap[k].ndim == 0 else cap[k]
    return cap


def _occ_frac(cap: dict) -> np.ndarray:
    """(E, S) mean buffer occupancy as a fraction of capacity."""
    occ = cap["occ_sum"]                      # (E, S, R, P, V)
    _, S, R, P, V = occ.shape
    # sum over cycles of count / (cycles * buffers * depth); depth B is not
    # in the capture, so normalize by the observed per-buffer ceiling
    per_buf = occ.sum(axis=(2, 3, 4)) / (cap["epoch_len"] * R * P * V)
    return per_buf  # mean flits per buffer per cycle (0..B)


def render_ascii(cap: dict) -> list:
    """One line per epoch: subnet occupancy heat + KF decision annotations."""
    frac = _occ_frac(cap)
    depth_est = max(float(frac.max()), 1e-9)
    E, S = frac.shape
    has_faults = "faults_active" in cap  # older captures lack the channels
    has_place = "place_cls" in cap       # older captures lack the channel
    lines = [
        f"# workload={cap['workload']} mode={cap['mode']} "
        f"epochs={cap['n_epochs']} epoch_len={cap['epoch_len']} "
        f"seed={cap['seed']} backend={cap['backend']}",
        "#  ep |occ/subnet| grant  deny mcqMax | z(dram,push,icnt) "
        "innov0   gain0  x_pred sig cfg"
        + (" | flt rej rst ok     nis" if has_faults else "")
        + (" |  mv gpu" if has_place else ""),
    ]
    for e in range(E):
        heat = "".join(
            HEAT[min(int(frac[e, s] / depth_est * (len(HEAT) - 1)),
                     len(HEAT) - 1)]
            for s in range(S)
        )
        z = cap["z_obs"][e]
        fault_cols = ""
        if has_faults:
            # the fault -> reject -> reset -> recover story, one glyph each
            fault_cols = (
                f" | {'F' if cap['faults_active'][e] else '.':>3s}"
                f" {'R' if cap['kf_rejected'][e] else '.':>3s}"
                f" {'*' if cap['kf_reset'][e] else '.':>3s}"
                f" {'y' if cap['kf_healthy'][e] else 'n':>2s}"
                f" {float(cap['kf_nis'][e]):7.2f}"
            )
        place_cols = ""
        if has_place:
            # relocation timeline: tiles whose class moved vs the previous
            # epoch's plan, and the GPU tile count ('M' marks a migration
            # epoch)
            moves = (
                0 if e == 0
                else int((cap["place_cls"][e] != cap["place_cls"][e - 1]).sum())
            )
            n_gpu = int((cap["place_cls"][e] == 1).sum())
            place_cols = (
                f" | {('M' + str(moves)) if moves else '.':>3s} {n_gpu:3d}"
            )
        lines.append(
            f"{e:5d} |{heat:^10s}| {int(cap['arb_grant'][e].sum()):6d}"
            f" {int(cap['arb_deny'][e].sum()):5d}"
            f" {int(cap['mcq_max'][e].max()):6d} |"
            f" ({z[0]:+.2f},{z[1]:+.2f},{z[2]:+.2f})"
            f" {cap['kf_innovation'][e][0]:+.3f}"
            f" {cap['kf_gain'][e][0]:7.3f}"
            f" {cap['kf_x_pred'][e]:+.3f}"
            f" {int(cap['kf_signal'][e]):3d}"
            f" {int(cap['applied_config'][e]):3d}"
            + fault_cols
            + place_cols
        )
    return lines


def render_csv(cap: dict) -> list:
    """Machine-readable per-epoch rows (same quantities as the ASCII view)."""
    has_faults = "faults_active" in cap  # older captures lack the channels
    has_place = "place_cls" in cap       # older captures lack the channel
    cols = (
        ["epoch", "occ_sum", "arb_grant", "arb_deny", "mcq_sum", "mcq_max"]
        + [f"z_{i}" for i in range(3)]
        + [f"innovation_{i}" for i in range(3)]
        + [f"gain_{i}" for i in range(3)]
        + ["cov_trace", "x_pred", "kf_signal", "applied_config",
           "gpu_ipc", "avg_latency"]
        + (["faults_active", "kf_nis", "kf_rejected", "kf_reset",
            "kf_healthy"] if has_faults else [])
        + (["place_moves", "place_gpu_tiles"] if has_place else [])
    )
    lines = [",".join(cols)]
    for e in range(int(cap["n_epochs"])):
        row = (
            [e, int(cap["occ_sum"][e].sum()), int(cap["arb_grant"][e].sum()),
             int(cap["arb_deny"][e].sum()), int(cap["mcq_sum"][e].sum()),
             int(cap["mcq_max"][e].max())]
            + [float(v) for v in cap["z_obs"][e]]
            + [float(v) for v in cap["kf_innovation"][e]]
            + [float(v) for v in cap["kf_gain"][e]]
            + [float(cap["kf_cov_trace"][e]), float(cap["kf_x_pred"][e]),
               int(cap["kf_signal"][e]), int(cap["applied_config"][e]),
               float(cap["gpu_ipc"][e]), float(cap["avg_latency"][e])]
            + ([int(cap["faults_active"][e]), float(cap["kf_nis"][e]),
                int(cap["kf_rejected"][e]), int(cap["kf_reset"][e]),
                int(cap["kf_healthy"][e])] if has_faults else [])
            + ([0 if e == 0 else
                int((cap["place_cls"][e] != cap["place_cls"][e - 1]).sum()),
                int((cap["place_cls"][e] == 1).sum())] if has_place else [])
        )
        lines.append(",".join(str(v) for v in row))
    return lines


def check(save_path: str | None = None, device=None) -> int:
    """Self-validation: capture, invariants, round-trip, renderers.  On the
    card the capture must take one B3 launch an epoch and nothing else."""
    dev = resolve_device(device)
    ops.reset_launches()
    cap = capture(workload="PATH", n_epochs=4, epoch_len=60, device=dev)
    E, L = int(cap["n_epochs"]), int(cap["epoch_len"])
    want = ({"noc_fused_cycles": 0, "noc_fused_cycles_probed": E,
             "noc_arbitrate": 0} if dev.type == "cuda" else
            {"noc_fused_cycles": 0, "noc_fused_cycles_probed": 0,
             "noc_arbitrate": 0})
    assert dict(ops.LAUNCHES) == want, (
        f"probes-on capture launched {dict(ops.LAUNCHES)}, expected {want}")
    occ = cap["occ_sum"]
    assert occ.min() >= 0 and occ.max() <= L * 64, "occupancy out of bounds"
    assert cap["mcq_max"].min() >= 0, "negative MC queue depth"
    assert (cap["arb_grant"] >= 0).all() and (cap["arb_deny"] >= 0).all()
    assert np.isfinite(cap["kf_gain"]).all(), "non-finite Kalman gain"
    # the KF member's signal is the binarized one-step prediction
    assert (
        (cap["kf_x_pred"] > 0.0).astype(np.int32) == cap["kf_signal"]
    ).all(), "kf_signal inconsistent with one-step prediction"

    with tempfile.TemporaryDirectory() as tmp:
        path = save_path or os.path.join(tmp, "probe_capture.npz")
        save(cap, path)
        cap2 = load(path)
    for k, v in cap.items():
        np.testing.assert_array_equal(np.asarray(cap2[k]), np.asarray(v),
                                      err_msg=f"round-trip mismatch: {k}")
    a_lines, c_lines = render_ascii(cap2), render_csv(cap2)
    assert len(a_lines) == E + 2 and len(c_lines) == E + 1
    print("\n".join(a_lines))
    print(f"noc_trace check OK ({save_path or 'temporary npz'}, {E} epochs, "
          f"{want['noc_fused_cycles_probed']} B3 launches)")
    return 0


def _steady(fn, dev, repeats: int) -> float:
    """Median wall seconds of ``repeats`` calls after one warm-up call."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    fn()
    walls = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def record(backend: str = "fused", device=None) -> dict:
    """Measure the probe overhead and return the `noc_obs`-shaped row
    (printed by `main`; appended nowhere).  On the card probes-off is B2
    and probes-on is B3, one launch an epoch each; each side is the
    median of RECORD_REPEATS steady calls."""
    dev = resolve_device(device)
    engine = ENGINE_OF[backend]
    cfg = sim.NoCConfig(mode="kf", n_epochs=8, epoch_len=100)
    wl = "SHIFT_PATH_BFS"
    ops.reset_launches()
    t_off = _steady(lambda: sim.simulate(cfg, wl, device=dev, engine=engine),
                    dev, RECORD_REPEATS)
    launches_off = dict(ops.LAUNCHES)
    ops.reset_launches()
    traced = []
    t_on = _steady(lambda: traced.append(sim.simulate_with_trace(
        cfg, wl, device=dev, engine=engine)), dev, RECORD_REPEATS)
    launches_on = dict(ops.LAUNCHES)
    _, trace = traced[-1]
    rec = {
        "bench": "noc_obs",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "backend": dev.type,
        "sim_backend": engine,
        "workload": wl,
        "n_epochs": cfg.n_epochs,
        "epoch_len": cfg.epoch_len,
        "config_hash": ledger.config_hash(cfg),
        "steady_off_s": round(t_off, 6),
        "steady_on_s": round(t_on, 6),
        "probe_overhead_steady": round(t_on / max(t_off, 1e-9), 4),
        "repeats": RECORD_REPEATS,
        "launches_off": launches_off,
        "launches_on": launches_on,
        "probe_summary": probes.summarize_trace(trace),
        **ledger.run_stamp(),
    }
    problems = ledger.validate_row(rec)
    if problems:
        raise ValueError(f"malformed noc_obs row: {problems}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay NoC/KF flight-recorder captures on the port")
    ap.add_argument("--workload", default="SHIFT_PATH_BFS",
                    help="any PROFILES or SCENARIOS name")
    ap.add_argument("--mode", default="kf")
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--epoch-len", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="fused", choices=tuple(ENGINE_OF),
                    help="cycle engine (fused: B3 on the card; ref; arb); "
                         "all bitwise-identical, probes included")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--faults", metavar="NAME", default=None,
                    help="inject a registered fault scenario and render the "
                         "fault/reject/reset/recover columns")
    ap.add_argument("--guard", action="store_true",
                    help="arm the self-healing KF guard (innovation gate +"
                         " watchdog + fair-split fallback)")
    ap.add_argument("--placement", metavar="NAME", default=None,
                    help="apply a registered placement scenario and render "
                         "the relocation-timeline columns")
    ap.add_argument("--control", default="bandwidth",
                    choices=("bandwidth", "placement", "joint"),
                    help="which levers the KF signal may pull: VC bandwidth"
                         " boosts, placement relocation, or both")
    ap.add_argument("--csv", action="store_true",
                    help="emit CSV rows instead of the ASCII timeline")
    ap.add_argument("--save", metavar="F.npz", help="save the capture")
    ap.add_argument("--load", metavar="F.npz",
                    help="render a saved capture instead of simulating")
    ap.add_argument("--check", action="store_true",
                    help="self-validation (tiny capture + invariants)")
    ap.add_argument("--record", action="store_true",
                    help="print the noc_obs probe-overhead row")
    args = ap.parse_args(argv)

    if args.check:
        return check(save_path=args.save, device=args.device)
    if args.record:
        rec = record(backend=args.backend, device=args.device)
        print(f"# probe overhead {rec['probe_overhead_steady']}x (off "
              f"{rec['steady_off_s']:.4f} s, on {rec['steady_on_s']:.4f} s, "
              f"median of {rec['repeats']}), launches off "
              f"{rec['launches_off']}, on {rec['launches_on']}")
        print(json.dumps(rec))
        return 0

    if args.load:
        cap = load(args.load)
    else:
        cap = capture(workload=args.workload, mode=args.mode,
                      n_epochs=args.epochs, epoch_len=args.epoch_len,
                      seed=args.seed, backend=args.backend,
                      faults=args.faults, guard=args.guard,
                      placement=args.placement, control=args.control,
                      device=args.device)
    if args.save:
        save(cap, args.save)
    lines = render_csv(cap) if args.csv else render_ascii(cap)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
