"""Kernel micro-benches of the port: the hand-written kernels' wall time
per call against their plain PyTorch versions, entry for entry the JAX
package's `benchmarks/kernels_bench.py` (same names and shapes):

  flash_attn_512   B5 in f32 at q (1, 512, 4, 64), k / v (1, 512, 2, 64),
                   causal, against `attention_ref`;
  mamba_scan_256   B6 at (2, 256, 64, 16), chunk 64, against `scan_ref`;
  kf_bank_N        B4 at n = 1024 / 16384 / 131072 filters, M = 3;
  noc_arb_lanes    B1 on the (4, 36) dense lanes of `_arb_inputs` (numpy
                   seed 0), against `router.arbitrate`;
  noc_cycle_fused  `simulate` of the static 4 x 100 config on PATH on the
                   "fused" engine (B2, one launch an epoch) against "ref".

A name ends in ``cuda`` on the card (the JAX package's ``interp`` /
``compiled``) and in ``plain`` on the CPU, where every entry point runs
its plain version.  On the card each kernel's output is first held
against its plain version on the same inputs, at that kernel's
chip_smoke.py tolerance: bitwise for B1, B2, B4 and B6, 2e-5 for B5 in
f32; a mismatch exits non-zero and nothing falls back.  A time is the
host wall of ``reps`` calls that end in one synchronize, after one call
that builds and warms, and whose output is the one held: 3 calls, as
the JAX bench times, and 1 for each `simulate` engine.

    PYTHONPATH=src python -m benchmarks.torch_kernels_bench [--record]
        [--device cpu] [--bench-json PATH]

``--record`` appends a `noc_cycle_kernels` row to the port's ledger
(BENCH_noc_torch.json).  Imports no JAX.
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

import numpy as np
import torch

from repro_torch._util import resolve_device
from repro_torch.core.noc import router as rt
from repro_torch.core.noc import sim as noc_sim
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.kf_bank import ops as kf_ops
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref
from repro_torch.kernels.noc_cycle import ops as noc_ops

# chip_smoke.py's tolerance for B5 in f32 (the others are bitwise)
B5_F32_TOL = 2e-5
KF_SIZES = (1024, 16384, 131072)
# timed calls of each engine's 400-cycle simulate after the warm one (one
# "ref" run takes seconds on the card: ~700 launches a simulated cycle)
SIM_REPS = 1


def _time(f, dev: torch.device, reps: int = 3):
    """(microseconds per call, the first call's output): one warm call,
    whose output the caller holds against the plain version, then
    ``reps`` calls ending in one synchronize."""
    first = f()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del out
    return (time.perf_counter() - t0) / reps * 1e6, first


def _leaves(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in _leaves(part)]


def max_abs_err(a, b) -> float:
    """Largest |a - b| over matching tensor leaves (0 when all equal, inf
    on a shape or dtype mismatch or where one side is NaN and the other
    not)."""
    err = 0.0
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        if torch.equal(x, y):
            continue
        if x.dtype.is_floating_point:
            d = (x.double() - y.double()).abs()
            d = torch.where(torch.isnan(x) & torch.isnan(y), 0.0, d)
            err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
        else:
            err = max(err, float((x.long() - y.long()).abs().max()))
    return err


def held(name: str, got, want, tol: float = 0.0) -> float:
    """``got`` against ``want`` within ``tol`` (0: bitwise); exits non-zero
    on a mismatch.  Returns the max abs error."""
    err = max_abs_err(got, want)
    if not err <= tol:
        raise SystemExit(f"torch_kernels_bench: {name} differs from its "
                         f"plain version: max abs err {err} > {tol}")
    return err


def _arb_inputs(dev, lead=(4, 36), P=5, V=4, B=4) -> dict:
    rng = np.random.default_rng(0)
    PV = P * V

    def t(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype)

    gm = t(rng.random(lead[:-1] + (1, V)) < 0.7, torch.bool)
    cm = t(rng.random(lead[:-1] + (1, V)) < 0.7, torch.bool)
    i32 = torch.int32
    return dict(
        valid=t(rng.random(lead + (PV,)) < 0.5, torch.bool),
        cls=t(rng.integers(0, 2, lead + (PV,)), i32),
        out_port=t(rng.integers(0, P, lead + (PV,)), i32),
        rr_ptr=t(rng.integers(0, PV, lead + (P,)), i32),
        down_count=t(rng.integers(0, B + 1, lead + (P, V)), i32),
        down_exists=t(rng.random(lead + (P,)) < 0.8, torch.bool),
        gpu_vc_mask=torch.broadcast_to(gm, lead + (V,)),
        cpu_vc_mask=torch.broadcast_to(cm, lead + (V,)),
        sa_pref=t(rng.integers(-1, 2, lead), i32),
        accept=t(rng.random(lead) < 0.7, torch.bool),
        active=t(rng.random(lead) < 0.9, torch.bool),
    )


def noc_cycle_entries(dev: torch.device) -> dict:
    """The NoC engines at the paper's shapes (S = 4, R = 36): the
    arbitration kernel (B1, `ops.arbitrate_lanes`) against
    `router.arbitrate`, and `simulate` on the fused engine (B2) against
    the dense ref engine, each held first."""
    inp = _arb_inputs(dev)
    t_arb_lanes, lanes = _time(
        lambda: noc_ops.arbitrate_lanes(**inp, depth=4), dev)
    t_arb_ref, want = _time(lambda: rt.arbitrate(**inp, depth=4), dev)
    err = {"noc_arb_lanes": held("noc_arb_lanes", lanes, want)}

    cfg = noc_sim.NoCConfig(mode="static", static_gpu_vcs=3, n_epochs=4,
                            epoch_len=100)
    n_cycles = cfg.n_epochs * cfg.epoch_len

    def sim(engine):
        return noc_sim.simulate(cfg, "PATH", device=dev, engine=engine)

    t_sim, res = {}, {}
    for be in ("ref", "fused"):
        t_sim[be], res[be] = _time(lambda be=be: sim(be), dev, SIM_REPS)
    err["noc_cycle_fused"] = held("noc_cycle_fused", tuple(res["fused"]),
                                  tuple(res["ref"]))
    return {
        "mode": mode(dev),
        "arb_shapes": "(4,36) lanes",
        "arb_ref_us": round(t_arb_ref, 1),
        "arb_lanes_us": round(t_arb_lanes, 1),
        "sim_cycles": n_cycles,
        "sim_ref_us": round(t_sim["ref"], 1),
        "sim_fused_us": round(t_sim["fused"], 1),
        "fused_us_per_cycle": round(t_sim["fused"] / n_cycles, 2),
        "fused_vs_ref": round(t_sim["ref"] / max(t_sim["fused"], 1e-9), 3),
        "max_abs_err": err,
    }


def mode(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "plain"


def main(argv=None) -> list[dict]:
    """Prints the CSV and returns its entries, each {name, us, derived,
    max_abs_err}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", action="store_true",
                    help="append a noc_cycle_kernels row to the ledger")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--bench-json", default=None,
                    help="the ledger --record appends to (default: "
                         "BENCH_noc_torch.json)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tag = mode(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def emit(name, us, derived, err):
        rows.append(dict(name=name, us=us, derived=derived, max_abs_err=err))
        print(f"{name},{us:.0f},{derived}", flush=True)

    print("name,us_per_call,derived")

    # flash attention (B5, f32)
    q = torch.randn((1, 512, 4, 64), generator=g, device=dev)
    k = torch.randn((1, 512, 2, 64), generator=g, device=dev)
    v = torch.randn((1, 512, 2, 64), generator=g, device=dev)

    def attn_ref():
        return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)

    t_kern, got = _time(lambda: fa_ops.flash_attention(q, k, v), dev)
    t_ref, want = _time(attn_ref, dev)
    err = held("flash_attn_512", got, want, B5_F32_TOL)
    emit(f"flash_attn_512_{tag}", t_kern, f"ref={t_ref:.0f}us", err)

    # mamba scan (B6)
    shape = (2, 256, 64, 16)
    a = 0.9 + 0.099 * torch.rand(shape, generator=g, device=dev)
    b = torch.randn(shape, generator=g, device=dev)
    h0 = torch.zeros((2, 64, 16), device=dev)
    t_kern, got = _time(lambda: ms_ops.mamba_chunk_scan(a, b, h0, chunk=64,
                                                        block_d=64), dev)
    t_ref, want = _time(lambda: ms_ref.scan_ref(a, b, h0), dev)
    err = held("mamba_scan_256", got, want)
    emit(f"mamba_scan_256_{tag}", t_kern, f"ref={t_ref:.0f}us", err)

    # kf bank (B4): fleet sizes (one filter per link x class x pod)
    for n in KF_SIZES:
        x = torch.zeros((n,), device=dev)
        p = torch.ones((n,), device=dev)
        z = torch.randn((n, 3), generator=g, device=dev)
        h = torch.ones((3,), device=dev)
        r = torch.full((3,), 0.2, device=dev)
        t, got = _time(lambda: kf_ops.kf_bank_step(x, p, z, h, r), dev)
        err = held(f"kf_bank_{n}", got,
                   kf_ops.kf_bank_step_plain(x, p, z, h, r))
        emit(f"kf_bank_{n}", t, f"filters_per_s={n / t * 1e6:.2e}", err)

    # noc_cycle: arbitration kernel (B1) + fused full-cycle engine (B2)
    noc = noc_cycle_entries(dev)
    errs = noc.pop("max_abs_err")
    emit(f"noc_arb_lanes_{tag}", noc["arb_lanes_us"],
         f"ref={noc['arb_ref_us']:.0f}us", errs["noc_arb_lanes"])
    emit(f"noc_cycle_fused_{tag}", noc["sim_fused_us"],
         f"ref={noc['sim_ref_us']:.0f}us per {noc['sim_cycles']}-cycle sim "
         f"({noc['fused_us_per_cycle']:.1f}us/cycle, "
         f"{noc['fused_vs_ref']:.2f}x vs ref)", errs["noc_cycle_fused"])

    if args.record:
        from benchmarks.torch_bench_sweep import BENCH_PATH, append_record

        path = args.bench_json or BENCH_PATH
        rec = append_record({
            "bench": "noc_cycle_kernels",
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "backend": dev.type,
            **noc,
        }, path)
        print(json.dumps(rec, indent=2))
        print(f"appended noc_cycle_kernels record to {path}")
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
