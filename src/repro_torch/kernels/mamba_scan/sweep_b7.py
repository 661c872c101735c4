"""Sweep of B7's instantiation on the card.

    PYTHONPATH=src python -m repro_torch.kernels.mamba_scan.sweep_b7

Builds csrc/mamba_scan.cu once per variant, with the instantiation set
through -D (B7_K states per thread, B7_U steps in flight, B7_THREADS
threads per block, B7_TILE steps per tile; one nvcc per variant, all
started together), holds each variant's y and h_last bitwise against
`fused_mamba_scan_plain` at the model's shape (1, 517, 8192, 16), bf16 xc /
B / C, from a nonzero h0, and times it at L = 517 and 2048: the kernel's
device time per launch under torch.profiler (which ranks the variants)
and CUDA events over back-to-back launches (outputs allocated once).
Each variant whose layout holds 64 states (a channel's S / K lanes within
a warp, at least 8 channels a block) is also held bitwise and timed at
mamba2's shape (1, 517, 5120, 64); the others report "n/a" there.
Stage 1 crosses K with the block size at the library's U and tile; stage
2 crosses U with the tile at the fastest (K, threads).  Prints one line
per variant (with ptxas's registers and spills) and the fastest; needs a
CUDA device.  The library that the port loads keeps the defaults written
in the source: change them there to adopt a variant.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import fused, kernel


def holds(k: int, threads: int, s: int) -> bool:
    """Whether B7's layout (FusedLayout::kOk) takes s states at K = k
    states per thread and ``threads`` threads per block."""
    g = s // min(k, s)
    return s % min(k, s) == 0 and 32 % g == 0 and (threads // g) % 8 == 0


def _inputs(L: int, d: int = 8192, s: int = 16, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = 0.001 + 0.099 * torch.rand((1, L, d), generator=g, device="cuda")
    xc, b, c = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((1, L, d), (1, L, s), (1, L, s)))
    a_mat = -torch.arange(1, s + 1, dtype=torch.float32,
                          device="cuda").repeat(d, 1)
    h0 = torch.randn((1, d, s), generator=g, device="cuda")
    return dt, xc, b, c, a_mat, h0


def _ms(fn, n: int = 50) -> float:
    """Median over 5 repeats of the mean ms per call over n calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        reps.append(a.elapsed_time(b) / n)
    return statistics.median(reps)


def device_ms(fn, n: int, name: str = "mamba_fused_kernel",
              attempts: int = 3) -> tuple[float, int]:
    """The mean device duration (ms) of the launches of kernel ``name``
    that torch.profiler records over n calls of ``fn``, and how many it
    recorded; (0.0, 0) if a session records none after ``attempts``.  A
    mean over the recorded launches, so that a launch the tracing drops
    does not lower it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if name in e.name]
        if us:
            return sum(us) / 1e3 / len(us), len(us)
    return 0.0, 0


def _ptxas(log: str) -> str:
    """Registers and spill bytes of the bf16 S = 16 wide instantiation."""
    m = re.search(r"mamba_fused_kernelI13__nv_bfloat16Li16ELb1E.*?Used (\d+) "
                  r"registers", log, re.S)
    sp = re.search(r"mamba_fused_kernelI13__nv_bfloat16Li16ELb1E.*?(\d+) bytes "
                   r"stack frame, (\d+) bytes spill stores", log, re.S)
    return (f"{m.group(1) if m else '?'} registers, stack "
            f"{sp.group(1) if sp else '?'}, spill {sp.group(2) if sp else '?'}")


def run(variants: list[tuple[int, int, int, int]], cases) -> list[dict]:
    libs = [(f"mamba_scan_sweep_k{k}_u{u}_t{t}_l{tile}", kernel.SOURCES,
             (f"-DB7_K={k}", f"-DB7_U={u}", f"-DB7_THREADS={t}",
              f"-DB7_TILE={tile}"))
            for k, u, t, tile in variants]
    _build.build_all(libs)
    out = []
    for (k, u, t, tile), lib_spec in zip(variants, libs):
        lib = kernel.bind(ctypes.CDLL(str(_build.library_path(*lib_spec))))
        cfg = kernel.fused_config(lib)
        assert (cfg["K"], cfg["U"], cfg["threads"], cfg["tile"]) == (
            k, u, t, tile), cfg
        row = dict(K=k, U=u, threads=t, tile=tile,
                   ptxas=_ptxas(_build.build_log(*lib_spec).read_text()))
        for key, (ins, want) in cases.items():
            dt, xc, b, c, a_mat, h0 = ins
            if not holds(k, t, a_mat.shape[-1]):
                row[f"ms{key}"] = row[f"dev{key}"] = None
                continue
            y = torch.empty_like(dt)
            hl = torch.empty_like(h0)
            kernel.launch_fused(lib, dt, xc, b, c, a_mat, h0, y, hl)
            torch.cuda.synchronize()
            if want is not None:
                row["bitwise"] = row.get("bitwise", True) and (
                    torch.equal(y, want[0]) and torch.equal(hl, want[1]))
            def launch():
                kernel.launch_fused(lib, dt, xc, b, c, a_mat, h0, y, hl)

            row[f"ms{key}"] = _ms(launch)
            row[f"dev{key}"], recorded = device_ms(launch, 20)
            if not recorded:
                raise RuntimeError("torch.profiler recorded no B7 launch")
        print(f"[sweep] K={k} U={u} threads={t} tile={tile}: device "
              f"{row['dev517']:.4f} / {row['dev2048']:.4f} ms per launch at "
              f"L = 517 / 2048 (events {row['ms517']:.4f} / "
              f"{row['ms2048']:.4f} ms per call), S = 64 at L = 517 "
              + ("n/a" if row["dev64"] is None else
                 f"{row['dev64']:.4f} ms (events {row['ms64']:.4f})")
              + f", bitwise {row['bitwise']}, {row['ptxas']}", flush=True)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="2,4,8")
    ap.add_argument("--threads", default="64,128,256")
    ap.add_argument("--us", default="1,2,4,8,16")
    ap.add_argument("--tiles", default="32,64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_b7: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[sweep] {smi}; default instantiation {kernel.fused_config()}")
    ins517 = _inputs(517)
    ins64 = _inputs(517, d=5120, s=64, seed=2)
    # keyed by L at (1, L, 8192, 16), and 64 for (1, 517, 5120, 64)
    cases = {517: (ins517, fused.fused_mamba_scan_plain(*ins517)),
             2048: (_inputs(2048, seed=1), None),
             64: (ins64, fused.fused_mamba_scan_plain(*ins64))}
    base = kernel.fused_config()
    ints = lambda s: [int(x) for x in s.split(",")]  # noqa: E731
    stage1 = [(k, base["U"], t, base["tile"]) for k in ints(args.ks)
              for t in ints(args.threads)]
    rows = run(stage1, cases)
    best = min((r for r in rows if r["bitwise"]), key=lambda r: r["dev517"])
    stage2 = [(best["K"], u, best["threads"], tile) for u in ints(args.us)
              for tile in ints(args.tiles)
              if tile % u == 0 and (best["K"], u, best["threads"], tile)
              not in stage1]
    rows += run(stage2, cases)
    ok = all(r["bitwise"] for r in rows)
    best = min(rows, key=lambda r: r["dev517"])
    print(f"[sweep] fastest on the device at L=517: K={best['K']} "
          f"U={best['U']} threads={best['threads']} tile={best['tile']} "
          f"({best['dev517']:.4f} ms; L=2048 {best['dev2048']:.4f} ms); "
          f"every variant bitwise: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
