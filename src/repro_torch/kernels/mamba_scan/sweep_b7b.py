"""Sweep of B7-bwd's instantiation on the card.

    PYTHONPATH=src python -m repro_torch.kernels.mamba_scan.sweep_b7b \
        [--variants "MINB=1;CLUSTER=4;SUB=16,MINB=1"]

Builds csrc/mamba_scan_bwd.cu once per variant, with the instantiation set
through -D (B7B_K states a thread, B7B_SUB steps a sub-tile, B7B_CLUSTER
blocks a cluster, B7B_MINB blocks an SM the registers are held to; one
nvcc per variant, all started together; the first variant is the source's
defaults), holds each variant's six gradients against the plain versions
(relative L2 1e-5 where returned in f32, 1e-2 in bf16) and times it with
CUDA events over back-to-back calls and with torch.profiler's device time
of the walk, at falcon-mamba's training shape (4, 2048, 8192, 16) bf16
through the per-channel form and at zamba2's (4, 2048, 80 heads x 64, 64)
bf16 from h0 through the mamba2 form and the per-channel form.  Prints one
line per variant (ptxas's registers and spill bytes of the bf16 walks,
the runtime's blocks an SM) and the fastest at each shape; needs a CUDA
device.  The library that the port loads keeps the defaults written in
the source: change them there to adopt a variant.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import fused, kernel
from repro_torch.kernels.mamba_scan.sweep_b7 import _ms, device_ms

HD = 64   # zamba2's head dim


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _ptxas(log: str) -> str:
    """Registers and spill bytes of the bf16 16-byte-copy walks, and the
    most any walk instantiation spills."""
    out = []
    for s, m2, name in ((16, 0, "S16"), (64, 0, "S64"), (64, 1, "S64 ssd")):
        pat = rf"mamba_fused_bwd_kernelI13__nv_bfloat16Li{s}ELb{m2}ELb1E"
        m = re.search(pat + r".*?Used (\d+) registers", log, re.S)
        sp = re.search(pat + r".*?(\d+) bytes spill stores", log, re.S)
        out.append(f"{name} {m.group(1) if m else '?'} registers, spill "
                   f"{sp.group(1) if sp else '?'} B")
    spills = [int(x) for x in re.findall(
        r"mamba_fused_bwd_kernel\S*\n[^\n]*?(\d+) bytes stack frame", log)]
    out.append(f"largest stack of any walk {max(spills, default=-1)} B")
    return "; ".join(out)


def _cases(dev):
    """(label, form, inputs, plain gradients) at the two training shapes."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    B, L = 4, 2048
    out = []
    d, s = 8192, 16
    dt = 0.001 + 0.099 * torch.rand((B, L, d), generator=g, device=dev)
    xc, b, c = (torch.randn(sh, generator=g, device=dev).to(bf16)
                for sh in ((B, L, d), (B, L, s), (B, L, s)))
    a_mat = -torch.arange(1, s + 1, dtype=torch.float32,
                          device=dev).repeat(d, 1)
    gy = torch.randn((B, L, d), generator=g, device=dev)
    _, _, ckpt = kernel.mamba_fused(dt, xc, b, c, a_mat, None,
                                    checkpoints=True)
    ins = (dt, xc, b, c, a_mat, ckpt, gy, None)
    out.append(("falcon-mamba-7b (4, 2048, 8192, 16)", "channel", ins,
                fused.fused_mamba_scan_plain_bwd(dt, xc, b, c, a_mat, None,
                                                 gy)))
    nh, s = 80, 64
    d = nh * HD
    dth = 0.001 + 0.099 * torch.rand((B, L, nh), generator=g, device=dev)
    xh, b, c = (torch.randn(sh, generator=g, device=dev).to(bf16)
                for sh in ((B, L, nh, HD), (B, L, s), (B, L, s)))
    a_h = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
    h0, ghl = (torch.randn((B, nh, HD, s), generator=g, device=dev)
               for _ in range(2))
    gy = torch.randn((B, L, nh, HD), generator=g, device=dev)
    dt_d, xc, a_mat, h0_d = fused.ssd_channels(dth, xh, a_h, h0)
    a_mat = a_mat.contiguous()
    _, _, ckpt = kernel.mamba_fused(dt_d, xc, b, c, a_mat, h0_d,
                                    checkpoints=True)
    ins = (dth, xh, b, c, a_h, ckpt, gy, ghl)
    out.append(("zamba2-2.7b (4, 2048, 80 x 64, 64) mamba2 form", "ssd", ins,
                fused.fused_ssd_scan_plain_bwd(dth, xh, b, c, a_h, h0, gy,
                                               ghl)))
    gy_d, ghl_d = gy.view(B, L, d), ghl.view(B, d, s)
    ins = (dt_d, xc, b, c, a_mat, ckpt, gy_d, ghl_d)
    out.append(("zamba2-2.7b (4, 2048, 5120, 64) per-channel form",
                "channel", ins,
                fused.fused_mamba_scan_plain_bwd(dt_d, xc, b, c, a_mat, h0_d,
                                                 gy_d, ghl_d)))
    return out


def run(variants: list[dict], cases) -> list[dict]:
    libs = [("mamba_scan_bwd_sweep_" + "_".join(
        f"{k.lower()}{v}" for k, v in sorted(var.items())) if var else
        "mamba_scan_bwd_sweep_default", kernel.BWD_SOURCES,
        tuple(f"-DB7B_{k}={v}" for k, v in sorted(var.items())))
        for var in variants]
    _build.build_all(libs)
    rows = []
    for var, spec in zip(variants, libs):
        lib = kernel.bind_bwd(ctypes.CDLL(str(_build.library_path(*spec))))
        cfg = kernel.fused_bwd_config(lib)
        occ = {f"S{s}{' ssd' if m2 else ''}": kernel.fused_bwd_occupancy(
            torch.bfloat16, s, m2, lib)["blocks_per_sm"]
            for s, m2 in ((16, False), (64, False), (64, True))}
        row = dict(var=var, cfg=cfg, occ=occ,
                   ptxas=_ptxas(_build.build_log(*spec).read_text()))
        for label, form, ins, want in cases:
            outs = tuple(torch.empty_like(w) for w in want)
            launch = (kernel.launch_fused_bwd if form == "channel"
                      else kernel.launch_ssd_bwd)

            def call():
                launch(lib, *ins, outs)

            call()
            torch.cuda.synchronize()
            worst = max(_rel(o, w) / (1e-2 if o.dtype == torch.bfloat16
                                      else 1e-5)
                        for o, w in zip(outs, want))
            row.setdefault("ok", True)
            row["ok"] = row["ok"] and worst <= 1.0
            dev_ms, _ = device_ms(call, 3, "mamba_fused_bwd_kernel")
            row[label] = (_ms(call, 5), dev_ms, worst)
        rows.append(row)
        print(f"[sweep] {var or 'defaults'} ({cfg}; blocks an SM {occ}; "
              f"{row['ptxas']}): " + "; ".join(
                  f"{label} events {ms:.4f} ms, walk {dev:.4f} ms, worst "
                  f"gradient at {w:.3f} of its bound"
                  for label, (ms, dev, w) in
                  ((c[0], row[c[0]]) for c in cases)), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="MINB=1;CLUSTER=1;CLUSTER=4;"
                                          "SUB=4;SUB=16,MINB=1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_b7b: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[sweep] {smi}; default instantiation "
          f"{kernel.fused_bwd_config()}", flush=True)
    variants = [{}] + [
        dict(kv.split("=") for kv in v.split(","))
        for v in args.variants.split(";") if v]
    cases = _cases(torch.device("cuda"))
    rows = run(variants, cases)
    for label, *_ in cases:
        best = min(rows, key=lambda r: r[label][1] or r[label][0])
        print(f"[sweep] fastest at {label}: {best['var'] or 'defaults'} "
              f"(events {best[label][0]:.4f} ms, walk {best[label][1]:.4f} "
              f"ms)")
    ok = all(r["ok"] for r in rows)
    print(f"[sweep] every variant within its bounds: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
