"""torch.profiler hooks behind the torch figure drivers' ``--profile DIR``
flag.

`profiled_run(outdir, fn)` calls `fn` twice, each under its own profiler
session: DIR/<label>-cold (the first call: kernel builds, library loads,
allocator warm-up) and DIR/<label>-steady (the second call: everything
warm).  Each session exports a Chrome trace, ``trace.json``, into its
directory (open it in Perfetto or chrome://tracing).  With outdir falsy
it makes one plain call, so drivers can wrap their `run(...)`
unconditionally.  The CUDA activity is recorded when the card is there.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(outdir: str | None, label: str) -> Iterator[None]:
    """Profile the enclosed block into outdir/label/trace.json (no-op when
    outdir is falsy)."""
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(outdir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path, TRACE_FILE))


def profiled_run(outdir: str | None, fn: Callable[[], T],
                 label: str = "") -> T:
    """Call fn under a cold-call and a steady-call profiler session.

    The doubled call is deliberate: one capture that mixes kernel builds,
    warm-up and the steady run is unattributable, which is the problem
    this flag exists to solve.  Without an outdir there is exactly one
    call and no profiler.
    """
    if not outdir:
        return fn()
    prefix = f"{label}-" if label else ""
    with trace(outdir, f"{prefix}cold"):
        fn()
    with trace(outdir, f"{prefix}steady"):
        return fn()
