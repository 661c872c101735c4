"""Demand-trace recorder: capture the per-epoch demand rows of a run.

`TraceRecorder.record` turns a (config, source) pair into a
`traffic.RecordedTrace`: the exact per-epoch rows `traffic.resolve_source`
lowers for the simulator.  The simulator reads nothing else about demand,
so replaying the capture under the same config and random streams is
bitwise the original run.  With ``observe=True`` the recorder also runs
`sim.simulate_with_trace` and stores the `SimTrace` digest and the result
summary in the trace's meta; the rows stay the same.

`sim` is imported inside the functions: sim.py imports this package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.noc.traffic import RecordedTrace, WorkloadProfile


def _source_descriptor(source) -> str:
    """A short provenance tag for a demand source."""
    if isinstance(source, str):
        return source
    name = getattr(source, "name", None)
    if isinstance(name, str) and name:
        return f"{type(source).__name__}:{name}"
    return type(source).__name__


@dataclasses.dataclass
class TraceRecorder:
    """Captures replayable demand traces from simulation runs.

    name    — the name stamped on captured traces.
    observe — run the traced simulation and keep its digest in the meta
              (on the CUDA device unless ``device="cpu"`` is passed);
              False captures the rows only and runs nothing.
    """

    name: str = "capture"
    observe: bool = True

    def record(self, cfg, source, *, device=None, rng=None,
               engine: str | None = None) -> RecordedTrace:
        """The per-epoch demand rows a (cfg, source) run consumes, as a
        `RecordedTrace` (fit="exact", cfg.n_epochs rows).  ``device``,
        ``rng`` and ``engine`` are `sim.simulate_with_trace`'s."""
        from repro_torch.core.noc import sim
        from repro_torch.core.noc.traffic import resolve_source
        from repro_torch.obs.probes import summarize_trace

        demand = resolve_source(source, cfg.n_epochs)
        rows = WorkloadProfile(**{
            f: getattr(demand, f).cpu().numpy().astype(np.float32)
            for f in WorkloadProfile._fields
        })
        meta = {
            "source": _source_descriptor(source),
            "mode": cfg.mode,
            "n_epochs": int(cfg.n_epochs),
            "epoch_len": int(cfg.epoch_len),
            "seed": int(cfg.seed),
            "backend": engine or cfg.engine,
            "recorder": "TraceRecorder",
        }
        if self.observe:
            res, trace = sim.simulate_with_trace(
                cfg, demand, device=device, rng=rng, engine=engine
            )
            meta["observed"] = summarize_trace(trace)
            meta["result"] = sim.summarize(res)
        return RecordedTrace(demand=rows, fit="exact", name=self.name,
                             meta=meta)

    def record_to(self, path, cfg, source, *, device=None, rng=None,
                  engine: str | None = None) -> RecordedTrace:
        """`record`, then save the capture as a versioned npz trace file."""
        trace = self.record(cfg, source, device=device, rng=rng,
                            engine=engine)
        trace.save(path)
        return trace


def capture_demand(cfg, source, path=None, name: str = "capture",
                   observe: bool = False, **run) -> RecordedTrace:
    """One-shot capture (saved to ``path`` when given); ``run`` takes
    `TraceRecorder.record`'s keywords."""
    rec = TraceRecorder(name=name, observe=observe)
    if path is not None:
        return rec.record_to(path, cfg, source, **run)
    return rec.record(cfg, source, **run)
