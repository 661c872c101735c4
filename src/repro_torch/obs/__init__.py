"""Flight-recorder observability of the port.

  * probes.py   — `SimTrace`, the per-epoch introspection stream that
                  `sim.simulate_with_trace` returns (occupancy, arbitration
                  grant/deny, MC queue depth, KF internals, fault and
                  placement channels), and `summarize_trace`.
  * recorder.py — `TraceRecorder`: captures the per-epoch demand rows of a
                  run as a replayable `traffic.RecordedTrace`, optionally
                  stamped with the observed `SimTrace` digest.
  * ledger.py   — provenance stamps (git sha, card name, config hash),
                  the bench-row schema check and `append`, the one write
                  path of the port's BENCH_noc_torch.json.
  * profiling.py — torch.profiler sessions behind the torch figure
                  drivers' ``--profile DIR`` flag.
"""
from repro_torch.obs import ledger, profiling
from repro_torch.obs.probes import SimTrace, summarize_trace
from repro_torch.obs.recorder import TraceRecorder, capture_demand

__all__ = ["SimTrace", "summarize_trace", "TraceRecorder", "capture_demand",
           "ledger", "profiling"]
