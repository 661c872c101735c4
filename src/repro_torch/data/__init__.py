"""Data pipeline: deterministic synthetic corpus + host-side prefetch."""
