"""Serving substrate: KV slot caches, continuous-batching engine with
KF-arbitrated prefill/decode scheduling (the paper's technique at the
serving layer)."""
