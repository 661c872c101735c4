"""Slot-indexed decode caches: insert prefilled requests, free finished ones.

`lm.DecodeState` stacks per-layer caches with a batch dimension = decode
slots.  This module is the slot algebra the engine needs: write a single
prefilled request's cache into slot `i`, clear a slot, and track occupancy.
It works on every cache kind of the port (attention `KVCache`, the
`Mamba1State` / `Mamba2State` conv ring and SSM state, and the hybrid's
shared-block `shared_kv`) because it walks each cache's leaves, all
stacked (n_super, B, ...).

`insert_request` and `clear_slot` update ``state``'s tensors IN PLACE (the
reference returns updated copies) and return a DecodeState over them.
"""
from __future__ import annotations

from repro_torch.models import lm


def insert_request(
    state: lm.DecodeState, prefilled: lm.DecodeState, slot: int
) -> lm.DecodeState:
    """Copy request 0 of ``prefilled`` (a batch-1 state) into ``slot``."""
    def ins(dst, src):
        for d, s in zip(dst, src):      # leaves (n_super, B, ...): slot axis 1
            d[:, slot] = s[:, 0]

    for dc, sc in zip(state.caches, prefilled.caches):
        ins(dc, sc)
    if state.shared_kv is not None:
        ins(state.shared_kv, prefilled.shared_kv)
    state.length[slot] = prefilled.length[0]
    return state


def clear_slot(state: lm.DecodeState, slot: int) -> lm.DecodeState:
    """Zero a slot's caches (every leaf with ndim >= 2: K/V, and the conv
    ring and SSM state of a mamba layer) and its length.  As in the
    reference, the hybrid shared block's cache (`shared_kv`) is left as it
    is."""
    for cache in state.caches:
        for c in cache:
            if c.ndim >= 2:
                c[:, slot] = 0
    state.length[slot] = 0
    return state


def kv_occupancy(state: lm.DecodeState, max_len: int) -> float:
    """Fraction of cache capacity holding live tokens — the engine's
    'dramfull' (HBM pressure) telemetry signal.  One host sync."""
    total = state.length.sum()
    cap = state.length.shape[0] * max_len
    return float(total) / float(cap)
