"""The bitmask switch allocation of csrc/noc_cycle.cu's `lane_arbitrate`,
transcribed into plain Python, against the port's plain
`fused.lane_arbitrate` on every LaneArb field.

The CUDA kernels (B1, B2, B3) share that one device function: per output
a PV-bit request mask, the round robin as a rotate by rr and a find-first-
set (preferred class first), the one-traversal filter as a mask of input
ports.  Nothing here compiles CUDA, so this transcription is what the CPU
can check of the algorithm; the card tests hold the kernels themselves.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.noc_cycle import fused

P = 5


def _ffs(m: int) -> int:
    """Index of the lowest set bit of m > 0."""
    return (m & -m).bit_length() - 1


def mask_arbitrate(valid, cls, out_port, rr, down, exists, gm, cm, sa,
                   accept, active, *, depth):
    """One lane of the kernel's bitmask arbitration, on Python ints."""
    PV, V = len(valid), len(gm)
    full = (1 << PV) - 1
    req = [0] * P
    pref = 0
    for pv in range(PV):
        if valid[pv] and 0 <= out_port[pv] < P:
            req[out_port[pv]] |= 1 << pv
        if cls[pv] == sa or sa < 0:
            pref |= 1 << pv
    space = [sum(int(down[o * V + v] < depth) << v for v in range(V))
             for o in range(P)]
    gmask = sum(int(bool(x)) << v for v, x in enumerate(gm))
    cmask = sum(int(bool(x)) << v for v, x in enumerate(cm))

    def rotr(m, k):
        return ((m >> k) | (m << (PV - k))) & full

    out = dict(grant=[0] * P, winner=[0] * P, down_vc=[0] * P,
               new_rr=[0] * P, any_req=[0] * P, w_cls=[0] * P,
               deq=[0] * PV)
    used = 0
    for o in range(P):
        rot = rr[o] % PV  # Python's % floors, as the kernel's floor_mod
        key = rotr(req[o] & pref, rot) | (rotr(req[o] & ~pref & full, rot)
                                          << PV)
        win = 0
        if key:
            i = _ffs(key)
            win = ((i - PV if i >= PV else i) + rot) % PV
        wc = cls[win]
        has = space[o] & (gmask if wc == 1 else cmask)
        if o == P - 1:
            g0 = bool(req[o]) and bool(accept) and bool(active)
        else:
            g0 = (bool(req[o]) and bool(exists[o]) and has != 0
                  and bool(active))
        wp = win // V
        g = g0 and not (used >> wp) & 1
        used |= int(g0) << wp
        out["grant"][o] = int(g)
        out["winner"][o] = win
        out["down_vc"][o] = _ffs(has) if has else 0
        out["new_rr"][o] = (win + 1) % PV if g else rr[o]
        out["any_req"][o] = int(req[o] != 0)
        out["w_cls"][o] = wc
        if g:
            out["deq"][win] = 1
    return out


def _lanes(rng, L, V, *, p_valid=0.5, p_sa_neg=0.3, depth=4, rr_lo=0,
           rr_hi=None, cls_lo=0, cls_hi=2, port_lo=0, port_hi=P):
    """Random (rows, L) int32 lane rows in fused.lane_arbitrate's order."""
    PV = P * V
    rr_hi = PV if rr_hi is None else rr_hi

    def ri(lo, hi, rows):
        return rng.integers(lo, hi, (rows, L)).astype(np.int32)

    sa = ri(0, cls_hi, 1)
    sa[rng.random((1, L)) < p_sa_neg] = -1
    return dict(
        valid=(rng.random((PV, L)) < p_valid).astype(np.int32),
        cls=ri(cls_lo, cls_hi, PV), out_port=ri(port_lo, port_hi, PV),
        rr=ri(rr_lo, rr_hi, P), down=ri(0, depth + 1, P * V),
        exists=ri(0, 2, P), gmask=ri(0, 2, V), cmask=ri(0, 2, V), sa=sa,
        accept=ri(0, 2, 1), active=ri(0, 2, 1),
    )


def _check(rows, depth=4):
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    b = {k: t[k] != 0 for k in ("valid", "exists", "gmask", "cmask",
                                "accept", "active")}
    arb = fused.lane_arbitrate(
        b["valid"], t["cls"], t["out_port"], t["rr"], t["down"], b["exists"],
        b["gmask"], b["cmask"], t["sa"], b["accept"], b["active"],
        depth=depth)
    L = rows["valid"].shape[1]
    for i in range(L):
        lane = {k: [int(x) for x in v[:, i]] for k, v in rows.items()}
        got = mask_arbitrate(
            lane["valid"], lane["cls"], lane["out_port"], lane["rr"],
            lane["down"], lane["exists"], lane["gmask"], lane["cmask"],
            lane["sa"][0], lane["accept"][0], lane["active"][0], depth=depth)
        for name in fused.LaneArb._fields:
            want = [int(x) for x in getattr(arb, name)[:, i]]
            assert got[name] == want, (name, i, lane)


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), V=st.sampled_from([2, 4]),
       p_valid=st.sampled_from([0.05, 0.3, 0.6, 0.95]),
       p_sa_neg=st.sampled_from([0.0, 0.5, 1.0]),
       cls=st.sampled_from([(0, 2), (-1, 2), (-2, 4)]))
def test_mask_arbitration_matches_plain_on_random_lanes(seed, V, p_valid,
                                                         p_sa_neg, cls):
    """Classes outside {0, 1} (a garbage head's) included: with sa < 0
    every requester is preferred, also one whose class is sa."""
    rng = np.random.default_rng(seed)
    _check(_lanes(rng, 32, V, p_valid=p_valid, p_sa_neg=p_sa_neg,
                  cls_lo=cls[0], cls_hi=cls[1]))


def _edge(case, rows):
    PV = rows["valid"].shape[0]
    if case == "all_columns_empty":
        rows["valid"][:] = 0
    elif case == "sa_negative":
        rows["sa"][:] = -1
    elif case == "no_credit":
        rows["down"][:] = 4
    elif case == "rr_last":
        rows["rr"][:] = PV - 1
    elif case == "inactive":
        rows["active"][:] = 0
    elif case == "no_accept":
        rows["accept"][:] = 0
    elif case == "rr_and_ports_outside_range":
        rows["rr"][:] = np.random.default_rng(1).integers(
            -3 * PV, 3 * PV, rows["rr"].shape)
        rows["out_port"][::3] = 7
    elif case == "every_vc_requests":
        rows["valid"][:] = 1
    return rows


@pytest.mark.parametrize("case", [
    "all_columns_empty", "sa_negative", "no_credit", "rr_last", "inactive",
    "no_accept", "rr_and_ports_outside_range", "every_vc_requests",
])
@pytest.mark.parametrize("V", [2, 4])
def test_mask_arbitration_matches_plain_on_edge_cases(case, V):
    rng = np.random.default_rng(len(case) * 31 + V)
    _check(_edge(case, _lanes(rng, 64, V)))
