"""B7's per-thread arithmetic (csrc/mamba_scan.cu, `mamba_fused_kernel`),
transcribed into plain torch, against `fused.state_sum` and
`fused.fused_mamba_scan_plain`, bitwise.

The kernel puts one channel's S states on G = S / K adjacent lanes, lane j
holding the states j, j + G, ..., j + (K - 1) G; it sums y by log2(K)
levels of adds inside the thread, then xor shuffles at offsets G/2 ... 1.
It walks L in tiles of TILE steps, U steps at a time with a ragged tail
of single steps; each tile arrives through per-thread copies of 16 bytes
(or of one element where D or the alignment does not allow them) and is
converted, with B and C permuted, before it is walked; each tile's y
leaves in 16-byte (or one-element) copies.  Nothing here
compiles CUDA, so this transcription, indexed as the kernel indexes, is
what the CPU can check of the layout; tests/test_torch_cuda.py holds the
kernel itself on the card.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import fused, kernel

SOURCE = kernel.SOURCES[0].read_text()
DEFAULTS = {k: int(v) for k, v in re.findall(
    r"#define B7_(K|U|THREADS|TILE) (\d+)", SOURCE)}
KS, US = (2, 4, 8), (1, 2, 4, 8, 16)   # what sweep_b7.py instantiates


def _stage_tile(dt, xc, b, c, t0, *, tile, threads, ch, S, K, G, wide):
    """`copy_tile` into the arrival area (NaN where nothing was copied),
    then `convert_tile`: the walked tile's dt [TILE][CH], dt*xc [TILE][CH]
    and permuted B|C [TILE][2S], for every block (B|C per sequence)."""
    bsz, L, D = dt.shape
    nb = -(-D // ch)
    vd, vx = (4, 16 // xc.element_size()) if wide else (1, 1)
    dt_a = torch.full((bsz, nb, tile, ch), math.nan)
    xc_a = torch.full((bsz, nb, tile, ch), math.nan)
    bc_a = torch.full((bsz, tile, 2 * S), math.nan)
    xc, b, c = (x.to(torch.float32) for x in (xc, b, c))
    tid = torch.arange(threads)
    for arr, src, vw in ((dt_a, dt, vd), (xc_a, xc, vx)):
        for k in range(-(-tile * ch // vw // threads)):
            v = tid + k * threads
            v = v[v < tile * ch // vw]
            r, col = v // (ch // vw), (v % (ch // vw)) * vw
            for blk in range(nb):
                d0 = blk * ch
                ok = (t0 + r < L) & (d0 + col < D)
                for e in range(vw):
                    arr[:, blk, r[ok], col[ok] + e] = \
                        src[:, t0 + r[ok], d0 + col[ok] + e]
    for k in range(-(-tile * 2 * S // vx // threads)):
        v = tid + k * threads
        v = v[v < tile * 2 * S // vx]
        r, q = v // (2 * S // vx), (v % (2 * S // vx)) * vx
        ok = t0 + r < L
        for e in range(vx):
            col = q[ok] + e
            s = col % S
            bc_a[:, r[ok], col] = torch.where(col < S, b[:, t0 + r[ok], s],
                                              c[:, t0 + r[ok], s])
    # the conversion: every row and channel, copied or not
    col = torch.arange(2 * S)
    s = col % S
    bc_s = torch.empty_like(bc_a)
    bc_s[:, :, (col - s) + (s % G) * K + s // G] = bc_a
    return dt_a, dt_a * xc_a, bc_s


def _store_y(y, y_s, t0, n, *, threads, ch, W):
    """`store_y`: the tile's y rows from the stage to y, per thread."""
    D = y.shape[-1]
    row_v = ch // W
    tid = torch.arange(threads)
    for k in range(-(-y_s.shape[2] * row_v // threads)):
        v = tid + k * threads
        r, col = v // row_v, (v % row_v) * W
        for blk in range(y_s.shape[1]):
            d0 = blk * ch
            ok = (v < y_s.shape[2] * row_v) & (r < n) & (d0 + col < D)
            for e in range(W):
                y[:, t0 + r[ok], d0 + col[ok] + e] = y_s[:, blk, r[ok],
                                                         col[ok] + e]


def _lane_sum(p, K, G):
    """y of one step from the lanes' K products each, p (..., T, K) with T
    lanes in groups of G: halving inside the thread, then xor shuffles."""
    w = K // 2
    while w:
        p = p[..., :w] + p[..., w:2 * w]
        w //= 2
    s = p[..., 0]
    lane = torch.arange(s.shape[-1])
    off = G // 2
    while off:
        s = s + s[..., lane ^ off]
        off //= 2
    return s


def fused_transcription(dt, xc, b, c, a_mat, h0, *, K, U, threads, tile):
    """The kernel's walk for every block and lane of one launch."""
    bsz, L, D = dt.shape
    S = a_mat.shape[-1]
    K = min(K, S)
    G = S // K
    wide = D % (16 // xc.element_size()) == 0
    W = 4 if wide else 1
    ch = threads // G
    nb = -(-D // ch)
    tid = torch.arange(threads)
    cl, j = tid // G, tid % G
    d = torch.arange(nb)[:, None] * ch + cl                   # (nb, T)
    live = d < D
    dc = d.clamp(max=D - 1)
    states = j[:, None] + torch.arange(K) * G                 # (T, K)
    A = torch.where(live[..., None], a_mat[dc[..., None], states], 0.0)
    h = torch.zeros((bsz, nb, threads, K))
    if h0 is not None:
        h = torch.where(live[..., None],
                        h0[:, dc[..., None], states[None]], 0.0)
    y = torch.full((bsz, L, D), math.nan)
    bpos, cpos = j[:, None] * K + torch.arange(K), S + j[:, None] * K \
        + torch.arange(K)
    for t0 in range(0, L, tile):
        dt_s, dx_s, bc_s = _stage_tile(dt, xc, b, c, t0, tile=tile,
                                       threads=threads, ch=ch, S=S, K=K,
                                       G=G, wide=wide)
        n = min(tile, L - t0)
        y_s = torch.full((bsz, nb, tile, ch), math.nan)
        groups = [(tt, U) for tt in range(0, n - n % U, U)] + [
            (tt, 1) for tt in range(n - n % U, n)]
        for tt, nu in groups:
            a, bx, p = [], [], []
            for u in range(nu):
                dtv = dt_s[:, :, tt + u][..., cl][..., None]  # (B, nb, T, 1)
                dxv = dx_s[:, :, tt + u][..., cl][..., None]
                row = bc_s[:, tt + u]                         # (B, 2S)
                a.append(torch.exp(dtv * A))
                bx.append(dxv * row[:, bpos][:, None])
                p.append(row[:, cpos][:, None].expand_as(bx[-1]))
            for u in range(nu):
                h = a[u] * h + bx[u]
                p[u] = h * p[u]
            for u in range(nu):   # every lane writes its channel's y
                y_s[:, :, tt + u, cl] = _lane_sum(p[u], K, G)
        _store_y(y, y_s, t0, n, threads=threads, ch=ch, W=W)
    h_last = torch.full((bsz, D, S), math.nan)
    h_last[:, d[live][:, None], states[None].expand(nb, -1, -1)[live]] = \
        h[:, live]
    return y, h_last


def _inputs(B, L, D, S, seed):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, (B, L, D)).astype(np.float32)
    xc, b, c = (rng.normal(size=sh).astype(np.float32)
                for sh in ((B, L, D), (B, L, S), (B, L, S)))
    a_mat = (-np.exp(0.3 * rng.normal(size=(D, S)))).astype(np.float32)
    h0 = rng.normal(size=(B, D, S)).astype(np.float32)
    return [torch.from_numpy(x) for x in (dt, xc, b, c, a_mat, h0)]


def test_source_defaults_are_swept():
    """The library's instantiation is one of the transcribed ones."""
    assert set(DEFAULTS) == {"K", "U", "THREADS", "TILE"}
    assert DEFAULTS["K"] in KS and DEFAULTS["U"] in US
    assert DEFAULTS["TILE"] % DEFAULTS["U"] == 0


@pytest.mark.parametrize("S", [8, 16, 64])
@pytest.mark.parametrize("K", KS)
def test_lane_sum_is_state_sum(S, K):
    """The in-thread halving and the xor partners give state_sum's bits."""
    K = min(K, S)
    G = S // K
    rng = np.random.default_rng(S + K)   # magnitudes 1e-3 .. 1e4: the
    v = torch.from_numpy((rng.normal(size=(64, S))   # order shows in the bits
                          * 10.0 ** rng.integers(-3, 5, (64, S))
                          ).astype(np.float32))
    lanes = v.reshape(64, K, G).transpose(1, 2)   # lane j: states j + iG
    got = _lane_sum(lanes.reshape(1, 64 * G, K), K, G).reshape(64, G)
    want = fused.state_sum(v)
    for j in range(G):   # every lane of the group holds the sum
        assert torch.equal(got[:, j], want)


# L = 1, U - 1, U + 1 and one past a tile for every swept (K, U) (L = 0
# launches nothing: the wrapper returns h0), and a prefill's length for
# the library's own instantiation; at S = 64 (mamba2: G = 32 / 16 / 8
# lanes a channel for K = 2 / 4 / 8) every swept K at the library's U
CASES = [(S, K, U, L) for S in (8, 16) for K in KS for U in US
         for L in sorted({1, U - 1, U + 1, DEFAULTS["TILE"] + 1} - {0})] + [
    (64, K, DEFAULTS["U"], L) for K in KS
    for L in sorted({1, DEFAULTS["U"] - 1, DEFAULTS["U"] + 1,
                     DEFAULTS["TILE"] + 1} - {0})] + [
    (S, DEFAULTS["K"], DEFAULTS["U"], 517) for S in (8, 16, 64)]


@pytest.mark.parametrize("S,K,U,L", CASES)
def test_transcription_matches_plain(S, K, U, L):
    """Bitwise against the plain version, for D ragged against the block's
    channels with 16-byte copies (float32 xc at D % 4 == 0, bfloat16 at
    D % 8 == 0) and element copies (D odd), from zero and from h0."""
    threads, tile = DEFAULTS["THREADS"], DEFAULTS["TILE"]
    ch = threads // (S // min(K, S))
    for D, dtype in ((ch + 4, torch.float32), (ch + 8, torch.bfloat16),
                     (2 * ch + 3, torch.bfloat16)):
        dt, xc, b, c, a_mat, h0 = _inputs(2 if L < 64 else 1, L, D, S,
                                          seed=L + D + S + K + U)
        xc, b, c = (x.to(dtype) for x in (xc, b, c))
        for start in (None, h0):
            got = fused_transcription(dt, xc, b, c, a_mat, start, K=K, U=U,
                                      threads=threads, tile=tile)
            want = fused.fused_mamba_scan_plain(dt, xc, b, c, a_mat, start)
            assert torch.equal(got[0], want[0]), (D, dtype, start is None)
            assert torch.equal(got[1], want[1]), (D, dtype, start is None)
