"""ctypes launchers for the CUDA kernels of B5, which replace
repro/kernels/flash_attn/kernel.py::_flash_kernel, and of its backward
B5-bwd (a library of its own; it replaces no TPU kernel: the JAX package
differentiates its plain attention with XLA).

B5: bfloat16 inputs launch
the wgmma kernel fed by TMA in csrc/flash_attn_sm90.cu, float32 inputs the
SIMT kernel in csrc/flash_attn.cu (a static dispatch on the type, one
library, one entry point).  It checks device, dtype, shape and strides,
launches on PyTorch's current stream without synchronising, and raises if
the launch reports a CUDA error.  The library is built at first call
(`repro_torch.kernels._build`), never at import.

Asked for it (``with_lse``), B5 also writes each query row's natural
log-sum-exp of its valid capped, scaled logits, f32 (B, H, Sq), 0 for a row
with no valid key; the training forward asks, and B5-bwd reads it.

B5-bwd: bfloat16 inputs launch csrc/flash_attn_bwd_sm90.cu (the delta
kernel, then dK/dV and dQ on wgmma fed by TMA), float32 inputs the delta
kernel and the SIMT kernels of csrc/flash_attn_bwd.cu; one library, one
entry point, no statistics pass.

Instantiated for head dims 64, 80 and 128 and for float32 and bfloat16
inputs; any other combination raises on the card.  TMA reads bfloat16 q, k
and v (and, in the backward, o and dO) in place, so each needs a
16-byte-aligned base and strides on B, S and H that are positive multiples
of 8 elements (16 bytes); the library checks this before it launches and
returns TMA_MISALIGNED, which raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ops import LAUNCHES

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / name for name in ("flash_attn.cu", "flash_attn_sm90.cu")]
BWD_SOURCES = [CSRC / name for name in ("flash_attn_bwd.cu",
                                        "flash_attn_bwd_sm90.cu")]
HEAD_DIMS = (64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_MISALIGNED = -1  # the library's code for bf16 inputs TMA cannot read

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first call) and load the flash_attn library."""
    lib = _build.load_library("flash_attn", SOURCES)
    lib.flash_attn_fwd.argtypes = (
        [_I, _I] + [_P] * 5 + [_L] * 12 + [_I] * 8 + [_F, _P])
    lib.flash_attn_fwd.restype = _I
    return lib


@functools.cache
def bwd_library() -> ctypes.CDLL:
    """Build (first call) and load the flash_attn_bwd library."""
    lib = _build.load_library("flash_attn_bwd", BWD_SOURCES)
    lib.flash_attn_bwd.argtypes = (
        [_I, _I] + [_P] * 10 + [_L] * 24 + [_I] * 7 + [_F, _P])
    lib.flash_attn_bwd.restype = _I
    return lib


def _check_qkv(q, k, v, window, logit_cap, extra=()):
    """Device, type, layout and shape checks shared by both launchers."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be 4-d with a unit stride on D")
    if q.dtype not in DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"flash_attn has no instantiation for {q.dtype}, "
                         f"D={d} (instantiated: {list(DTYPES)} x {HEAD_DIMS})")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not q's "
                             f"{tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be > 0, got {logit_cap}")


def flash_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: int | None, logit_cap: float | None,
    kv_len: int | None, with_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """B5 on q (B, Sq, H, D), k/v (B, Sk, KV, D) CUDA tensors of one type,
    each with a unit stride on D (any strides on B, S and H).  With
    ``with_lse``, (out, lse): lse f32 (B, H, Sq), each row's natural
    log-sum-exp (0 for a row with no valid key); out's bits are the same
    either way."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    _check_qkv(q, k, v, window, logit_cap)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    kv_len = sk if kv_len is None else kv_len
    strides = [_strides(t) for t in (q, k, v)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = library().flash_attn_fwd(
        DTYPES[q.dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *strides[0], *strides[1], *strides[2], *out.stride()[:3],
        b, h, kvh, sq, sk, max(0, min(kv_len, sk)), int(causal),
        0 if window is None else int(window),
        0.0 if logit_cap is None else float(logit_cap), stream,
    )
    if rc == TMA_MISALIGNED:
        raise ValueError(
            "bf16 q, k or v is not TMA-aligned: each needs a base that is a "
            "multiple of 16 bytes and strides on B, S and H that are positive "
            "multiples of 8 elements (bases "
            f"{[hex(t.data_ptr()) for t in (q, k, v)]}, strides "
            f"{[t.stride() for t in (q, k, v)]})")
    if rc != 0:
        raise RuntimeError(f"flash_attn launch failed: CUDA error {rc}")
    LAUNCHES["flash_attn"] += 1
    return (out, lse) if with_lse else out


def flash_attn_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, *, causal: bool,
    window: int | None, logit_cap: float | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5-bwd: dq (B, Sq, H, D), dk and dv (B, Sk, KV, D) of B5's function
    (every key valid: no kv_len) at q, k, v, its output o, the rows'
    log-sum-exp lse (f32 (B, H, Sq), contiguous, as B5 writes it with
    ``with_lse``) and the output's gradient do, all but lse CUDA tensors of
    one type (float32 or bfloat16) with a unit stride on D; the gradients
    come out contiguous in that type.  One call launches the library's
    three kernels (delta, dK/dV, dQ) and counts one in
    LAUNCHES["flash_attn_bwd"]."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    _check_qkv(q, k, v, window, logit_cap, extra=(("o", o), ("do", do)))
    if (not lse.is_cuda or lse.dtype != torch.float32
            or lse.shape != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(
            f"lse must be a contiguous float32 CUDA tensor of shape "
            f"{(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)} on "
            f"{lse.device}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # delta's scratch, per 64-row query tile beside the tile's lse in log2
    # units (B, H, ceil(Sq / 64), 2, 64), read by both types' kernels
    delta = torch.empty(b * h * -(-sq // 64) * 128, dtype=torch.float32,
                        device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [x for t in (q, k, v, o, do, dq, dk, dv) for x in _strides(t)]
    rc = bwd_library().flash_attn_bwd(
        DTYPES[q.dtype], d,
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse, delta)),
        *strides, b, h, kvh, sq, sk, int(causal),
        0 if window is None else int(window),
        0.0 if logit_cap is None else float(logit_cap), stream,
    )
    if rc == TMA_MISALIGNED:
        raise ValueError(
            "bf16 q, k, v, o or do is not TMA-aligned: each needs a base "
            "that is a multiple of 16 bytes and strides on B, S and H that "
            "are positive multiples of 8 elements (strides "
            f"{[t.stride() for t in (q, k, v, o, do)]})")
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: CUDA error {rc}")
    LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv


def _strides(t: torch.Tensor) -> tuple[int, ...]:
    """Strides of B, S and H.  A dim of size 1 is never stepped, so its
    stride is replaced by the tensor's extent, a value TMA accepts."""
    st, shape = t.stride(), t.shape
    if 1 not in shape[:3]:
        return st[:3]
    extent = max(x * n for x, n in zip(st, shape))
    return tuple(x if n > 1 else extent for x, n in zip(st[:3], shape))
