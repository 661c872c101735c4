"""Port congruence: the flash attention entry point (B5's plain version, on
CPU tensors) against the JAX package's flash kernel in interpret mode (as
its own tests run it on the CPU) and against its dense oracle
`attention_ref`, on the same numpy inputs, in the model layout (B, S, H, D).

Tolerances: f32 atol 2e-6, rtol 1e-5 (the online softmax and the dense
softmax sum in other orders); bf16 atol 8e-3 plus rtol 2^-7, one bf16 ulp
of the value (both round an f32 result to bf16, and a last-bit difference
may fall on either side of a rounding boundary).  The row log-sum-exp that
B5 writes for its backward is f32 from f32 logits in both frameworks (bf16
inputs are widened first): atol 1e-5, rtol 1e-6 (summation order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import kernel as jkernel
from repro.kernels.flash_attn import ops as jops
from repro.kernels.flash_attn import ref as jref
from repro_torch.kernels.flash_attn import ops as tops
from repro_torch.kernels.flash_attn import ref as tref

TOL = {"float32": dict(atol=2e-6, rtol=1e-5),
       "bfloat16": dict(atol=8e-3, rtol=2 ** -7)}


def _qkv(b, sq, sk, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, sq, h, d)).astype(f),
            rng.normal(size=(b, sk, kv, d)).astype(f),
            rng.normal(size=(b, sk, kv, d)).astype(f))


def _both(arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype``."""
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in j]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


SHAPES = [
    # b, s, h, kv, d, causal, window, cap
    (2, 48, 6, 2, 64, True, None, None),       # GQA 3, ragged 48
    (1, 200, 8, 2, 128, True, None, 30.0),     # GQA 4, grok's logit cap
    (1, 200, 4, 1, 80, True, 16, None),        # h2o-danube width, window
    (2, 48, 8, 2, 80, False, None, None),      # bidirectional
    (1, 128, 6, 2, 128, True, 40, 30.0),       # window and cap together
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window,cap", SHAPES)
def test_plain_matches_jax_flash_and_ref(dtype, b, s, h, kv, d, causal,
                                         window, cap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, h, kv, d), dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    tops.reset_launches()
    out = tops.flash_attention(tq, tk, tv, **kw)
    assert tops.LAUNCHES["flash_attn"] == 0     # CPU tensors: plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    want_flash = jops.flash_attention(jq, jk, jv, block_q=128, block_k=128,
                                      **kw)
    want_ref = jref.attention_ref(
        *(x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)), **kw
    ).transpose(0, 2, 1, 3)
    for want in (want_flash, want_ref):
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


@pytest.mark.parametrize("kv_len", [100, 256])
def test_plain_kv_len_matches_jax_kernel(kv_len):
    """`kv_len < Sk` masks the tail keys (the reference's kernel-level
    argument; its public op passes Sk)."""
    b, h, kv, sq, sk, d = 1, 6, 2, 128, 256, 64
    q, k, v = _qkv(b, sq, sk, h, kv, d, seed=1)
    jt = [jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)]
    want = jkernel.flash_attention_kernel(
        *jt, causal=True, kv_len=kv_len, block_q=64, block_k=64,
        interpret=True)
    out = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=True, kv_len=kv_len)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(want),
                               **TOL["float32"])
    ref = jref.attention_ref(*jt, causal=True, kv_len=kv_len)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(ref),
                               **TOL["float32"])


def test_fully_masked_rows_are_zero():
    """A row with no valid key (its window lies wholly past kv_len) is 0 in
    the plain version, as in the reference's oracle."""
    b, h, kv, s, d = 1, 4, 2, 64, 64
    q, k, v = _qkv(b, s, s, h, kv, d, seed=2)
    kw = dict(causal=True, window=8, kv_len=20)
    out = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               **kw)
    dead = np.arange(s) - 8 + 1 >= 20                   # rows 27..63
    assert dead.any() and not dead.all()
    assert not out[:, dead].any()
    want = jref.attention_ref(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(want),
                               **TOL["float32"])


def test_plain_is_the_dense_oracle_in_model_layout():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 33, 33, 6, 3, 80, 3))
    out = tops.flash_attention_plain(q, k, v, causal=True, window=9)
    want = tref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=9)
    assert torch.equal(out, want.transpose(1, 2))


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _jax_lse(q, k, causal, window, cap, kv_len=None):
    """jax.nn.logsumexp of the reference's scaled, capped, masked logits
    (as its attention_ref forms them) of f32 q, k in the model layout, 0
    for a row with no valid key (one compile per shape: eager dispatch
    compiles every op anew per shape)."""
    q, k = (x.transpose(0, 2, 1, 3) for x in (q, k))
    d, sq, sk = q.shape[-1], q.shape[2], k.shape[2]
    k = jnp.repeat(k, q.shape[1] // k.shape[1], axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(d)
    if cap is not None:
        s = cap * jnp.tanh(s / cap)
    q_pos, k_pos = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    mask = k_pos < (sk if kv_len is None else kv_len)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    lse = jax.nn.logsumexp(s, axis=-1, where=mask)
    return jnp.where(mask.any(axis=-1), lse, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window,cap,kv_len", [
    *(shape + (None,) for shape in SHAPES),
    (1, 48, 4, 2, 64, True, 8, None, 20),      # rows 27..47 see no key
])
def test_plain_lse_matches_jax_logsumexp(dtype, b, s, h, kv, d, causal,
                                         window, cap, kv_len):
    """The plain version of B5's row log-sum-exp (``return_lse``) against
    jax.nn.logsumexp of the reference's logits on the same inputs, f32 (B,
    H, Sq); the output it returns beside it is the plain output."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, h, kv, d, seed=4),
                                       dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap, kv_len=kv_len)
    out, lse = tops.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert torch.equal(out, tops.flash_attention_plain(tq, tk, tv, **kw))
    want = np.asarray(_jax_lse(jq.astype(jnp.float32), jk.astype(jnp.float32),
                               causal, window, cap, kv_len))
    if kv_len is not None:
        dead = np.arange(s) - window + 1 >= kv_len
        assert dead.any() and not want[..., dead].any()
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)
