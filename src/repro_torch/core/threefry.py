"""JAX's threefry2x32 random numbers in torch, on any device.

Reproduces, bit for bit, what jax 0.9.0 computes for ``PRNGKey``,
``split``, ``fold_in``, ``random_bits`` (32-bit), ``uniform``, ``gumbel``
(float32, mode "low"), ``bernoulli``, ``categorical`` (with replacement),
``normal`` (float32) and ``randint`` (int32) under both settings of
``jax_threefry_partitionable``:

* the original scheme hashes ``iota(n)`` with the count split in halves
  (an odd count padded with one zero): output i < n/2 is the first word of
  hash(i, i + n/2), the rest the second words.  ``split(key, num)`` hashes
  ``iota(2 num)`` that way, and key i is words (2i, 2i + 1) of the result;
* the partitionable scheme hashes a (hi, lo) = (0, i) counter pair per
  element: ``split`` keeps both words, 32-bit ``random_bits`` their xor.

Under either scheme an element's bits are a function of its flat index
(and of the draw's size), so `categorical` draws its (rows, V) Gumbel
array a slice of rows at a time: at V = 128,256 the whole draw never
lives at once.  `gumbel` takes its logarithm from `xla_log`, the Cephes
polynomial XLA's CPU backend emits for ``log`` (torch's ``log`` differs
from it in the last bit for about one value in seven), so the draws are
the reference's bits on any device.  ``normal`` (float32) takes XLA:CPU's
erf_inv and log1p, written out the same way (`xla_erfinv`, `xla_log1p`).

The partitionable scheme is jax 0.9.0's default and this module's;
`threefry_partitionable` switches it for a block, as
``jax.threefry_partitionable`` does.  A key is an int64 tensor whose last
dim holds its two 32-bit words; every function broadcasts over the leading
dims of its key, so one call draws for many keys.  The words ride int64
tensors masked to 32 bits: torch's uint32 lacks shifts and adds on several
backends.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

Tensor = torch.Tensor
_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_PARTITIONABLE = contextvars.ContextVar("threefry_partitionable", default=True)


def partitionable() -> bool:
    """The scheme in force: True for the partitionable one (the default)."""
    return _PARTITIONABLE.get()


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Draw with the partitionable scheme (True) or the original one
    (False) inside the block; the setting before it is restored after."""
    token = _PARTITIONABLE.set(bool(flag))
    try:
        yield
    finally:
        _PARTITIONABLE.reset(token)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & _M) | (x >> (32 - r))


def hash2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor):
    """The threefry2x32 block function (20 rounds) on broadcastable int64
    tensors of 32-bit words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M
    x1 = (x1 + k1) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def prng_key(seed: int | Tensor, device=None) -> Tensor:
    """``jax.random.PRNGKey(seed)`` for int32 seeds (x64 off): the words
    (0, seed mod 2^32), shape (..., 2) for a tensor of seeds."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    if ((s < -2**31) | (s >= 2**31)).any():
        raise ValueError("PRNGKey takes int32 seeds")
    return torch.stack([torch.zeros_like(s), s & _M], dim=-1)


def _hash_count(key: Tensor, n: int):
    """The original scheme's hash of iota(n) under ``key`` (..., 2): the
    n output words, (..., n)."""
    half = (n + 1) // 2
    dev = key.device
    x0 = torch.arange(half, dtype=torch.int64, device=dev)
    x1 = torch.arange(half, 2 * half, dtype=torch.int64, device=dev)
    if n % 2:
        x1[-1] = 0
    k0, k1 = key[..., 0, None], key[..., 1, None]
    o0, o1 = hash2x32(k0, k1, x0, x1)
    return torch.cat([o0, o1], dim=-1)[..., :n]


def _hash_pairs(key: Tensor, n: int):
    """The partitionable scheme's hash of the counters (0, i), i < n."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return hash2x32(key[..., 0, None], key[..., 1, None],
                    torch.zeros_like(lo), lo)


def _bits_range(key: Tensor, n: int, start: int, stop: int) -> Tensor:
    """Words [start, stop) of 32-bit ``random_bits`` over n elements under
    one key (2,): what ``random_bits(key, (n,))[start:stop]`` gives,
    computing only those words."""
    i = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    k0, k1 = key[0], key[1]
    if partitionable():
        b1, b2 = hash2x32(k0, k1, torch.zeros_like(i), i)
        return b1 ^ b2
    # the original scheme: word i < half is the first word of
    # hash(i, i + half), word i >= half the second of hash(i - half, i);
    # an odd count's last pair is (half - 1, 0)
    half = (n + 1) // 2
    first = i < half
    j = torch.where(first, i, i - half)
    x1 = j + half
    if n % 2:
        x1 = torch.where(j == half - 1, torch.zeros_like(x1), x1)
    o0, o1 = hash2x32(k0, k1, j, x1)
    return torch.where(first, o0, o1)


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split(key, num)``: (..., 2) -> (..., num, 2)."""
    if partitionable():
        b1, b2 = _hash_pairs(key, num)
        return torch.stack([b1, b2], dim=-1)
    return _hash_count(key, 2 * num).reshape((*key.shape[:-1], num, 2))


def fold_in(key: Tensor, data: int) -> Tensor:
    """``jax.random.fold_in(key, data)`` for an int32 ``data``: the hash of
    the counter pair (0, data), under either scheme."""
    d = torch.full_like(key[..., 0], int(data) & _M)
    o0, o1 = hash2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: Tensor, shape: tuple[int, ...] = ()) -> Tensor:
    """32-bit ``random_bits``: (..., 2) -> (..., *shape) int64 words."""
    size = math.prod(shape)
    if size >= 2**32 - 1:
        raise ValueError("random_bits draws fewer than 2^32 - 1 words")
    if partitionable():
        b1, b2 = _hash_pairs(key, size)
        bits = b1 ^ b2
    else:
        bits = _hash_count(key, size)
    return bits.reshape((*key.shape[:-1], *shape))


def uniform(key: Tensor, shape: tuple[int, ...] = (),
            minval: float = 0.0, maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform(key, shape)`` in float32: 23 random mantissa
    bits under exponent 0 make [1, 2), shifted and scaled as JAX does."""
    return _to_uniform(random_bits(key, shape), minval, maxval)


def _to_uniform(bits: Tensor, minval: float, maxval: float) -> Tensor:
    one_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, (one_two - 1.0) * (hi - lo) + lo)


F32_TINY = 1.1754943508222875e-38   # float32's smallest normal
# the polynomial's coefficients, rounded to float32 as XLA holds them
_LOG_P = torch.tensor((
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1), dtype=torch.float32).tolist()


def _fma(a: Tensor, b, c) -> Tensor:
    """a * b + c rounded once to float32 (float32 operands: the product is
    exact in float64, the sum rounds there and then to float32)."""
    return (a.double() * b + c).float()


def xla_log(x: Tensor) -> Tensor:
    """float32 log as XLA's CPU backend computes it for positive normal
    inputs: the Cephes polynomial (Eigen's former plog), with the fused
    multiply-adds LLVM forms.  Inputs below the smallest normal are
    clamped to it, as there; zero, negative and non-finite inputs are not
    handled (`gumbel` never makes them)."""
    f32 = torch.float32
    x = torch.clamp(x.to(f32), min=F32_TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(f32) - 126.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(f32)
    small = m < 0.707106781186547524
    t = m - 1.0
    e = torch.where(small, e - 1.0, e)
    t = torch.where(small, t + m, t)
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = _fma(torch.full_like(t, p[0]), t, p[1])
    y1 = _fma(torch.full_like(t, p[3]), t, p[4])
    y2 = _fma(torch.full_like(t, p[6]), t, p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * -2.12194440e-4)
    t = t - t2 * 0.5
    t = t + y
    return t + e * 0.693359375


def gumbel(key: Tensor, shape: tuple[int, ...] = ()) -> Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, mode "low": -log(-log
    u) of a uniform u on [tiny, 1), for one key (2,)."""
    return _gumbel_of(random_bits(key, shape))


def _gumbel_of(bits: Tensor) -> Tensor:
    return -xla_log(-xla_log(_to_uniform(bits, F32_TINY, 1.0)))


def bernoulli(key: Tensor, p: float, shape: tuple[int, ...]) -> Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float p (a
    float32 mean), mode "low": uniform < p."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


CATEGORICAL_SLICE = 1 << 24   # Gumbel elements drawn at a time


def categorical(key: Tensor, logits: Tensor,
                shape: tuple[int, ...]) -> Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for one key (2,)
    and float32 logits (V,) over the last axis (with replacement): the
    argmax over V of a (*shape, V) Gumbel draw plus the logits, the first
    maximum on a tie.  The draw is taken whole rows at a time, at most
    ``CATEGORICAL_SLICE`` elements each, each slice's bits being those its
    flat indices have in the whole draw.  Returns int64 (*shape)."""
    v = logits.shape[-1]
    rows = math.prod(shape)
    n = rows * v
    if n >= 2**32 - 1:
        raise ValueError("categorical draws fewer than 2^32 - 1 words")
    logits = logits.to(torch.float32)
    step = max(1, CATEGORICAL_SLICE // v)
    out = []
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        g = _gumbel_of(_bits_range(key, n, r0 * v, r1 * v)).view(r1 - r0, v)
        out.append(torch.argmax(g + logits, dim=-1))
    if not out:
        return torch.zeros(shape, dtype=torch.int64, device=key.device)
    return torch.cat(out).view(shape)


# XLA's float32 erf_inv: a degree-8 polynomial in w - 2.5 (w < 5) or in
# sqrt(w) - 3 (w >= 5), w = -log1p(-x^2), coefficients highest first
_ERFINV_LT5 = torch.tensor((
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941), dtype=torch.float32).tolist()
_ERFINV_GE5 = torch.tensor((
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682), dtype=torch.float32).tolist()
# XLA:CPU's log1p below |x| = sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x),
# the Cephes rational, coefficients highest first (rounded to float32)
_LOG1P_P = torch.tensor((
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1), dtype=torch.float32).tolist()
_LOG1P_Q = torch.tensor((
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1),
    dtype=torch.float32).tolist()


def _horner(x: Tensor, coeffs) -> Tensor:
    """sum c_i x^(n-i), each step one fused multiply-add (`_fma`)."""
    y = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        y = _fma(y, x, c)
    return y


def xla_log1p(x: Tensor) -> Tensor:
    """float32 log1p as XLA's CPU backend computes it on (-1, 1): the
    Cephes rational for |x| < sqrt(2) - 1 (its polynomials in fused
    multiply-adds), else `xla_log` of 1 + x."""
    x2 = x * x
    r = _horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)
    small = x + _fma(torch.full_like(x, -0.5), x2, (x * x2) * r)
    large = xla_log(x + 1.0)
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def xla_erfinv(x: Tensor) -> Tensor:
    """float32 erf_inv as XLA expands it (Giles' two-branch polynomial
    on w = -log1p(-x^2), in fused multiply-adds), on (-1, 1); +-1 give
    +-inf.  The square root is taken in float64 and rounded once, which
    is the correctly rounded float32 root XLA's takes (torch's CPU sqrt
    can differ in the last bit)."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0)
    lo = torch.tensor(_ERFINV_LT5, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = torch.tensor(math.sqrt(2), dtype=torch.float32).item()
# nextafter(-1, 0) in float32: the low end of normal's uniform draw
_NORMAL_LO = -1.0 + 2.0 ** -24


def normal(key: Tensor, shape: tuple[int, ...] = ()) -> Tensor:
    """``jax.random.normal(key, shape)`` in float32, for one key (2,):
    sqrt(2) erf_inv(u) of a uniform u on [nextafter(-1, 0), 1), with
    XLA:CPU's erf_inv (`xla_erfinv`), bit for bit."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.tensor(_SQRT2, device=u.device) * xla_erfinv(u)


def randint(key: Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 for
    int32 bounds: two 32-bit words per value from the key's two halves,
    reduced mod the span as JAX does in uint32 arithmetic."""
    if not -2**31 <= minval <= maxval - 1 < 2**31 - 1:
        raise ValueError(f"randint needs int32 bounds with minval < maxval, "
                         f"got [{minval}, {maxval})")
    k = split(key, 2)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & _M
    mult = (2**16 % span) ** 2 & _M
    mult %= span
    off = (((hi % span) * mult) & _M) + lo % span
    off = (off & _M) % span
    return (minval + off).to(torch.int32)
