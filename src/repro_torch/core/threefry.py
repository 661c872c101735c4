"""JAX's threefry2x32 random numbers in torch, on any device.

Reproduces, bit for bit, what jax 0.9.0 computes for ``PRNGKey``,
``split``, ``random_bits`` (32-bit), ``uniform`` (float32) and ``randint``
(int32) under both settings of ``jax_threefry_partitionable``:

* the original scheme hashes ``iota(n)`` with the count split in halves
  (an odd count padded with one zero): output i < n/2 is the first word of
  hash(i, i + n/2), the rest the second words.  ``split(key, num)`` hashes
  ``iota(2 num)`` that way, and key i is words (2i, 2i + 1) of the result;
* the partitionable scheme hashes a (hi, lo) = (0, i) counter pair per
  element: ``split`` keeps both words, 32-bit ``random_bits`` their xor.

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


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split(key, num)``: (..., 2) -> (..., num, 2)."""
    if partitionable():
        b1, b2 = _hash_pairs(key, num)
        return torch.stack([b1, b2], dim=-1)
    return _hash_count(key, 2 * num).reshape((*key.shape[:-1], num, 2))


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
    bits = random_bits(key, shape)
    one_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (one_two - 1.0) * (hi - lo) + lo)


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
