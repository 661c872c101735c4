"""Port congruence: `repro_torch.core.threefry` against `jax.random`,
bitwise, under both settings of `jax_threefry_partitionable` (jax 0.9.0
defaults it to True).  Each flip of the JAX flag is scoped with the
config's own context manager, so no setting leaks into the other tests of
this process; the port's flag is scoped the same way."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import threefry as tf
from repro_torch.core.noc import sim as tsim

SEEDS = [0, 1, 2, 42, 2**31 - 1]
FLAGS = [True, False]


@contextlib.contextmanager
def both(flag):
    with jax.threefry_partitionable(flag), tf.threefry_partitionable(flag):
        yield


def words(key) -> np.ndarray:
    """A JAX key's two uint32 words as int64 (raw or typed keys)."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key).astype(np.int64)


def same_bits(a, b: torch.Tensor):
    a = np.asarray(a)
    assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
    assert a.tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(flag, seed):
    with both(flag):
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        np.testing.assert_array_equal(words(jk), tk.numpy())
        for n in (3, 500, 12):
            np.testing.assert_array_equal(words(jax.random.split(jk, n)),
                                          tf.split(tk, n).numpy())


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(flag, seed):
    with both(flag):
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        for shape in ((), (36,), (64,)):
            same_bits(jax.random.uniform(jk, shape), tf.uniform(tk, shape))


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(flag, seed):
    with both(flag):
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        for shape in ((), (36,), (64,)):
            same_bits(jax.random.randint(jk, shape, 0, 8),
                      tf.randint(tk, shape, 0, 8))
        # a span that is not a power of two exercises the 2^32 mod span term
        same_bits(jax.random.randint(jk, (37,), -5, 100_003),
                  tf.randint(tk, (37,), -5, 100_003))


@pytest.mark.parametrize("flag", FLAGS)
def test_draws_broadcast_over_a_batch_of_keys(flag):
    """One call on (n, k, 2) keys equals JAX vmapped over them."""
    with both(flag):
        jk = jax.random.split(jax.random.split(jax.random.PRNGKey(7), 3)[1], 5)
        tk = tf.split(tf.split(tf.prng_key(7), 3)[1], 5)
        jk2 = jax.vmap(lambda k: jax.random.split(k, 4))(jk)
        tk2 = tf.split(tk, 4)
        np.testing.assert_array_equal(words(jk2), tk2.numpy())
        vv = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (36,))))
        same_bits(vv(jk2), tf.uniform(tk2, (36,)))
        vi = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (36,), 0, 8)))
        same_bits(vi(jk2), tf.randint(tk2, (36,), 0, 8))


def test_flag_context_restores():
    assert tf.partitionable() is True
    with tf.threefry_partitionable(False):
        assert tf.partitionable() is False
        with tf.threefry_partitionable(True):
            assert tf.partitionable() is True
        assert tf.partitionable() is False
    assert tf.partitionable() is True


def _jax_epoch_streams(seed, n_epochs, L, R, n_mc):
    """The reference simulator's draws (repro/core/noc/sim.py), numpy."""
    @jax.jit
    def one(k):
        keys = jax.random.split(k, L)
        k3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        up = jax.vmap(lambda k: jax.random.uniform(k, ()))(k3[:, 0])
        ug = jax.vmap(lambda k: jax.random.uniform(k, (R,), jnp.float32))(
            k3[:, 1])
        di = jax.vmap(lambda k: jax.random.randint(k, (R,), 0, n_mc))(
            k3[:, 2])
        return up, ug, di

    keys = jax.random.split(jax.random.PRNGKey(seed), n_epochs)
    outs = [one(keys[e]) for e in range(n_epochs)]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


@pytest.mark.parametrize("flag", FLAGS)
def test_epoch_streams_are_the_reference_draws(flag):
    """`sim.threefry_epoch_streams` for a batch of seeds (one repeated)
    gives each row its seed's reference streams, epoch by epoch, also when
    the epochs are drawn in several chunks."""
    E, L, R, n_mc = 5, 30, 36, 8
    seeds = [3, 0, 3, 2**31 - 1]
    old = tsim.STREAM_BYTES
    with both(flag):
        ref = {s: _jax_epoch_streams(s, E, L, R, n_mc) for s in set(seeds)}
        streams = tsim.threefry_epoch_streams(seeds, E, L, R, n_mc)
        tsim.STREAM_BYTES = 1  # one epoch a chunk
        try:
            chunked = tsim.threefry_epoch_streams(seeds, E, L, R, n_mc)
        finally:
            tsim.STREAM_BYTES = old
    # drawn outside the block: each provider keeps the setting it was
    # made under
    for e in range(E):
        got = streams(e)
        for b, s in enumerate(seeds):
            for k in range(3):
                same_bits(ref[s][k][e], got[k][b])
        for x, y in zip(got, chunked(e)):
            assert torch.equal(x, y)
