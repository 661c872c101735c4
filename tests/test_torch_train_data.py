"""Port congruence: the training data path — threefry's `fold_in`,
`gumbel`, `bernoulli` and `categorical` and the synthetic dataset —
against `jax.random` and the reference's `SyntheticDataset`, bitwise,
under both settings of `jax_threefry_partitionable` (each flip scoped, as
tests/test_torch_threefry.py scopes it).

`gumbel` needs XLA:CPU's float32 log, which torch's `log` misses in the
last bit for about one value in seven; `threefry.xla_log` transcribes it
and is held bitwise against `jnp.log` here."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data import synthetic as jsyn
from repro_torch.core import threefry as tf
from repro_torch.data import synthetic as tsyn
from repro_torch.data.prefetch import Prefetcher

FLAGS = [True, False]


@contextlib.contextmanager
def both(flag):
    with jax.threefry_partitionable(flag), tf.threefry_partitionable(flag):
        yield


def same_bits(a, b: torch.Tensor):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape
    assert a.astype(b.dtype).tobytes() == b.tobytes()


def test_xla_log_is_xla_cpu_log():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(1.2e-38, 1.0, 400_000),
        rng.uniform(0.0, 90.0, 100_000),
        np.exp(rng.uniform(-87, 88, 100_000)),
        [1.1754944e-38, 1.0, 2.0, 0.5, 0.70710677, 3.4e38],
    ]).astype(np.float32)
    same_bits(jnp.log(x), tf.xla_log(torch.from_numpy(x)))


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_fold_in(flag, seed):
    with both(flag):
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        for d in (0, 1, 5, 123_457, 2**31 - 1):
            np.testing.assert_array_equal(
                np.asarray(jax.random.fold_in(jk, d)).astype(np.int64),
                tf.fold_in(tk, d).numpy())


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_gumbel_and_bernoulli(flag, seed):
    with both(flag):
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        for shape in ((), (7,), (33, 17), (2, 3, 65)):
            same_bits(jax.random.gumbel(jk, shape), tf.gumbel(tk, shape))
        for p in (0.7, 0.5, 0.01):
            same_bits(jax.random.bernoulli(jk, p, (5, 9)),
                      tf.bernoulli(tk, p, (5, 9)))


@pytest.mark.parametrize("flag", FLAGS)
def test_categorical_sliced_at_full_vocab(flag):
    """At llama3.2-3b's vocabulary (V = 128,256) the draw is taken in row
    slices; whole, in slices of one and two rows, and at an odd total
    count (the original scheme pads it), the samples equal JAX's."""
    v = 128_256
    logits = np.random.default_rng(1).normal(size=v).astype(np.float32)
    tl = torch.from_numpy(logits)
    old = tf.CATEGORICAL_SLICE
    with both(flag):
        jk, tk = jax.random.PRNGKey(11), tf.prng_key(11)
        for shape in ((2, 3), (1, 5)):
            want = np.asarray(jax.random.categorical(jk, logits, shape=shape))
            try:
                for rows in (1, 64):
                    tf.CATEGORICAL_SLICE = rows * v
                    same_bits(want, tf.categorical(tk, tl, shape).to(
                        torch.int32))
            finally:
                tf.CATEGORICAL_SLICE = old


@pytest.mark.parametrize("flag", FLAGS)
def test_sliced_bits_equal_the_whole_draw(flag):
    """An element's bits are a function of its flat index (and the draw's
    size): every slice of `_bits_range` equals the same words of one
    whole `random_bits` draw, at even and odd sizes."""
    with both(flag):
        key = tf.prng_key(5)
        for n in (1000, 1001):
            whole = tf.random_bits(key, (n,))
            for a, b in ((0, 1), (0, n), (3, 17), (500, 501), (n - 7, n)):
                assert torch.equal(tf._bits_range(key, n, a, b), whole[a:b])


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("arch,seq,batch,seed", [
    ("llama3.2-3b", 32, 2, 0), ("llama3.2-3b", 17, 3, 9),
    ("grok-1-314b", 24, 2, 1)])
def test_synthetic_batches_are_the_reference_bits(flag, arch, seq, batch,
                                                   seed):
    with both(flag):
        jd = jsyn.make_dataset(jconfigs.smoke(arch), seq, batch, seed=seed)
        td = tsyn.make_dataset(tconfigs.smoke(arch), seq, batch, seed=seed,
                               device="cpu")
        for step in range(4):
            want, got = jd.batch(step), td.batch(step)
            assert set(want) == set(got) == {"tokens", "labels", "mask"}
            for k in want:
                assert got[k].dtype == {"mask": torch.float32}.get(
                    k, torch.int32)
                same_bits(want[k], got[k])


def test_synthetic_batch_at_full_vocab():
    """llama3.2-3b's full vocabulary: the Markov map's int32 product
    wraps (2654435761 mod V times a token passes 2^31), as the
    reference's does."""
    jd = jsyn.make_dataset(jconfigs.get("llama3.2-3b"), 16, 2, seed=3)
    td = tsyn.make_dataset(tconfigs.get("llama3.2-3b"), 16, 2, seed=3,
                           device="cpu")
    want, got = jd.batch(2), td.batch(2)
    for k in want:
        same_bits(want[k], got[k])


def test_frontend_embeds_and_normal_run():
    """A frontend config's dataset draws its embeds (bitwise the
    reference's: tests/test_torch_frontends.py) and `normal` draws."""
    cfg = tconfigs.smoke("internvl2-2b")
    batch = tsyn.make_dataset(cfg, 8, 2, device="cpu").batch(0)
    assert batch["embeds"].shape == (2, cfg.frontend_len, cfg.frontend_dim)
    assert batch["embeds"].dtype == torch.float32
    x = tf.normal(tf.prng_key(0), (3,))
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())


def test_prefetcher_keeps_order_and_raises_the_producer_error():
    seen = []

    def make(step):
        if step == 5:
            raise ValueError("bad step")
        seen.append(step)
        return {"x": torch.full((2,), float(step))}

    pf = Prefetcher(make, depth=2, start_step=2)
    try:
        for want in (2, 3, 4):
            step, batch = pf.get()
            assert step == want and float(batch["x"][0]) == want
        with pytest.raises(ValueError, match="bad step"):
            pf.get()
    finally:
        pf.close()
