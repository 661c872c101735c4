"""Port congruence of `models.layers.embed` with the reference's
`jnp.take(table, tokens, axis=0)` at the edges of the vocabulary: ids in
[0, vocab) take their row, ids in [-vocab, 0) wrap, and every other id gives
a row of NaN (take's default "fill" mode).  Bitwise, NaN rows included
(`assert_array_equal` counts NaN equal to NaN)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers as tlayers

VOCAB, WIDTH = 11, 6


@pytest.mark.parametrize("table_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16"), ("bfloat16", "float32")])
def test_embed_matches_jnp_take_at_the_vocab_edges(table_dtype, out_dtype):
    table = np.random.default_rng(0).normal(size=(VOCAB, WIDTH)).astype(
        np.float32)
    ids = np.array([[0, VOCAB - 1, VOCAB, -1],
                    [-VOCAB, -VOCAB - 1, 3, 2 * VOCAB]], dtype=np.int32)
    want = jlayers.embed({"table": jnp.asarray(table).astype(table_dtype)},
                         jnp.asarray(ids), getattr(jnp, out_dtype))
    got = tlayers.embed(
        {"table": torch.from_numpy(table).to(getattr(torch, table_dtype))},
        torch.from_numpy(ids).to(torch.int64), getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (2, 4,
                                                                    WIDTH)
    want = np.asarray(want.astype(jnp.float32))
    # the NaN rows are the ids outside [-vocab, vocab)
    assert np.isnan(want).all(-1).tolist() == [[False, False, True, False],
                                               [False, True, False, True]]
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
