"""Port congruence: the MoE decoders' serving calls — `prefill_caches`
and `decode_step` of grok-1 and llama4-maverick — against the JAX package
at their smoke sizes, with the reference's parameters carried across by
`interop.lm_params`: a prefill and 3 decode steps of 2 slots (2 tokens a
step, so capacity 1: routes are dropped in every step), every K/V cache
and the logits after each.

Held first eagerly, with ONE GEMM on both sides (tests/_torch_moe.py),
to relative L2 <= 1e-5; then against the compiled reference within
max(1e-2, 1.5 x the reference's own distance between that compiled run
and its eager flash-routed run on the same calls), the bound of
tests/test_torch_moe_lm.py and tests/test_torch_hybrid.py.  Cache lengths
are equal.
"""
import pytest

from _torch_moe import (ARCHS, compile_witness, model, one_gemm,
                        prefill_decode, tokens, worst)

EAGER = 1e-5
MODEL = 1e-2


@pytest.fixture(scope="module", params=ARCHS)
def m(request):
    return model(request.param)


def test_prefill_and_decode_match_jax_eagerly_on_one_gemm(m):
    """prefill_caches, then 3 decode_steps (2 slots: 2 tokens a step, so
    capacity 1 and drops in every step): every K/V cache and the logits
    within 1e-5 relative L2 of the reference run eagerly."""
    with one_gemm():
        want, got = prefill_decode(m, tokens(m[3], 16, 16),
                                   eager_jax=True)
    name, err = worst(got, want)
    print(f"{m[3].name} eager, one GEMM: worst relative L2 {err:.3e} "
          f"({name})")
    assert err <= EAGER, name


def test_prefill_and_decode_match_jax(m):
    """Against the compiled reference: the worst field within max(1e-2,
    1.5 x the worst distance of the reference's compiled run from its
    eager flash-routed run on the same calls); lengths exactly."""
    toks = tokens(m[3], 13, 13)
    want, w_name, witness = compile_witness(m, toks)
    _, got = prefill_decode(m, toks, eager_jax=False)
    name, err = worst(got, want)
    bound = max(MODEL, 1.5 * witness)
    print(f"{m[3].name} compiled: worst relative L2 {err:.3e} ({name}); "
          f"the reference's compiled against its eager run {witness:.3e} "
          f"({w_name}); bound {bound:.3e}")
    assert err <= bound, name
