"""Helpers of the zamba2 congruence tests (tests/test_torch_hybrid.py,
tests/test_torch_serve_ssm.py): one GEMM for both packages, the
reference's attention on its flash kernel, a prefill-and-decode run of
either package, and the witness of the reference's own drift between its
compiled run and its eager flash-routed run.

The reference's bf16 `matmul` (XLA's dot) sums k in another order than
the port's f32 product on the CPU; `jax_matmul` / `torch_matmul` give
both packages one product (float64 sums, rounded to f32, then to the
input type) so that a comparison sees everything else.  The reference's
prefill runs `attend_ref`, which rounds the probabilities to bf16 before
the PV product; its flash kernel (run in interpret mode here) keeps them
f32, as the port's flash path does.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro_torch.models import lm as tlm

ARCH = "zamba2-2.7b"


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tokens(seed: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, jconfigs.smoke(ARCH).vocab_size, (2, s)).astype(np.int32)


def _exact(a, w, spec):
    """a (bf16 values as f32) x w -> f32, summed in float64."""
    return np.einsum(spec, a.astype(np.float64),
                     w.astype(np.float64)).astype(np.float32)


def jax_matmul(x, w, spec=None):
    """`repro.models.layers.matmul` on `_exact` (a host callback, so that
    it also runs under the reference's remat and scans)."""
    spec = spec or "...d,df->...f"
    xf, wf = x.astype(jnp.float32), w.astype(x.dtype).astype(jnp.float32)
    out = jax.eval_shape(lambda a, b: jnp.einsum(spec, a, b), xf, wf)
    return jax.pure_callback(
        lambda a, b: _exact(np.asarray(a), np.asarray(b), spec),
        out, xf, wf).astype(x.dtype)


def torch_matmul(x, w):
    """`repro_torch.models.layers.matmul` on `_exact`."""
    out = _exact(x.float().numpy(), w.to(x.dtype).float().numpy(),
                 "...d,df->...f")
    return torch.from_numpy(out).to(x.dtype)


def reversed_k_matmul(x, w):
    """The port's CPU product with k summed in the other order."""
    return torch.matmul(x.float().flip(-1), w.float().flip(0)).to(x.dtype)


def flash_attend(monkeypatch):
    """The reference's `attend` through its flash kernel."""
    orig = jattention.attend
    monkeypatch.setattr(jattention, "attend", lambda *a, **k: orig(
        *a, **{**k, "use_kernel": True}))


def state_fields(st) -> dict:
    """Every cache field of a hybrid decode state, by name."""
    out = {}
    for j, c in enumerate(st.caches):
        out[f"ssm{j}"], out[f"conv{j}"] = c.ssm, c.conv
    out["shared k"], out["shared v"] = st.shared_kv.k, st.shared_kv.v
    return out


def prefill_decode(step_fn, prefill_fn, toks, n_steps=3) -> dict:
    """Prefill, then n_steps decode steps on seeded tokens: every field of
    the state after each, and the logits of each step (numpy copies: the
    port's decode_step writes its caches in place)."""
    rng = np.random.default_rng(100 + toks.shape[1])
    st = prefill_fn(toks)
    seen = {f"prefill {k}": to_np(v).copy()
            for k, v in state_fields(st).items()}
    for t in range(n_steps):
        tok = rng.integers(0, jconfigs.smoke(ARCH).vocab_size,
                           (2, 1)).astype(np.int32)
        logits, st = step_fn(tok, st)
        seen[f"logits {t}"] = to_np(logits).copy()
        seen.update({f"decode {t} {k}": to_np(v).copy()
                     for k, v in state_fields(st).items()})
    return seen


def runs(model, eager_jax: bool):
    """((prefill, step) of the reference, (prefill, step) of the port) on
    ``model`` = (params, cfg_j, tparams, cfg_t); the reference's run
    eagerly when ``eager_jax``."""
    params, cfg_j, tparams, cfg_t = model
    ctx = jax.disable_jit if eager_jax else contextlib.nullcontext

    def jax_prefill(toks):
        with ctx():
            return jlm.prefill_caches(params, jnp.asarray(toks), cfg_j, 32)

    def jax_step(tok, st):
        with ctx():
            return jlm.decode_step(params, jnp.asarray(tok), st, cfg_j)

    def port_prefill(toks):
        return tlm.prefill_caches(tparams, torch.from_numpy(toks), cfg_t, 32)

    def port_step(tok, st):
        return tlm.decode_step(tparams, torch.from_numpy(tok), st, cfg_t)

    return (jax_prefill, jax_step), (port_prefill, port_step)


def worst(got: dict, want: dict) -> tuple[str, float]:
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    k = max(errs, key=errs.get)
    return k, errs[k]


def compile_witness(model, s: int) -> tuple[dict, str, float]:
    """The reference's compiled prefill + 3 decode steps on ``tokens(s,
    s)``, and its worst distance (field, relative L2) from the same calls
    run eagerly with its attention on the flash kernel."""
    toks = tokens(s, s)
    (jp, js), _ = runs(model, eager_jax=False)
    want = prefill_decode(js, jp, toks)
    with pytest.MonkeyPatch.context() as mp:
        flash_attend(mp)
        (ep, es), _ = runs(model, eager_jax=True)
        eager = prefill_decode(es, ep, toks)
    return (want, *worst(eager, want))
