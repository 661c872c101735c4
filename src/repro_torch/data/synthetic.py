"""Deterministic synthetic token pipeline.

A reproducible pseudo-corpus (Zipfian unigrams + a short-range Markov
mixer), so that the training loss is a meaningful, decreasing signal
without external datasets.  Every batch is a pure function of (seed,
step), drawn with the JAX package's threefry streams
(`repro_torch.core.threefry`): tokens, labels and mask are bitwise the
reference's for the same (seed, step), under either threefry scheme, and
on any device.  Resuming at step k reproduces the exact batch stream a
run without failure would have seen.

The batch is made on the dataset's device (the CUDA device unless the
caller names another).  The categorical draw is taken a slice of rows at
a time (`threefry.categorical`), so at llama3.2-3b's vocabulary of
128,256 the (B, S + 1, V) Gumbel array never lives whole.  A config with
a modality frontend also gets ``embeds`` (B, frontend_len, frontend_dim),
a float32 normal draw (`threefry.normal`, bitwise the reference's), and
its mask zeroed on the first frontend_len positions, as the reference
does.  For the encoder-decoder (seamless) that zeroes decoder positions,
though its embeds feed the encoder: a quirk of the reference, mirrored.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._util import resolve_device
from repro_torch.core import threefry

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.1         # unigram skew
    markov_mix: float = 0.7     # P(next ~ markov) vs unigram resample
    frontend_len: int = 0       # [audio]/[vlm]: prefix length
    frontend_dim: int = 0


def _unigram_logits(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks ** cfg.zipf_a
    return np.log(probs / probs.sum()).astype(np.float32)


def _wrap_int32(x: Tensor) -> Tensor:
    """int64 values taken mod 2^32 into int32's range, as int32 arithmetic
    wraps in the reference."""
    return ((x + 2**31) % 2**32) - 2**31


@dataclasses.dataclass
class SyntheticDataset:
    cfg: DataConfig
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._logits = torch.from_numpy(_unigram_logits(self.cfg)).to(
            self.device)

    def batch(self, step: int) -> dict[str, Tensor]:
        """Pure function of (seed, step) -> {tokens, labels, mask[,
        embeds]}: int32, int32 and float32 (B, S) tensors (and float32
        (B, F, frontend_dim) embeds) on the dataset's device."""
        cfg = self.cfg
        key = threefry.fold_in(
            threefry.prng_key(cfg.seed, device=self.device), step)
        k_tok, k_mix, _k_shift, k_emb = threefry.split(key, 4)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size

        base = threefry.categorical(k_tok, self._logits, (b, s + 1))
        # Markov mixer: with prob markov_mix, token t = f(token t-1) via a
        # fixed pseudo-random permutation (int32 arithmetic, wrapping)
        perm_mult = 2654435761 % v  # Knuth multiplicative hash
        mapped = _wrap_int32(_wrap_int32(base[:, :-1] * perm_mult) + 12289)
        mapped = torch.remainder(mapped, v)   # the sign of the divisor
        take_markov = threefry.bernoulli(k_mix, cfg.markov_mix, (b, s))
        toks = torch.where(take_markov, mapped, base[:, 1:])
        tokens = torch.cat([base[:, :1], toks[:, :-1]], dim=1)
        out = {
            "tokens": tokens.to(torch.int32),
            "labels": toks.to(torch.int32),
            "mask": torch.ones((b, s), dtype=torch.float32,
                               device=self.device),
        }
        if cfg.frontend_len:
            out["embeds"] = threefry.normal(
                k_emb, (b, cfg.frontend_len, cfg.frontend_dim))
            # prefix positions carry no next-token loss
            out["mask"][:, :cfg.frontend_len] = 0.0
        return out


def make_dataset(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                 device: str | torch.device | None = None
                 ) -> SyntheticDataset:
    return SyntheticDataset(DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        frontend_len=model_cfg.frontend_len if model_cfg.frontend else 0,
        frontend_dim=model_cfg.frontend_dim if model_cfg.frontend else 0,
    ), device=device)
