"""Encoder-decoder backbone (seamless-m4t-large-v2).

The speech frontend is a stub (precomputed frame embeddings through a
linear projector, `frontends`); the backbone is the 24-layer encoder and
24-layer decoder transformer.  Encoder blocks are bidirectional
self-attention; decoder blocks are causal self-attention, cross-attention
and an MLP.  Decoding threads a self-attention KV cache and cross-attention
K/V computed once per sequence at prefill.  Positions use RoPE, as in the
reference (the published model uses a relative position bias; that does
not change shapes or FLOPs).

The parameter tree keeps the reference's names, except that its stacked
``enc_blocks`` / ``dec_blocks`` are lists of per-layer dicts here, walked
by a Python loop (`interop.encdec_params` carries a reference tree
across).  Attention in the encoder goes through `attention.attend` with
no mask, so through the flash kernel (B5, ``causal=False``) on the card
and B5-bwd under autograd; the decoder's self-attention through `attend`,
causal; cross-attention through the plain `attention.attend_ref`, as the
reference computes it outside any kernel.  Each block runs under
``cfg.remat`` while gradients are recorded (`lm._remat_wrap`).

The reference's `encode`, `forward` and `encdec_loss` take ``use_kernel``
to pick its Pallas kernel over its plain attention, and its
`init_encdec_state` encodes with ``use_kernel=False`` (probabilities
rounded to bf16 before PV).  The port's `attend` has no such choice: it
always goes through B5 (the plain version keeps the probabilities in f32),
so these functions take no ``use_kernel`` and `init_encdec_state` encodes
through B5 too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention, frontends, layers, lm
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import ACT_DTYPE

Tensor = torch.Tensor


def _make_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {
        "ln1": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "ln2": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "attn": attention.make_attention(gen, cfg, dtype),
        "mlp": layers.make_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _make_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {
        "ln1": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "ln2": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "ln3": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "attn": attention.make_attention(gen, cfg, dtype),
        "cross": attention.make_attention(gen, cfg, dtype),
        "mlp": layers.make_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def make_encdec(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (tests carry the
    reference's across with `interop.encdec_params`)."""
    dtype = lm.param_dtype(cfg)
    dev = gen.device
    params = {
        "embed": layers.make_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype),
        "projector": frontends.make_projector(gen, cfg, dtype),
        "enc_blocks": [_make_enc_block(gen, cfg, dtype)
                       for _ in range(cfg.n_encoder_layers)],
        "enc_norm": layers.make_norm(cfg.d_model, cfg.norm, dev),
        "dec_blocks": [_make_dec_block(gen, cfg, dtype)
                       for _ in range(cfg.n_layers)],
        "final_norm": layers.make_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": layers.truncated_normal(
            gen, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, dtype)}
    return params


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def encode(params: dict, embeds: Tensor, cfg: ModelConfig) -> Tensor:
    """embeds: (B, F, frontend_dim) -> the encoder output (B, F, D) in
    ACT_DTYPE.  RoPE runs over the frame index; attention has no mask (B5
    with ``causal=False`` on the card)."""
    x = frontends.apply_projector(params["projector"], embeds.to(ACT_DTYPE),
                                  cfg)
    b, f = x.shape[:2]
    positions = _positions(b, f, x.device)

    def block(x, p):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        q, k, v = attention.qkv_project(p["attn"], h, cfg, positions)
        o = attention.attend(q, k, v, causal=False,
                             logit_cap=cfg.attn_logit_softcap)
        x = x + attention.out_project(o, p["attn"]["wo"])
        h = layers.apply_norm(p["ln2"], x, cfg.norm)
        return x + layers.apply_mlp(p["mlp"], h, cfg.act)

    body = lm._remat_wrap(block, cfg)
    for p in params["enc_blocks"]:
        x = body(x, p)
    return layers.apply_norm(params["enc_norm"], x, cfg.norm)


# --------------------------------------------------------------------------
# Decoder (teacher-forced training forward)
# --------------------------------------------------------------------------

def forward(params: dict, tokens: Tensor, embeds: Tensor, cfg: ModelConfig,
            *, enc_out: Optional[Tensor] = None) -> Tensor:
    """tokens: (B, S) decoder input; embeds: (B, F, frontend_dim) frames
    (not read when ``enc_out`` is given) -> logits (B, S, V) f32.  Each
    decoder block projects the encoder output to its own cross K/V
    (`attention.encode_kv`)."""
    if enc_out is None:
        enc_out = encode(params, embeds, cfg)
    b, s = tokens.shape
    x = layers.embed(params["embed"], tokens, ACT_DTYPE)
    positions = _positions(b, s, tokens.device)

    def block(x, p, enc_out):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        x = x + attention.self_attention(p["attn"], h, cfg, positions)
        h = layers.apply_norm(p["ln2"], x, cfg.norm)
        kv = attention.encode_kv(p["cross"], enc_out, cfg)
        x = x + attention.cross_attention(p["cross"], h, kv, cfg)
        h = layers.apply_norm(p["ln3"], x, cfg.norm)
        return x + layers.apply_mlp(p["mlp"], h, cfg.act)

    body = lm._remat_wrap(block, cfg)
    for p in params["dec_blocks"]:
        x = body(x, p, enc_out)
    return lm._final_logits(params, x, cfg)


def encdec_loss(params: dict, batch: dict,
                cfg: ModelConfig) -> tuple[Tensor, dict]:
    """The masked next-token loss of ``batch`` ({tokens, labels, mask,
    embeds}) and its metrics {ce, loss}."""
    logits = forward(params, batch["tokens"], batch["embeds"], cfg)
    ce = lm.cross_entropy(logits, batch["labels"], batch["mask"])
    return ce, {"ce": ce, "loss": ce}


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

class EncDecState(NamedTuple):
    self_kv: KVCache      # stacked (L, B, Smax, KV, D); length (L, B)
    cross_k: Tensor       # (L, B, F, KV, D), computed once at prefill
    cross_v: Tensor
    length: Tensor        # (B,) tokens decoded so far


def init_encdec_state(params: dict, embeds: Tensor, cfg: ModelConfig,
                      max_len: int) -> EncDecState:
    """Run the encoder once (through B5 on the card: see the module's
    note) and compute every decoder layer's cross K/V; the self-attention
    cache starts empty, so the first decoded token sits at position 0."""
    enc_out = encode(params, embeds, cfg)
    b, f = enc_out.shape[:2]
    dev = enc_out.device
    n = cfg.n_layers
    shape = (n, b, f, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.empty(shape, dtype=ACT_DTYPE, device=dev)
    cv = torch.empty(shape, dtype=ACT_DTYPE, device=dev)
    for i, p in enumerate(params["dec_blocks"]):
        ck[i], cv[i] = attention.encode_kv(p["cross"], enc_out, cfg)
    shape = (n, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv = KVCache(k=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
                 v=torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
                 length=torch.zeros((n, b), dtype=torch.int32, device=dev))
    return EncDecState(self_kv=kv, cross_k=ck, cross_v=cv,
                       length=torch.zeros((b,), dtype=torch.int32,
                                          device=dev))


def decode_step(params: dict, token: Tensor, state: EncDecState,
                cfg: ModelConfig) -> tuple[Tensor, EncDecState]:
    """token: (B, 1) int -> (logits (B, 1, V) f32, new state).  The new
    token's K/V are written into ``state.self_kv``'s tensors IN PLACE (the
    reference returns updated copies); the cross K/V are read, never
    written."""
    x = layers.embed(params["embed"], token, ACT_DTYPE)
    cache = state.self_kv
    lengths = []
    for i, p in enumerate(params["dec_blocks"]):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        h, c = attention.self_attention_decode(
            p["attn"], h, cfg, KVCache(cache.k[i], cache.v[i],
                                       cache.length[i]))
        lengths.append(c.length)
        x = x + h
        h = layers.apply_norm(p["ln2"], x, cfg.norm)
        x = x + attention.cross_attention(
            p["cross"], h, (state.cross_k[i], state.cross_v[i]), cfg)
        h = layers.apply_norm(p["ln3"], x, cfg.norm)
        x = x + layers.apply_mlp(p["mlp"], h, cfg.act)
    return lm._final_logits(params, x, cfg), EncDecState(
        self_kv=KVCache(k=cache.k, v=cache.v, length=torch.stack(lengths)),
        cross_k=state.cross_k, cross_v=state.cross_v,
        length=state.length + 1)
