"""Carry inputs, state and weights across from numpy into the port.

What crosses over: demand, fault and placement streams, recorded traces,
simulator state, the flight-recorder carry and random streams (the NoC
simulator has no weights), a language model's parameter tree and decode
state (the serving path), an encoder-decoder's parameter tree and decode
state, and a training state (parameters and AdamW moments).  Each
converter takes any object with the right field names whose leaves numpy
can read (for example a NamedTuple of numpy arrays) and returns the
port's structure of the same names on ``device``.
uint16 injection stamps widen to the port's int32 stamps value for value;
bfloat16 leaves (numpy's ml_dtypes type) cross as torch.bfloat16 exactly.
The port materializes named fault and placement scenarios itself
(`core.noc.faults`, `core.noc.placement`); `fault_stream` and
`placement_stream` carry streams built elsewhere, such as a test's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.noc.faults import FaultStream
from repro_torch.core.noc.placement import PlacementStream
from repro_torch.core.noc.router import SubnetState
from repro_torch.core.noc.sim import EpochStreams, MCState
from repro_torch.core.noc.traffic import RecordedTrace, WorkloadProfile
from repro_torch.kernels.noc_cycle.fused import LaneState, ProbeLanes
from repro_torch.models import encdec, lm
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import Mamba1State, Mamba2State
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import TrainState


def tensor(x, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.astype(np.float32)  # every bfloat16 value is a float32 value
    t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    if bf16:
        t = t.to(torch.bfloat16)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _convert(cls, obj, device, dtypes: dict | None = None):
    dtypes = dtypes or {}
    return cls(*(
        tensor(getattr(obj, f), device, dtypes.get(f)) for f in cls._fields
    ))


def epoch_demand(obj, device="cpu") -> WorkloadProfile:
    """Per-epoch demand rows (five (E,) float32 leaves)."""
    return _convert(WorkloadProfile, obj, device,
                    {f: torch.float32 for f in WorkloadProfile._fields})


def fault_stream(obj, device="cpu") -> FaultStream:
    return _convert(FaultStream, obj, device, {
        "link_ok": torch.bool, "router_ok": torch.bool, "mc_ok": torch.bool,
        "telem_mode": torch.int32, "telem_mag": torch.float32,
    })


def placement_stream(obj, device="cpu") -> PlacementStream:
    return _convert(PlacementStream, obj, device,
                    {"cls0": torch.int32, "cls1": torch.int32})


def subnet_state(obj, device="cpu") -> SubnetState:
    return _convert(SubnetState, obj, device, {
        "buf_meta": torch.int16, "buf_binj": torch.int32,
        "head": torch.int8, "count": torch.int8, "rr_ptr": torch.int8,
    })


def mc_state(obj, device="cpu") -> MCState:
    return _convert(MCState, obj, device, {
        "q_meta": torch.int8, "head": torch.int32, "count": torch.int32,
        "timer": torch.int32, "stage_valid": torch.bool,
        "stage_dst": torch.int32, "stage_cls": torch.int32,
    })


def lane_state(obj, device="cpu") -> LaneState:
    return _convert(LaneState, obj, device,
                    {f: torch.int32 for f in LaneState._fields})


def probe_lanes(obj, device="cpu") -> ProbeLanes:
    """The lane engine's flight-recorder carry (three int32 leaves)."""
    return _convert(ProbeLanes, obj, device,
                    {f: torch.int32 for f in ProbeLanes._fields})


def recorded_trace(obj) -> RecordedTrace:
    """A recorded trace (``demand`` rows, ``fit``, ``name``, ``meta``) as
    the port's `RecordedTrace`; its rows stay float32 numpy arrays."""
    demand = WorkloadProfile(*(
        np.array(getattr(obj.demand, f), np.float32)
        for f in WorkloadProfile._fields
    ))
    return RecordedTrace(demand=demand, fit=obj.fit, name=obj.name,
                         meta=dict(obj.meta))


def epoch_stream_provider(
    u_phase, u_gen, d_idx, device="cpu"
) -> EpochStreams:
    """An epoch-stream provider over pre-drawn arrays: u_phase (E, L),
    u_gen (E, L, R) float32 and d_idx (E, L, R) int."""
    up = tensor(u_phase, device, torch.float32)
    ug = tensor(u_gen, device, torch.float32)
    di = tensor(d_idx, device, torch.int64)

    def streams(epoch: int):
        return up[epoch], ug[epoch], di[epoch]

    return streams


# a mamba mixer's leaves kept in float32 (the norm: its scale); the others
# are in the parameter dtype (the reference's `make_mamba1`, `make_mamba2`)
MAMBA1_F32 = ("dt_proj", "dt_bias", "a_log", "d_skip")
MAMBA2_F32 = ("dt_bias", "a_log", "d_skip", "norm")


def lm_params(tree, cfg: ModelConfig, device="cpu") -> dict:
    """An LM's parameter tree as the reference's `make_lm` builds it (dicts
    of arrays, each pattern position's blocks stacked over n_super; the
    hybrid's one ``shared_attn`` block unstacked) -> the port's tree
    (`lm.make_lm`'s layout: a list of per-layer dicts per pattern
    position; a frontend's ``projector`` carried as it is).  Leaf types
    are kept (a moe block's router stays float32, its experts in the
    parameter dtype), except that a mamba mixer's leaves
    are cast as the port's `make_mamba1` / `make_mamba2` make them:
    `MAMBA1_F32` / `MAMBA2_F32` in float32, the rest in the parameter
    dtype."""
    pattern, n_super = lm.layer_pattern(cfg)
    pdt = lm.param_dtype(cfg)
    f32_keys = {"mamba1": MAMBA1_F32, "mamba2": MAMBA2_F32}

    def cast(node, dtype):
        if isinstance(node, dict):
            return {k: cast(v, dtype) for k, v in node.items()}
        return node.to(dtype)

    out = _unstack(tree, cfg, device)
    for j, kind in enumerate(pattern):
        if kind not in f32_keys:
            continue
        for blk in out["blocks"][j]:
            blk["mixer"] = {
                k: cast(v, torch.float32 if k in f32_keys[kind] else pdt)
                for k, v in blk["mixer"].items()}
    return out


def _unstack(tree, cfg: ModelConfig, device) -> dict:
    """The reference's LM tree (each pattern position's blocks stacked
    over n_super) in the port's layout, every leaf's type kept."""
    pattern, n_super = lm.layer_pattern(cfg)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [[_tree(tree["blocks"][j], device, i)
                      for i in range(n_super)] for j in range(len(pattern))]
    return out


def _tree(node, device, i=None):
    """A nested dict of arrays as tensors on ``device``, each leaf's type
    kept; with ``i``, layer i of leaves stacked over layers."""
    if isinstance(node, dict):
        return {k: _tree(v, device, i) for k, v in node.items()}
    return tensor(node if i is None else np.asarray(node)[i], device)


def encdec_params(tree, cfg: ModelConfig, device="cpu") -> dict:
    """An encoder-decoder's parameter tree as the reference's
    `make_encdec` builds it (``enc_blocks`` and ``dec_blocks`` stacked over
    their layers) -> the port's (`encdec.make_encdec`'s layout: a list of
    per-layer dicts each; ``projector``, the norms, ``embed`` and
    ``unembed`` as they are), every leaf's type kept."""
    counts = {"enc_blocks": cfg.n_encoder_layers, "dec_blocks": cfg.n_layers}
    return {k: ([_tree(v, device, i) for i in range(counts[k])]
                if k in counts else _tree(v, device))
            for k, v in tree.items()}


def encdec_state(obj, device="cpu") -> encdec.EncDecState:
    """An encoder-decoder decode state (``self_kv`` stacked (L, B, Smax,
    KV, D) with (L, B) lengths, ``cross_k`` / ``cross_v`` (L, B, F, KV, D),
    ``length``) as the port's `encdec.EncDecState`: bf16 K/V, int32
    lengths."""
    kv = obj.self_kv
    return encdec.EncDecState(
        self_kv=KVCache(k=tensor(kv.k, device, torch.bfloat16),
                        v=tensor(kv.v, device, torch.bfloat16),
                        length=tensor(kv.length, device, torch.int32)),
        cross_k=tensor(obj.cross_k, device, torch.bfloat16),
        cross_v=tensor(obj.cross_v, device, torch.bfloat16),
        length=tensor(obj.length, device, torch.int32))


def train_state(obj, cfg: ModelConfig, device="cpu") -> TrainState:
    """A training state (``params``; ``opt`` with ``step``, ``mu``, ``nu``,
    as the reference's TrainState and OptState hold them) as the port's
    `TrainState`: the parameters through `lm_params` (`encdec_params` for
    an encoder-decoder), the moments laid out the same way in their own
    type, the step an int32 scalar."""
    opt = obj.opt
    if cfg.is_encoder_decoder:
        params = encdec_params(obj.params, cfg, device)
        mu = encdec_params(opt.mu, cfg, device)
        nu = encdec_params(opt.nu, cfg, device)
    else:
        params = lm_params(obj.params, cfg, device)
        mu = _unstack(opt.mu, cfg, device)
        nu = _unstack(opt.nu, cfg, device)
    return TrainState(
        params=params,
        opt=opt_lib.OptState(step=tensor(opt.step, device, torch.int32),
                             mu=mu, nu=nu))


def decode_state(obj, device="cpu") -> lm.DecodeState:
    """A decode state (``caches`` stacked over n_super: (k, v, length)
    attention caches or (conv, ssm) mamba states, a Mamba2State where the
    stacked ssm has rank 5, (n_super, B, nh, hd, ds); the hybrid's
    ``shared_kv``; ``length``) as the port's `lm.DecodeState`: bf16 K/V and
    conv rings, f32 SSM states, int32 lengths."""
    def cache(c):
        if hasattr(c, "ssm"):
            state = Mamba2State if np.ndim(c.ssm) == 5 else Mamba1State
            return state(conv=tensor(c.conv, device, torch.bfloat16),
                         ssm=tensor(c.ssm, device, torch.float32))
        return KVCache(k=tensor(c.k, device, torch.bfloat16),
                       v=tensor(c.v, device, torch.bfloat16),
                       length=tensor(c.length, device, torch.int32))

    shared = getattr(obj, "shared_kv", None)
    return lm.DecodeState(
        caches=[cache(c) for c in obj.caches],
        shared_kv=None if shared is None else cache(shared),
        length=tensor(obj.length, device, torch.int32))
