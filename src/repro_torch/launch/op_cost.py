"""FLOPs and bytes of one step, counted op by op on the meta device.

The port's cost source for the NoC trace adapter
(`core.noc.trace_adapters.step_cost`).  A step is run on meta tensors
(`launch.specs.abstract_params` and friends) under a `TorchDispatchMode`
that sees every aten op the step issues; nothing executes, and every
layer is counted (a Python loop over layers issues each layer's ops, so
no loop body is counted once).  The op rules are those of the JAX
package's trip-count-correct HLO cost model:

  flops:  matmul       2 x m x n x k (the batch dims multiply in);
                       addmm / baddbmm add the bias's numel
          convolution  2 x result numel x (C_in / groups x kernel size)
          elementwise  result numel (add, mul, exp, where, compare, ...)
          reduction    operand numel (sum, mean, amax, any, cumsum, ...)
          softmax      5 x numel (max, subtract, exp, sum, divide)
          casts, copies, views and factories: none
  bytes:  HBM traffic at op boundaries, each eager op taken as a fusion
          of one:
          matmul / convolution  operands + result
          elementwise, reduction, cast, factory  result only (the write;
                                its reads are its producers' writes,
                                counted there)
          copy / gather / scatter / concatenate / sort  2 x result (read
                                + write; an in-place index_put_ returns
                                the whole buffer, as XLA's
                                dynamic-update-slice does)
          views                 none
          the step's inputs     once each, those the step reads (the
                                weights and the cache read per step)

Where this departs from the HLO model: XLA fuses an elementwise chain
into one write, where the eager count writes every op's result, so the
port's bytes sit above the HLO model's on a step with long elementwise
chains (prefill: ~1.6x at the tiny serving config; decode, where the
weight and cache reads dominate, ~1.0x).  A cast that XLA folds into its
consumer is a write here.  The FLOPs agree to well inside 1%.

What the count sees: the plain PyTorch versions of the port's kernels.
The kernels are ctypes calls that a dispatch mode cannot see, and on meta
tensors every wrapper takes its plain version (as on CPU tensors), so a
flash attention counts its score matmuls and its softmax.  The MoE
experts take the card's form (every expert's GEMM) on meta, since no
route can be read there.  This is a symbolic count: `count` refuses a
tensor that is not on the meta device, so it can never run a kernel's
plain version on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
_CONV = {"convolution", "_convolution"}
_SOFTMAX = {"_softmax", "_log_softmax"}
_REDUCE = {"sum", "mean", "amax", "amin", "any", "all", "argmax", "argmin",
           "prod", "var", "var_mean", "std", "logsumexp",
           "linalg_vector_norm", "norm", "cumsum", "cumprod"}
_REDUCE_OR_ELEMENTWISE = {"max", "min"}   # one tensor in: a reduction
_COPY = {"clone", "copy", "copy_", "cat", "stack", "index", "_unsafe_index",
         "index_select", "embedding", "gather", "index_put", "index_put_",
         "_index_put_impl_", "scatter", "scatter_", "scatter_add",
         "scatter_add_", "index_add", "index_add_", "slice_scatter",
         "select_scatter", "constant_pad_nd", "repeat", "flip", "roll",
         "sort", "topk", "_unsafe_view_copy"}
_CAST = {"_to_copy", "to"}
_FACTORY = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
            "arange", "scalar_tensor", "fill", "fill_", "zero_",
            "new_zeros", "new_ones", "new_full"}
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "lift_fresh", "lift_fresh_copy"}
_VIEW = {"view", "_unsafe_view", "reshape", "_reshape_alias", "unsqueeze",
         "squeeze", "permute", "transpose", "t", "expand", "slice",
         "select", "alias", "detach", "as_strided", "split",
         "split_with_sizes", "unbind", "chunk", "narrow", "diagonal",
         "unfold", "view_as_real", "view_as_complex", "_conj", "_neg_view",
         "unsqueeze_", "squeeze_", "transpose_", "t_", "as_strided_",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_local_scalar_dense"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    """FLOPs and bytes of one counted step."""

    flops: float = 0.0
    bytes: float = 0.0

    def add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes


def _matmul_flops(name: str, args, out: torch.Tensor) -> float:
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    flops = 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        flops += out.numel()
    return flops


def _conv_flops(args, out: torch.Tensor) -> float:
    w = args[1]   # (C_out, C_in / groups, *kernel)
    return 2.0 * out.numel() * w.shape[1] * math.prod(w.shape[2:])


class OpCounter(TorchDispatchMode):
    """Counts every aten op issued under it by the rules above.  Inputs
    (``inputs``: the step's argument tensors) are counted once each, the
    first time an op reads one."""

    def __init__(self, inputs=()):
        super().__init__()
        self.cost = Cost()
        self._inputs = {id(t): t for t in _tensors(inputs)}
        self._read: set[int] = set()

    def _reads(self, ins) -> None:
        for t in ins:
            key = id(t)
            if key in self._inputs and key not in self._read:
                self._read.add(key)
                self.cost.add(0.0, _nbytes(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        self._reads(ins)
        outs = _tensors(out)
        if name in _VIEW or name in _EMPTY or not outs:
            return out
        relems = sum(t.numel() for t in outs)
        rbytes = sum(_nbytes(t) for t in outs)
        if name in _MATMUL:
            self.cost.add(_matmul_flops(name, args, outs[0]),
                          rbytes + sum(_nbytes(t) for t in ins))
        elif name in _CONV:
            self.cost.add(_conv_flops(args, outs[0]),
                          rbytes + sum(_nbytes(t) for t in ins))
        elif name in _SOFTMAX:
            self.cost.add(5.0 * relems, rbytes)
        elif name in _REDUCE or (name in _REDUCE_OR_ELEMENTWISE
                                 and len(ins) == 1):
            self.cost.add(max(ins[0].numel(), relems), rbytes)
        elif name in _COPY:
            self.cost.add(0.0, 2 * rbytes)
        elif name in _CAST or name in _FACTORY:
            self.cost.add(0.0, rbytes)
        else:   # elementwise
            self.cost.add(float(relems), rbytes)
        return out


def count(fn: Callable, *args: Any, **kwargs: Any) -> tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` on meta tensors under the counter;
    returns (its output, its Cost).  Every tensor argument must be on the
    meta device."""
    ins = _tensors((args, kwargs))
    off = sorted({str(t.device) for t in ins if t.device.type != "meta"})
    if off:
        raise ValueError(f"op_cost.count runs on meta tensors only (a "
                         f"symbolic count), got tensors on {off}")
    counter = OpCounter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
