"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA device; it never silently falls back to CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a Stream object on every launch."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of NamedTuples (nested), with the
    matching leaves of ``rest``; other leaves pass through ``fn`` too."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map(fn, *leaves) for leaves in zip(tree, *rest)
        ))
    return fn(tree, *rest)


def stack_trees(trees):
    """Stack same-structured NamedTuples of tensors along a new leading
    axis."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    *trees)
