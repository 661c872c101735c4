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


def tree_leaves(tree, path: tuple = ()):
    """(path, leaf) pairs of a tree of dicts, lists, tuples and
    NamedTuples: dict keys in sorted order (as ``jax.tree.leaves`` walks a
    dict), sequences by index, a NamedTuple's fields by name; ``None`` is
    an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and
    NamedTuples, with the matching leaves of ``rest``; the structure is
    ``tree``'s.  ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def map_paths(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree's leaves (paths as `tree_leaves`
    gives them); the structure is ``tree``'s."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_paths(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
