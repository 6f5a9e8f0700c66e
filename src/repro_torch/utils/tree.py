"""Small utilities over the port's param trees: nested dicts and lists
whose leaves are tensors (``repro/utils/tree.py``)."""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The tensor leaves in key order (dicts) and index order (lists,
    tuples)."""
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure; other leaves pass through."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, item, *(r[i] for r in rest))
                          for i, item in enumerate(tree))
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree


def tree_count(tree) -> int:
    """Total number of parameters in a tree."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensors (meta tensors count too)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype: torch.dtype):
    """Cast every floating leaf to ``dtype`` (integer leaves stay)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of a tree, in f32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum((x.float().square().sum() for x in leaves), torch.zeros(())))
