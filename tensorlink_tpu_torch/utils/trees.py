"""Helpers over parameter collections (port of
``tensorlink_tpu/utils/trees.py``): a "tree" is a tensor, a list or tuple
of trees, or a dict (a state dict) of trees; ``nest``/``flatten`` turn
dotted state-dict names into the JAX package's nested layout and back."""

from __future__ import annotations

import torch


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree, in order (dicts in insertion order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for sub in tree.values() for t in leaves(sub)]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """Every leaf of a nested container of any objects (tensors, arrays,
    numbers), in ``jax.tree.leaves``'s order: dict keys sorted, lists and
    tuples in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_size(tree) -> int:
    """Total number of tensor elements."""
    return sum(t.numel() for t in leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the tensors."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, as a 0-d
    tensor on the leaves' device (no host sync)."""
    ts = [t.float() for t in leaves(tree)]
    if not ts:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


def nest(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}} (a state dict's names as the
    JAX package's param tree)."""
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def flatten(tree, prefix: str = "") -> dict:
    """Inverse of ``nest``: nested dicts -> {dotted name: leaf} (empty
    subtrees vanish)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
