"""Parameter trees: nested dicts of tensors.

The port keeps parameters, gradients and noise as plain (possibly nested)
dicts of tensors where the reference has JAX pytrees.  These helpers walk
them in insertion order, which is the order every draw and every sum
visits the leaves.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any  # a tensor, or a dict whose values are trees


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf; ``rest`` must have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_device(tree: Tree) -> torch.device:
    """The device of the tree's first leaf."""
    return tree_leaves(tree)[0].device
