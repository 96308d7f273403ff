"""Nested-dict parameter trees: the few ``jax.tree`` operations the
training path needs. A tree is a dict of trees and tensors; dict keys are
visited in sorted order, as ``jax.tree_util`` flattens a dict, so leaf
order (a global norm's sum, a checkpoint's keys) is the reference's."""
from __future__ import annotations

from typing import Callable, Iterator

import torch


def tree_items(tree: dict, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted key order; a path joins keys with ``/``."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    return [v for _, v in tree_items(tree)]


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
