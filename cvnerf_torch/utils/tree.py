"""Nested dicts of tensors: a model's params, its Adam moments."""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The ``/``-joined key path of every tensor of a nested dict, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_like(tree: dict, leaves: list) -> dict:
    """``leaves`` (in ``tree_leaves`` order) in the nested layout of
    ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def match_tree(got: dict, want: dict, path: str, what: str, device) -> dict:
    """``got`` in ``want``'s layout and leaf order on ``device``; raises
    where a leaf is missing or of another shape."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: {what} holds keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f", the run expects {sorted(want)}")
        return {k: match_tree(got[k], v, path, f"{what}.{k}", device)
                for k, v in want.items()}
    if got.shape != want.shape:
        raise ValueError(f"{path}: {what} has shape {tuple(got.shape)}, "
                         f"the run expects {tuple(want.shape)}")
    return got.to(device)
