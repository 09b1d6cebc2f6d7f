"""Parameter and state trees of the port: dicts of tensors, with the layers
in a list where the JAX package stacks them on a leading dim (the layers it
scans).

This module holds that layout rule, a list stands for a stacked leading
dim, for the optimizer (``tree_map``'s ``stacked``: weight decay counts the
dim), the checkpoint (``flat_paths``: a list is saved as its stack), the
sharding specs (``stacked_shape``: a spec has the layer dim first) and the
gradient compression (``map_stacked``: its int8 blocks run over the stack).
"""
from __future__ import annotations


def tree_map(fn, tree, *rest, stacked=False):
    """``fn(leaf, *rest_leaves, stacked=...)`` over a tree and the same
    positions of ``rest``; ``stacked`` tells ``fn`` whether the leaf sits in
    a list. A ``rest`` tree may hold a subtree where ``tree`` has a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), stacked=stacked)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *r, stacked=True) for v, *r in zip(tree, *rest)]
    return fn(tree, *rest, stacked=stacked)


def leaves(tree) -> list:
    out = []
    tree_map(lambda x, stacked: out.append(x), tree)
    return out


def flat_paths(tree, path=()) -> dict:
    """The reference's ``/``-joined leaf paths -> the leaf; under a list,
    -> the list of its items' leaves (nested lists for nested lists)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_paths(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        items = [flat_paths(v, path) for v in tree]
        if not items or any(it.keys() != items[0].keys() for it in items[1:]):
            raise ValueError(f"{'/'.join(path)}: a list must hold items of one structure")
        return {k: [it[k] for it in items] for k in items[0]}
    return {"/".join(path): tree}


def stacked_shape(leaf) -> tuple:
    """The reference's shape of a ``flat_paths`` value: a list's length in
    front of its items' (equal) shapes."""
    if isinstance(leaf, list):
        shapes = {stacked_shape(x) for x in leaf}
        if len(shapes) != 1:
            raise ValueError(f"the items of a stacked leaf differ in shape: {sorted(shapes)}")
        return (len(leaf),) + shapes.pop()
    return tuple(leaf.shape)


def list_depth(leaf) -> int:
    """The lists nested above the tensors of a ``flat_paths`` value (its
    leading dims that are list dims)."""
    return 1 + list_depth(leaf[0]) if isinstance(leaf, list) else 0


def unflatten_paths(flat: dict) -> dict:
    """Nested dicts from ``/``-joined paths (the reference's structure)."""
    out: dict = {}
    for path, value in flat.items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = value
    return out


def stack(leaf):
    """A ``flat_paths`` value as one tensor: a list's items stacked on a
    new leading dim (nested lists on several)."""
    import torch

    return torch.stack([stack(x) for x in leaf]) if isinstance(leaf, list) else leaf


def map_stacked(fn, tree):
    """``fn`` of each of the reference's leaves (a list's items stacked,
    ``stack``), its result split back into ``tree``'s layout."""
    done = {p: fn(stack(v)) for p, v in flat_paths(tree).items()}

    def walk(x, path, idx):
        if isinstance(x, dict):
            return {k: walk(v, path + (str(k),), idx) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, path, idx + (i,)) for i, v in enumerate(x)]
        y = done["/".join(path)]
        for i in idx:
            y = y[i]
        return y

    return walk(tree, (), ())
