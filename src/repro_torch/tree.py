"""Nested-dict pytrees in JAX's flatten order.

The port's params, optimizer state and checkpoints are nested dicts of
tensors.  The reference flattens such trees with its pytree functions,
which visit a dict's keys sorted; the order matters where leaves are
summed (AdamW's global gradient norm) or listed (checkpoint manifests),
so these helpers visit them the same way.  A leaf's path is its keys
joined by ``/``, as the reference prints ``tree_flatten_with_path``'s.
"""
from __future__ import annotations


def leaves_with_path(tree, prefix: str = "") -> list:
    """[(path, leaf)] in JAX's flatten order (sorted keys at every level);
    a tree that is not a dict is one leaf with the path ``prefix``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaves_with_path(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result keeps ``tree``'s key order."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def unflatten_like(tree, flat: list):
    """A tree of ``tree``'s structure holding ``flat``'s leaves, given in
    JAX's flatten order."""
    it = iter(flat)
    paths = {p: next(it) for p, _ in leaves_with_path(tree)}
    return tree_map_with_path(lambda p, _: paths[p], tree)


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` for each leaf; the result keeps the key order."""
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}
