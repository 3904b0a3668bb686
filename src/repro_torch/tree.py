"""Minimal pytree helpers over the port's parameter layout: nested dicts,
lists and tuples whose leaves are tensors (the JAX package's layout).

``tree_map`` and ``tree_leaves`` visit dict keys in insertion order;
``jax_leaves``, ``jax_unflatten`` and ``jax_treedef`` follow
``jax.tree.flatten``, which sorts dict keys (the order of a checkpoint's
leaves)."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one tree, or zipped over trees of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the same (insertion) order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_like(tree: Any, leaves) -> Any:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def unstack(tree: Any) -> list:
    """Per-layer views of a tree of stacked ``[L, ...]`` tensors, one
    ``unbind`` per leaf (a list of per-layer trees is returned as it
    is). Indexing ``a[i]`` instead would give each layer's backward a
    zeroed gradient the size of the whole leaf."""
    if isinstance(tree, list):
        return tree
    cols = [a.unbind(0) for a in tree_leaves(tree)]
    return [tree_like(tree, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def jax_leaves(tree: Any) -> list:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in jax_leaves(t)]
    return [tree]


def jax_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with ``leaves`` given in ``jax_leaves``
    order."""
    it = iter(leaves)

    def build(t: Any, it: Iterator) -> Any:
        if isinstance(t, dict):
            out = {k: build(t[k], it) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x, it) for x in t)
        return next(it)

    return build(like, it)


def jax_treedef(tree: Any) -> str:
    """``str(treedef)`` as ``jax.tree.flatten`` gives it, e.g.
    ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def node(t: Any) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({node(tree)})"
