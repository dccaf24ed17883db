"""Nested containers of tensors, the port's counterpart of `jax.tree_util`.

A tree is a dict, a list, a tuple or a NamedTuple of trees, or a leaf (a
tensor, an array or a number); None is an empty subtree. Leaves are taken
in JAX's order: dict keys sorted, sequences and NamedTuple fields in order,
so a flattened tree lines up with the JAX package's flattening of the same
structure (the checkpoint manifests depend on it).
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and the trees ``rest``,
    which follow ``tree``'s structure down to its leaves (a leaf of
    ``tree`` may face a subtree of ``rest``, as an optimizer's per-leaf
    state does). Returns a tree of ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, v, *[r[i] for r in rest])
                            for i, v in enumerate(tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)] in JAX's leaf order. A path is a tuple of entries: a
    dict key, a sequence index (int) or ``.field`` for a NamedTuple
    field."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_paths(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [item for name, v in zip(tree._fields, tree)
                for item in tree_flatten_with_paths(v, prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_flatten_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten_like(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in the order
    `tree_leaves` gives)."""
    paths = [path for path, _ in tree_flatten_with_paths(tree)]
    if len(paths) != len(leaves):
        raise ValueError(f"the tree has {len(paths)} leaves, got "
                         f"{len(leaves)}")
    return _build(tree, (), dict(zip(paths, leaves)))


def _build(t: Any, prefix: tuple, values: dict) -> Any:
    """`tree_unflatten_like`'s recursion, at module level: a nested
    recursive function would be a reference cycle holding every leaf (on a
    card, its memory) until the garbage collector runs."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _build(v, prefix + (k,), values) for k, v in t.items()}
    if _is_namedtuple(t):
        return type(t)(*[_build(v, prefix + (f".{n}",), values)
                         for n, v in zip(t._fields, t)])
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, prefix + (i,), values)
                       for i, v in enumerate(t))
    return values[prefix]
