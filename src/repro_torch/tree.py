"""Maps over the port's state trees: nested dicts, lists and tuples of
tensors (the JAX package's pytree layout).  Dicts keep their key order; a
None leaf stays None.  ``jax_leaves`` and ``jax_unflatten`` list and
place leaves in the order ``jax.tree`` does."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """The leaves in ``tree_map`` order, None leaves left out."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


# --- the JAX package's flatten order ---------------------------------------
#
# ``jax.tree`` flattens a dict by SORTED key, a NamedTuple by field and a
# list or tuple by position, and a None has no leaves.  Checkpoints and the
# telemetry vectors list leaves in that order, so that the two packages
# read each other's files and labels.


def _jax_children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def jax_leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree`` order; each path is what
    ``jax.tree_util.keystr`` gives for it (``['emb'][0]['tables']``)."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [x for key, v in _jax_children(tree)
                for x in jax_leaves_with_paths(v, prefix + key)]
    return [(prefix, tree)]


def jax_leaves(tree) -> list[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in jax_leaves_with_paths(tree)]


def jax_unflatten(template, leaves):
    """A tree of ``template``'s structure (dict key order kept) whose
    leaves, taken in ``jax.tree`` order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
