"""Trees of tensors: nested dicts, lists and tuples, in the JAX package's
pytree order (a dict's keys sorted, a sequence in order, ``None`` an empty
subtree), so a tree's leaves line up one for one with
``jax.tree.leaves`` of the same structure in the reference.  The LM's
parameters, the dense optimizers' states and the train state that a
checkpoint saves are such trees."""

from __future__ import annotations

from typing import Any, Callable, Optional


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    return type(tree)(children)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    """The leaves of `tree` in pytree order (``None`` has none)."""
    if tree is None:
        return []
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return [tree]
    return [x for c in _children(tree) for x in leaves(c, is_leaf)]


def leaves_with_path(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None,
                     _path: tuple = ()) -> list:
    """(path, leaf) pairs in pytree order.  A path is the tuple of keys from
    the root: a dict's key, a sequence's index (the reference's ``DictKey``
    and ``SequenceKey`` entries)."""
    if tree is None:
        return []
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return [(_path, tree)]
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    return [x for k, c in zip(keys, _children(tree))
            for x in leaves_with_path(c, is_leaf, _path + (k,))]


def map_with_path(fn: Callable, tree: Any,
                  is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """`fn(path, leaf)` over the leaves of `tree`, in its structure."""
    out = [fn(p, x) for p, x in leaves_with_path(tree, is_leaf)]
    return unflatten(tree, out, is_leaf)


def map(fn: Callable, tree: Any, *rest: Any,
        is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """`fn` over the leaves of `tree` and the matching subtrees of `rest`
    (which share its structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    cols = zip(_children(tree), *(_children(r) for r in rest))
    return _rebuild(tree, [map(fn, *c, is_leaf=is_leaf) for c in cols])


def unflatten(like: Any, new_leaves: list,
              is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """A tree of `like`'s structure whose leaves are `new_leaves`, in order."""
    it = iter(new_leaves)
    out = map(lambda _: next(it), like, is_leaf=is_leaf)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
