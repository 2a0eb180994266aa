"""Nested dicts (and lists) of tensors as the reference's pytrees.

The trainer, the optimizer and the checkpoint keep state as the
reference does, in nested dicts, and need the few pytree operations the
reference takes from ``jax.tree_util``: a map over matching trees, the
leaves in JAX's order (dict keys sorted) and the leaves by name, with
names built as the reference's ``checkpoint.manager._flatten_with_names``
builds them (``params/layer0/attn/wq``; a list index as ``[i]``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _walk(tree, path: Tuple[str, ...]) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def flatten_with_names(tree) -> Dict[str, Any]:
    """name -> leaf, in JAX's leaf order."""
    return dict(_walk(tree, ()))


def leaves(tree) -> list:
    """The leaves in JAX's order (``jax.tree_util.tree_leaves``)."""
    return [leaf for _, leaf in _walk(tree, ())]


def _rebuild(tree, path: Tuple[str, ...], flat: Mapping[str, Any]):
    if isinstance(tree, dict):
        return {k: _rebuild(v, path + (str(k),), flat)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, path + (f"[{i}]",), flat)
                          for i, v in enumerate(tree))
    return flat["/".join(path)]


def unflatten_like(like, flat: Mapping[str, Any]):
    """A tree of ``like``'s structure whose leaves are ``flat[name]``;
    raises ``KeyError`` for a name ``flat`` lacks. (A module-level
    helper, not a nested function that calls itself: that would be a
    reference cycle holding ``flat``'s tensors, such as a layer's
    gathered FSDP leaves, until the garbage collector runs.)"""
    return _rebuild(like, (), flat)
