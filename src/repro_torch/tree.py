"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port's counterpart of the ``jax.tree`` / ``jax.tree_util`` calls the
reference makes. Leaves are walked and named exactly as
``jax.tree_util.tree_flatten_with_path`` and ``keystr`` walk and name them:
dict keys in sorted order (``['embed']``), list and tuple items by index
(``[0]``), NamedTuple fields in declaration order (``.params``,
``.opt.step``), and ``None`` holds no leaf. So a ``TrainState`` of the port
names its leaves as the reference's does, and checkpoint groups, manifests
and chunk files agree byte for byte between the packages.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any):
    """``(key string, child)`` pairs in the reference's flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{key!r}]", node[key]) for key in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", child) for i, child in enumerate(node)]
    return None


def rebuild(node: Any, items) -> Any:
    """A container of ``node``'s type holding ``items`` (a NamedTuple takes
    them as its fields)."""
    return type(node)(*items) if _is_namedtuple(node) else type(node)(items)


def flatten_with_keys(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs of a tree, in the reference's order and with
    its ``keystr`` names; ``None`` holds no leaf."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    return [pair for key, child in children for pair in flatten_with_keys(child, prefix + key)]


def unflatten_like(template: Any, by_key: dict, prefix: str = "") -> Any:
    """``template``'s structure with each leaf replaced by ``by_key[key]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {key: unflatten_like(val, by_key, f"{prefix}[{key!r}]")
                for key, val in template.items()}
    children = _children(template)
    if children is None:
        return by_key[prefix]
    return rebuild(template, [unflatten_like(child, by_key, prefix + key)
                              for key, child in children])


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the reference's order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in flatten_with_keys(tree)]


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    keys = [key for key, _ in flatten_with_keys(template)]
    leaves = list(leaves)
    if len(leaves) != len(keys):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(keys)}")
    return unflatten_like(template, dict(zip(keys, leaves)))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the like-keyed leaves of
    ``rest`` (``jax.tree.map``); the result has ``tree``'s structure."""
    others = [dict(flatten_with_keys(r)) for r in rest]
    return unflatten_like(tree, {key: fn(leaf, *(o[key] for o in others))
                                 for key, leaf in flatten_with_keys(tree)})
