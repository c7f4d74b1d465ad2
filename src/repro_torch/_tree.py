"""Parameter and optimizer trees: nested dicts and lists of tensors.

The reference's pytrees are JAX's; the port's are plain containers, its
model keeping the layers as a list of per-layer dicts.  Leaves are
visited in JAX's order (dict keys sorted, list items in order), so a walk
over either package's tree meets the same leaves in the same order, and
a leaf's key (its path joined by ``/``, a list item by its index) is the
reference checkpoint's key for the same leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

SEP = "/"


def items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf, in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{k}{SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}{i}{SEP}")
    else:
        yield prefix[:-len(SEP)], tree


def leaves(tree: Any) -> List[Any]:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf (and the matching leaves of ``rest``, trees of
    the same structure), in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(target: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """A tree of ``target``'s structure whose leaves are ``flat[key]``."""
    if isinstance(target, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}{SEP}")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(unflatten(v, flat, f"{prefix}{i}{SEP}")
                            for i, v in enumerate(target))
    return flat[prefix[:-len(SEP)]]


def unzip(tree: Any, n: int) -> Tuple[Any, ...]:
    """``n`` trees from a tree whose leaves are ``n``-tuples (what
    ``tree_map`` of a function returning ``n`` values gives)."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    if isinstance(tree, list):
        parts = [unzip(v, n) for v in tree]
        return tuple([p[i] for p in parts] for i in range(n))
    return tuple(tree)


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from ``{key: leaf}`` (keys split at ``/``)."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *path, last = key.split(SEP)
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out
