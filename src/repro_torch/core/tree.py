"""Nested dicts and lists of tensors as trees (no reference module: the JAX
package uses ``jax.tree_util``).

The order is ``jax.tree_util``'s: a dict's keys sorted, a list's items by
index, ``None`` an empty subtree.  Everything that must line up a flat list
with a tree -- Adafactor's state list, the global norm's sum, a
checkpoint's ``leaf_N`` files -- walks it in this order, so the two
packages agree leaf for leaf.  It is not Python's insertion order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def flatten_with_paths(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in ``jax.tree_util`` order; a path's parts are the
    dict keys and list indices, as strings."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(tree_like: Any, new_leaves: List[Any]) -> Any:
    """``tree_like``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def build(t: Any) -> Any:
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the caller's order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which must hold as many leaves in the same order."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"trees of {[len(f) for f in flat]} leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
