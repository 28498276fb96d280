"""Trees of tensors as the port keeps them (nested dicts and lists), walked
in the JAX package's leaf order: dict keys sorted, list items in order."""
from __future__ import annotations

from repro_torch.models.convert import STACKED


def tree_leaves(tree) -> list:
    """The leaves of `tree` in jax.tree_util's order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def jax_ndims(tree, extra: int = 0) -> list[int]:
    """The rank each leaf has in the JAX package's layout, in `tree_leaves`
    order: a leaf inside a group of layers (`models.convert.STACKED`) has
    the group's leading axes ([L] or [U, I]) in front of its own."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in jax_ndims(
            tree[k], extra + (STACKED[k] if k in STACKED
                              and isinstance(tree[k], list) else 0))]
    if isinstance(tree, (list, tuple)):
        return [n for v in tree for n in jax_ndims(v, extra)]
    return [tree.ndim + extra]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and of the trees in `rest`, which
    have its structure), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree of `like`'s structure whose leaves are `leaves`, taken in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)
