"""Trees of tensors: nested dicts, lists and tuples (named tuples among
them) with tensor leaves, as the model's parameters, caches and the
optimizer's state are kept.

``flatten`` gives the leaves in ``jax.tree.flatten``'s order (dict keys
sorted, lists and tuples in order), which the checkpoint layout and the
optimizer's global norm follow; ``unflatten`` puts leaves back into a
tree's structure; ``tree_map`` is the two together.
"""

from __future__ import annotations


def flatten(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [tree]


def unflatten(tree, leaves):
    """A tree of ``tree``'s structure with its leaves taken in turn from
    the iterator ``leaves``."""
    if isinstance(tree, dict):
        new = {k: unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        children = [unflatten(t, leaves) for t in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    return next(leaves)


def tree_map(fn, tree):
    """``tree``'s structure with ``fn`` of each leaf."""
    return unflatten(tree, map(fn, flatten(tree)))
