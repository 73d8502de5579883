"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Params, grads and optimizer moments are nested dicts whose leaves are
tensors (or anything that is not a dict); these helpers walk them in key
insertion order, so trees built from one another line up leaf by leaf.
"""


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf-wise over ``tree`` and the trees in ``rest``, which
    must have ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
