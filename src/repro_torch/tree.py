"""Trees: nested dicts, lists, tuples and NamedTuples with tensor (or
numpy) leaves — the model's parameters, the optimizer's state, the
checkpointed loop state.

The port's stand-in for ``jax.tree_util``.  Dict entries are visited in
sorted key order by ``tree_leaves``, as ``jax.tree_util`` does.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree, path=()) -> list:
    """(path, leaf) of every leaf in :func:`tree_leaves` order; a path is
    the tuple of dict keys and sequence indices from the root."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the matching leaves of
    ``rest`` (trees of the same structure) zipped in; the result has
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *vals)
                            for vals in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vals) for vals in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)
