"""Pytrees of tensors in ``jax.tree_util``'s leaf order.

The optimizers sum the gradient norm in leaf order and the checkpointer
matches leaves by position, so both must see a tree's leaves in the order
the reference's ``jax.tree_util`` gives them: dict keys sorted, NamedTuple
fields and list / tuple items in order.  With that order a reference
checkpoint restores into the port's trees, and the other way round.

Paths are the reference checkpointer's strings: dict keys and list
indices as they are, NamedTuple fields as ``.name`` (``opt/.mu/embed/table``).
"""

from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _is_leaf(node) -> bool:
    """A tensor, a scalar, None, or a tuple type that declares itself a
    leaf (``tree_leaf``: the sharding rules' partition specs)."""
    return getattr(type(node), "tree_leaf", False)


def _children(node):
    """(path components, children) of an inner node, or None for a leaf."""
    if _is_leaf(node):
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    if _is_namedtuple(node):
        return ["." + f for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [str(i) for i in range(len(node))], list(node)
    return None


def _walk(node, prefix, paths, leaves):
    kids = _children(node)
    if kids is None:
        paths.append("/".join(prefix))
        leaves.append(node)
        return
    for name, child in zip(*kids):
        _walk(child, prefix + [name], paths, leaves)


def tree_flatten_with_paths(tree):
    """(paths, leaves) of ``tree`` in the reference's leaf order.  The
    recursion is a module function, not a closure: a recursive closure
    refers to itself through its cell, a reference cycle that would keep
    the leaves (device memory) alive until the garbage collector runs."""
    paths, leaves = [], []
    _walk(tree, [], paths, leaves)
    return paths, leaves


def tree_leaves(tree) -> list:
    return tree_flatten_with_paths(tree)[1]


def _build(node, it):
    if _is_leaf(node):
        return next(it)
    if isinstance(node, dict):
        out = {k: None for k in node}  # keep the caller's key order
        for k in sorted(node):
            out[k] = _build(node[k], it)
        return out
    if _is_namedtuple(node):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in leaf order);
    a module-level recursion, as :func:`tree_flatten_with_paths`'."""
    it = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure, in leaf order; the result has ``tree``'s structure."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(t) for t in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves against {len(leaves)}")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
