"""Trees of tensors as ``jax.tree_util`` sees them, for the optimizers, the
gradient compressor and the checkpoint.

A tree is nested dicts, lists and tuples (NamedTuples included) whose other
values are leaves; ``None`` is an empty subtree.  Leaves come in
``jax.tree_util``'s order: dict keys sorted, sequences by position.  So the
i-th leaf of a port tree is the i-th leaf of the reference's tree of the
same structure, and a checkpoint's leaves line up across the packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

Pytree = Any
Path = Tuple[Any, ...]          # dict keys (str) and sequence positions (int)


def _children(node) -> List[Tuple[Any, Any]]:
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree: Pytree, prefix: Path = ()
                       ) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree_util``'s leaf order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for k, v in _children(tree):
        out += flatten_with_paths(v, prefix + (k,))
    return out


def tree_leaves(tree: Pytree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` and of trees of the same structure
    in ``rest``; the result keeps ``tree``'s node types."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(tree)]
    if isinstance(tree, list):
        return out
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def tree_unflatten_like(template: Pytree, leaves: Sequence) -> Pytree:
    """A tree of ``template``'s structure whose leaves, in leaf order, are
    ``leaves``."""
    it = iter(leaves)
    paths = flatten_with_paths(template)
    by_path = {p: next(it) for p, _ in paths}
    return _rebuild(template, (), by_path)


def _rebuild(node, prefix, by_path):
    if node is None:
        return None
    if not _is_node(node):
        return by_path[prefix]
    if isinstance(node, dict):
        return {k: _rebuild(v, prefix + (k,), by_path)
                for k, v in node.items()}
    out = [_rebuild(v, prefix + (i,), by_path) for i, v in enumerate(node)]
    if isinstance(node, list):
        return out
    return type(node)(*out) if hasattr(node, "_fields") else tuple(out)


def tree_from_paths(paths: Sequence[Path], leaves: Sequence) -> Pytree:
    """Rebuild a tree from ``flatten_with_paths`` output: a string key
    makes a dict, an int key a tuple (a NamedTuple comes back as a plain
    tuple; :func:`tree_unflatten_like` restores its type)."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    groups: dict = {}
    for p, leaf in zip(paths, leaves):
        groups.setdefault(p[0], []).append((p[1:], leaf))
    built = {k: tree_from_paths([p for p, _ in v], [x for _, x in v])
             for k, v in groups.items()}
    if all(isinstance(k, int) for k in built):
        return tuple(built.get(i) for i in range(max(built) + 1))
    return built
