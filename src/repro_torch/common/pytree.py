"""Small tree helpers over the port's nests of dicts, tuples and lists
(counterpart of ``repro.common.pytree``).

The leaf order and the '/'-joined path strings are the reference's
letter for letter: dict keys in sorted order (as ``jax.tree_util``
flattens a dict), sequence entries by index, ``None`` an empty subtree.
The checkpoint layout (``checkpoint/store.py``) is keyed by these
paths, so a checkpoint written by either package reads in the other.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator, List, Tuple

import torch

Tree = Any


def _children(node: Any) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), v) for i, v in enumerate(node)]


def _is_node(node: Any) -> bool:
    return isinstance(node, (dict, tuple, list))


def tree_paths(tree: Tree) -> Iterator[Tuple[str, Any]]:
    """Yield ('a/b/c', leaf) pairs in the reference's leaf order."""
    def walk(node, prefix):
        if node is None:
            return
        if not _is_node(node):
            yield "/".join(prefix), node
            return
        for key, child in _children(node):
            yield from walk(child, prefix + (key,))

    yield from walk(tree, ())


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Tree) -> Tree:
    """The tree of ``fn(path, leaf)``, with ``tree``'s nesting (dicts keep
    their keys, tuples stay tuples, lists lists)."""
    def walk(node, prefix):
        if node is None:
            return None
        if not _is_node(node):
            return fn("/".join(prefix), node)
        if isinstance(node, dict):
            return {k: walk(node[k], prefix + (str(k),)) for k in node}
        out = [walk(v, prefix + (str(i),)) for i, v in enumerate(node)]
        return tuple(out) if isinstance(node, tuple) else out

    return walk(tree, ())


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (which must have its nesting)."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    out = [tree_map(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def count_params(tree: Tree) -> int:
    return int(sum(math.prod(leaf.shape) for leaf in tree_leaves(tree)))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves, in leaf order, of each leaf's sum
    of squares in fp32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def unstack(tree: Tree, n: int) -> List[Tree]:
    """A tree of [n, ...] leaves -> n trees of [...] views, by one
    ``unbind`` a leaf: autograd puts the n slices' grads together with one
    stack, where n ``select``s would each add a zero-padded copy of the
    whole leaf's grad."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [unstack(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    out = tree.unbind(0)
    if len(out) != n:
        raise ValueError(f"leading dim {len(out)}, want {n}")
    return list(out)
