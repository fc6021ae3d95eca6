"""Minimal pytree helpers over the port's parameter and cache trees.

Trees are nested ``dict``s, ``tuple``/``list``s and ``NamedTuple``s with
tensors (or numpy arrays) at the leaves — the same layout the reference
package keeps, so leaves can be compared path by path. A path is the
tuple of dict keys / NamedTuple field names / sequence indices from the
root to a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       _path: Path = ()) -> Any:
    """``fn(path, leaf, *other_leaves)`` over every leaf of ``tree``;
    ``rest`` trees must share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _path=_path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(getattr(r, f) for r in rest),
                               _path=_path + (f,))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  _path=_path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(_path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return tree_map_with_path(lambda _p, *xs: fn(*xs), tree, *rest)


def tree_leaves_with_path(tree: Any, _path: Path = ()
                          ) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, _path + (k,))
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from tree_leaves_with_path(v, _path + (f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, _path + (i,))
    else:
        yield _path, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
