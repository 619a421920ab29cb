"""Runtime numeric utilities and parameter-tree helpers.

Counterpart of ``deepspeed_tpu/runtime/runtime_utils.py``: ``global_norm``
(:16), ``clip_by_global_norm`` (:31) and ``param_count`` (:116).  A tree
is a nest of dicts, lists and tuples (NamedTuples included) with tensors
at the leaves, the shape the JAX package's pytrees take here.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in a fixed order (dict insertion order, then position)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over")
    return out


def global_norm(tree: Any) -> torch.Tensor:
    """L2 norm over a whole tree, the squares summed in fp32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(sq)


def clip_by_global_norm_(leaves: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """Scale a list of leaves in place by ``min(1, max_norm / (norm +
    1e-6))`` (no scaling when ``max_norm`` is 0 or less); returns the norm
    before clipping (``global_norm`` of the leaves unless given)."""
    if norm is None:
        norm = global_norm(leaves)
    if max_norm and max_norm > 0:
        factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for x in leaves:
            x.mul_(factor)
    return norm


def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> Tuple[Any, torch.Tensor]:
    """:func:`clip_by_global_norm_` on copies of the tree's leaves; returns
    the scaled tree and the norm before clipping."""
    leaves = [x.clone() for x in tree_leaves(tree)]
    norm = clip_by_global_norm_(leaves, max_norm, norm)
    return tree_unflatten(tree, leaves), norm


def param_count(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
