"""Runtime numeric utilities and parameter-tree helpers.

Counterpart of ``deepspeed_tpu/runtime/runtime_utils.py``: ``global_norm``
(:16), ``clip_by_global_norm`` (:31), ``partition_balanced`` (:42, copied:
pure Python), ``see_memory_usage`` (:92, on ``torch.cuda.memory_stats``
with the JAX package's keys) and ``param_count`` (:116).  A tree is a nest
of dicts, lists and tuples (NamedTuples included) with tensors at the
leaves, the shape the JAX package's pytrees take here.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, List, Sequence, Tuple

import torch

from ..utils.logging import logger


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


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = (),
                       skip: Sequence[str] = ()) -> Any:
    """``fn(path, leaf)`` over a dict tree's leaves (anything not a dict
    is a leaf, a QuantizedTensor too; ``path`` is the tuple of keys),
    keeping the subtrees whose key is in ``skip`` as they are."""
    if isinstance(tree, dict):
        return {k: (v if k in skip else
                    tree_map_with_path(fn, v, path + (k,), skip))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_at(tree: Any, path: tuple) -> Any:
    """The subtree of a dict tree at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


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


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Split ``weights`` into ``num_parts`` contiguous chunks minimizing the
    largest chunk's weight (the pipeline partitioner's split).  Returns the
    part boundaries, ``num_parts + 1`` of them: a binary search on the cap
    with a greedy check."""
    n = len(weights)
    if num_parts <= 0:
        raise ValueError("num_parts must be positive")
    if num_parts >= n:
        bounds = list(range(n + 1))
        bounds += [n] * (num_parts - n)
        return bounds
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + float(w))

    def parts_needed(cap: float) -> int:
        parts, cur = 1, 0.0
        for w in weights:
            w = float(w)
            if w > cap:
                return num_parts + 1
            if cur + w > cap:
                parts += 1
                cur = w
            else:
                cur += w
        return parts

    lo, hi = max(map(float, weights)), prefix[-1]
    for _ in range(64):
        mid = (lo + hi) / 2
        if parts_needed(mid) <= num_parts:
            hi = mid
        else:
            lo = mid
    cap = hi
    bounds = [0]
    cur = 0.0
    for i, w in enumerate(weights):
        w = float(w)
        if cur + w > cap and len(bounds) < num_parts:
            bounds.append(i)
            cur = w
        else:
            cur += w
    bounds += [n] * (num_parts + 1 - len(bounds))
    return bounds


def see_memory_usage(message: str = "", force: bool = False) -> dict:
    """Device memory by card index: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (the caching allocator's allocated bytes, now
    and at their peak) and ``bytes_limit`` (the card's total memory), the
    JAX package's keys; empty without a card.  ``force`` logs the totals
    with ``message``."""
    stats = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            stats[str(i)] = {
                "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.get_device_properties(
                    i).total_memory,
            }
    if force and stats:
        total = sum(v["bytes_in_use"] for v in stats.values())
        peak = sum(v["peak_bytes_in_use"] for v in stats.values())
        logger.info("%s | mem in_use=%.2fGB peak=%.2fGB", message,
                    total / 2**30, peak / 2**30)
    return stats


def param_count(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))



# elements of one span of a host update: its temporaries stay small
HOST_CHUNK = 1 << 20
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
_heap_kept = False


def keep_host_heap() -> bool:
    """Keep freed host memory in the heap for reuse (glibc's mallopt: no
    fresh mapping under 1 GiB, no trim under 2 GiB).  An eager host update
    allocates a few MiB of temporaries per op; fresh mappings would fault
    every page in again, and a page fault is what costs most in a
    sandboxed host (a 5-10x slower update).  Once per process; False where
    the C library has no mallopt."""
    global _heap_kept
    if not _heap_kept:
        try:
            libc = ctypes.CDLL(None)
            _heap_kept = bool(libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
                              and libc.mallopt(_M_TRIM_THRESHOLD, 1 << 31))
        except (OSError, AttributeError):
            _heap_kept = False
    return _heap_kept
