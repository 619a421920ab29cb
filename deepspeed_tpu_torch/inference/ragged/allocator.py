"""Blocked KV-cache allocator (host-side free list + refcounts).

TPU-native port of the reference's ``BlockedAllocator``
(``deepspeed/inference/v2/ragged/blocked_allocator.py`` — 105 LoC linked
free-list over an int tensor), grown for automatic prefix caching: blocks
are REFCOUNTED (several sequences may alias one physical block read-only)
and a block whose content is registered in the prefix-cache hash index
retires to a *cached-free* LRU pool instead of the plain free list when
its last reference drops.  Allocation prefers plain-free blocks and only
then evicts from the cached pool, oldest first — reuse before overwrite.

Pure host Python: allocation happens between steps, never on the device.
A copy of ``deepspeed_tpu/inference/ragged/allocator.py`` (free of JAX),
kept in the port so the port never imports the JAX package.

Accounting invariant (checked by ``assert_invariants`` and the scheduler
fuzz tests)::

    referenced + cached_free + free == total

where *referenced* counts blocks with refcount >= 1, *cached_free* the
evictable prefix-cache pool, and *free* the plain free list.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set


class BlockedAllocator:
    """Fixed pool of KV blocks handed out to sequences.

    ``on_evict(block)`` fires when a cached-free block is reclaimed for a
    fresh allocation (the owner of the hash index drops its entry there).
    """

    def __init__(self, num_blocks: int,
                 on_evict: Optional[Callable[[int], None]] = None):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._free_set: Set[int] = set(self._free)
        self._refs: Dict[int, int] = {}            # block -> refcount >= 1
        # block -> None, insertion-ordered: oldest released first (the
        # LRU eviction order); value unused, OrderedDict is the O(1)
        # ordered set
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        self._hashed: Set[int] = set()   # blocks registered in the index
        self.on_evict = on_evict
        # high-water mark of the referenced pool (pure int compare on
        # the paths that grow it — the pool-pressure gauge device
        # telemetry exports; reset_peaks() rearms it for a bench leg)
        self._peak_referenced = 0

    # ---- introspection ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: plain free + evictable cached-free."""
        return len(self._free) + len(self._cached_free)

    @property
    def cached_free_blocks(self) -> int:
        return len(self._cached_free)

    @property
    def referenced_blocks(self) -> int:
        return len(self._refs)

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    @property
    def peak_referenced_blocks(self) -> int:
        """High-water mark of concurrently referenced blocks."""
        return self._peak_referenced

    def reset_peaks(self) -> None:
        self._peak_referenced = len(self._refs)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def is_cached(self, block: int) -> bool:
        """Whether the block's content is registered in the hash index
        (set via :meth:`mark_cached`; survives release into the
        cached-free pool, cleared on eviction)."""
        return block in self._hashed

    def assert_invariants(self) -> None:
        """referenced + cached_free + free == total, pools disjoint."""
        ref = set(self._refs)
        cf = set(self._cached_free)
        fr = self._free_set
        assert not (ref & cf) and not (ref & fr) and not (cf & fr), \
            "allocator pools overlap"
        assert len(ref) + len(cf) + len(fr) == self._num_blocks, (
            f"referenced({len(ref)}) + cached_free({len(cf)}) + "
            f"free({len(fr)}) != total({self._num_blocks})")
        assert len(self._free) == len(fr), "free list duplicates"
        assert all(c >= 1 for c in self._refs.values())
        # cached-free blocks are by definition index-registered
        assert cf <= self._hashed, "cached-free block without a hash"

    # ---- allocation ------------------------------------------------------
    def allocate(self, num_blocks: int) -> List[int]:
        """Hand out ``num_blocks`` blocks at refcount 1, drawing from the
        plain free list first and then evicting cached-free blocks oldest
        first (``on_evict`` notifies the hash-index owner per block)."""
        if num_blocks > self.free_blocks:
            raise ValueError(
                f"Cannot allocate {num_blocks} blocks: "
                f"{self.free_blocks} free")
        out = self._free[:num_blocks]
        del self._free[:num_blocks]
        self._free_set.difference_update(out)
        while len(out) < num_blocks:
            b, _ = self._cached_free.popitem(last=False)   # LRU: oldest
            self._hashed.discard(b)
            if self.on_evict is not None:
                self.on_evict(b)
            out.append(b)
        for b in out:
            self._refs[b] = 1
        if len(self._refs) > self._peak_referenced:
            self._peak_referenced = len(self._refs)
        return out

    def ref(self, block: int) -> None:
        """Add a reference: alias a live shared block (refcount += 1) or
        revive a cached-free block into the referenced pool."""
        if block in self._refs:
            self._refs[block] += 1
        elif block in self._cached_free:
            del self._cached_free[block]
            self._refs[block] = 1
            if len(self._refs) > self._peak_referenced:
                self._peak_referenced = len(self._refs)
        else:
            raise ValueError(
                f"Cannot ref block {block}: not referenced or cached-free")

    def mark_cached(self, block: int) -> None:
        """Declare the (referenced) block's content index-registered: when
        its last reference drops it retires to the cached-free pool."""
        if block not in self._refs:
            raise ValueError(f"Cannot cache block {block}: not referenced")
        self._hashed.add(block)

    def unmark_cached(self, block: int) -> None:
        """Withdraw index registration.  A block already resting in the
        cached-free pool moves to the plain free list (nothing can match
        it any more)."""
        self._hashed.discard(block)
        if block in self._cached_free:
            del self._cached_free[block]
            self._free.append(block)
            self._free_set.add(block)

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block.  A block whose refcount
        hits zero retires to the cached-free pool when its content is
        index-registered, else to the plain free list.  Validation is
        atomic: a rejected call (unknown block, or more frees than
        references — including duplicates WITHIN this call) mutates
        nothing."""
        counts: Dict[int, int] = {}
        for b in blocks:
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"Invalid block id {b}")
            counts[b] = counts.get(b, 0) + 1
        for b, c in counts.items():
            if self._refs.get(b, 0) < c:
                raise ValueError(f"Double free of block {b}")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b]:
                continue
            del self._refs[b]
            if b in self._hashed:
                self._cached_free[b] = None    # newest at the LRU tail
            else:
                self._free.append(b)
                self._free_set.add(b)
