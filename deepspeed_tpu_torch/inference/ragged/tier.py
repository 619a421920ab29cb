"""Tiered KV block cache: a bounded host-RAM ring with NVMe overflow.

Counterpart of ``deepspeed_tpu/inference/ragged/tier.py``, copied whole
(the reference imports no jax).  When the allocator evicts a cached-free
block, the engine demotes its content here instead of discarding it,
keyed by the block's prefix-chain digest (:func:`~.state.chain_hash`: the
digest binds the parent chain, so ``(parent_digest, block_digest)`` is
one bytes key).  A later ``match_prefix`` that misses the device cache
but hits this tier revives the block: NVMe reads are queued through the
port's aio pool (``ops/aio.py``) at probe time and resolved at the
engine's pre-dispatch drain, so a spilled-chain hit pays block uploads,
not a re-prefill.

Verification: every payload carries a blake2b-16 checksum over its leaf
bytes, computed at demotion and checked again at every boundary crossing
(NVMe read-back, export to a peer, import from one, which also recomputes
the chain digest from ``(parent, tokens)``).  A failed check drops the
entry (the caller re-prefills); corrupted spill bytes never reach the
device cache.

Host-side numpy and file I/O only: the engine owns every device
transfer.  RAM-only when no spill directory is configured or the aio
pool cannot be built (overflow is then discarded).
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...utils.logging import logger
from .state import chain_hash


def payload_checksum(leaves: Sequence[np.ndarray]) -> bytes:
    """blake2b-16 over leaf dtypes/shapes/bytes — the integrity stamp a
    demoted block carries across every tier boundary."""
    h = hashlib.blake2b(digest_size=16)
    for a in leaves:
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


class _Entry:
    """One demoted block.  ``leaves`` holds the payload while RAM-
    resident; after spilling, ``path`` names the file and ``meta`` the
    per-leaf (dtype, shape) needed to deserialize it."""

    __slots__ = ("parent", "tokens", "checksum", "nbytes", "origin",
                 "leaves", "path", "meta", "iobuf")

    def __init__(self, parent: bytes, tokens: Tuple[int, ...],
                 checksum: bytes, nbytes: int, origin: str,
                 leaves: Optional[List[np.ndarray]]):
        self.parent = parent
        self.tokens = tokens
        self.checksum = checksum
        self.nbytes = nbytes
        self.origin = origin              # "local" | "remote"
        self.leaves = leaves              # RAM tier only
        self.path: Optional[str] = None   # NVMe tier only
        self.meta: Optional[List[Tuple[np.dtype, tuple]]] = None
        self.iobuf: Optional[np.ndarray] = None  # in-flight write buffer


class ReviveOp:
    """A revive in flight: carries the payload (RAM hit) or the read
    buffer an ``async_pread`` was queued into (NVMe hit, issued at probe
    time so the read overlaps scheduling).  ``resolve()`` on the owning
    tier hands back verified leaves or ``None``."""

    __slots__ = ("digest", "parent", "tokens", "checksum", "source",
                 "leaves", "buf", "meta", "path", "failed")

    def __init__(self, digest: bytes, ent: _Entry, source: str):
        self.digest = digest
        self.parent = ent.parent
        self.tokens = ent.tokens
        self.checksum = ent.checksum
        self.source = source              # "ram" | "nvme" | "remote"
        self.leaves = ent.leaves
        self.buf: Optional[np.ndarray] = None
        self.meta = ent.meta
        self.path = ent.path
        self.failed = False


def _deserialize(buf: np.ndarray,
                 meta: List[Tuple[np.dtype, tuple]]) -> List[np.ndarray]:
    out, off = [], 0
    for dtype, shape in meta:
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += n
    return out


class KVBlockTier:
    """Host-RAM ring + NVMe spill directory, both byte-bounded, LRU
    within each tier.  Demotion flows HBM -> RAM -> NVMe -> dropped;
    revival consumes the entry (the block re-registers in the HBM index
    on restage, which supersedes the tier copy)."""

    def __init__(self, ram_bytes: int, nvme_dir: Optional[str] = None,
                 nvme_bytes: int = 0, aio_factory=None):
        self.ram_bytes = int(ram_bytes)
        self.nvme_dir = nvme_dir
        self.nvme_bytes = int(nvme_bytes) if nvme_dir else 0
        if self.nvme_bytes:
            try:
                os.makedirs(nvme_dir, exist_ok=True)
            except OSError as e:
                logger.warning("kv tier: spill dir %r unusable (%s); "
                               "running RAM-only", nvme_dir, e)
                self.nvme_bytes = 0
        self._ram: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._nvme: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._ram_used = 0
        self._nvme_used = 0
        self._aio = None
        self._aio_failed = False
        self._aio_factory = aio_factory
        self._io_pending = False
        # strong refs to every buffer a queued aio op targets — a numpy
        # buffer freed under an in-flight native read/write is heap
        # corruption, so nothing here is released before a wait()
        self._inflight: List[np.ndarray] = []
        self.spill_failures = 0        # writes/reads the backend failed

    # ---- aio plumbing ----------------------------------------------------
    def _handle(self):
        """Lazy aio handle (first spill pays the native-lib load); None
        when the toolchain is unavailable — the tier degrades to
        RAM-only and overflow is dropped."""
        if self._aio is not None or self._aio_failed:
            return self._aio
        try:
            if self._aio_factory is not None:
                self._aio = self._aio_factory()
            else:
                from ...ops.aio import AsyncIOHandle
                self._aio = AsyncIOHandle(thread_count=2)
        except Exception as e:
            logger.warning("kv tier: NVMe spill disabled (%s); "
                           "running RAM-only", e)
            self._aio_failed = True
            self.nvme_bytes = 0
        return self._aio

    def _drain_io(self) -> None:
        """Complete every queued aio op and release the buffer holds."""
        if not self._io_pending:
            return
        failed = self._aio.wait()
        if failed:
            self.spill_failures += failed
        self._inflight.clear()
        for ent in self._nvme.values():
            ent.iobuf = None
        self._io_pending = False

    def __del__(self):
        # runs before attribute teardown: drain while the in-flight
        # buffers are still strongly referenced
        h = self.__dict__.get("_aio")
        if h is not None and self.__dict__.get("_io_pending"):
            h.wait()

    # ---- write side ------------------------------------------------------
    def put(self, parent: bytes, digest: bytes, tokens: Sequence[int],
            leaves: Sequence[np.ndarray],
            origin: str = "local") -> Dict[str, int]:
        """Demote one block's payload into the RAM ring (spilling the
        ring's overflow down to NVMe).  Returns an event dict the engine
        turns into counters: ``stored`` (0/1 — dup keys are no-ops),
        ``nbytes``, ``spilled`` blocks and ``spilled_bytes`` pushed to
        NVMe by the ring overflow, ``dropped`` blocks discarded off the
        bottom."""
        ev = {"stored": 0, "nbytes": 0, "spilled": 0, "spilled_bytes": 0,
              "dropped": 0}
        if digest in self._ram or digest in self._nvme:
            return ev
        arrs = [np.ascontiguousarray(np.asarray(a)) for a in leaves]
        nbytes = sum(a.nbytes for a in arrs)
        if nbytes > max(self.ram_bytes, self.nvme_bytes):
            ev["dropped"] = 1
            return ev
        ent = _Entry(parent, tuple(int(t) for t in tokens),
                     payload_checksum(arrs), nbytes, origin, arrs)
        self._ram[digest] = ent
        self._ram_used += nbytes
        ev["stored"], ev["nbytes"] = 1, nbytes
        while self._ram_used > self.ram_bytes and self._ram:
            old_digest, old = self._ram.popitem(last=False)
            self._ram_used -= old.nbytes
            if self._spill(old_digest, old):
                ev["spilled"] += 1
                ev["spilled_bytes"] += old.nbytes
            else:
                ev["dropped"] += 1
        return ev

    def _spill(self, digest: bytes, ent: _Entry) -> bool:
        """Push a RAM-evicted entry to its NVMe file (async write; the
        serialized buffer stays referenced until the next drain)."""
        if ent.nbytes > self.nvme_bytes or self._handle() is None:
            return False
        buf = np.empty(ent.nbytes, np.uint8)
        off = 0
        meta = []
        for a in ent.leaves:
            n = a.nbytes
            buf[off:off + n] = a.reshape(-1).view(np.uint8)
            off += n
            meta.append((a.dtype, a.shape))
        path = os.path.join(self.nvme_dir, digest.hex() + ".kv")
        self._aio.async_pwrite(buf, path, truncate=True)
        self._io_pending = True
        self._inflight.append(buf)
        ent.leaves = None
        ent.path = path
        ent.meta = meta
        ent.iobuf = buf
        self._nvme[digest] = ent
        self._nvme_used += ent.nbytes
        while self._nvme_used > self.nvme_bytes and self._nvme:
            dead_digest, dead = self._nvme.popitem(last=False)
            if dead_digest == digest:     # the entry we just spilled
                self._nvme[dead_digest] = dead
                break
            self._evict_nvme(dead)
        return True

    def _evict_nvme(self, ent: _Entry) -> None:
        self._nvme_used -= ent.nbytes
        if ent.iobuf is not None:
            self._drain_io()              # never unlink under a write
        try:
            os.remove(ent.path)
        except OSError:
            pass  # already gone — the index entry is what matters

    # ---- read side -------------------------------------------------------
    def contains(self, digest: bytes) -> bool:
        return digest in self._ram or digest in self._nvme

    def __contains__(self, digest: bytes) -> bool:
        return self.contains(digest)

    def __len__(self) -> int:
        return len(self._ram) + len(self._nvme)

    def digests(self) -> frozenset:
        """Every chain digest currently revivable from this tier."""
        return frozenset(self._ram) | frozenset(self._nvme)

    def begin_revive(self, digest: bytes) -> Optional[ReviveOp]:
        """Start restaging ``digest``, CONSUMING the tier entry (on
        success the block re-registers in the HBM index; on failure the
        content was bad anyway).  NVMe hits queue their ``async_pread``
        right here — probe time — so the disk read overlaps the
        scheduler round and the dispatch-ahead window before
        ``resolve()`` needs the bytes."""
        ent = self._ram.pop(digest, None)
        if ent is not None:
            self._ram_used -= ent.nbytes
            src = "remote" if ent.origin == "remote" else "ram"
            return ReviveOp(digest, ent, src)
        ent = self._nvme.pop(digest, None)
        if ent is None:
            return None
        self._nvme_used -= ent.nbytes
        src = "remote" if ent.origin == "remote" else "nvme"
        op = ReviveOp(digest, ent, src)
        if ent.iobuf is not None:
            self._drain_io()              # write must land before read
        op.buf = np.empty(ent.nbytes, np.uint8)
        from ...ops.aio import AioError
        try:
            self._aio.async_pread(op.buf, ent.path)
            self._io_pending = True
            self._inflight.append(op.buf)
        except AioError as e:
            logger.warning("kv tier: spill file lost from under us "
                           "(%s); reviving as a miss", e)
            self.spill_failures += 1
            op.failed = True
            self._remove_file(op.path)
        return op

    def _remove_file(self, path: Optional[str]) -> None:
        if path is None:
            return
        try:
            os.remove(path)
        except OSError:
            pass  # already gone — the index entry is what matters

    def resolve(self, op: ReviveOp) -> Optional[List[np.ndarray]]:
        """Finish a revive: drain outstanding I/O, deserialize, verify
        the checksum.  ``None`` means the payload failed verification
        (or the file died) — the caller re-prefills."""
        if op.failed:
            return None
        if op.buf is not None:
            self._drain_io()              # the queued pread lands here
            leaves = _deserialize(op.buf, op.meta)
            self._remove_file(op.path)    # consumed — file can go now
        else:
            leaves = op.leaves
        if leaves is None or payload_checksum(leaves) != op.checksum:
            self.spill_failures += 1
            logger.warning("kv tier: checksum mismatch on revive of "
                           "%s from %s — dropping, caller re-prefills",
                           op.digest.hex()[:12], op.source)
            return None
        return leaves

    # ---- cross-replica export/import ------------------------------------
    def export(self, digest: bytes) -> Optional[dict]:
        """Non-destructively copy one entry out for a peer replica
        (fleet chain fetch).  NVMe entries are read back synchronously
        and verified first — a corrupted spill file exports as a miss,
        never as bytes."""
        ent = self._ram.get(digest)
        if ent is not None:
            self._ram.move_to_end(digest)
            leaves = ent.leaves
        else:
            ent = self._nvme.get(digest)
            if ent is None:
                return None
            if ent.iobuf is not None:
                self._drain_io()
            buf = np.empty(ent.nbytes, np.uint8)
            from ...ops.aio import AioError
            try:
                failed = self._aio.sync_pread(buf, ent.path)
            except AioError:
                failed = 1
            if failed:
                self.spill_failures += 1
                self._drop_nvme(digest, ent)
                return None
            leaves = _deserialize(buf, ent.meta)
        if payload_checksum(leaves) != ent.checksum:
            self.spill_failures += 1
            logger.warning("kv tier: checksum mismatch exporting %s — "
                           "dropping the entry", digest.hex()[:12])
            self._drop(digest)
            return None
        return {"digest": digest, "parent": ent.parent,
                "tokens": list(ent.tokens),
                "leaves": [np.array(a) for a in leaves],
                "checksum": ent.checksum}

    def clear(self) -> None:
        """Drop every entry, in RAM and on NVMe (their content is stale:
        the weights that computed it were replaced)."""
        for digest in list(self.digests()):
            self._drop(digest)

    def _drop(self, digest: bytes) -> None:
        ent = self._ram.pop(digest, None)
        if ent is not None:
            self._ram_used -= ent.nbytes
            return
        ent = self._nvme.pop(digest, None)
        if ent is not None:
            self._drop_nvme_entry(ent)

    def _drop_nvme(self, digest: bytes, ent: _Entry) -> None:
        self._nvme.pop(digest, None)
        self._drop_nvme_entry(ent)

    def _drop_nvme_entry(self, ent: _Entry) -> None:
        self._nvme_used -= ent.nbytes
        if ent.iobuf is not None:
            # the spill write is still in flight: land it first, then
            # unlink — dropping the index entry alone would leak the
            # file on disk forever (the entry left self._nvme, so no
            # later evict/drop pass can ever see it again)
            self._drain_io()
        try:
            os.remove(ent.path)
        except OSError:
            pass  # already gone — the index entry is what matters

    @staticmethod
    def verify_record(rec: dict) -> bool:
        """The arrival-side contract for a fetched block record: the
        chain digest must recompute from ``(parent, tokens)`` and the
        payload checksum must match the leaves.  Pure — callable before
        any state is touched."""
        try:
            if chain_hash(rec["parent"], rec["tokens"]) != rec["digest"]:
                return False
            return payload_checksum(rec["leaves"]) == rec["checksum"]
        except (KeyError, TypeError, ValueError):
            return False

    def insert_record(self, rec: dict) -> Dict[str, int]:
        """Import a verified peer record (``verify_record`` first —
        this trusts its caller)."""
        return self.put(rec["parent"], rec["digest"], rec["tokens"],
                        rec["leaves"], origin="remote")

    # ---- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"ram_entries": len(self._ram),
                "ram_bytes": self._ram_used,
                "nvme_entries": len(self._nvme),
                "nvme_bytes": self._nvme_used,
                "spill_failures": self.spill_failures}
