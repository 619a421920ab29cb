"""Ragged inference state: sequence descriptors, the paged KV cache and
batch metadata.

Counterpart of ``deepspeed_tpu/inference/ragged/state.py``, ported whole
except the KV tier hooks (``KVBlockTier``, restage and demote queues;
ROADMAP Queue 1, host layers).  What changes with PyTorch:

* the KV cache is one tensor [L, num_blocks + 1, block_size, 2, Hkv, D]
  on the device, updated in place by the forward (the extra row is the
  trash block budget padding writes to), or with ``quant`` "int8"/"fp8"
  a (codes, scales [L, num_blocks + 1, block_size, 2, Hkv] fp32) pair.
  L leads, so a layer's slice ``kv[li]`` stays contiguous — the
  paged-attention kernel needs that;
* batch metadata is staged in ONE flat int32 host buffer per step and
  crosses to the device in one copy; :class:`RaggedBatch` holds views
  of the device copy.  With a :class:`BatchStager` on a CUDA engine the
  buffers are pinned and the copy is asynchronous.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...platform.cuda import resolve_device
from .allocator import BlockedAllocator

# Sentinel token value in a pending queue meaning "the value is the
# previous pipelined step's on-device sample for this sequence's slot" —
# the host schedules position/blocks for it without ever reading the
# token back (the step substitutes it on the device from the prior
# step's [max_seqs] sample tensor).  Real token ids are >= 0.
FEEDBACK_TOKEN = -1

# root parent digest of every per-sequence block hash chain
_CHAIN_ROOT = b"kv-prefix-chain-v1"


def chain_hash(parent: bytes, tokens) -> bytes:
    """Rolling content hash of one FULL KV block: digest of
    ``(parent_hash, block_tokens)``.  128-bit blake2b — the index maps
    digest -> physical block and a collision would silently alias wrong
    KV, so a real cryptographic digest (not Python's ``hash``) is the
    cheap insurance."""
    toks = np.asarray(tokens, np.int64).tobytes()
    return hashlib.blake2b(parent + toks, digest_size=16).digest()


def iter_prefix_chain_digests(tokens, block_size: int,
                              max_blocks: Optional[int] = None):
    """Lazily yield the chain digest of each FULL block-aligned prefix
    of ``tokens`` (a generator, so a cache-miss admission hashes one
    block, not the whole prompt)."""
    n = len(tokens) // block_size
    if max_blocks is not None:
        n = min(n, max_blocks)
    parent = _CHAIN_ROOT
    for k in range(n):
        parent = chain_hash(parent, tokens[k * block_size:
                                           (k + 1) * block_size])
        yield parent


def prefix_chain_digests(tokens, block_size: int,
                         max_blocks: Optional[int] = None) -> List[bytes]:
    """Chain digests of every FULL block-aligned prefix of ``tokens`` —
    the engine-independent form of the prefix-cache key.  Entry ``k`` is
    the digest a :class:`StateManager` index holds iff the first
    ``(k+1) * block_size`` tokens of this stream are resident."""
    return list(iter_prefix_chain_digests(tokens, block_size,
                                          max_blocks))


@dataclasses.dataclass
class KVCacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    block_size: int = 64
    num_blocks: int = 128
    dtype: torch.dtype = torch.bfloat16
    # "none" | "int8" | "fp8": codes + one fp32 scale per K/V vector
    quant: str = "none"
    # None = the card (raises without one)
    device: object = None

    @property
    def max_context(self) -> int:
        return self.num_blocks * self.block_size

    def __post_init__(self):
        if self.quant not in ("none", "int8", "fp8"):
            raise ValueError(
                f"kv_quant={self.quant!r}: the paged cache supports "
                "'int8' or 'fp8' (per-vector scales); weight_quant is "
                "the option that also takes 'int4'")

    def kv_zeros(self):
        """A pristine cache on the device: [L, blocks+1, bs, 2, Hkv, D] in
        ``dtype``, or (codes of that shape in int8 / float8_e4m3fn, fp32
        scales [L, blocks+1, bs, 2, Hkv]) when quantized."""
        shape = (self.num_layers, self.num_blocks + 1, self.block_size, 2,
                 self.num_kv_heads, self.head_dim)
        dev = resolve_device(self.device)
        if self.quant == "none":
            return torch.zeros(shape, dtype=self.dtype, device=dev)
        qdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[self.quant]
        return (torch.zeros(shape, dtype=qdt, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev))


@dataclasses.dataclass
class SequenceDescriptor:
    uid: int
    seen_tokens: int = 0                       # tokens already in KV
    blocks: List[int] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated
    # --- prefix-cache state --------------------------------------------
    cached_tokens: int = 0        # tokens served from the prefix cache
    # token ids in KV order while every value is host-known; a deferred
    # on-device token (FEEDBACK_TOKEN) breaks the chain — blocks past the
    # break are never content-hashed
    chain: List[int] = dataclasses.field(default_factory=list)
    chain_broken: bool = False
    # per-full-block rolling hashes (parallel to ``blocks``' prefix);
    # pre-seeded by a prefix match, extended as chain blocks fill
    hashes: List[bytes] = dataclasses.field(default_factory=list)
    # speculative-decode state: DRAFTED tokens of the most recent step
    # whose acceptance has not resolved yet (see resolve_draft)
    draft_len: int = 0

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        total = self.seen_tokens + new_tokens
        needed = -(-total // block_size)       # ceil
        return max(0, needed - len(self.blocks))

    @property
    def resumable(self) -> bool:
        """The host knows every KV row's token id in order (intact chain,
        no unresolved draft): the sequence can be released and
        re-prefilled token-identically."""
        return (not self.chain_broken and self.draft_len == 0
                and len(self.chain) == self.seen_tokens)


class RaggedBatch(NamedTuple):
    """Fixed-shape device view of one engine step.  All tensors are
    padded to (token_budget, max_seqs); only the first ``n_tokens``
    tokens are real."""
    token_ids: torch.Tensor      # [T] i32
    positions: torch.Tensor      # [T] i32, position within its sequence
    seq_slot: torch.Tensor       # [T] i32, row into block_tables
    token_valid: torch.Tensor    # [T] bool, False for budget padding
    block_tables: torch.Tensor   # [max_seqs, max_blocks] i32; -1 pad
                                 # (maps to the trash row)
    context_lens: torch.Tensor   # [max_seqs] i32, ctx len AFTER this step
    logits_idx: torch.Tensor     # [max_seqs] i32, flat idx of each seq's
                                 # last token this step (-1 if none)
    n_tokens: int                # real token count (host int)
    n_seqs: int
    feedback_src: Optional[torch.Tensor] = None
                                 # [T] i32: slot whose previous-step
                                 # on-device sample supplies this token's
                                 # id (-1 = token_ids holds the value)
    seq_uids: Optional[torch.Tensor] = None
                                 # [max_seqs] i32 holding the uint32 bits
                                 # of the uid occupying each slot
    verify_idx: Optional[torch.Tensor] = None
                                 # [max_seqs, n_verify] i32 speculative
                                 # verify windows (-1 pad); None unless
                                 # n_verify > 1


def _layout(T: int, S: int, nb: int, nv: int):
    """(name, shape, fill) of each field of the flat int32 buffer."""
    return (("token_ids", (T,), 0), ("positions", (T,), 0),
            ("seq_slot", (T,), 0), ("feedback_src", (T,), -1),
            ("token_valid", (T,), 0), ("block_tables", (S, nb), -1),
            ("context_lens", (S,), 0), ("logits_idx", (S,), -1),
            ("seq_uids", (S,), 0), ("verify_idx", (S, nv), -1))


def _views(flat, layout) -> Dict[str, object]:
    """Named views into a flat numpy array or torch tensor."""
    out, o = {}, 0
    for name, shape, _ in layout:
        n = int(np.prod(shape))
        out[name] = flat[o:o + n].reshape(shape)
        o += n
    return out


def _flat_size(layout) -> int:
    return sum(int(np.prod(shape)) for _, shape, _ in layout)


class BatchStager:
    """Alternating host staging buffers for RaggedBatch metadata (the
    reference's pinned "fast host buffer").  The depth-2 serving
    pipeline builds step N+1's metadata while step N runs; alternating
    sets guarantee the host never rewrites a buffer whose host-to-device
    copy for an earlier step may still be in flight.  ``pin`` allocates
    page-locked buffers (a CUDA engine), so that copy is asynchronous."""

    def __init__(self, token_budget: int, max_seqs: int, max_blocks: int,
                 depth: int = 2, n_verify: int = 1, pin: bool = False):
        self.shape_key = (token_budget, max_seqs, max_blocks)
        self.n_verify = max(1, n_verify)
        self._layout = _layout(token_budget, max_seqs, max_blocks,
                               self.n_verify)
        n = _flat_size(self._layout)
        self._bufs = []
        for _ in range(max(2, depth)):
            host = torch.empty(n, dtype=torch.int32, pin_memory=pin)
            self._bufs.append((host, _views(host.numpy(), self._layout)))
        self._i = 0

    def next_buffers(self) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
        """The next staging set (flat host tensor, numpy views), reset to
        its fill values."""
        host, views = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        for name, _, fill in self._layout:
            views[name].fill(fill)
        return host, views


class StateManager:
    """Owns allocator + sequence table + the paged KV cache + the
    prefix-cache hash index.

    With ``prefix_cache=True``, every FULL block whose token chain is
    host-known is registered in a ``digest -> physical block`` index as
    it fills; :meth:`match_prefix` aliases an incoming prompt's longest
    cached block-aligned prefix into the new sequence's block table
    (refcounted, read-only) so prefill starts at the first uncached
    token.  Unreferenced cached blocks rest on the allocator's LRU
    cached-free pool until evicted for a fresh allocation."""

    def __init__(self, cfg: KVCacheConfig, max_seqs: int = 16,
                 max_blocks_per_seq: Optional[int] = None,
                 prefix_cache: bool = False):
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq or cfg.num_blocks
        self.prefix_cache = prefix_cache
        self.allocator = BlockedAllocator(cfg.num_blocks,
                                          on_evict=self._on_evict)
        self.seqs: Dict[int, SequenceDescriptor] = {}
        self._slots: Dict[int, int] = {}       # uid -> batch row
        self._free_slots = list(range(max_seqs))
        # prefix-cache index: chain digest -> physical block (1:1), plus
        # the reverse map the eviction callback uses
        self._hash_index: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        # copy-on-write copies queued by match_prefix: (uid, src, dst);
        # the ENGINE runs them on the device before the next step
        self.cow_pending: List[Tuple[int, int, int]] = []
        # fired with the uid AFTER a sequence's blocks/slot are released
        self.on_release: Optional[callable] = None
        # (digest, block) index entries registered since the last
        # build_batch began (a failed step must unregister exactly these)
        self.round_registered: List[Tuple[bytes, int]] = []
        self.kv = cfg.kv_zeros()
        self.device = (self.kv[0] if isinstance(self.kv, tuple)
                       else self.kv).device

    # ---- sequence lifecycle ---------------------------------------------
    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid not in self.seqs:
            if not self._free_slots:
                raise RuntimeError("No free sequence slots")
            self.seqs[uid] = SequenceDescriptor(uid=uid)
            self._slots[uid] = self._free_slots.pop(0)
        return self.seqs[uid]

    def slot(self, uid: int) -> int:
        return self._slots[uid]

    def release(self, uid: int) -> None:
        """Blocks drop one reference each: a block whose content is
        index-registered and whose refcount hits zero retires to the
        cached-free LRU pool (matchable until evicted); the rest go back
        to the free list."""
        seq = self.seqs.pop(uid, None)
        if seq is None:
            return
        if self.cow_pending:
            # a queued-but-undrained COW copy must die with its owner
            self.cow_pending = [c for c in self.cow_pending if c[0] != uid]
        if seq.blocks:
            # retire TAIL blocks first: eviction (oldest released first)
            # then consumes chains leaf-first
            self.allocator.free(list(reversed(seq.blocks)))
        self._free_slots.append(self._slots.pop(uid))
        if self.on_release is not None:
            self.on_release(uid)

    # ---- prefix cache ----------------------------------------------------
    def _on_evict(self, block: int) -> None:
        """Allocator reclaimed a cached-free block: drop its index entry
        (nothing may match content about to be overwritten)."""
        h = self._block_hash.pop(block, None)
        if h is not None:
            self._hash_index.pop(h, None)

    def match_prefix(self, uid: int, tokens: List[int],
                     max_pool_take: Optional[int] = None) -> int:
        """Alias the longest cached block-aligned prefix of ``tokens``
        into a NEW sequence ``uid`` and return the number of prompt
        tokens served from the cache (0 = no match).

        ``max_pool_take`` caps how many blocks the match may REMOVE from
        the allocatable pool (reviving a cached-free block and the COW
        copy below each count; aliasing a live block is free).

        At least one token is always left for the prefill step.  When
        the cached chain covers the whole prompt, the last matched block
        is copy-on-write'd: a fresh block is allocated, a device copy
        (queued on ``cow_pending``) duplicates the content, and the
        sequence's table points at the private copy."""
        bs = self.cfg.block_size
        if (not self.prefix_cache or uid in self.seqs
                or not self._free_slots or len(tokens) <= bs):
            return 0
        if max_pool_take is None:
            max_pool_take = self.allocator.free_blocks
        hashes: List[bytes] = []
        blocks: List[int] = []
        takes = 0
        for h in iter_prefix_chain_digests(tokens, bs,
                                           self.max_blocks_per_seq):
            b = self._hash_index.get(h)
            if b is None:
                break
            t = 1 if self.allocator.refcount(b) == 0 else 0
            if takes + t > max_pool_take:
                break
            takes += t
            hashes.append(h)
            blocks.append(b)
        if not blocks:
            return 0
        for b in blocks:
            self.allocator.ref(b)
        matched = len(blocks) * bs
        if matched >= len(tokens):
            # full cover: re-schedule the last token so the step has
            # output; it re-writes position matched-1 inside the last
            # matched block -> copy-on-write
            matched = len(tokens) - 1
            if takes < max_pool_take and self.allocator.free_blocks >= 1:
                src = blocks[-1]
                [dst] = self.allocator.allocate(1)
                self.cow_pending.append((uid, src, dst))
                self.allocator.free([src])     # swap our alias for the copy
                blocks[-1] = dst
            else:
                # no room for the private copy: drop back to a
                # block-aligned match instead
                self.allocator.free([blocks.pop()])
                hashes.pop()
                matched = len(blocks) * bs
                if not blocks:
                    return 0
        seq = self.get_or_create(uid)
        seq.blocks = list(blocks)
        seq.seen_tokens = matched
        seq.cached_tokens = matched
        seq.chain = list(tokens[:matched])
        seq.hashes = hashes
        return matched

    def _register_chain_blocks(self, seq: SequenceDescriptor) -> None:
        """Content-hash and index any chain blocks that just became full
        (a block is matchable from the very step that fills it; stream
        order makes the write land before any aliasing step's read)."""
        bs = self.cfg.block_size
        while len(seq.hashes) < len(seq.chain) // bs:
            k = len(seq.hashes)
            parent = seq.hashes[-1] if seq.hashes else _CHAIN_ROOT
            h = chain_hash(parent, seq.chain[k * bs:(k + 1) * bs])
            seq.hashes.append(h)
            if h not in self._hash_index:
                b = seq.blocks[k]
                self._hash_index[h] = b
                self._block_hash[b] = h
                self.allocator.mark_cached(b)
                self.round_registered.append((h, b))

    def unregister_blocks(self, entries: List[Tuple[bytes, int]]) -> None:
        """Withdraw specific ``(digest, block)`` index registrations;
        only entries still mapping the same block are touched."""
        for h, b in entries:
            if self._hash_index.get(h) != b:
                continue
            del self._hash_index[h]
            self._block_hash.pop(b, None)
            self.allocator.unmark_cached(b)

    def reset_prefix_cache(self) -> None:
        """Drop every index entry; cached-free blocks become plain free."""
        for b in list(self._block_hash):
            self.allocator.unmark_cached(b)
        self._block_hash.clear()
        self._hash_index.clear()
        self.cow_pending.clear()

    def prefix_digests(self) -> frozenset:
        """Hex digests resident in the prefix-cache index right now."""
        return frozenset(h.hex() for h in self._hash_index)

    def pool_stats(self) -> Dict[str, int]:
        """Allocator-truth pool occupancy (pure host ints)."""
        al = self.allocator
        return {
            "free": len(al._free),
            "cached_free": al.cached_free_blocks,
            "referenced": al.referenced_blocks,
            "total": al.total_blocks,
            "peak_referenced": al.peak_referenced_blocks,
            "prefix_index_entries": len(self._hash_index),
            "live_seqs": len(self.seqs),
            "free_slots": len(self._free_slots),
        }

    def take_cow_copies(self) -> List[Tuple[int, int]]:
        """Hand the queued (src, dst) copy-on-write block copies to the
        engine and clear the queue."""
        out = [(s, d) for _, s, d in self.cow_pending]
        self.cow_pending.clear()
        return out

    # ---- scheduling query ------------------------------------------------
    @property
    def max_context_tokens(self) -> int:
        return self.max_blocks_per_seq * self.cfg.block_size

    def context_remaining(self, uid: int) -> int:
        seq = self.seqs.get(uid)
        seen = seq.seen_tokens if seq else 0
        return self.max_context_tokens - seen

    def can_schedule(self, uid: int, new_tokens: int) -> bool:
        seq = self.seqs.get(uid) or SequenceDescriptor(uid=uid)
        need = seq.blocks_needed(new_tokens, self.cfg.block_size)
        slot_ok = uid in self._slots or bool(self._free_slots)
        return (need <= self.allocator.free_blocks and slot_ok
                and new_tokens <= self.context_remaining(uid))

    def reserve_ahead(self, uid: int, n_tokens: int) -> bool:
        """Pre-allocate KV blocks covering ``n_tokens`` beyond the
        current context.  False when the pool or context limit cannot
        cover it."""
        seq = self.seqs[uid]
        if n_tokens > self.context_remaining(uid):
            return False
        need = seq.blocks_needed(n_tokens, self.cfg.block_size)
        if need > self.allocator.free_blocks:
            return False
        if need:
            seq.blocks.extend(self.allocator.allocate(need))
        return True

    def resolve_draft(self, uid: int, accepted: int) -> int:
        """Resolve a speculative verify step for ``uid``: commit the
        ``accepted`` leading draft tokens and rewind the write cursor
        over the rejected tail (host bookkeeping only); prefix-cache
        registration of the window's full blocks happens here.  Returns
        the number of rejected tokens rolled back."""
        seq = self.seqs.get(uid)
        if seq is None or not seq.draft_len:
            return 0
        k = seq.draft_len
        seq.draft_len = 0
        if not 0 <= accepted <= k:
            raise ValueError(f"accepted={accepted} outside 0..{k}")
        rejected = k - accepted
        if rejected:
            seq.seen_tokens -= rejected
            if not seq.chain_broken:
                del seq.chain[-rejected:]
        if self.prefix_cache and not seq.chain_broken:
            self._register_chain_blocks(seq)
        return rejected

    def advance(self, uid: int, n_tokens: int) -> None:
        """Account tokens written on the device outside build_batch; the
        content hash chain ends here."""
        seq = self.seqs[uid]
        seq.seen_tokens += n_tokens
        seq.chain_broken = True

    # ---- batch building --------------------------------------------------
    def build_batch(self, requests: List[tuple], token_budget: int,
                    stager: Optional[BatchStager] = None,
                    draft_lens: Optional[Dict[int, int]] = None,
                    n_verify: int = 1) -> RaggedBatch:
        """requests: [(uid, list_of_new_token_ids)]; allocates KV blocks
        and produces the padded device metadata.  A token id of
        :data:`FEEDBACK_TOKEN` (single-token decode continuations only)
        marks a deferred on-device token: the host stages id 0 and
        records the sequence's slot in ``feedback_src``.  With
        ``stager``, metadata is written into its alternating buffers.

        ``draft_lens``: per-uid count of trailing SPECULATIVE tokens in
        that request's token list; the sequence is marked draft-pending
        and ``resolve_draft`` commits or rewinds it.  ``n_verify > 1``
        emits ``verify_idx`` ([max_seqs, n_verify])."""
        max_blocks = self.cfg.num_blocks
        T = token_budget
        nv = max(1, n_verify)
        self.round_registered = []
        if stager is not None \
                and stager.shape_key == (T, self.max_seqs, max_blocks) \
                and stager.n_verify >= n_verify:
            host, b = stager.next_buffers()
            nv = stager.n_verify
        else:
            layout = _layout(T, self.max_seqs, max_blocks, nv)
            flat = np.empty(_flat_size(layout), np.int32)
            b = _views(flat, layout)
            for name, _, fill in layout:
                b[name].fill(fill)
            host = torch.from_numpy(flat)
        token_ids, positions = b["token_ids"], b["positions"]
        seq_slot, block_tables = b["seq_slot"], b["block_tables"]
        context_lens, logits_idx = b["context_lens"], b["logits_idx"]
        feedback_src, verify_idx = b["feedback_src"], b["verify_idx"]
        seq_uids = b["seq_uids"].view(np.uint32)

        # keep existing sequences' tables valid even if not in this batch
        for uid, seq in self.seqs.items():
            s = self._slots[uid]
            block_tables[s, :len(seq.blocks)] = seq.blocks
            context_lens[s] = seq.seen_tokens
            seq_uids[s] = np.uint32(uid & 0xFFFFFFFF)

        cursor = 0
        n_seqs = 0
        for uid, new_tokens in requests:
            n = len(new_tokens)
            if n == 0:
                continue
            k_draft = draft_lens.get(uid, 0) if draft_lens else 0
            if k_draft and (k_draft >= n or n_verify <= k_draft):
                raise ValueError(
                    f"uid {uid}: {k_draft} drafts need a {k_draft + 1}-"
                    f"token window and n_verify > {k_draft}")
            if cursor + n > T:
                raise ValueError(f"token budget {T} exceeded")
            seq = self.get_or_create(uid)
            if seq.draft_len:
                raise ValueError(
                    f"uid {uid}: unresolved draft window "
                    f"({seq.draft_len} tokens) — resolve_draft must run "
                    "before more tokens are scheduled")
            if n > self.context_remaining(uid):
                raise ValueError(
                    f"uid {uid}: {n} new tokens exceed remaining context "
                    f"({self.context_remaining(uid)} of "
                    f"{self.max_context_tokens})")
            need = seq.blocks_needed(n, self.cfg.block_size)
            if need:
                seq.blocks.extend(self.allocator.allocate(need))
            s = self._slots[uid]
            block_tables[s, :len(seq.blocks)] = seq.blocks
            if n == 1 and new_tokens[0] == FEEDBACK_TOKEN:
                # deferred decode token: value comes from the previous
                # step's on-device sample at this sequence's slot
                token_ids[cursor] = 0
                feedback_src[cursor] = s
                # the host never learns this KV row's token id in order,
                # so content hashing stops here for this sequence
                seq.chain_broken = True
            else:
                token_ids[cursor:cursor + n] = new_tokens
                if not seq.chain_broken:
                    # the host-known "KV contents in order" record that
                    # preemption re-queues (index registration below
                    # stays cache-gated)
                    seq.chain.extend(int(t) for t in new_tokens)
            positions[cursor:cursor + n] = np.arange(
                seq.seen_tokens, seq.seen_tokens + n)
            seq_slot[cursor:cursor + n] = s
            seq.seen_tokens += n
            context_lens[s] = seq.seen_tokens
            seq_uids[s] = np.uint32(uid & 0xFFFFFFFF)
            logits_idx[s] = cursor + n - 1
            if n_verify > 1:
                verify_idx[s, 0] = cursor + n - 1
                if k_draft:
                    verify_idx[s, :k_draft + 1] = np.arange(
                        cursor + n - 1 - k_draft, cursor + n)
                    seq.draft_len = k_draft
            cursor += n
            n_seqs += 1
            if self.prefix_cache and not seq.chain_broken \
                    and not seq.draft_len:
                self._register_chain_blocks(seq)
        b["token_valid"][:cursor] = 1

        # ONE host-to-device copy of the whole metadata set (asynchronous
        # from a pinned stager buffer); the CPU path copies too, so a
        # batch never aliases a staging buffer the host will rewrite
        if self.device.type == "cpu":
            dev = host.clone()
        else:
            dev = host.to(self.device, non_blocking=True)
        d = _views(dev, _layout(T, self.max_seqs, max_blocks, nv))
        return RaggedBatch(
            token_ids=d["token_ids"], positions=d["positions"],
            seq_slot=d["seq_slot"], token_valid=d["token_valid"].bool(),
            block_tables=d["block_tables"], context_lens=d["context_lens"],
            logits_idx=d["logits_idx"], n_tokens=cursor, n_seqs=n_seqs,
            feedback_src=d["feedback_src"], seq_uids=d["seq_uids"],
            verify_idx=(d["verify_idx"][:, :n_verify]
                        if n_verify > 1 else None))
