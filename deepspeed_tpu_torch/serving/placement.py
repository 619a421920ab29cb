"""Placement policy for the multi-replica serving front-end
(docs/SERVING.md "Fleet: routing, failover, migration").

Pure host-side scoring over engine-independent keys — the scheduler/
engine boundary split made both sides of a placement decision portable:

* the **prompt side** is :func:`prompt_digests` — the rolling chain
  digests of the prompt's full block-aligned prefixes
  (``ragged.state.prefix_chain_digests``, the SAME function
  ``match_prefix`` consumes, so router-side scoring and engine-side
  matching can never disagree on the key);
* the **replica side** is a digest set — ``StateManager.
  prefix_digests()`` live, or ``engine.snapshot()["prefix_index"]``
  from a replica's last snapshot.

``affinity_chain_len`` is deliberately a *leading-run* match, not a set
intersection: the engine can only alias a cached prefix whose every
ancestor block is resident (``match_prefix`` stops at the first miss),
so a mid-stream hit is worth nothing to prefill and must score nothing
to placement.

Everything here is pure functions over small sequences — no device
work, no engine references — so the router, the load harness, and the
tests all score placements the same way.

Copied from the JAX package's ``serving/placement.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..inference.ragged.state import prefix_chain_digests

PLACEMENT_POLICIES = ("affinity", "least_loaded", "round_robin")

# per-replica roles for disaggregated serving (docs/SERVING.md
# "Disaggregated pools & elasticity"): a "prefill" replica runs
# chunk-free prompt ingestion and hands finished prefills off, a
# "decode" replica hosts the token loops, "mixed" serves both (the
# colocated default — a fleet of only mixed replicas behaves exactly
# as before roles existed)
REPLICA_ROLES = ("prefill", "decode", "mixed")


def split_by_pool(order: Sequence[str], roles: Dict[str, str],
                  pool: Optional[str]) -> List[str]:
    """Stable-partition an already-ranked replica order for a pool-
    targeted placement: replicas serving ``pool`` (their role IS the
    pool, or ``mixed``) keep their rank ahead of everything else, and
    the rest stay as a ranked FALLBACK — a pool with no capacity must
    degrade to colocated placement, never to a lost request.
    ``pool=None`` (no split: pre-disaggregation behavior) returns the
    order unchanged."""
    if pool is None:
        return list(order)
    want = (pool, "mixed")
    pref = [n for n in order if roles.get(n, "mixed") in want]
    rest = [n for n in order if roles.get(n, "mixed") not in want]
    return pref + rest


class CombinedDigestIndex:
    """Membership view over a replica's RESIDENT digest index plus its
    KV tier (docs/KV_TIERING.md "The tier as a fleet asset"): a tiered
    chain scores placement affinity exactly like a resident one,
    because the engine's ``match_prefix`` revive path can serve it —
    restaging a spilled chain is far cheaper than re-prefilling it on a
    cold replica.  Pure membership composition (two ``in``-supporting
    containers), so it stays inside this module's no-engine-references
    contract; :meth:`~.replica.ReplicaHandle.digest_index` builds it.
    ``__len__`` is an upper bound (a digest resident AND tiered counts
    twice) — ranking only uses ``in``."""

    __slots__ = ("resident", "tier")

    def __init__(self, resident, tier):
        self.resident = resident
        self.tier = tier

    def __contains__(self, h) -> bool:
        return h in self.resident or h in self.tier

    def __len__(self) -> int:
        return len(self.resident) + len(self.tier)


def prompt_digests(tokens: Sequence[int], block_size: int,
                   max_blocks: Optional[int] = None) -> List[str]:
    """Hex chain digests of the prompt's full block-aligned prefixes —
    directly comparable against a replica's
    ``StateManager.prefix_digests()`` or its snapshot's
    ``prefix_index`` list."""
    return [h.hex() for h in prefix_chain_digests(tokens, block_size,
                                                  max_blocks)]


def affinity_chain_len(digests: Sequence, index) -> int:
    """Longest cached-chain match: the number of LEADING prompt digests
    present in ``index`` (any container supporting ``in`` — the router
    scores bytes digests against a replica's live index dict; hex
    digests score against a snapshot's ``prefix_index`` list.  Both
    sides must use the same encoding).  The run stops at the first
    miss — blocks past a gap are unreachable to ``match_prefix`` and
    score nothing."""
    n = 0
    for h in digests:
        if h not in index:
            break
        n += 1
    return n


def rank_replicas(policy: str, digests: Sequence,
                  candidates: Sequence[Tuple[str, object, int]],
                  rr_offset: int = 0,
                  scores: Optional[Dict[str, int]] = None,
                  ) -> Tuple[List[str], Dict[str, int]]:
    """Order candidate replicas best-first for one placement.

    ``candidates``: ``(name, digest_index, load)`` per routable replica
    — ``digest_index`` is the replica's resident prefix-digest set,
    ``load`` its live+queued request count (an int, so ordering is
    exact and deterministic).  Returns ``(ordered_names, scores)`` with
    ``scores[name]`` the affinity chain length (computed for every
    policy — it is the placement-hit telemetry even when the policy
    ignores it).  Callers scoring many candidates against one prompt
    may pass precomputed ``scores`` (the router's lazy shared-stream
    scorer); ``digests`` is then ignored.

    * ``affinity`` — longest cached-chain match first, then least
      loaded, then name (stable across runs);
    * ``least_loaded`` — load ascending, then name;
    * ``round_robin`` — registration order rotated by ``rr_offset``
      (the bench baseline the affinity bar is measured against).
    """
    if policy not in PLACEMENT_POLICIES:
        raise ValueError(f"placement={policy!r}: expected one of "
                         f"{PLACEMENT_POLICIES}")
    if scores is None:
        scores = {name: affinity_chain_len(digests, idx)
                  for name, idx, _ in candidates}
    names = [name for name, _, _ in candidates]
    if not names:
        return [], scores
    if policy == "round_robin":
        k = rr_offset % len(names)
        return names[k:] + names[:k], scores
    if policy == "affinity":
        order = sorted(candidates,
                       key=lambda c: (-scores[c[0]], c[2], c[0]))
    else:                                    # least_loaded
        order = sorted(candidates, key=lambda c: (c[2], c[0]))
    return [c[0] for c in order], scores
