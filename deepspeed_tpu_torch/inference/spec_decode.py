"""Model-free draft proposal for speculative decoding (prompt lookup).

Counterpart of ``deepspeed_tpu/inference/spec_decode.py``, copied whole:
it holds no device arrays, so nothing changes with PyTorch.

Decode normally advances one token per dispatched step.  Speculative
decoding breaks that bound by *guessing* the next ``k`` tokens and
scoring the guess in ONE ragged dispatch (the verify step — a decoding
sequence contributes ``1 + k`` positions, exactly like a chunked
prefill), then keeping the longest prefix of the guess that matches
what the model would have sampled anyway.  Verification makes the
output exactly the non-speculative stream — the draft source only
changes how often the guess is right, never what is emitted.

This module is the zero-weight draft source: an n-gram / prompt-lookup
proposer that mines candidate continuations from the request's OWN
token history (prompt + emitted tokens).  The traffic a prefix-cached
server attracts — code completion, RAG over quoted documents,
summarization, multi-turn chat — repeats its own substrings constantly,
and "what followed this n-gram last time" is a startlingly good draft
there, for free (reference lineage: prompt-lookup decoding, and the
n-gram speculators of the vLLM/DeepSpeed-FastGen ecosystems; the ragged
verify shape follows ``deepspeed/inference/v2``'s ragged batching,
which treats multi-token-per-sequence steps as a first-class batch
shape).

The proposer is DATA ONLY from the engine's point of view: the verify
step takes drafts as plain token lists, so a future draft-model
proposer (a tiny engine sharing the scheduler) can slot in behind the
same ``propose()`` surface without reworking the engine.

Everything here is pure host-side dict/list work — no device arrays,
no syncs (it runs inside the engine's ``_schedule``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class NgramProposer:
    """Per-request n-gram continuation index.

    For every request the proposer keeps the token history (prompt +
    emitted tokens, appended via :meth:`observe`) and, per n-gram size
    ``n`` in ``[min_ngram, max_ngram]``, a map from n-gram to the END
    positions (exclusive) of its two most recent occurrences.  A draft
    for the next decode step is "the tokens that followed the current
    history suffix the last time it occurred", longest ``n`` first:

    * the suffix n-gram's *previous* occurrence ends at ``src``;
    * the span ``history[src:]`` is what followed it last time — and
      because the suffix recurs with period ``len(history) - src``, the
      span is extended cyclically when the draft window is longer than
      the span (a constant or short-cycle tail — the attractor greedy
      decoding of small models falls into — drafts at full width).

    Drafts are *guesses*: a wrong draft costs only the budget its
    verify positions consumed; the accept-longest-matching-prefix check
    in the engine keeps the output stream exact.
    """

    def __init__(self, max_draft: int, max_ngram: int = 3,
                 min_ngram: int = 1):
        if max_draft < 1:
            raise ValueError(f"max_draft must be >= 1, got {max_draft}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_draft = max_draft
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self._hist: Dict[int, List[int]] = {}
        # uid -> n -> ngram tuple -> (latest end, previous end | None)
        self._index: Dict[int, Dict[int, Dict[Tuple[int, ...],
                                              Tuple[int, Optional[int]]]]] \
            = {}

    # ------------------------------------------------------------------
    def observe(self, uid: int, tokens) -> None:
        """Append emitted/prompt ``tokens`` to ``uid``'s history and
        index every n-gram they complete.  Negative ids (the engine's
        deferred-feedback sentinel) are skipped — they are placeholders,
        not stream content."""
        h = self._hist.setdefault(uid, [])
        idx = self._index.setdefault(
            uid, {n: {} for n in range(self.min_ngram, self.max_ngram + 1)})
        for t in tokens:
            t = int(t)
            if t < 0:
                continue
            h.append(t)
            e = len(h)
            for n, tab in idx.items():
                if e >= n:
                    g = tuple(h[e - n:e])
                    prev = tab.get(g)
                    tab[g] = (e, prev[0] if prev is not None else None)

    def forget(self, uid: int) -> None:
        self._hist.pop(uid, None)
        self._index.pop(uid, None)

    def history_len(self, uid: int) -> int:
        return len(self._hist.get(uid, ()))

    # ------------------------------------------------------------------
    def _prev_occurrence(self, uid: int) -> Optional[int]:
        """END position (exclusive) of the most recent occurrence of the
        current history suffix STRICTLY BEFORE the suffix itself —
        longest n-gram first, None when no suffix size matches."""
        h = self._hist.get(uid)
        if not h:
            return None
        idx = self._index[uid]
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(h) < n:
                continue
            ent = idx[n].get(tuple(h[-n:]))
            if ent is None:
                continue
            _, prev = ent
            # the suffix itself is always the newest-indexed occurrence
            # (observe() appends to history and index together), so the
            # usable match is the one before it — always < len(h)
            if prev is not None:
                return prev
        return None

    def propose(self, uid: int, last_token: int, limit: int) -> List[int]:
        """Draft up to ``min(limit, max_draft)`` continuation tokens for
        the decode step that will feed ``last_token`` next.

        ``last_token`` must be the request's current stream tail; when
        it is not (direct-API callers that feed tokens the engine never
        emitted — teacher forcing, fuzz drives), the history is healed
        by appending it, so the match stays anchored at the true fed
        token either way.  Returns ``[]`` when nothing matches (the
        step degrades to a plain 1-token decode)."""
        limit = min(limit, self.max_draft)
        if limit <= 0:
            return []
        h = self._hist.get(uid)
        if h is None or not h or h[-1] != int(last_token):
            self.observe(uid, [last_token])
            h = self._hist.get(uid)
            if not h:
                return []
        src = self._prev_occurrence(uid)
        if src is None:
            return []
        # the tokens that followed the matched occurrence, extended
        # cyclically: the suffix recurs with period len(h) - src, so
        # wrapping continues the established cycle
        period = len(h) - src
        return [h[src + (j % period)] for j in range(limit)]

    def lookahead(self, uid: int) -> bool:
        """Cheap "is this stream currently predictable" signal: does the
        current history suffix have an earlier occurrence?  The
        pipelined driver uses it to choose, per sequence per step,
        between the feedback-marker fast path (dispatch ahead without
        waiting — no drafts possible, the next token id is still on
        device) and the verify path (wait for the collect so the
        concrete token can anchor a draft window).  Random streams keep
        full dispatch-ahead pipelining; repetitive streams trade one
        pipeline bubble for up to ``max_draft`` extra tokens per step."""
        return self._prev_occurrence(uid) is not None
