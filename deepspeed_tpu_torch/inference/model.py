"""Ragged-batch model forward with the paged KV cache.

Counterpart of ``deepspeed_tpu/inference/model.py``: one step processes
the scheduled mixed prefill/decode tokens of a :class:`RaggedBatch`:

  embed [n] -> per layer: qkv + rope(positions) -> write K/V into the
  paged cache -> per-token attention over the owning sequence's block
  table (``ops.paged_attention``: the Hopper kernel on the card, its
  plain version on the CPU) -> MLP -> final norm -> unembed only at each
  sequence's last scheduled token.

PyTorch runs eagerly, so the step computes only the batch's ``n_tokens``
real tokens, not its padded budget (the JAX package pads to a fixed shape
for XLA).  The rows of every valid token are identical either way; only
the trash block no longer receives the padding tokens' garbage.  The
cache is updated in place.  Dense weights only (quantized weights are a
later slice).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models import layers as L
from ..models.transformer import (TransformerConfig, _norm,
                                  _require_supported, attn_scale,
                                  unstack_layers)
from ..ops.paged_attention import paged_attention
from .ragged.state import RaggedBatch


def _kv_slots(batch: RaggedBatch, n: int, block_size: int, trash: int):
    """(block, offset) of each of the first n tokens' KV row; the same for
    every layer, so a step computes it once."""
    pos = batch.positions[:n].long()
    blk = batch.block_tables[batch.seq_slot[:n].long(), pos // block_size]
    # budget-padding tokens write to the trash block (last row) so they
    # can never clobber a live sequence's KV
    blk = torch.where(batch.token_valid[:n], blk.long(), trash)
    return blk, pos % block_size


def _write_kv(kv_layer: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              slots) -> None:
    """Scatter per-token K/V into the paged cache, in place.
    kv_layer: [blocks+1, bs, 2, Hkv, D]; k/v: [n, Hkv, D]; ``slots`` from
    :func:`_kv_slots`."""
    blk, off = slots
    kv_layer[blk, off] = torch.stack([k, v], dim=1).to(kv_layer.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype,
        contract_dims: int = 1) -> torch.Tensor:
    """``x @ w`` contracting x's last dim with w's first ``contract_dims``
    dims; always returns ``dt``."""
    wshape = w.shape
    K = 1
    for s in wshape[:contract_dims]:
        K *= s
    y = (x.reshape(-1, K) @ w.reshape(K, -1).to(dt)).to(dt)
    return y.reshape(*x.shape[:-1], *wshape[contract_dims:])


def _qkv_proj(cfg: TransformerConfig, ap, h: torch.Tensor, dt, rope):
    """qkv projection + biases + rotary -> q [n, H, D], k/v [n, Hkv, D].
    ``rope``: (cos, sin) rows of the tokens' positions, [n, 1, R/2]."""
    q = _mm(h, ap["wq"], dt)
    k = _mm(h, ap["wk"], dt)
    v = _mm(h, ap["wv"], dt)
    if cfg.attn_bias:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    if rope is not None:
        q = L.rotate(q, *rope)
        k = L.rotate(k, *rope)
    return q, k, v


def _ffn(cfg: TransformerConfig, lp, h: torch.Tensor, dt,
         act: Callable) -> torch.Tensor:
    """Dense MLP branch of a serving layer."""
    mp = lp["mlp"]
    u = _mm(h, mp["wi"], dt)
    if cfg.mlp_bias:
        u = u + mp["bi"].to(dt)
    u = act(_mm(h, mp["wg"], dt)) * u if cfg.gated_mlp else act(u)
    d = _mm(u, mp["wo"], dt)
    if cfg.mlp_bias:
        d = d + mp["bo"].to(dt)
    return d


@torch.no_grad()
def ragged_forward(cfg: TransformerConfig, params, kv: torch.Tensor,
                   batch: RaggedBatch, block_size: int,
                   max_blocks_per_seq: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (last_token_logits [max_seqs, vocab] f32, kv).

    ``kv``: [L, blocks+1, bs, 2, Hkv, D], written in place (and returned
    for symmetry with the JAX function).  Rows of the logits whose
    ``batch.logits_idx`` is -1 are garbage (callers mask by it).
    Speculative verify batches (``batch.verify_idx``) are not ported yet.

    Every path is position-absolute: a batch whose tokens start at a
    nonzero context offset (chunked prefill, or a prefill resuming after
    a prefix-cache hit aliased the leading blocks) needs no special
    handling."""
    _require_supported(cfg)
    if batch.verify_idx is not None:
        raise NotImplementedError("speculative verify batches are not "
                                  "ported yet (ROADMAP Queue 1, item 5)")
    n = batch.n_tokens
    embed_tab = params["embed"]
    dt = embed_tab["table"].dtype
    norm = _norm(cfg)
    act = L.ACTIVATIONS[cfg.activation]
    scale = attn_scale(cfg)
    positions = batch.positions[:n]

    x = L.embed(embed_tab, batch.token_ids[:n]).to(dt)            # [n, dm]
    if cfg.embed_norm:                  # bloom word_embeddings_layernorm
        x = norm(params["ln_embed"], x)
    rope = None
    if cfg.position == "learned":
        x = x + params["pos_embed"]["table"][positions.long()].to(dt)
    elif cfg.position == "alibi":
        L.alibi_slopes(cfg.num_heads)            # raises: not ported yet
    else:
        cos, sin = L.rope_freqs(cfg.rotary_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
        p = positions.long()
        rope = (cos[p][:, None, :], sin[p][:, None, :])     # [n, 1, R/2]

    # per-step work every layer shares: the KV write slots and the
    # per-layer views of the stacked weights
    slots = _kv_slots(batch, n, block_size, kv.shape[1] - 1)
    seq_slot = batch.seq_slot[:n]
    layers = unstack_layers(params["blocks"], cfg.num_layers)
    for li, lp in enumerate(layers):
        kv_layer = kv[li]                 # contiguous: L is the lead dim
        ap = lp["attn"]
        h = norm(lp["ln1"], x)
        q, k, v = _qkv_proj(cfg, ap, h, dt, rope)
        _write_kv(kv_layer, k, v, slots)
        o = paged_attention(kv_layer, q.contiguous(), seq_slot,
                            positions, batch.block_tables, block_size,
                            max_blocks_per_seq, scale)
        o = _mm(o.reshape(n, -1), ap["wo"], dt, contract_dims=2)
        if cfg.attn_out_bias:
            o = o + ap["bo"].to(dt)
        if not cfg.parallel_block:
            x = x + o
            h = norm(lp["ln2"], x)
        elif cfg.parallel_separate_norms:
            h = norm(lp["ln2"], x)   # gpt-neox: MLP norms the original x
        # parallel residual (falcon/phi): MLP reads the same ln1 output
        d = _ffn(cfg, lp, h, dt, act)
        x = x + o + d if cfg.parallel_block else x + d

    # logits only at each sequence's last scheduled token; -1 pads read
    # token 0 and give garbage rows
    last = norm(params["ln_f"], x[batch.logits_idx.clamp(min=0).long()])
    if cfg.tie_embeddings:
        logits = last @ embed_tab["table"].to(dt).T
    else:
        logits = last @ params["lm_head"]["kernel"].to(dt)
        if cfg.head_bias:
            logits = logits + params["lm_head"]["bias"].to(dt)
    return logits.float(), kv


@torch.no_grad()
def pipelined_ragged_step(cfg: TransformerConfig, params, kv: torch.Tensor,
                          batch: RaggedBatch, prev_toks: torch.Tensor,
                          sample_fn: Callable, block_size: int,
                          max_blocks_per_seq: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One serving pipeline stage, entirely on the device: substitute
    deferred feedback tokens from the previous step's on-device samples,
    run the ragged forward, sample every slot's next token.

    ``prev_toks``: [max_seqs] i32, the previous step's sample output
    (still on the device).  ``batch.feedback_src[t] == s`` means token
    ``t``'s id is ``prev_toks[s]``; -1 keeps the host-staged id.
    Returns (sampled tokens [max_seqs] i32, kv); rows whose
    ``batch.logits_idx`` is -1 are garbage."""
    fb = batch.feedback_src
    if fb is not None:
        tok = torch.where(fb >= 0, prev_toks[fb.clamp(min=0).long()],
                          batch.token_ids)
        batch = batch._replace(token_ids=tok)
    logits, kv = ragged_forward(cfg, params, kv, batch, block_size,
                                max_blocks_per_seq)
    return sample_fn(logits), kv
