"""Ragged-batch model forward with the paged KV cache.

Counterpart of ``deepspeed_tpu/inference/model.py``: one step processes
the scheduled mixed prefill/decode tokens of a :class:`RaggedBatch`:

  embed [n] -> per layer: qkv + rope(positions) -> write K/V into the
  paged cache -> per-token attention over the owning sequence's block
  table (``ops.paged_attention``: the Hopper kernel on the card, its
  plain version on the CPU; with ALiBi slopes for ``position="alibi"``)
  -> MLP -> final norm -> unembed only at each sequence's last scheduled
  token.  :func:`pipelined_ragged_step` then samples every slot with a
  key folded by (uid, position) (``sampler.row_keys``).

PyTorch runs eagerly, so the step computes only the batch's ``n_tokens``
real tokens, not its padded budget (the JAX package pads to a fixed shape
for XLA).  The rows of every valid token are identical either way; only
the trash block no longer receives the padding tokens' garbage.  The
cache is updated in place.

Quantized serving (``quant=`` a tree from
``inference.quantization.quantize_model_params``): each layer's weights
are merged one layer at a time, left quantized for the mixed-input GEMM
(``mixed_gemm=True``: ``ops.mixed_gemm.mixed_matmul``, the Hopper kernel
on the card) or dequantized into the serving dtype; a quantized embedding
table is dequantized per step (an untied model dequantizes only the
gathered rows).  A quantized cache is a ``(codes, scales)`` pair: K/V are
quantized on write, one symmetric scale per vector, and the attention
reads the codes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models import layers as L
from ..models.transformer import (TransformerConfig, _norm,
                                  _require_supported, attn_scale,
                                  unstack_layers)
from ..ops.mixed_gemm import mixed_matmul
from ..ops.paged_attention import _kv_parts, paged_attention
from ..ops.quant import QuantizedTensor, dequantize_any, is_rowwise_int8
from .quantization import merge_layer
from .ragged.state import RaggedBatch
from .sampler import row_keys

# quantized KV cache: code dtype -> the largest code magnitude
_KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def _quantize_kv(x: torch.Tensor, qdt: torch.dtype):
    """x: [..., D] -> (codes [..., D] in ``qdt``, scales [...] f32), one
    symmetric scale per trailing vector."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / _KV_QMAX[qdt], min=1e-8)
    q = xf / scale[..., None]
    if qdt == torch.int8:
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(qdt), scale


def _kv_slots(batch: RaggedBatch, n: int, block_size: int, trash: int):
    """(block, offset) of each of the first n tokens' KV row; the same for
    every layer, so a step computes it once."""
    pos = batch.positions[:n].long()
    blk = batch.block_tables[batch.seq_slot[:n].long(), pos // block_size]
    # budget-padding tokens write to the trash block (last row) so they
    # can never clobber a live sequence's KV
    blk = torch.where(batch.token_valid[:n], blk.long(), trash)
    return blk, pos % block_size


def _write_kv(kv_layer, k: torch.Tensor, v: torch.Tensor, slots) -> None:
    """Scatter per-token K/V into the paged cache, in place, quantizing on
    write when the cache is a (codes, scales) pair.  kv_layer:
    [blocks+1, bs, 2, Hkv, D]; k/v: [n, Hkv, D]; ``slots`` from
    :func:`_kv_slots`."""
    blk, off = slots
    data, scales = _kv_parts(kv_layer)
    kv = torch.stack([k, v], dim=1)                      # [n, 2, Hkv, D]
    if scales is None:
        data[blk, off] = kv.to(data.dtype)
        return
    codes, sc = _quantize_kv(kv, data.dtype)
    # one-byte codes scatter through a uint8 view (index_put does not
    # cover every fp8 type on every device)
    data.view(torch.uint8)[blk, off] = codes.view(torch.uint8)
    scales[blk, off] = sc


def _mm(x: torch.Tensor, w, dt: torch.dtype,
        contract_dims: int = 1) -> torch.Tensor:
    """``x @ w`` contracting x's last dim with w's first ``contract_dims``
    dims; always returns ``dt``.  A row-wise QuantizedTensor ``w`` goes
    through the mixed-input GEMM."""
    if isinstance(w, QuantizedTensor):
        return mixed_matmul(x, w, contract_dims=contract_dims, out_dtype=dt)
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


def _embed_rows(params, quant, ids: torch.Tensor, tied: bool):
    """(embedded rows [n, dm], the table for a tied unembed or None, dt).
    A quantized table is dequantized into its original dtype: whole when
    the unembed needs it (tied) or the layout is not row-wise, else only
    the gathered rows, which are bitwise the rows of the whole table."""
    if quant is None or "embed" not in quant:
        tab = params["embed"]["table"]
        return L.embed(params["embed"], ids), tab, tab.dtype
    qt = quant["embed"]["table"]
    if tied or not is_rowwise_int8(qt):
        tab = dequantize_any(qt)
        return L.embed({"table": tab}, ids), tab, tab.dtype
    idx = ids.long()
    return qt.data[idx].to(qt.dtype) * qt.scale[idx].to(qt.dtype), None, \
        qt.dtype


@torch.no_grad()
def ragged_forward(cfg: TransformerConfig, params, kv,
                   batch: RaggedBatch, block_size: int,
                   max_blocks_per_seq: int, quant=None,
                   mixed_gemm: bool = False):
    """-> (last_token_logits [max_seqs, vocab] f32, kv).

    ``kv``: [L, blocks+1, bs, 2, Hkv, D], or a quantized ``(codes,
    scales [L, blocks+1, bs, 2, Hkv])`` pair, written in place (and
    returned for symmetry with the JAX function).  Rows of the logits
    whose ``batch.logits_idx`` is -1 are garbage (callers mask by it).
    ``quant``: the quantized half of the weights
    (``quantize_model_params``), merged one layer at a time; with
    ``mixed_gemm`` its row-wise weights go through the mixed-input GEMM,
    else each layer is dequantized into the serving dtype.
    Speculative verify batches (``batch.verify_idx``) are not ported yet.

    Every path is position-absolute: a batch whose tokens start at a
    nonzero context offset (chunked prefill, or a prefill resuming after
    a prefix-cache hit aliased the leading blocks) needs no special
    handling."""
    _require_supported(cfg)
    if batch.verify_idx is not None:
        raise NotImplementedError("speculative verify batches are not "
                                  "ported yet (ROADMAP Queue 1, item 1)")
    n = batch.n_tokens
    x, table, dt = _embed_rows(params, quant, batch.token_ids[:n],
                               cfg.tie_embeddings)
    x = x.to(dt)                                                   # [n, dm]
    norm = _norm(cfg)
    act = L.ACTIVATIONS[cfg.activation]
    scale = attn_scale(cfg)
    positions = batch.positions[:n]

    if cfg.embed_norm:                  # bloom word_embeddings_layernorm
        x = norm(params["ln_embed"], x)
    rope = slopes = None
    if cfg.position == "learned":
        x = x + params["pos_embed"]["table"][positions.long()].to(dt)
    elif cfg.position == "alibi":
        # once per step, from the model's head count (never the local Hkv)
        slopes = L.cached_alibi_slopes(cfg.num_heads, x.device)
    else:
        cos, sin = L.rope_freqs(cfg.rotary_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
        p = positions.long()
        rope = (cos[p][:, None, :], sin[p][:, None, :])     # [n, 1, R/2]

    # per-step work every layer shares: the KV write slots and the
    # per-layer views of the stacked weights
    data, scales = _kv_parts(kv)
    slots = _kv_slots(batch, n, block_size, data.shape[1] - 1)
    seq_slot = batch.seq_slot[:n]
    layers = unstack_layers(params["blocks"], cfg.num_layers)
    for li, lp in enumerate(layers):
        # contiguous: L is the lead dim
        kv_layer = data[li] if scales is None else (data[li], scales[li])
        if quant is not None:
            lp = merge_layer(lp, quant["blocks"], li, dt, mixed=mixed_gemm)
        ap = lp["attn"]
        h = norm(lp["ln1"], x)
        q, k, v = _qkv_proj(cfg, ap, h, dt, rope)
        _write_kv(kv_layer, k, v, slots)
        o = paged_attention(kv_layer, q.contiguous(), seq_slot,
                            positions, batch.block_tables, block_size,
                            max_blocks_per_seq, scale, slopes=slopes)
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
        logits = last @ table.to(dt).T
    else:
        logits = last @ params["lm_head"]["kernel"].to(dt)
        if cfg.head_bias:
            logits = logits + params["lm_head"]["bias"].to(dt)
    return logits.float(), kv


@torch.no_grad()
def pipelined_ragged_step(cfg: TransformerConfig, params, quant, kv,
                          batch: RaggedBatch, prev_toks: torch.Tensor,
                          rng: Optional[torch.Tensor], sample_fn: Callable,
                          block_size: int, max_blocks_per_seq: int,
                          mixed_gemm: bool = False
                          ) -> Tuple[torch.Tensor, object]:
    """One serving pipeline stage, entirely on the device: substitute
    deferred feedback tokens from the previous step's on-device samples,
    run the ragged forward, sample every slot's next token.

    ``prev_toks``: [max_seqs] i32, the previous step's sample output
    (still on the device).  ``batch.feedback_src[t] == s`` means token
    ``t``'s id is ``prev_toks[s]``; -1 keeps the host-staged id.
    ``rng`` is the caller's BASE key (``utils.prng``): each row samples
    with ``row_keys(rng, uid, context length)``, so sampled values are
    invariant to scheduling (pipeline depth, chunking, prefix-cache
    hits).  ``sample_fn(logits, keys)`` consumes the per-row keys.  A
    greedy sampler takes ``rng=None`` and gets ``keys=None``: the JAX
    step folds a zero key that XLA then drops, which eager PyTorch
    would run, so the fold is skipped instead.
    ``quant``/``mixed_gemm`` as in :func:`ragged_forward`.
    Returns (sampled tokens [max_seqs] i32, kv); rows whose
    ``batch.logits_idx`` is -1 are garbage."""
    fb = batch.feedback_src
    if fb is not None:
        tok = torch.where(fb >= 0, prev_toks[fb.clamp(min=0).long()],
                          batch.token_ids)
        batch = batch._replace(token_ids=tok)
    logits, kv = ragged_forward(cfg, params, kv, batch, block_size,
                                max_blocks_per_seq, quant=quant,
                                mixed_gemm=mixed_gemm)
    keys = None if rng is None else row_keys(rng, batch.seq_uids,
                                             batch.context_lens)
    return sample_fn(logits, keys), kv
