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

The step computes the batch's first ``n_tokens`` tokens.  The engine
pads that count up to a power-of-two token bucket (the JAX package pads
every step to its whole budget for XLA), so that a step's shapes repeat
and a CUDA graph of it can be replayed; padding tokens are invalid, write
their K/V to the trash block and are never read.  The cache is updated
in place.

A speculative verify batch (``batch.verify_idx`` [S, W]) takes logits at
every position of each sequence's draft window, and
:func:`pipelined_ragged_step` samples each of them with the key the
stepwise engine would use there (``sampler.window_keys``).

Decode bursts (:func:`snapshot_prefix`, :func:`decode_burst_forward`,
:func:`scatter_tail`) run ``steps`` decode iterations on the device with
no host step between them: attention merges a dense read-only snapshot
of each slot's context with the burst's own KV tail by an online
softmax, in plain torch ops as the reference's XLA ops (no Pallas kernel
there, no hand kernel here); a quantized model's projections still go
through the mixed-input GEMM.

A mixture-of-experts layer (``num_experts > 1``) runs
``parallel.moe.moe_serving`` on the step's rows: only the batch's valid
tokens are gated and take expert capacity (the JAX step gates its
padding too, which can take capacity from real tokens), at the capacity
the JAX step gives its T rows (the staged batch's length, the token
budget; a burst's slot count); then the qwen2-moe shared expert.
Nothing in it reads back to the host, so its steps capture as graphs.

Quantized serving (``quant=`` a tree from
``inference.quantization.quantize_model_params``): each layer's weights
are merged one layer at a time, left quantized for the mixed-input GEMM
(``mixed_gemm=True``: ``ops.mixed_gemm.mixed_matmul``, the Hopper kernel
on the card) or dequantized into the serving dtype; a quantized embedding
table is dequantized per step (an untied model dequantizes only the
gathered rows).  A quantized cache is a ``(codes, scales)`` pair: K/V are
quantized on write, one symmetric scale per vector, and the attention
reads the codes.

Serving offload (:func:`ragged_forward`'s ``kv_host`` and ``stream``):
with the cache in host memory, each layer's slice is copied into a
working layer on the device before the layer and back after it (on the
card, asynchronous copies between page-locked memory and fixed device
addresses, so a step with them still captures as a CUDA graph); with an
``NVMeWeightStore`` the block weights come from the store one layer at a
time, left quantized for the mixed-input GEMM where it takes them.

Tensor parallelism (``shard_mesh=``, a rank's :class:`ShardPlan`): the
JAX forward runs under GSPMD, with paged attention in a ``shard_map``
over the tensor axis.  Here each rank holds its slices (query heads, KV
heads and their cache, MLP columns, vocab rows), runs paged attention on
its own head group (K2-TP), sums the row-parallel partial products over
the ranks and gathers the logits, so every rank computes the same
logits; memory shards (an ``fsdp`` axis, a quantized tree) are gathered
a layer at use.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..comm.collectives import exact_psum, gather_dim
from ..comm.mesh import TENSOR_AXIS
from ..comm.overlap import (ServingComm, shard_matmul_allgather,
                            shard_matmul_allreduce)
from ..models import layers as L
from ..models.transformer import (TransformerConfig, _norm,
                                  _shared_expert, attn_scale, unstack_layers)
from ..parallel.moe import moe_serving
from ..runtime.runtime_utils import tree_map_with_path
from ..ops.mixed_gemm import mixed_matmul
from ..ops.paged_attention import _kv_parts, paged_attention
from ..ops.quant import (QuantizedTensor, _div, dequantize_any,
                         is_mixed_gemm_layout, is_rowwise_int8)
from .quantization import (DENSE_ONLY_GROUPS, _row_scaled, contract_dims,
                           merge_layer, merge_layer_qts)
from .ragged.state import RaggedBatch
from .sampler import row_keys, window_keys

# quantized KV cache: code dtype -> the largest code magnitude
_KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def _quantize_kv(x: torch.Tensor, qdt: torch.dtype):
    """x: [..., D] -> (codes [..., D] in ``qdt``, scales [...] f32), one
    symmetric scale per trailing vector."""
    xf = x.float()
    scale = torch.clamp(_div(xf.abs().amax(dim=-1), _KV_QMAX[qdt]),
                        min=1e-8)
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


class ShardPlan:
    """One rank's part of the tensor-parallel serving forward (built by
    ``InferenceEngine`` under a topology; the JAX forward gets the same
    from GSPMD and the ``shard_map`` of ``_paged_attention_pallas``).

    * ``head_split``: the cache holds this rank's ``Hkv/tp`` KV heads,
      and paged attention (K2) runs on them and the rank's ``H/tp`` query
      heads, the ALiBi slopes cut with them (K2-TP).  With
      ``heads_local`` the attention weights are the rank's head slices
      and ``wo``'s partial sums are all-reduced; without it (a quantized
      tree, memory-sharded and gathered whole) the full q/k/v are
      projected, the rank's heads taken, and the attention outputs
      all-gathered over heads before ``wo``.
    * ``mlp_split``: ``wi``/``wg`` hold the rank's ``d_ff/tp`` columns
      and ``wo`` its rows; the down-projection's partials are
      all-reduced (tiled under a :class:`ServingComm`).
    * ``embed_split`` / ``unembed_split``: the embedding table / LM head
      hold the rank's ``vocab/tp`` rows / columns: the lookup is a masked
      local lookup plus an all-reduce (exact: the other ranks add zeros),
      and the logits are all-gathered over vocab (a gather never rounds,
      so every rank samples the same tokens).
    * ``gathers`` / ``qgathers``: the memory shards (the ``fsdp`` axis,
      and every axis of a quantized tree) as ``path -> ((dim, axis),
      ...)``, all-gathered at use: a layer's leaves at that layer, the
      others once a step.

    Every reduction sums in rank order (``comm.collectives.exact_psum``).
    With ``measure`` set, every collective is timed between device
    synchronizations into ``comm_ms`` (the comm share of a step)."""

    def __init__(self, topology, *, head_split: bool, heads_local: bool,
                 mlp_split: bool, embed_split: bool, unembed_split: bool,
                 gathers: Dict[tuple, tuple], qgathers: Dict[tuple, dict]):
        self.topology = topology
        self.tp = topology.tp_size
        self.rank = topology.axis_rank(TENSOR_AXIS)
        self.group = topology.group(TENSOR_AXIS)
        self.head_split, self.heads_local = head_split, heads_local
        self.mlp_split = mlp_split
        self.embed_split, self.unembed_split = embed_split, unembed_split
        self.gathers, self.qgathers = gathers, qgathers
        self.measure = False
        self.comm_ms = 0.0

    # -- collectives -------------------------------------------------------
    def timed(self, fn: Callable, *args):
        if not self.measure:
            return fn(*args)
        dev = next(a for a in args if isinstance(a, torch.Tensor)).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.comm_ms += (time.perf_counter() - t0) * 1e3
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function(f"all_reduce_{TENSOR_AXIS}"):
            return self.timed(exact_psum, x, self.group, self.tp)

    def gather(self, x: torch.Tensor, dim: int, axis: str = TENSOR_AXIS
               ) -> torch.Tensor:
        topo = self.topology
        with torch.profiler.record_function(f"all_gather_{axis}"):
            return self.timed(gather_dim, x, dim, topo.group(axis),
                              topo.size(axis))

    def _gathered(self, x: torch.Tensor, recipe, li: Optional[int] = None):
        """``x`` (a stacked leaf when ``li`` is given: its layer ``li``)
        with its memory shards all-gathered; a layer dim that is itself
        cut gathers the whole leaf first."""
        if li is not None and all(d != 0 for d, _ in recipe):
            x, recipe, li = x[li], tuple((d - 1, a) for d, a in recipe), None
        for d, a in recipe:
            x = self.gather(x, d, a)
        return x if li is None else x[li]

    # -- weights -----------------------------------------------------------
    def top(self, params):
        """The non-block leaves with their memory shards gathered."""
        return tree_map_with_path(lambda path, x: self._gathered(
            x, self.gathers[path]) if path in self.gathers else x, params,
            skip=("blocks",))

    def layer(self, blocks, li: int):
        """Layer ``li``'s dense weights (views, or gathered copies)."""
        return tree_map_with_path(lambda path, x: (
            self._gathered(x, self.gathers[path], li)
            if path in self.gathers else x[li]), blocks, ("blocks",))

    def quant_embed(self, quant):
        """The quantized tree's embedding table, gathered whole."""
        if quant is None or "embed" not in quant:
            return quant
        qt = quant["embed"]["table"]
        return {**quant, "embed": {"table": self._qt_gathered(
            qt, self.qgathers[("embed", "table")])}}

    def _qt_gathered(self, qt: QuantizedTensor, recipes,
                     li: Optional[int] = None) -> QuantizedTensor:
        parts = {}
        for name in ("data", "scale", "zero"):
            t = getattr(qt, name)
            parts[name] = None if t is None else self._gathered(
                t, recipes.get(name, ()), li)
        shape = qt.shape if li is None else qt.shape[1:]
        return QuantizedTensor(parts["data"], parts["scale"], parts["zero"],
                               qt.bits, shape, qt.dtype, layout=qt.layout)

    def merge_quant(self, lp, quant_blocks, li: int, dt: torch.dtype,
                    mixed: bool):
        """Layer ``li`` of the memory-sharded quantized tree, each payload
        gathered, merged into ``lp`` (``quantization.merge_layer_qts``:
        row-wise for the mixed-input GEMM, K3, or dequantized)."""
        return merge_layer_qts(lp, {
            gname: {name: self._qt_gathered(
                qt, self.qgathers[("blocks", gname, name)], li)
                for name, qt in qgroup.items()}
            for gname, qgroup in quant_blocks.items()}, dt, mixed)

    # -- the forward's sharded steps ----------------------------------------
    def embed_rows(self, table: torch.Tensor, ids: torch.Tensor):
        """Rows of a vocab-split table: a masked local lookup, summed over
        the ranks."""
        v = table.shape[0]
        local = ids.long() - self.rank * v
        hit = (local >= 0) & (local < v)
        rows = table[local.clamp(0, v - 1)]
        return self.psum(torch.where(hit[:, None], rows,
                                     torch.zeros_like(rows)))

    def slopes(self, slopes: Optional[torch.Tensor]):
        if slopes is None or not self.head_split:
            return slopes
        h = slopes.shape[0] // self.tp
        return slopes[self.rank * h:(self.rank + 1) * h]

    def heads(self, q, k, v):
        """This rank's query and KV heads of a full projection."""
        if not self.head_split or self.heads_local:
            return q, k, v
        hq, hk = q.shape[1] // self.tp, k.shape[1] // self.tp
        r = self.rank
        return (q[:, r * hq:(r + 1) * hq], k[:, r * hk:(r + 1) * hk],
                v[:, r * hk:(r + 1) * hk])

    def attn_out(self, o: torch.Tensor, wo, dt: torch.dtype):
        """The attention output projection of this rank's heads."""
        n = o.shape[0]
        if self.heads_local:
            return self.psum(_mm(o.reshape(n, -1), wo, dt, contract_dims=2))
        if self.head_split:
            o = self.gather(o, 1)
        return _mm(o.reshape(n, -1), wo, dt, contract_dims=2)

    def down(self, u: torch.Tensor, wo, dt: torch.dtype,
             comm: Optional[ServingComm]):
        """The MLP down-projection of this rank's columns, summed."""
        if comm is not None and comm.downproj \
                and not isinstance(wo, QuantizedTensor):
            return self.timed(shard_matmul_allreduce, u, wo, comm, dt)
        return self.psum(_mm(u, wo, dt))

    def unembed(self, last: torch.Tensor, w: torch.Tensor, bias,
                dt: torch.dtype, comm: Optional[ServingComm]):
        """Logits of this rank's vocab columns, gathered over vocab.  The
        weight is made contiguous first (a tied table's transpose is a
        view): the GEMM's summation order then does not depend on the row
        count, so the tiled path is bitwise the serial one."""
        w = w.contiguous()
        if comm is not None and comm.unembed:
            logits = self.timed(shard_matmul_allgather, last, w, comm, dt)
            return logits if bias is None else \
                logits + self.gather(bias.to(dt), -1)
        logits = last @ w
        if bias is not None:
            logits = logits + bias.to(dt)
        return self.gather(logits, -1)


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
         act: Callable, valid: Optional[torch.Tensor] = None,
         tokens: int = 0, shard: Optional[ShardPlan] = None,
         comm: Optional[ServingComm] = None) -> torch.Tensor:
    """MLP or MoE branch of a serving layer.  MoE: the experts over the
    rows of ``h`` whose ``valid`` is set (a step's padding takes no
    expert capacity), at the capacity the JAX serving forward gives its
    ``tokens`` rows at the same call site; then the qwen2-moe shared
    expert.  Under a ``shard`` plan that splits the MLP, the
    down-projection's partial sums are all-reduced, tile-decomposed
    under ``comm``."""
    if cfg.num_experts > 1:
        d = moe_serving(lp["gate"], lp["experts"], h, valid, tokens,
                        top_k=cfg.moe_top_k,
                        capacity_factor=cfg.eval_capacity_factor,
                        min_capacity=cfg.min_capacity, activation=act,
                        gated=cfg.gated_mlp, norm_topk=cfg.moe_norm_topk)
        if "shared" in lp:       # qwen2-moe sigmoid-gated shared expert
            d = d + _shared_expert(lp["shared"], h, act, cfg.gated_mlp)
        return d
    mp = lp["mlp"]
    u = _mm(h, mp["wi"], dt)
    if cfg.mlp_bias:
        u = u + mp["bi"].to(dt)
    u = act(_mm(h, mp["wg"], dt)) * u if cfg.gated_mlp else act(u)
    if shard is not None and shard.mlp_split:
        d = shard.down(u, mp["wo"], dt, comm)
    else:
        d = _mm(u, mp["wo"], dt)
    if cfg.mlp_bias:
        d = d + mp["bo"].to(dt)
    return d


def _stream_layer(stream, li: int, dt: torch.dtype,
                  mixed_gemm: bool = False):
    """Layer ``li``'s weight tree from the weight store (views of a device
    slot): the dense leaves as they are, each quantized payload
    dequantized into ``dt``, or with ``mixed_gemm`` a row-wise int8 or
    packed int4 payload left quantized as the mixed-input GEMM's operand
    (as ``merge_layer`` does with a resident quantized tree)."""
    rec = stream.fetch_layer(li)
    lp = {k: (dict(v) if isinstance(v, dict) else v)
          for k, v in rec["dense"].items()}
    for gname, grp in rec.get("quant", {}).items():
        g = dict(lp.get(gname, {}))
        for name, arrs in grp.items():
            bits, shp, odt, layout = stream.qmeta[gname][name]
            qt = QuantizedTensor(arrs["data"], arrs["scale"],
                                 arrs.get("zero"), bits, shp, odt,
                                 layout=layout)
            if mixed_gemm and gname not in DENSE_ONLY_GROUPS \
                    and is_mixed_gemm_layout(qt):
                g[name] = _row_scaled(qt, contract_dims(gname, name,
                                                        len(shp) + 1))
            else:
                g[name] = dequantize_any(qt, dt)
        lp[gname] = g
    return lp


def _parts(kv):
    return kv if isinstance(kv, tuple) else (kv,)


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


def _embed(params, quant, ids: torch.Tensor, tied: bool,
           shard: Optional[ShardPlan]):
    """:func:`_embed_rows`, or under a vocab-split ``shard`` the rows
    summed over the ranks (the table for a tied unembed is this rank's
    rows)."""
    if shard is not None and shard.embed_split:
        tab = params["embed"]["table"]
        return shard.embed_rows(tab, ids), tab, tab.dtype
    return _embed_rows(params, quant, ids, tied)


def _unembed(cfg: TransformerConfig, params, table, last: torch.Tensor,
             dt, shard: Optional[ShardPlan], comm: Optional[ServingComm]):
    """Logits of the final-normed rows ``last``: tied to the embedding
    table or through the LM head, gathered over vocab under a plan that
    splits it."""
    if cfg.tie_embeddings:
        w, bias, split = table.to(dt).T, None, \
            shard is not None and shard.embed_split
    else:
        w = params["lm_head"]["kernel"].to(dt)
        bias = params["lm_head"]["bias"] if cfg.head_bias else None
        split = shard is not None and shard.unembed_split
    if split:
        return shard.unembed(last, w, bias, dt, comm)
    logits = last @ w
    return logits if bias is None else logits + bias.to(dt)


@torch.no_grad()
def ragged_forward(cfg: TransformerConfig, params, kv,
                   batch: RaggedBatch, block_size: int,
                   max_blocks_per_seq: int, *, quant=None, kv_host=None,
                   stream=None, mixed_gemm: bool = False,
                   shard_mesh: Optional[ShardPlan] = None,
                   comm: Optional[ServingComm] = None):
    """-> (last_token_logits [max_seqs, vocab] f32, kv).

    ``kv``: [L, blocks+1, bs, 2, Hkv, D], or a quantized ``(codes,
    scales [L, blocks+1, bs, 2, Hkv])`` pair, written in place (and
    returned for symmetry with the JAX function).  Rows of the logits
    whose ``batch.logits_idx`` is -1 are garbage (callers mask by it).
    ``quant``: the quantized half of the weights
    (``quantize_model_params``), merged one layer at a time; with
    ``mixed_gemm`` its row-wise weights go through the mixed-input GEMM,
    else each layer is dequantized into the serving dtype.
    ``kv_host``: with ``kv`` in host memory (KV offload), the working
    layer on the device (one layer's ``[blocks+1, bs, 2, Hkv, D]``, or
    its codes and scales): layer ``li`` of the cache is copied into it
    before the layer and back after it, so the device holds one layer's
    KV (the JAX forward takes a flag and moves the layer itself).
    ``stream``: an ``inference.weight_stream.NVMeWeightStore`` holding
    the block weights (``params`` then has no ``blocks``): each layer's
    tree comes from the store (:func:`_stream_layer`) and is released
    after the layer.  On a
    speculative verify batch (``batch.verify_idx`` [S, W]) the logits are
    [S, W, vocab]: every position of each draft window (-1 pads read
    token 0 and give garbage rows).

    Every path is position-absolute: a batch whose tokens start at a
    nonzero context offset (chunked prefill, or a prefill resuming after
    a prefix-cache hit aliased the leading blocks) needs no special
    handling.

    ``shard_mesh``: this rank's :class:`ShardPlan` under a tensor-parallel
    topology (the JAX forward takes the mesh itself, for GSPMD and
    ``shard_map``) (``params``, ``quant`` and ``kv`` then hold the rank's
    slices): K2 runs on the rank's head group, the row-parallel partial
    sums are all-reduced and the logits all-gathered over vocab, so
    every rank returns the same logits.  ``comm``: a
    :class:`~..comm.overlap.ServingComm` plan, under which the MLP
    down-projection's all-reduce and the unembed's gather run
    tile-decomposed (bitwise the serial path)."""
    n = batch.n_tokens
    shard = shard_mesh
    if shard is not None:
        params, quant = shard.top(params), shard.quant_embed(quant)
    x, table, dt = _embed(params, quant, batch.token_ids[:n],
                          cfg.tie_embeddings, shard)
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
        # once per step, from the model's head count (never the local
        # Hkv); a rank's heads take their own slopes
        slopes = L.cached_alibi_slopes(cfg.num_heads, x.device)
        if shard is not None:
            slopes = shard.slopes(slopes)
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
    if stream is None and shard is None:
        layers = unstack_layers(params["blocks"], cfg.num_layers)
    for li in range(cfg.num_layers):
        if shard is not None:
            lp = shard.layer(params["blocks"], li)
        elif stream is None:
            lp = layers[li]
        else:
            lp = _stream_layer(stream, li, dt, mixed_gemm=mixed_gemm)
        if kv_host is None:
            # contiguous: L is the lead dim
            kv_layer = data[li] if scales is None else (data[li], scales[li])
        else:
            for w, h in zip(_parts(kv_host), _parts(kv)):
                w.copy_(h[li], non_blocking=True)
            kv_layer = kv_host
        if quant is not None:
            lp = (merge_layer(lp, quant["blocks"], li, dt, mixed=mixed_gemm)
                  if shard is None else
                  shard.merge_quant(lp, quant["blocks"], li, dt, mixed_gemm))
        ap = lp["attn"]
        h = norm(lp["ln1"], x)
        q, k, v = _qkv_proj(cfg, ap, h, dt, rope)
        if shard is not None:
            q, k, v = shard.heads(q, k, v)
        _write_kv(kv_layer, k, v, slots)
        # K2; under a plan (K2-TP) on this rank's head group
        o = paged_attention(kv_layer, q.contiguous(), seq_slot,
                            positions, batch.block_tables, block_size,
                            max_blocks_per_seq, scale, slopes=slopes)
        if shard is not None:
            o = shard.attn_out(o, ap["wo"], dt)
        else:
            o = _mm(o.reshape(n, -1), ap["wo"], dt, contract_dims=2)
        if cfg.attn_out_bias:
            o = o + ap["bo"].to(dt)
        if not cfg.parallel_block:
            x = x + o
            h = norm(lp["ln2"], x)
        elif cfg.parallel_separate_norms:
            h = norm(lp["ln2"], x)   # gpt-neox: MLP norms the original x
        # parallel residual (falcon/phi): MLP reads the same ln1 output;
        # MoE capacity from the staged batch's full length (the JAX
        # step's token budget), its valid tokens the real rows
        d = _ffn(cfg, lp, h, dt, act, valid=batch.token_valid[:n],
                 tokens=batch.token_ids.shape[0], shard=shard, comm=comm)
        x = x + o + d if cfg.parallel_block else x + d
        if kv_host is not None:
            for w, h in zip(_parts(kv_host), _parts(kv)):
                h[li].copy_(w, non_blocking=True)
        if stream is not None:
            stream.release_layer()

    # logits only at each sequence's last scheduled token, or at every
    # position of a verify batch's draft windows; -1 pads read token 0
    # and give garbage rows
    idx = (batch.logits_idx if batch.verify_idx is None
           else batch.verify_idx)
    last = norm(params["ln_f"], x[idx.clamp(min=0).long()])
    logits = _unembed(cfg, params, table, last, dt, shard, comm)
    return logits.float(), kv


@torch.no_grad()
def pipelined_ragged_step(cfg: TransformerConfig, params, quant, kv,
                          batch: RaggedBatch, prev_toks: torch.Tensor,
                          rng: Optional[torch.Tensor], sample_fn: Callable,
                          block_size: int, max_blocks_per_seq: int,
                          mixed_gemm: bool = False, kv_host=None,
                          stream=None, *, shard_mesh: Optional[ShardPlan] = None,
                          comm: Optional[ServingComm] = None
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
    ``quant``/``mixed_gemm``/``kv_host``/``stream``/``shard_mesh``/``comm`` as
    in :func:`ragged_forward`.
    Returns (sampled tokens [max_seqs] i32, kv); rows whose
    ``batch.logits_idx`` is -1 are garbage.

    On a verify batch (``batch.verify_idx`` [S, W]) every window position
    is sampled and the tokens are [S, W]: column ``j`` is the model's
    choice after window position ``j``, keyed by ``fold_in(fold_in(rng,
    uid), position_j + 1)``, the fold of the stepwise path, so a
    drafting row's columns reproduce the non-speculative stream and the
    host accepts the longest matching draft prefix.  ``prev_toks`` may
    then be the previous verify step's [S, W] output; feedback reads its
    column 0."""
    fb = batch.feedback_src
    if fb is not None:
        prev = prev_toks if prev_toks.dim() == 1 else prev_toks[:, 0]
        tok = torch.where(fb >= 0, prev[fb.clamp(min=0).long()],
                          batch.token_ids)
        batch = batch._replace(token_ids=tok)
    logits, kv = ragged_forward(cfg, params, kv, batch, block_size,
                                max_blocks_per_seq, quant=quant,
                                kv_host=kv_host, stream=stream,
                                mixed_gemm=mixed_gemm, shard_mesh=shard_mesh,
                                comm=comm)
    if batch.verify_idx is not None:
        S, W = batch.verify_idx.shape
        vidx = batch.verify_idx.clamp(min=0).long()
        # window column j holds the token at positions[vidx]; its sample
        # lands at position + 1, the index row_keys folds
        wpos = batch.positions[vidx] + 1                       # [S, W]
        keys = (None if rng is None else
                window_keys(rng, batch.seq_uids, wpos).reshape(S * W, 2))
        flat = sample_fn(logits.reshape(S * W, -1), keys)
        return flat.reshape(S, W), kv
    keys = None if rng is None else row_keys(rng, batch.seq_uids,
                                             batch.context_lens)
    return sample_fn(logits, keys), kv


# --------------------------------------------------------------------------
# decode bursts: several decode iterations with no host step between them
# --------------------------------------------------------------------------

def snapshot_prefix(kv, block_tables: torch.Tensor, P: int,
                    block_size: int):
    """Each slot's first ``P`` context rows gathered through its block
    table into a dense read-only buffer [L, S, P, 2, Hkv, D] (the burst's
    attention operand, gathered once a burst).  A quantized cache
    snapshots as (codes, scales [L, S, P, 2, Hkv]); the burst dequantizes
    per layer.  -1 table pads read the trash row."""
    data, scales = _kv_parts(kv)
    nb = P // block_size
    tables = block_tables[:, :nb].long()                        # [S, nb]
    trash = data.shape[1] - 1
    tables = torch.where(tables < 0, trash, tables)
    raw = (data.view(torch.uint8) if data.element_size() == 1
           and data.dtype != torch.uint8 else data)
    ctx = raw[:, tables]                     # [L, S, nb, bs, 2, Hkv, D]
    nL, S = ctx.shape[0], ctx.shape[1]
    ctx = ctx.reshape(nL, S, P, 2, ctx.shape[-2], ctx.shape[-1])
    if raw is not data:
        ctx = ctx.view(data.dtype)
    if scales is None:
        return ctx
    sctx = scales[:, tables].reshape(nL, S, P, 2, ctx.shape[-2])
    return (ctx, sctx)


def _dequant_rows(codes: torch.Tensor, scales: torch.Tensor,
                  dt: torch.dtype) -> torch.Tensor:
    return (codes.float() * scales[..., None]).to(dt)


@torch.no_grad()
def decode_burst_forward(cfg: TransformerConfig, params, prefix,
                         base_ctx: torch.Tensor, token0: torch.Tensor,
                         steps: int, sample_fn: Callable,
                         rng: Optional[torch.Tensor],
                         uids: Optional[torch.Tensor] = None, *,
                         quant=None, mixed_gemm: bool = False,
                         shard_mesh: Optional[ShardPlan] = None,
                         comm: Optional[ServingComm] = None):
    """``steps`` decode iterations on the device (port of the reference's
    ``decode_burst_forward``).

    prefix: :func:`snapshot_prefix`'s [L, S, P, 2, Hkv, D] (or codes and
    scales); base_ctx: [S] i32 tokens in context per slot; token0: [S]
    i32 the last fed token; uids: [S] the uid bits of each slot (keys
    fold the base ``rng`` by (uid, position) as the stepwise path does,
    so seeded bursts match seeded steps; a greedy ``sample_fn`` takes
    ``rng=None`` and gets no keys).  Returns (tokens [steps, S] i32,
    tail [L, S, steps, 2, Hkv, D]) for :func:`scatter_tail`.

    Attention of each token merges (a) dense attention over the prefix,
    masked by base_ctx, and (b) attention over the in-burst tail, masked
    by iteration, by an online softmax.  ``shard_mesh``/``comm`` as in
    :func:`ragged_forward` (the prefix is then this rank's KV heads)."""
    shard = shard_mesh
    pdata, pscales = _kv_parts(prefix)
    S, P = pdata.shape[1], pdata.shape[2]
    Hkv, D = pdata.shape[4], pdata.shape[5]
    rep = cfg.num_heads // cfg.num_kv_heads
    H = Hkv * rep                       # this rank's query heads
    if shard is not None:
        params, quant = shard.top(params), shard.quant_embed(quant)
    norm = _norm(cfg)
    act = L.ACTIVATIONS[cfg.activation]
    scale = attn_scale(cfg)
    dev = base_ctx.device
    cos = sin = slopes = None
    if cfg.position == "rope":
        cos, sin = L.rope_freqs(cfg.rotary_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=dev)
    elif cfg.position == "alibi":
        slopes = L.cached_alibi_slopes(cfg.num_heads, dev)
        if shard is not None:
            slopes = shard.slopes(slopes)
        slopes = slopes.float().reshape(Hkv, rep)
    if uids is None:
        uids = torch.zeros(S, dtype=torch.int32, device=dev)
    if shard is None:
        layers = unstack_layers(params["blocks"], cfg.num_layers)
    # the prefix in the serving dtype, [L, S, Hkv, P, D] for K and V:
    # dequantized and laid out once a burst (the reference does it per
    # layer and iteration; the values are the same)
    dt0 = (params["embed"]["table"].dtype
           if shard is not None and shard.embed_split else
           _embed_rows(params, quant, token0[:1], cfg.tie_embeddings)[2])
    kpre, vpre = pdata[:, :, :, 0], pdata[:, :, :, 1]
    if pscales is not None:
        kpre = _dequant_rows(kpre, pscales[:, :, :, 0], dt0)
        vpre = _dequant_rows(vpre, pscales[:, :, :, 1], dt0)
    kpre = kpre.to(dt0).permute(0, 1, 3, 2, 4).contiguous()
    vpre = vpre.to(dt0).permute(0, 1, 3, 2, 4).contiguous()
    cols = torch.arange(P, device=dev)[None, :]
    valid = cols < base_ctx[:, None]                           # [S, P]
    live = base_ctx > 0                                        # [S]
    kidx = torch.arange(steps, device=dev)
    tail = None
    toks = []
    tok = token0
    for j in range(steps):
        pos = base_ctx + j                  # this token's position
        x, table, dt = _embed(params, quant, tok, cfg.tie_embeddings, shard)
        x = x.to(dt)
        if tail is None:
            tail = torch.zeros((cfg.num_layers, S, steps, 2, Hkv, D),
                               dtype=dt, device=dev)
        if cfg.embed_norm:              # bloom word_embeddings_layernorm
            x = norm(params["ln_embed"], x)
        if cfg.position == "learned":
            x = x + params["pos_embed"]["table"][pos.long()].to(dt)
        rope = None
        if cos is not None:
            p = pos.long()
            rope = (cos[p][:, None, :], sin[p][:, None, :])
        for li in range(cfg.num_layers):
            lp = layers[li] if shard is None else \
                shard.layer(params["blocks"], li)
            if quant is not None:
                lp = (merge_layer(lp, quant["blocks"], li, dt,
                                  mixed=mixed_gemm) if shard is None else
                      shard.merge_quant(lp, quant["blocks"], li, dt,
                                        mixed_gemm))
            ap = lp["attn"]
            h = norm(lp["ln1"], x)
            q, k, v = _qkv_proj(cfg, ap, h, dt, rope)
            if shard is not None:
                q, k, v = shard.heads(q, k, v)
            tail[li, :, j, 0] = k
            tail[li, :, j, 1] = v
            qg = q.reshape(S, Hkv, rep, D)
            # (a) prefix attention, masked by each slot's context length
            sa = torch.matmul(qg, kpre[li].transpose(-1, -2)).float() \
                * scale                                       # [S,Hkv,rep,P]
            if slopes is not None:  # ALiBi over absolute prefix positions
                sa = sa + slopes[None, :, :, None] * cols[:, None, None,
                                                          :].float()
            sa = torch.where(valid[:, None, None, :], sa, -1e30)
            ma = sa.amax(dim=-1)
            pa = torch.exp(sa - ma[..., None])
            la = pa.sum(dim=-1)
            oa = torch.matmul(pa.to(dt), vpre[li])
            # (b) in-burst tail attention, masked by iteration (<= j)
            kt, vt = tail[li, :, :, 0], tail[li, :, :, 1]
            sb = torch.einsum("shrd,skhd->shrk", qg, kt).float() * scale
            if slopes is not None:  # tail key k sits at base_ctx + k
                kpos = (base_ctx[:, None] + kidx[None, :]).float()
                sb = sb + slopes[None, :, :, None] * kpos[:, None, None, :]
            sb = torch.where((kidx <= j)[None, None, None, :], sb, -1e30)
            mb = sb.amax(dim=-1)
            pb = torch.exp(sb - mb[..., None])
            lb = pb.sum(dim=-1)
            ob = torch.einsum("shrk,skhd->shrd", pb.to(dt), vt)
            # online-softmax merge of the two parts
            m = torch.maximum(ma, mb)
            wa = torch.exp(ma - m)
            wb = torch.exp(mb - m)
            denom = la * wa + lb * wb
            o = (oa.float() * wa[..., None] + ob.float() * wb[..., None]) \
                / torch.clamp(denom, min=1e-30)[..., None]
            o = o.reshape(S, H, D).to(dt)
            if shard is not None:
                o = shard.attn_out(o, ap["wo"], dt)
            else:
                o = _mm(o.reshape(S, -1), ap["wo"], dt, contract_dims=2)
            if cfg.attn_out_bias:
                o = o + ap["bo"].to(dt)
            if not cfg.parallel_block:
                x = x + o
                h = norm(lp["ln2"], x)
            elif cfg.parallel_separate_norms:
                h = norm(lp["ln2"], x)
            # MoE: the JAX burst gates its S slot rows; a slot in the
            # burst has context (base_ctx > 0), an empty one is padding
            d = _ffn(cfg, lp, h, dt, act, valid=live, tokens=S,
                     shard=shard, comm=comm)
            x = x + o + d if cfg.parallel_block else x + d
        x = norm(params["ln_f"], x)
        logits = _unembed(cfg, params, table, x, dt, shard, comm)
        # sampled token j lands at position pos + 1, the stepwise fold
        keys = None if rng is None else row_keys(rng, uids, pos + 1)
        tok = sample_fn(logits.float(), keys)
        toks.append(tok)
    return torch.stack(toks), tail


def scatter_tail(kv, tail: torch.Tensor, block_tables: torch.Tensor,
                 base_ctx: torch.Tensor, block_size: int):
    """Write the burst's tail [L, S, K, 2, Hkv, D] into the paged cache,
    in place: (slot s, iteration j) lands at block ``tables[s, (base +
    j) // bs]``, offset ``(base + j) % bs``; -1 pads go to the trash row.
    A quantized cache quantizes the tail here.  Returns ``kv``."""
    data, scales = _kv_parts(kv)
    nL, K = tail.shape[0], tail.shape[2]
    pos = (base_ctx[:, None].long()
           + torch.arange(K, device=tail.device)[None, :])       # [S, K]
    blk = torch.gather(block_tables.long(), 1, pos // block_size)
    trash = data.shape[1] - 1
    blk = torch.where(blk < 0, trash, blk)
    off = pos % block_size
    li = torch.arange(nL, device=tail.device)[:, None, None]
    if scales is None:
        data[li, blk[None], off[None]] = tail.to(data.dtype)
        return kv
    codes, sc = _quantize_kv(tail, data.dtype)   # sc: [L, S, K, 2, Hkv]
    data.view(torch.uint8)[li, blk[None], off[None]] = \
        codes.view(torch.uint8)
    scales[li, blk[None], off[None]] = sc
    return kv
