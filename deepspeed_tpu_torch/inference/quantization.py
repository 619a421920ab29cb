"""Weight-quantized serving: split a parameter tree into dense and
quantized halves, and reassemble one layer at a time.

Counterpart of ``deepspeed_tpu/inference/quantization.py``: the block
projection weights (``wq wk wv wo wi wg``) of the stacked ``blocks`` tree
become stacked :class:`~..ops.quant.QuantizedTensor`s (int8: the row-wise
weight-shaped layout; int4: packed row-wise nibbles, or grouped when the
contraction is odd; fp6/fp12: the packed row-wise minifloat layouts
when the trailing dim divides into 24-bit words, else the emulated
grouped minifloat codes), optionally the embedding table too; norms and
biases stay dense.  The serving forward merges one layer's weights at a time
(:func:`merge_layer`; under a topology :func:`merge_layer_qts`, on the
layer a rank gathered from its memory shards): left quantized for the
mixed-input GEMM, or dequantized into the serving dtype.  The mixed-input GEMM's per-layer
operands (payload views, scales one per contraction row) are built once
per stacked weight (:func:`mixed_operand`), not at every step.

Each stacked weight is quantized one layer slice at a time into
preallocated payload tensors (the JAX package quantizes the stacked leaf
at once); the codes and scales are the same, but the fp32 temporaries of
a Llama-3-8B ``[32, 4096, 14336]`` leaf (7.5 GB) never exist.  The
minifloat layouts take no kernel (nor do they in the reference): the
forward dequantizes them layer by layer with plain torch ops.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops.mixed_gemm import flat_kn
from ..ops.quant import (MINIFLOAT_BY_BITS, QuantizedTensor,
                         _quantize_leading, _quantize_rowwise_minifloat,
                         default_groups, dequantize_any,
                         is_mixed_gemm_layout, minifloat_layout,
                         minifloat_quantize, quantize, quantize_rowwise,
                         quantize_rowwise4)

# weights eligible for quantization inside a block (2D+ matmul operands)
_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "wi", "wg")

# block groups whose weights the serving forward consumes dense (MoE
# experts and the shared expert); they never reach the mixed-input GEMM
DENSE_ONLY_GROUPS = ("experts", "shared")


def contract_dims(group_name: str, name: str, ndim: int) -> int:
    """How many leading dims of a stacked ``[L, ...]`` block weight its
    projection contracts: 2 for the attention output ``[L, H, Dh, d]``
    (the int4 packing must flatten the split the serving GEMM uses), else
    1."""
    return 2 if group_name == "attn" and name == "wo" and ndim >= 4 else 1


def _quantize_stacked(w: torch.Tensor, bits: int,
                      contract_dims: int = 1) -> QuantizedTensor:
    """Quantize a [L, ...] stacked weight layer by layer into stacked
    payloads: bits 8 = row-wise weight-shaped int8 (scales per (layer,
    row)); 4 = packed row-wise nibbles (grouped when the contraction is
    odd); 6 / 12 = packed row-wise fp6 / fp12 when the trailing dim
    divides by 4 / 2, else the emulated grouped minifloat codes."""
    L = w.shape[0]
    if bits == 8:
        data = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((L, w.shape[1]) + (1,) * (w.dim() - 2),
                            dtype=torch.float32, device=w.device)
        for i in range(L):
            qt = _quantize_leading(w[i], lead_dims=1)
            data[i], scale[i] = qt.data, qt.scale
        return QuantizedTensor(data, scale, None, 8, tuple(w.shape), w.dtype,
                               layout="rowwise")
    K = 1
    for d in w.shape[1:1 + contract_dims]:
        K *= d
    if bits == 4 and K % 2 == 0:
        data = torch.empty((L, K // 2, w[0].numel() // K), dtype=torch.int8,
                           device=w.device)
        scale = torch.empty((L, w.shape[1], 1), dtype=torch.float32,
                            device=w.device)
        for i in range(L):
            qt = quantize_rowwise4(w[i], contract_dims=contract_dims)
            data[i], scale[i] = qt.data, qt.scale
        return QuantizedTensor(data, scale, None, 4, tuple(w.shape), w.dtype,
                               layout="rowwise4")
    layout = minifloat_layout(bits, w.shape)
    if layout is not None:
        data = torch.empty(w.shape[:-1] + (w.shape[-1] * bits // 8,),
                           dtype=torch.uint8, device=w.device)
        scale = torch.empty((L, w.shape[1], 1), dtype=torch.float32,
                            device=w.device)
        for i in range(L):
            qt = _quantize_rowwise_minifloat(w[i], layout)
            data[i], scale[i] = qt.data, qt.scale
        return QuantizedTensor(data, scale, None, bits, tuple(w.shape),
                               w.dtype, layout=layout)
    # an odd contraction cannot pack strided halves, an indivisible
    # trailing dim no minifloat words: the grouped layouts
    groups = default_groups(w[0].numel())
    if bits in MINIFLOAT_BY_BITS:
        qts = [minifloat_quantize(w[i], fmt=MINIFLOAT_BY_BITS[bits],
                                  num_groups=groups) for i in range(L)]
    else:
        qts = [quantize(w[i], bits=bits, num_groups=groups)
               for i in range(L)]
    return QuantizedTensor(
        data=torch.stack([q.data for q in qts]),
        scale=torch.stack([q.scale for q in qts]),
        zero=None if qts[0].zero is None
        else torch.stack([q.zero for q in qts]),
        bits=bits, shape=(L,) + qts[0].shape, dtype=qts[0].dtype)


def layer_qt(qt: QuantizedTensor, i: int) -> QuantizedTensor:
    """Layer ``i``'s slice of a stacked QuantizedTensor (views), still
    quantized: what the mixed-input GEMM consumes."""
    return QuantizedTensor(qt.data[i], qt.scale[i],
                           None if qt.zero is None else qt.zero[i],
                           qt.bits, qt.shape[1:], qt.dtype, layout=qt.layout)


def mixed_operand(qt: QuantizedTensor, i: int, cdims: int
                  ) -> QuantizedTensor:
    """Layer ``i`` of a stacked row-wise weight as the mixed-input GEMM
    consumes it: :func:`layer_qt`'s views, with scales coarser than one
    per contraction row (per head for the attention ``wo``) expanded to
    rows in a broadcastable shape.  All layers' operands are built on
    first use and kept on ``qt.operands``, so a serving step neither
    rebuilds the views nor expands scales (an in-place update of
    ``qt.scale`` must reset ``qt.operands``)."""
    if qt.operands is None:
        qt.operands = tuple(_row_scaled(layer_qt(qt, j), cdims)
                            for j in range(qt.shape[0]))
    return qt.operands[i]


def _row_scaled(qt: QuantizedTensor, cdims: int) -> QuantizedTensor:
    rows, _ = flat_kn(qt.shape, cdims)
    n = qt.scale.numel()
    if n == rows:
        return qt
    s = qt.scale.reshape(n, 1).expand(n, rows // n)
    # int8: one scale per weight row before the trailing dims; int4: the
    # packed layout's [K, 1]
    shape = ((rows, 1) if qt.layout == "rowwise4"
             else qt.shape[:cdims] + (1,) * (len(qt.shape) - cdims))
    return QuantizedTensor(qt.data, s.reshape(shape), None, qt.bits,
                           qt.shape, qt.dtype, layout=qt.layout)


def layer_weight(qt: QuantizedTensor, i: int, dt: torch.dtype
                 ) -> torch.Tensor:
    """Dequantize layer ``i`` of a stacked QuantizedTensor into ``dt``."""
    return dequantize_any(layer_qt(qt, i), dt)


def quantize_model_params(params: Dict[str, Any], bits: int = 8,
                          quantize_embeddings: bool = False
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split ``params`` into (dense_tree, quant_tree).  ``dense_tree``
    mirrors ``params`` (new dicts, the same tensors) minus the quantized
    leaves; ``quant_tree`` holds the stacked QuantizedTensors under the
    same paths (``blocks`` weights, and ``embed.table`` with
    ``quantize_embeddings``).  The pair feeds
    ``ragged_forward(..., quant=quant_tree)``."""
    def copy(tree):
        return ({k: copy(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree)

    dense = copy(params)
    quant: Dict[str, Any] = {"blocks": {}}
    for group_name, group in dense["blocks"].items():
        if not isinstance(group, dict):
            continue
        qgroup = {}
        for name in list(group):
            w = group[name]
            if name in _BLOCK_WEIGHTS and w.dim() >= 3:   # [L, ...] weight
                qgroup[name] = _quantize_stacked(
                    w, bits, contract_dims(group_name, name, w.dim()))
                del group[name]
        if qgroup:
            quant["blocks"][group_name] = qgroup
    if quantize_embeddings:
        tab = dense["embed"]["table"]
        if bits in MINIFLOAT_BY_BITS:
            quant["embed"] = {"table": minifloat_quantize(
                tab, fmt=MINIFLOAT_BY_BITS[bits])}
        else:
            quant["embed"] = {"table": quantize_rowwise(tab) if bits == 8
                              else quantize(tab, bits=bits)}
        del dense["embed"]["table"]
    return dense, quant


def merge_layer(lp: Dict[str, Any], quant_blocks: Dict[str, Any], i: int,
                dt: torch.dtype, mixed: bool = False) -> Dict[str, Any]:
    """One layer's full param dict: its dense slice plus its quantized
    weights, dequantized into ``dt`` here or (``mixed=True``) left as
    row-wise operands of the mixed-input GEMM (:func:`mixed_operand`)."""
    out = dict(lp)
    for group_name, qgroup in quant_blocks.items():
        g = dict(out.get(group_name, {}))
        for name, qt in qgroup.items():
            if mixed and group_name not in DENSE_ONLY_GROUPS \
                    and is_mixed_gemm_layout(qt):
                g[name] = mixed_operand(
                    qt, i, contract_dims(group_name, name, len(qt.shape)))
            else:
                g[name] = layer_weight(qt, i, dt)
        out[group_name] = g
    return out


def merge_layer_qts(lp: Dict[str, Any], qlayer: Dict[str, Any],
                    dt: torch.dtype, mixed: bool = False) -> Dict[str, Any]:
    """:func:`merge_layer` for one layer's unstacked QuantizedTensors
    ``{group: {name: qt}}``: what a tensor-parallel engine's rank has
    after it gathers the layer of its memory-sharded quantized tree (the
    JAX engine's ``generic`` placement, which XLA gathers at use).  Each
    is left row-wise for the mixed-input GEMM or dequantized into
    ``dt``, as the one-device merge does."""
    out = dict(lp)
    for group_name, qgroup in qlayer.items():
        g = dict(out.get(group_name, {}))
        for name, qt in qgroup.items():
            if mixed and group_name not in DENSE_ONLY_GROUPS \
                    and is_mixed_gemm_layout(qt):
                g[name] = _row_scaled(qt, contract_dims(
                    group_name, name, len(qt.shape) + 1))
            else:
                g[name] = dequantize_any(qt, dt)
        out[group_name] = g
    return out
