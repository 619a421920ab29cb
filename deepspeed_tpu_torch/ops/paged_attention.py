"""Paged attention: the Hopper kernel, its wrapper and its plain version.

Counterpart of ``deepspeed_tpu/ops/paged_attention.py`` (the Pallas TPU
kernel ``_kernel``).  The kernel is CUDA C++ in ``csrc/paged_attention.cu``
(see the note at its top for its design and what bounds it), built by
``ops/builder.py`` at first use and bound through ``ctypes``.

:func:`paged_attention` is the wrapper the serving forward calls: for
tensors on the CPU it runs :func:`paged_attention_plain`; for tensors on
a CUDA device it checks every operand and launches the kernel, or raises.
It never falls back from the kernel to the plain version.

:func:`paged_attention_plain` ports the JAX package's two XLA
formulations (``deepspeed_tpu/inference/model.py``): the one-shot gather
``_paged_attention`` (:145) and, past ``_ONE_SHOT_GATHER_BYTES`` of
gathered context, the block-at-a-time online softmax
``_paged_attention_chunked`` (:191).

A quantized cache travels as a ``(codes, scales)`` tuple, as in the JAX
package: int8 or fp8 (e4m3) codes ``[blocks+1, bs, 2, Hkv, D]`` with one
fp32 scale per K/V row ``[blocks+1, bs, 2, Hkv]``.  The plain versions
dequantize the gathered rows to q's dtype (``_dequant_ctx``); the kernel
reads the codes and dequantizes each row it reads.

ALiBi (the TPU kernel's ``alibi`` operand): optional fp32 ``slopes``, any
shape of ``H`` elements reshapeable to ``[Hkv, rep]`` in head order
``h = hkv * rep + r``, add ``slopes[h] * key_position`` to each score
after the ``* scale`` and before the mask, for either cache type.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from .builder import CUDAOpBuilder

NEG_INF = -1e30

# one-shot gather cap: [T, C, 2, Hkv, D] materializes T*C*2*Hkv*D
# elements; past this many BYTES the chunked online-softmax path runs
_ONE_SHOT_GATHER_BYTES = 512 * 1024 * 1024

# what the kernel takes (csrc/paged_attention.cu)
HEAD_DIMS = (64, 128)
MAX_REP = 8
MAX_BLOCK_SIZE = 256

# code dtype of a quantized cache -> the kernel's code_type
KV_CODE_TYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}

BUILDER = CUDAOpBuilder("paged_attention", ["paged_attention.cu"])

KVLayer = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _kernel_fn(quant: bool):
    """The C entry point: (kv, [scales,] slopes, q, seq_slot, positions,
    block_tables, out) pointers, 8 ints, the scale, [code_type,] stream;
    a null ``slopes`` pointer means no ALiBi."""
    lib = BUILDER.load()
    if quant:
        fn = lib.paged_attention_quant
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        return fn
    fn = lib.paged_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kv_parts(kv_layer: KVLayer):
    """(data, scales-or-None) of a paged cache operand."""
    if isinstance(kv_layer, tuple):
        return kv_layer[0], kv_layer[1]
    return kv_layer, None


def _gather(data: torch.Tensor, idx) -> torch.Tensor:
    """``data[idx]``; one-byte codes gather through a uint8 view (indexing
    kernels do not cover every fp8 type on every device)."""
    if data.element_size() == 1 and data.dtype != torch.uint8:
        return data.view(torch.uint8)[idx].view(data.dtype)
    return data[idx]


def _dequant_ctx(data: torch.Tensor, scales: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
    """data: [..., D] codes, scales: [...] -> [..., D] in ``dt``."""
    return (data.float() * scales[..., None]).to(dt)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention(kv_layer: KVLayer, q: torch.Tensor,
                    seq_slot: torch.Tensor, positions: torch.Tensor,
                    block_tables: torch.Tensor, block_size: int,
                    max_blocks_per_seq: int, scale: float,
                    slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """kv_layer: [blocks+1, bs, 2, Hkv, D] (last row = trash), or a
    quantized ``(codes, scales [blocks+1, bs, 2, Hkv])`` pair; q: [T, H, D];
    seq_slot/positions: [T] i32; block_tables: [max_seqs, >= nb] i32
    (-1 pad); ``slopes``: optional ALiBi slopes, H fp32 values in head
    order -> out [T, H, D].  CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 q; a bf16, int8 or fp8 cache) and bump
    ``paged_attention.launches`` (bf16 cache), ``.int8_launches`` or
    ``.fp8_launches``, and ``.alibi_launches`` as well when the launch
    carried slopes."""
    if q.device.type == "cpu":
        return paged_attention_plain(kv_layer, q, seq_slot, positions,
                                     block_tables, block_size,
                                     max_blocks_per_seq, scale, slopes)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    data, scales = _kv_parts(kv_layer)
    operands = [("kv", data), ("seq_slot", seq_slot),
                ("positions", positions), ("block_tables", block_tables)]
    if scales is not None:
        operands.append(("kv scales", scales))
    if slopes is not None:
        operands.append(("slopes", slopes))
    for name, x in operands:
        _check(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        _check(x.is_contiguous(), f"{name} is not contiguous")
    _check(q.is_contiguous(), "q is not contiguous")
    if scales is None:
        _check(q.dtype == torch.bfloat16 and data.dtype == torch.bfloat16,
               f"needs bf16 q and kv, got {q.dtype} and {data.dtype}")
    else:
        _check(q.dtype == torch.bfloat16, f"needs bf16 q, got {q.dtype}")
        _check(data.dtype in KV_CODE_TYPES,
               f"quantized kv codes must be int8 or float8_e4m3fn, got "
               f"{data.dtype}")
        _check(scales.dtype == torch.float32
               and tuple(scales.shape) == tuple(data.shape[:-1]),
               f"kv scales {scales.dtype} {tuple(scales.shape)} vs codes "
               f"{tuple(data.shape)}")
    _check(q.dim() == 3 and data.dim() == 5,
           f"q {tuple(q.shape)} / kv {tuple(data.shape)}")
    T, H, D = q.shape
    nrows, bs, two, Hkv, Dk = data.shape
    _check(two == 2 and Dk == D and bs == block_size,
           f"kv {tuple(data.shape)} vs q {tuple(q.shape)}, "
           f"block_size {block_size}")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(H % Hkv == 0 and 1 <= H // Hkv <= MAX_REP,
           f"H={H}, Hkv={Hkv}: need H % Hkv == 0 and rep <= {MAX_REP}")
    _check(1 <= bs <= MAX_BLOCK_SIZE, f"block_size {bs} > {MAX_BLOCK_SIZE}")
    for name, x in (("seq_slot", seq_slot), ("positions", positions),
                    ("block_tables", block_tables)):
        _check(x.dtype == torch.int32, f"{name} must be int32, got {x.dtype}")
    _check(seq_slot.shape == (T,) and positions.shape == (T,),
           "seq_slot/positions must be [T]")
    _check(block_tables.dim() == 2
           and 1 <= max_blocks_per_seq <= block_tables.shape[1],
           f"block_tables {tuple(block_tables.shape)} vs "
           f"max_blocks_per_seq {max_blocks_per_seq}")
    _check(data.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
           "kv/q must be 16-byte aligned")
    if slopes is not None:
        _check(slopes.dtype == torch.float32 and slopes.numel() == H,
               f"slopes must be {H} fp32 values (Hkv * rep), got "
               f"{slopes.dtype} {tuple(slopes.shape)}")
    out = torch.empty_like(q)
    if T == 0:
        return out
    ints = (T, H, Hkv, D, bs, nrows, block_tables.shape[1],
            max_blocks_per_seq)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (None if slopes is None else slopes.data_ptr(), q.data_ptr(),
            seq_slot.data_ptr(), positions.data_ptr(),
            block_tables.data_ptr(), out.data_ptr())
    if scales is None:
        err = _kernel_fn(False)(data.data_ptr(), *ptrs, *ints, float(scale),
                                stream)
    else:
        err = _kernel_fn(True)(data.data_ptr(), scales.data_ptr(), *ptrs,
                               *ints, float(scale),
                               KV_CODE_TYPES[data.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    if scales is None:
        paged_attention.launches += 1
    elif data.dtype == torch.int8:
        paged_attention.int8_launches += 1
    else:
        paged_attention.fp8_launches += 1
    if slopes is not None:
        paged_attention.alibi_launches += 1
    return out


paged_attention.launches = 0          # bf16 cache
paged_attention.int8_launches = 0     # int8 codes + scales
paged_attention.fp8_launches = 0      # fp8 e4m3 codes + scales
paged_attention.alibi_launches = 0    # with ALiBi slopes (either cache)


def paged_attention_plain(kv_layer: KVLayer, q: torch.Tensor,
                          seq_slot: torch.Tensor, positions: torch.Tensor,
                          block_tables: torch.Tensor, block_size: int,
                          max_blocks_per_seq: int, scale: float,
                          slopes: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-token attention over the owning sequence's context by gather
    (port of ``_paged_attention``); switches to the block-at-a-time form
    when the one-shot gather would exceed ``_ONE_SHOT_GATHER_BYTES``."""
    T, H, D = q.shape
    data, scales = _kv_parts(kv_layer)
    nrows, _, _, Hkv, _ = data.shape
    C = max_blocks_per_seq * block_size
    if T * C * 2 * Hkv * D * data.element_size() > _ONE_SHOT_GATHER_BYTES:
        return paged_attention_chunked(kv_layer, q, seq_slot, positions,
                                       block_tables, block_size,
                                       max_blocks_per_seq, scale, slopes)
    rep = H // Hkv
    tables = _tables(block_tables, seq_slot, max_blocks_per_seq, nrows)
    ctx = _gather(data, tables).reshape(T, C, 2, Hkv, D)   # [T, nb, bs, ...]
    k_ctx, v_ctx = ctx[:, :, 0], ctx[:, :, 1]           # [T, C, Hkv, D]
    if scales is not None:
        sctx = scales[tables].reshape(T, C, 2, Hkv)
        k_ctx = _dequant_ctx(k_ctx, sctx[:, :, 0], q.dtype)
        v_ctx = _dequant_ctx(v_ctx, sctx[:, :, 1], q.dtype)
    qg = q.reshape(T, Hkv, rep, D)
    s = torch.einsum("thrd,tchd->thrc", qg, k_ctx).float() * scale
    cols = torch.arange(C, device=q.device)[None, :]
    if slopes is not None:      # ALiBi: slope_h * absolute key position
        s = s + _alibi(slopes, Hkv, rep, cols)
    valid = cols <= positions[:, None]                  # [T, C]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("thrc,tchd->thrd", p, v_ctx)
    return o.reshape(T, H, D)


def paged_attention_chunked(kv_layer: KVLayer, q: torch.Tensor,
                            seq_slot: torch.Tensor, positions: torch.Tensor,
                            block_tables: torch.Tensor, block_size: int,
                            max_blocks_per_seq: int, scale: float,
                            slopes: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Port of ``_paged_attention_chunked``: one context block per step
    ([T, bs, 2, Hkv, D] gathered) folded into an online softmax — the
    one-shot numerics with memory proportional to T * block_size."""
    T, H, D = q.shape
    data, scales = _kv_parts(kv_layer)
    nrows, bs, _, Hkv, _ = data.shape
    rep = H // Hkv
    tables = _tables(block_tables, seq_slot, max_blocks_per_seq, nrows)
    qg = q.reshape(T, Hkv, rep, D)
    offs = torch.arange(bs, device=q.device)
    m = torch.full((T, Hkv, rep), float("-inf"), device=q.device)
    l = torch.zeros((T, Hkv, rep), device=q.device)
    acc = torch.zeros((T, Hkv, rep, D), device=q.device)
    for j in range(max_blocks_per_seq):
        ctx = _gather(data, tables[:, j])               # [T, bs, 2, Hkv, D]
        k, v = ctx[:, :, 0], ctx[:, :, 1]
        if scales is not None:
            sc = scales[tables[:, j]]                   # [T, bs, 2, Hkv]
            k = _dequant_ctx(k, sc[:, :, 0], q.dtype)
            v = _dequant_ctx(v, sc[:, :, 1], q.dtype)
        s = torch.einsum("thrd,tbhd->thrb", qg, k).float() * scale
        cols = j * bs + offs[None, :]
        if slopes is not None:
            s = s + _alibi(slopes, Hkv, rep, cols)
        valid = cols <= positions[:, None]              # [T, bs]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        w = torch.exp(m - m_new)
        l = l * w + p.sum(dim=-1)
        pv = torch.einsum("thrb,tbhd->thrd", p.to(q.dtype), v)
        acc = acc * w[..., None] + pv.float()
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(T, H, D).to(q.dtype)


def _alibi(slopes: torch.Tensor, Hkv: int, rep: int,
           cols: torch.Tensor) -> torch.Tensor:
    """ALiBi bias [1, Hkv, rep, C] of key positions ``cols`` [1, C]."""
    return (slopes.float().reshape(Hkv, rep)[None, :, :, None]
            * cols[:, None, None, :].float())


def _tables(block_tables, seq_slot, nb: int, nrows: int) -> torch.Tensor:
    """Each token's block-table row, -1 pads mapped to the trash row."""
    tables = block_tables[seq_slot.long(), :nb].long()  # [T, nb]
    return torch.where(tables < 0, nrows - 1, tables)
