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
"""

from __future__ import annotations

import ctypes

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

BUILDER = CUDAOpBuilder("paged_attention", ["paged_attention.cu"])


def _kernel_fn():
    lib = BUILDER.load()
    fn = lib.paged_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention(kv_layer: torch.Tensor, q: torch.Tensor,
                    seq_slot: torch.Tensor, positions: torch.Tensor,
                    block_tables: torch.Tensor, block_size: int,
                    max_blocks_per_seq: int, scale: float) -> torch.Tensor:
    """kv_layer: [blocks+1, bs, 2, Hkv, D] (last row = trash); q: [T, H, D];
    seq_slot/positions: [T] i32; block_tables: [max_seqs, >= nb] i32
    (-1 pad) -> out [T, H, D].  CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 only) and bump
    ``paged_attention.launches``."""
    if q.device.type == "cpu":
        return paged_attention_plain(kv_layer, q, seq_slot, positions,
                                     block_tables, block_size,
                                     max_blocks_per_seq, scale)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    for name, x in (("kv_layer", kv_layer), ("seq_slot", seq_slot),
                    ("positions", positions), ("block_tables", block_tables)):
        _check(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        _check(x.is_contiguous(), f"{name} is not contiguous")
    _check(q.is_contiguous(), "q is not contiguous")
    _check(q.dtype == torch.bfloat16 and kv_layer.dtype == torch.bfloat16,
           f"needs bf16 q and kv, got {q.dtype} and {kv_layer.dtype}")
    _check(q.dim() == 3 and kv_layer.dim() == 5,
           f"q {tuple(q.shape)} / kv {tuple(kv_layer.shape)}")
    T, H, D = q.shape
    nrows, bs, two, Hkv, Dk = kv_layer.shape
    _check(two == 2 and Dk == D and bs == block_size,
           f"kv {tuple(kv_layer.shape)} vs q {tuple(q.shape)}, "
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
    _check(kv_layer.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
           "kv/q must be 16-byte aligned")
    out = torch.empty_like(q)
    if T == 0:
        return out
    err = _kernel_fn()(
        kv_layer.data_ptr(), q.data_ptr(), seq_slot.data_ptr(),
        positions.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        T, H, Hkv, D, bs, nrows, block_tables.shape[1],
        max_blocks_per_seq, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_plain(kv_layer: torch.Tensor, q: torch.Tensor,
                          seq_slot: torch.Tensor, positions: torch.Tensor,
                          block_tables: torch.Tensor, block_size: int,
                          max_blocks_per_seq: int,
                          scale: float) -> torch.Tensor:
    """Per-token attention over the owning sequence's context by gather
    (port of ``_paged_attention``); switches to the block-at-a-time form
    when the one-shot gather would exceed ``_ONE_SHOT_GATHER_BYTES``."""
    T, H, D = q.shape
    nrows, _, _, Hkv, _ = kv_layer.shape
    C = max_blocks_per_seq * block_size
    if T * C * 2 * Hkv * D * kv_layer.element_size() > _ONE_SHOT_GATHER_BYTES:
        return paged_attention_chunked(kv_layer, q, seq_slot, positions,
                                       block_tables, block_size,
                                       max_blocks_per_seq, scale)
    rep = H // Hkv
    tables = _tables(block_tables, seq_slot, max_blocks_per_seq, nrows)
    ctx = kv_layer[tables].reshape(T, C, 2, Hkv, D)   # [T, nb, bs, ...]
    k_ctx, v_ctx = ctx[:, :, 0], ctx[:, :, 1]           # [T, C, Hkv, D]
    qg = q.reshape(T, Hkv, rep, D)
    s = torch.einsum("thrd,tchd->thrc", qg, k_ctx).float() * scale
    cols = torch.arange(C, device=q.device)[None, :]
    valid = cols <= positions[:, None]                  # [T, C]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("thrc,tchd->thrd", p, v_ctx)
    return o.reshape(T, H, D)


def paged_attention_chunked(kv_layer: torch.Tensor, q: torch.Tensor,
                            seq_slot: torch.Tensor, positions: torch.Tensor,
                            block_tables: torch.Tensor, block_size: int,
                            max_blocks_per_seq: int,
                            scale: float) -> torch.Tensor:
    """Port of ``_paged_attention_chunked``: one context block per step
    ([T, bs, 2, Hkv, D] gathered) folded into an online softmax — the
    one-shot numerics with memory proportional to T * block_size."""
    T, H, D = q.shape
    nrows, bs, _, Hkv, _ = kv_layer.shape
    rep = H // Hkv
    tables = _tables(block_tables, seq_slot, max_blocks_per_seq, nrows)
    qg = q.reshape(T, Hkv, rep, D)
    offs = torch.arange(bs, device=q.device)
    m = torch.full((T, Hkv, rep), float("-inf"), device=q.device)
    l = torch.zeros((T, Hkv, rep), device=q.device)
    acc = torch.zeros((T, Hkv, rep, D), device=q.device)
    for j in range(max_blocks_per_seq):
        ctx = kv_layer[tables[:, j]]                    # [T, bs, 2, Hkv, D]
        k, v = ctx[:, :, 0], ctx[:, :, 1]
        s = torch.einsum("thrd,tbhd->thrb", qg, k).float() * scale
        cols = j * bs + offs[None, :]
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


def _tables(block_tables, seq_slot, nb: int, nrows: int) -> torch.Tensor:
    """Each token's block-table row, -1 pads mapped to the trash row."""
    tables = block_tables[seq_slot.long(), :nb].long()  # [T, nb]
    return torch.where(tables < 0, nrows - 1, tables)
