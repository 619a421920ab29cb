"""Paged attention: the Hopper kernel, its wrapper and its plain version.

Counterpart of ``deepspeed_tpu/ops/paged_attention.py`` (the Pallas TPU
kernel ``_kernel``).  The kernels are CUDA C++ in
``csrc/paged_attention.cu`` (see the note at its top for the two designs,
the plan and what bounds them), built by ``ops/builder.py`` at first use
and bound through ``ctypes``.

:func:`paged_attention` is the wrapper the serving forward calls: for
tensors on the CPU it runs :func:`paged_attention_plain`; for tensors on
a CUDA device it checks every operand and launches the plan kernel and
the work kernel, or raises.  It never falls back from the kernel to the
plain version.  :func:`plan_plain` is the plan kernel's PyTorch twin
(which tokens go to the chunk design and which to the decode design, and
how a tile splits along its KV blocks); :func:`design_for` names the
design of a run, :func:`shape_error` the widths the kernel refuses.

:func:`paged_attention_plain` ports the JAX package's two XLA
formulations (``deepspeed_tpu/inference/model.py``): the one-shot gather
``_paged_attention`` (:145) and, past ``_ONE_SHOT_GATHER_BYTES`` of
gathered context, the block-at-a-time online softmax
``_paged_attention_chunked`` (:191).

A quantized cache travels as a ``(codes, scales)`` tuple, as in the JAX
package: int8 or fp8 (e4m3) codes ``[blocks+1, bs, 2, Hkv, D]`` with one
fp32 scale per K/V row ``[blocks+1, bs, 2, Hkv]``.  The plain versions
dequantize the gathered rows to q's dtype (``_dequant_ctx``); the kernel
reads the codes and dequantizes each key tile once, for every query row
of the tile.

ALiBi (the TPU kernel's ``alibi`` operand): optional fp32 ``slopes``, any
shape of ``H`` elements reshapeable to ``[Hkv, rep]`` in head order
``h = hkv * rep + r``, add ``slopes[h] * key_position`` to each score
after the ``* scale`` and before the mask, for either cache type.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..profiling import flops_profiler as _flops
from .builder import CUDAOpBuilder

NEG_INF = -1e30

# one-shot gather cap: [T, C, 2, Hkv, D] materializes T*C*2*Hkv*D
# elements; past this many BYTES the chunked online-softmax path runs
_ONE_SHOT_GATHER_BYTES = 512 * 1024 * 1024

# what the kernel takes (csrc/paged_attention.cu): every head dim of the
# presets (one template instance each), any GQA ratio up to MAX_REP (the
# largest held against the plain version on the card), 1 <= bs <= 256
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
MAX_REP = 128
MAX_BLOCK_SIZE = 256

# the two designs of csrc/paged_attention.cu and their tiles' query rows:
# a run of at most DECODE_ROWS (token, head) rows is one decode tile (the
# four warps split its keys), a longer run is cut into CHUNK_ROWS-row chunk
# tiles (a warp a 16-row slice)
DESIGNS = ("chunk", "decode")
CHUNK_ROWS = 64
DECODE_ROWS = 16
# an item: t0, n, row0, b0, b1, split, nsplit, slot (the plan kernel's)
ITEM_INTS = 8
_HEADER_INTS = 8

# code dtype of a quantized cache -> the kernel's code_type
KV_CODE_TYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}

BUILDER = CUDAOpBuilder("paged_attention", ["paged_attention.cu"])

KVLayer = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def design_for(n_tokens: int, rep: int) -> str:
    """The design a run of ``n_tokens`` consecutive tokens of one sequence
    takes at ``rep`` query heads a KV head: "decode" when its rows fit one
    16-row tile, else "chunk"."""
    return "decode" if n_tokens * rep <= DECODE_ROWS else "chunk"


def items_target(Hkv: int, sms: int) -> int:
    """Work items a KV head the plan aims for: two blocks an SM over the
    Hkv heads, rounded down so that they run as one wave (rounded up,
    BLOOM's 32 heads made 9 x 32 = 288 blocks, two waves on 132 SMs, and
    its decode batch ran 1.4x slower under tools/flash_ab.py)."""
    return max(1, 2 * sms // Hkv)


def max_items(T: int, rep: int, target: int) -> int:
    """A bound on the items the plan writes for T tokens: a tile a run
    (at most T runs) plus ceil(T rep / 64) more for chunk runs, and the
    splits' extra items, at most 2 x target (each split tile reads more
    than w* = ceil(W / target) blocks and gets fewer than 2 x its blocks /
    w* items).  The partial slots are bounded by 2 x target too."""
    return T + -(-T * rep // CHUNK_ROWS) + 2 * target


def items_offset(T: int) -> int:
    """Where the items start in the plan workspace (int32): after the
    header and the run_start, item_off and slot_off scratch of T + 1."""
    return _HEADER_INTS + (3 * (T + 1) + 3) // 4 * 4


def _blocks_for(pos: int, bs: int, nb: int) -> int:
    return 0 if pos < 0 else min(pos // bs + 1, nb)


def plan_plain(seq_slot, positions, rep: int, bs: int, nb: int,
               target: int) -> torch.Tensor:
    """The plan kernel's twin (``paged_attention_plan_kernel``): the work
    items, int32 [n_items, ITEM_INTS], of tokens with these slots and
    positions.  Runs: tokens adjacent in the batch with the same slot and
    consecutive positions.  A run of rows = n x rep <= 16 is one decode
    tile, a longer one ceil(rows / 64) chunk tiles.  W sums the runs'
    tiles x the blocks of their deepest token; the tiles of a decode run
    or of a single token are split into ceil(blocks / w*) ranges of
    blocks (w* = ceil(W / target)), evened out; each split tile's items
    take consecutive workspace slots."""
    slots = [int(x) for x in seq_slot]
    pos = [int(x) for x in positions]
    T = len(pos)
    starts = [t for t in range(T) if t == 0 or slots[t] != slots[t - 1]
              or pos[t] != pos[t - 1] + 1] + [T]
    runs = []
    for t0, t1 in zip(starts, starts[1:]):
        n = t1 - t0
        rows = n * rep
        decode = rows <= DECODE_ROWS
        tiles = 1 if decode else -(-rows // CHUNK_ROWS)
        runs.append((t0, n, rows, decode, tiles,
                     _blocks_for(pos[t1 - 1], bs, nb), decode or n == 1))
    W = sum(tiles * nblk for _, _, _, _, tiles, nblk, _ in runs)
    wstar = max(1, -(-W // target))
    items, n_slots = [], 0
    for t0, n, rows, decode, tiles, nblk, splittable in runs:
        nsplit, bps = 1, nblk
        if splittable and nblk > wstar:
            bps = -(-nblk // -(-nblk // wstar))
            nsplit = -(-nblk // bps)
        tr = DECODE_ROWS if decode else CHUNK_ROWS
        for k in range(tiles):
            row0 = k * tr
            for s in range(nsplit):
                if nsplit > 1:
                    b0, b1 = s * bps, min(s * bps + bps, nblk)
                    slot = n_slots + k * nsplit + s
                else:
                    last = min(n - 1, (row0 + min(tr, rows - row0) - 1)
                               // rep)
                    b0, b1 = 0, _blocks_for(pos[t0 + last], bs, nb)
                    slot = -1
                items.append((t0, n, row0, b0, b1, s, nsplit, slot))
        if nsplit > 1:
            n_slots += tiles * nsplit
    return torch.tensor(items, dtype=torch.int32).reshape(-1, ITEM_INTS)


def designs_of(items: torch.Tensor, rep: int) -> dict:
    """Items by design, of a plan from :func:`plan_plain`."""
    out = dict.fromkeys(DESIGNS, 0)
    for n in items[:, 1].tolist():
        out[design_for(n, rep)] += 1
    return out


def _kernel_fn(name: str):
    """A C entry of the library: ``paged_attention_bf16`` (kv, slopes, q,
    seq_slot, positions, block_tables, out, plan, counters, partials
    pointers, 12 ints, the scale, stream), ``paged_attention_quant`` (the
    same with the scales pointer second and the code type before the
    stream) or ``paged_attention_plan`` (seq_slot, positions, plan
    pointers, 6 ints, stream).  A null ``slopes`` pointer means no ALiBi."""
    fn = getattr(BUILDER.load(), name)
    if fn.argtypes is None:
        ptrs = {"paged_attention_bf16": 10, "paged_attention_quant": 11,
                "paged_attention_plan": 3}[name]
        if name == "paged_attention_plan":
            tail = [ctypes.c_int] * 6
        else:
            tail = [ctypes.c_int] * 12 + [ctypes.c_float]
            if name == "paged_attention_quant":
                tail.append(ctypes.c_int)
        fn.argtypes = [ctypes.c_void_p] * ptrs + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (plan, counters, partials): the plan's int32
# workspace, the split counters (zero between calls: the kernel's last
# block of each split tile resets its own) and the fp32 partials.  Launches
# on one stream run in order, so they may share all three; kept across
# calls, as zeroing fresh counters would add a launch to every call
_workspaces: Dict[Tuple[int, int], List[torch.Tensor]] = {}
# (device index, stream) -> what the plan workspace holds the plan of: the
# seq_slot and positions tensors themselves (held, so that no other tensor
# takes their ids) with their version counters, the widths, the workspace
# address.  A call that matches skips the plan kernel: the layers of one
# step share one plan
_planned: Dict[Tuple[int, int], tuple] = {}


def _workspace(device, stream: int, plan_ints: int, counter_ints: int,
               partial_floats: int) -> List[torch.Tensor]:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = [torch.empty(0, dtype=torch.int32, device=device),
              torch.zeros(0, dtype=torch.int32, device=device),
              torch.empty(0, dtype=torch.float32, device=device)]
        _workspaces[key] = ws
    if ws[0].numel() < plan_ints:
        ws[0] = torch.empty(plan_ints, dtype=torch.int32, device=device)
    if ws[1].numel() < counter_ints:
        ws[1] = torch.zeros(counter_ints, dtype=torch.int32, device=device)
    if ws[2].numel() < partial_floats:
        ws[2] = torch.empty(partial_floats, dtype=torch.float32,
                            device=device)
    return ws


def forget_plan(device, stream: int) -> None:
    """Forget what the plan workspace of (device, stream) holds, so that
    the next call there runs the plan kernel.  A CUDA graph's replay
    rewrites the workspace behind the wrapper's back, and a capture must
    record its first call's plan launch."""
    _planned.pop((device.index, stream), None)


def held_workspaces(device, stream: int) -> List[torch.Tensor]:
    """The workspaces of (device, stream) as they stand: a CUDA graph
    that captured them keeps them, so that no later growth frees memory
    its replays write."""
    return list(_workspaces.get((device.index, stream), ()))


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


def shape_error(H: int, Hkv: int, D: int, bs: int) -> Optional[str]:
    """Why the kernel does not take these widths (query heads, KV heads,
    head dim, block size), or None."""
    if D not in HEAD_DIMS:
        return f"head_dim {D} not in {HEAD_DIMS}"
    if Hkv < 1 or H % Hkv or not 1 <= H // Hkv <= MAX_REP:
        return f"H={H}, Hkv={Hkv}: need H % Hkv == 0 and rep <= {MAX_REP}"
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        return f"block_size {bs} not in 1..{MAX_BLOCK_SIZE}"
    return None


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
    tensors launch the plan and the work kernel (bf16 q; a bf16, int8 or
    fp8 cache) and bump ``paged_attention.launches`` (bf16 cache),
    ``.int8_launches`` or ``.fp8_launches``, and ``.alibi_launches`` as
    well when the launch carried slopes: one count a call."""
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
    why = shape_error(H, Hkv, D, bs)
    _check(why is None, why)
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
    rep = H // Hkv
    sms = _sm_count(q.device.index)
    target = items_target(Hkv, sms)
    bound = max_items(T, rep, target)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan, counters, partials = _workspace(
        q.device, stream, items_offset(T) + ITEM_INTS * bound,
        2 * target * Hkv, 2 * target * Hkv * CHUNK_ROWS * (D + 2))
    ws_key = (q.device.index, stream)
    planned = (seq_slot, seq_slot._version, positions, positions._version,
               rep, bs, max_blocks_per_seq, target, plan.data_ptr())
    held = _planned.get(ws_key)
    replan = (held is None or held[0] is not seq_slot
              or held[2] is not positions or held[1] != planned[1]
              or held[3:] != planned[3:])
    ptrs = (None if slopes is None else slopes.data_ptr(), q.data_ptr(),
            seq_slot.data_ptr(), positions.data_ptr(),
            block_tables.data_ptr(), out.data_ptr(), plan.data_ptr(),
            counters.data_ptr(), partials.data_ptr())
    ints = (T, H, Hkv, D, bs, nrows, block_tables.shape[1],
            max_blocks_per_seq, bound, target, sms, int(replan))
    if scales is None:
        err = _kernel_fn("paged_attention_bf16")(
            data.data_ptr(), *ptrs, *ints, float(scale), stream)
    else:
        err = _kernel_fn("paged_attention_quant")(
            data.data_ptr(), scales.data_ptr(), *ptrs, *ints, float(scale),
            KV_CODE_TYPES[data.dtype], stream)
    if err != 0:
        _planned.pop(ws_key, None)
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    _planned[ws_key] = planned
    if scales is None:
        paged_attention.launches += 1
    elif data.dtype == torch.int8:
        paged_attention.int8_launches += 1
    else:
        paged_attention.fp8_launches += 1
    if slopes is not None:
        paged_attention.alibi_launches += 1
    if _flops._ACTIVE:       # 2 products over each token's context
        _flops.note_kernel_flops("paged_attention", 4.0 * H * D * float(
            (positions.long() + 1).sum()))
    return out


paged_attention.launches = 0          # bf16 cache
paged_attention.int8_launches = 0     # int8 codes + scales
paged_attention.fp8_launches = 0      # fp8 e4m3 codes + scales
paged_attention.alibi_launches = 0    # with ALiBi slopes (either cache)


def launch_plan(seq_slot: torch.Tensor, positions: torch.Tensor, rep: int,
                bs: int, nb: int, target: int,
                plan: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the plan kernel alone on the card (CUDA int32 [T] operands)
    into ``plan`` (a fresh int32 workspace when None) and return the
    workspace, not synchronised: for timing the plan and for
    :func:`plan_device`."""
    T = seq_slot.shape[0]
    bound = max_items(T, rep, target)
    if plan is None:
        plan = torch.full((items_offset(T) + ITEM_INTS * bound,), -7,
                          dtype=torch.int32, device=seq_slot.device)
    stream = torch.cuda.current_stream(seq_slot.device).cuda_stream
    err = _kernel_fn("paged_attention_plan")(
        seq_slot.data_ptr(), positions.data_ptr(), plan.data_ptr(), T, rep,
        bs, nb, bound, target, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention plan launch failed: "
                           f"cudaError {err}")
    return plan


def plan_device(seq_slot: torch.Tensor, positions: torch.Tensor, rep: int,
                bs: int, nb: int, target: int) -> torch.Tensor:
    """The plan kernel's items, int32 [n_items, ITEM_INTS] on the host,
    for holding the device plan against :func:`plan_plain`; it
    synchronises."""
    T = seq_slot.shape[0]
    host = launch_plan(seq_slot, positions, rep, bs, nb, target).cpu()
    if int(host[3]) != 0:
        raise RuntimeError("paged_attention plan: more items than the bound")
    n = int(host[0])
    start = items_offset(T)
    return host[start:start + ITEM_INTS * n].reshape(n, ITEM_INTS)


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
