"""Mixed-input GEMM: bf16 activations x int8 / packed-int4 weights.

Counterpart of ``deepspeed_tpu/ops/mixed_gemm.py`` (the Pallas TPU kernels
``_mixed_kernel`` and ``_mixed4_kernel``).  The kernels are CUDA C++ in
``csrc/mixed_gemm.cu`` (see the note at its top for the two designs and
what bounds them), built by ``ops/builder.py`` at first use and bound
through ``ctypes``.

:func:`mixed_matmul_2d` (int8) and :func:`mixed4_matmul_2d` (int4) are
the wrappers: for tensors on the CPU they run their plain versions
(:func:`mixed_matmul_2d_plain`, :func:`mixed4_matmul_2d_plain`), which
round x and each dequantized weight to bf16 where the TPU kernels do and
accumulate in fp32; for tensors on a CUDA device they check every
operand and launch the kernel of the design :func:`design_for` picks from
M, or raise.  :func:`mixed_matmul` is the serving entry point
(``inference/model._mm``): it flattens the contraction, expands
coarser-than-row scales and routes a row-wise
:class:`~.quant.QuantizedTensor` to the right wrapper.
:func:`shape_error` says which ``[K, N]`` the family takes, on every
device alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..profiling import flops_profiler as _flops
from .builder import CUDAOpBuilder
from .quant import (QuantizedTensor, dequantize, is_mixed_gemm_layout,
                    is_rowwise_int4, unpack_nibbles)

BUILDER = CUDAOpBuilder("mixed_gemm", ["mixed_gemm.cu"],
                        ["sm90.cuh", "sm90_wgmma.cuh"])

# the reference's K/N block (deepspeed_tpu/ops/mixed_gemm.py:97-98):
# a K-extent or N past it must be a multiple of it
BLOCK_K = BLOCK_N = 512
# what the kernels take (csrc/mixed_gemm.cu): K in 32-row code tiles (64
# for int4, a tile per half), N in 16-column fragments
K_CHUNK = 32
N_MULTIPLE = 16

# the two designs of csrc/mixed_gemm.cu, by the C entry's `design` number
DESIGNS = {"decode": 0, "prefill": 1}
# M up to which the split-K decode design runs (its m16n8k16 products
# hold M in up to 4 tiles of 8); above it the wgmma prefill design
DECODE_MAX_M = 32
# the decode design's output columns a block and code rows a stage
DECODE_STRIP = 128
DECODE_ROWS = 32
# the prefill design's output columns a tile, and its tile heights
PREFILL_COLS = 128
PREFILL_ROWS = (128, 256)


def design_for(M: int) -> str:
    """The kernel design for M rows of x: "decode" (split-K weight
    streaming on mma.sync) up to DECODE_MAX_M, "prefill" (wgmma) above."""
    return "decode" if M <= DECODE_MAX_M else "prefill"


def decode_split(M: int, K: int, N: int, int4: bool, sms: int) -> int:
    """Blocks along K for the decode design: enough for two blocks an SM
    over the ceil(N / 128) strips, at most one per 32-row code tile, and
    few enough that the fp32 partials (written and read once: 8 x split x
    M bytes a column) stay within a quarter of the code bytes (K or K/2 a
    column)."""
    rows = K // 2 if int4 else K
    strips = -(-N // DECODE_STRIP)
    want = -(-2 * sms // strips)
    return max(1, min(want, rows // DECODE_ROWS, rows // (32 * M)))


def prefill_rows(M: int, N: int, sms: int) -> int:
    """Rows of x a prefill tile takes: 256 (two 64-row products a consumer
    warpgroup, so each code tile is dequantized once per 256 rows) where
    M is past 128 and that still leaves a tile for every two SMs, else
    128 (twice the tiles: wk/wv at M 1024 make 32 tiles of 256 rows, and
    ran slower than on 64 of 128)."""
    cols = -(-N // PREFILL_COLS)
    if M > 128 and -(-M // 256) * cols * 2 >= sms:
        return 256
    return 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (counters, partials) of the decode design's
# split-K reduction: the counters start at 0 and the kernel's last block of
# each strip sets its own back to 0; launches on one stream run in order,
# so they may share both.  Kept across calls: zeroing fresh counters would
# add a memset launch to each of a decode step's 7 x layers calls
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, strips: int, floats: int):
    key = (device.index, stream)
    counters, partials = _workspaces.get(key, (None, None))
    if counters is None or counters.numel() < strips:
        counters = torch.zeros(max(strips, 256), dtype=torch.int32,
                               device=device)
    if partials is None or partials.numel() < floats:
        partials = torch.empty(floats, dtype=torch.float32, device=device)
    _workspaces[key] = (counters, partials)
    return counters, partials


def held_workspaces(device, stream: int) -> List[torch.Tensor]:
    """The split workspace of (device, stream) as it stands (for a CUDA
    graph that captured it to keep)."""
    return list(_workspaces.get((device.index, stream), ()))


def _kernel_fn():
    lib = BUILDER.load()
    fn = lib.mixed_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def shape_error(K: int, N: int, int4: bool) -> Optional[str]:
    """Why a ``[K, N]`` weight is not taken by the kernel family, or None.
    The reference's tiling contract (``_tile_plan``: the K-extent, K for
    int8 and K/2 for int4, and N must divide their clamped 512 blocks),
    then the CUDA kernel's chunking.  Checked on every device, so a shape
    the card refuses is refused on the CPU too."""
    Kb = K // 2 if int4 else K
    bk, bn = min(BLOCK_K, Kb), min(BLOCK_N, N)
    if Kb % bk or N % bn:
        return (f"K-extent={Kb}/N={N} must divide block_k={bk}/"
                f"block_n={bn}")
    step = 2 * K_CHUNK if int4 else K_CHUNK
    if K % step:
        return f"K={K} must be a multiple of {step}"
    if N % N_MULTIPLE:
        return f"N={N} must be a multiple of {N_MULTIPLE}"
    return None


def _require_shape(K: int, N: int, int4: bool) -> None:
    why = shape_error(K, N, int4)
    if why is not None:
        raise ValueError(why)


def _operand_error(x, data, scale, out_dtype, K: int) -> Optional[str]:
    """Why the kernel does not take these operands, or None (the messages
    are formatted only on the way to raising: this runs every call)."""
    dev = x.get_device()
    for name, t in (("data", data), ("scale", scale)):
        if t.get_device() != dev:
            return f"{name} on {t.device}, x on {x.device}"
        if not t.is_contiguous():
            return f"{name} is not contiguous"
    if not x.is_contiguous():
        return "x is not contiguous"
    if not x.is_floating_point():
        return f"needs floating x, got {x.dtype}"
    if data.dtype != torch.int8:
        return f"needs int8 data, got {data.dtype}"
    if scale.dtype != torch.float32 or scale.numel() != K:
        return (f"needs fp32 scale of {K} rows, got {scale.dtype} "
                f"{tuple(scale.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        return f"out_dtype {out_dtype} not bf16/fp32"
    if (x.data_ptr() | data.data_ptr() | scale.data_ptr()) % 16:
        return "x/data/scale must be 16-byte aligned"
    return None


def _launch(x, data, scale, out_dtype, int4: bool):
    M, K = x.shape
    N = data.shape[1]
    why = _operand_error(x, data, scale, out_dtype, K)
    if why is not None:
        raise ValueError(f"mixed_gemm kernel: {why}")
    # the kernel's operand type (the reference casts x to bf16 in-kernel)
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out, None
    design = design_for(M)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = _sm_count(x.device.index)
    split, rows, ws, counters = 1, 0, None, None
    if design == "prefill":
        rows = prefill_rows(M, N, sms)
    else:
        split = decode_split(M, K, N, int4, sms)
        if split > 1:
            strips = -(-N // DECODE_STRIP)
            counters, ws = _workspace(x.device, stream, strips,
                                      split * strips * M * DECODE_STRIP)
    err = _kernel_fn()(x.data_ptr(), data.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), None if ws is None else ws.data_ptr(),
                       None if counters is None else counters.data_ptr(),
                       M, K, N, int(int4), int(out_dtype == torch.float32),
                       DESIGNS[design], split, rows, stream)
    if err != 0:
        raise RuntimeError(f"mixed_gemm kernel launch failed: cudaError {err}")
    return out, design


def mixed_matmul_2d(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                    *, out_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """``x [M, K] @ (int8 data [K, N] * scale [K, 1]) -> [M, N]``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel and
    bump ``mixed_matmul_2d.launches``."""
    M, K = x.shape
    if data.shape[0] != K or scale.numel() != K:
        raise ValueError(f"x {tuple(x.shape)}, data {tuple(data.shape)}, "
                         f"scale {tuple(scale.shape)}")
    _require_shape(K, data.shape[1], int4=False)
    if x.device.type == "cpu":
        return mixed_matmul_2d_plain(x, data, scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mixed_gemm kernel: unsupported device {x.device}")
    out, design = _launch(x, data, scale if scale.dim() == 1 else
                          scale.reshape(K), out_dtype, int4=False)
    mixed_matmul_2d.launches += 1
    if design is not None:
        mixed_matmul_2d.design_launches[design] += 1
    if _flops._ACTIVE:
        _flops.note_kernel_flops("mixed_matmul_2d", 2.0 * M * K * data.shape[1])
    return out


mixed_matmul_2d.launches = 0
mixed_matmul_2d.design_launches = dict.fromkeys(DESIGNS, 0)


def mixed4_matmul_2d(x: torch.Tensor, data: torch.Tensor,
                     scale: torch.Tensor, *,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ unpack(int4 data [K/2, N], scale [K, 1]) -> [M, N]``;
    byte row j packs flat contraction rows j (low nibble) and j + K/2
    (high).  CPU tensors take the plain version; CUDA tensors launch the
    kernel of ``design_for(M)`` and bump ``mixed4_matmul_2d.launches`` and
    ``mixed4_matmul_2d.design_launches[design]``."""
    M, K = x.shape
    if 2 * data.shape[0] != K or scale.numel() != K:
        raise ValueError(f"x {tuple(x.shape)}, data {tuple(data.shape)}, "
                         f"scale {tuple(scale.shape)}")
    _require_shape(K, data.shape[1], int4=True)
    if x.device.type == "cpu":
        return mixed4_matmul_2d_plain(x, data, scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mixed_gemm kernel: unsupported device {x.device}")
    out, design = _launch(x, data, scale if scale.dim() == 1 else
                          scale.reshape(K), out_dtype, int4=True)
    mixed4_matmul_2d.launches += 1
    if design is not None:
        mixed4_matmul_2d.design_launches[design] += 1
    if _flops._ACTIVE:
        _flops.note_kernel_flops("mixed4_matmul_2d", 2.0 * M * K * data.shape[1])
    return out


mixed4_matmul_2d.launches = 0
mixed4_matmul_2d.design_launches = dict.fromkeys(DESIGNS, 0)


def _product_bf16(x: torch.Tensor, w: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """bf16 operands, fp32 accumulation (the tensor-core product)."""
    return (x.to(torch.bfloat16).float() @ w.float()).to(out_dtype)


def mixed_matmul_2d_plain(x: torch.Tensor, data: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: w = bf16(code * bf16(scale))
    (one rounding, as the bf16 multiply of the TPU kernel), x rounded to
    bf16, fp32 accumulation."""
    w = data.to(torch.bfloat16) * scale.reshape(-1, 1).to(torch.bfloat16)
    return _product_bf16(x, w, out_dtype)


def mixed4_matmul_2d_plain(x: torch.Tensor, data: torch.Tensor,
                           scale: torch.Tensor,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """As :func:`mixed_matmul_2d_plain` over the two unpacked halves."""
    lo, hi = unpack_nibbles(data)
    w = (torch.cat([lo, hi], dim=0).to(torch.bfloat16)
         * scale.reshape(-1, 1).to(torch.bfloat16))
    return _product_bf16(x, w, out_dtype)


def flat_kn(wshape, contract_dims: int = 1):
    """(K, N) of a weight whose first ``contract_dims`` dims contract."""
    K = N = 1
    for d in wshape[:contract_dims]:
        K *= d
    for d in wshape[contract_dims:]:
        N *= d
    return K, N


def mixed_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                 contract_dims: int = 1,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(qt)`` through the mixed-input kernel family.

    ``x``: [..., K]; ``qt``: a row-wise int8 (weight-shaped payload) or
    packed row-wise int4 ("rowwise4") tensor whose first ``contract_dims``
    weight dims flatten into K and the rest into N — the attention output
    projection [H, Dh, d] uses ``contract_dims=2``.  Scales coarser than
    one per row (per head for [H, Dh, d]) are expanded to rows."""
    if not is_mixed_gemm_layout(qt):
        raise ValueError(f"mixed_matmul consumes the row-wise int8/int4 "
                         f"symmetric layouts, got {qt!r}")
    int4 = is_rowwise_int4(qt)
    wshape = tuple(qt.shape)
    K, N = flat_kn(wshape, contract_dims)
    lead = x.shape[:-1]
    if x.shape[-1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not contract with "
                         f"{wshape} over {contract_dims} dims")
    s = qt.scale.reshape(-1)
    if s.numel() != K:
        if K % s.numel():
            raise ValueError(f"scales {tuple(qt.scale.shape)} do not tile "
                             f"K={K}")
        # leading-dim scales are constant over their trailing rows
        s = s[:, None].expand(s.numel(), K // s.numel()).reshape(K)
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, K)
    if int4:
        # the flat packing fixed K at quantize time; another contraction
        # split would reshape into garbage
        if qt.data.shape[-2] != K // 2:
            raise ValueError(f"rowwise4 payload {tuple(qt.data.shape)} was "
                             f"packed for another contraction split (K={K})")
        y = mixed4_matmul_2d(x2, qt.data.reshape(K // 2, N), s,
                             out_dtype=out_dtype)
    else:
        y = mixed_matmul_2d(x2, qt.data.reshape(K, N), s,
                            out_dtype=out_dtype)
    return y.reshape(*lead, *wshape[contract_dims:])


def dequant_matmul_reference(x: torch.Tensor, qt: QuantizedTensor,
                             out_dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """The dequantize-then-matmul path: bf16 dense weight, then x @ w."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(qt, torch.bfloat16)
    wshape = tuple(qt.shape)
    K = wshape[0]
    ct = torch.promote_types(x.dtype, w.dtype)
    y = x.reshape(-1, K).to(ct) @ w.reshape(K, -1).to(ct)
    return y.to(out_dtype).reshape(*x.shape[:-1], *wshape[1:])
