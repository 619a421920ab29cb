"""Mixed-input GEMM: bf16 activations x int8 / packed-int4 weights.

Counterpart of ``deepspeed_tpu/ops/mixed_gemm.py`` (the Pallas TPU kernels
``_mixed_kernel`` and ``_mixed4_kernel``).  The kernels are CUDA C++ in
``csrc/mixed_gemm.cu`` (see the note at its top for the design and what
bounds it), built by ``ops/builder.py`` at first use and bound through
``ctypes``.

:func:`mixed_matmul_2d` (int8) and :func:`mixed4_matmul_2d` (int4) are
the wrappers: for tensors on the CPU they run their plain versions
(:func:`mixed_matmul_2d_plain`, :func:`mixed4_matmul_2d_plain`), which
round x and each dequantized weight to bf16 where the TPU kernels do and
accumulate in fp32; for tensors on a CUDA device they check every
operand and launch the kernel, or raise.  :func:`mixed_matmul` is the
serving entry point (``inference/model._mm``): it flattens the
contraction, expands coarser-than-row scales and routes a row-wise
:class:`~.quant.QuantizedTensor` to the right wrapper.
:func:`shape_error` says which ``[K, N]`` the family takes, on every
device alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .builder import CUDAOpBuilder
from .quant import (QuantizedTensor, dequantize, is_mixed_gemm_layout,
                    is_rowwise_int4, unpack_nibbles)

BUILDER = CUDAOpBuilder("mixed_gemm", ["mixed_gemm.cu"])

# the reference's K/N block (deepspeed_tpu/ops/mixed_gemm.py:97-98):
# a K-extent or N past it must be a multiple of it
BLOCK_K = BLOCK_N = 512
# what the kernel takes (csrc/mixed_gemm.cu): K in 32-row chunks (64 for
# int4, a chunk per half), N in 16-column fragments
K_CHUNK = 32
N_MULTIPLE = 16


def _kernel_fn():
    lib = BUILDER.load()
    fn = lib.mixed_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixed_gemm kernel: {msg}")


def _launch(x, data, scale, out_dtype, int4: bool):
    M, K = x.shape
    N = data.shape[1]
    for name, t in (("data", data), ("scale", scale)):
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(x.is_contiguous(), "x is not contiguous")
    _check(x.is_floating_point(), f"needs floating x, got {x.dtype}")
    # the kernel's operand type (the reference casts x to bf16 in-kernel)
    x = x.to(torch.bfloat16)
    _check(data.dtype == torch.int8, f"needs int8 data, got {data.dtype}")
    _check(scale.dtype == torch.float32 and scale.numel() == K,
           f"needs fp32 scale of {K} rows, got {scale.dtype} "
           f"{tuple(scale.shape)}")
    _check(out_dtype in (torch.bfloat16, torch.float32),
           f"out_dtype {out_dtype} not bf16/fp32")
    _check(x.data_ptr() % 16 == 0 and data.data_ptr() % 16 == 0,
           "x/data must be 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    # the M tile from M, as the reference's _tile_plan (M padded up to a
    # power of two), from the kernel's 16 up to 128
    block_m = min(128, max(16, 1 << (M - 1).bit_length()))
    err = _kernel_fn()(x.data_ptr(), data.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), M, K, N, int(int4),
                       int(out_dtype == torch.float32), block_m,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mixed_gemm kernel launch failed: cudaError {err}")
    return out


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
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    out = _launch(x, data, scale.reshape(K), out_dtype, int4=False)
    mixed_matmul_2d.launches += 1
    return out


mixed_matmul_2d.launches = 0


def mixed4_matmul_2d(x: torch.Tensor, data: torch.Tensor,
                     scale: torch.Tensor, *,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ unpack(int4 data [K/2, N], scale [K, 1]) -> [M, N]``;
    byte row j packs flat contraction rows j (low nibble) and j + K/2
    (high).  CPU tensors take the plain version; CUDA tensors launch the
    kernel and bump ``mixed4_matmul_2d.launches``."""
    M, K = x.shape
    if 2 * data.shape[0] != K or scale.numel() != K:
        raise ValueError(f"x {tuple(x.shape)}, data {tuple(data.shape)}, "
                         f"scale {tuple(scale.shape)}")
    _require_shape(K, data.shape[1], int4=True)
    if x.device.type == "cpu":
        return mixed4_matmul_2d_plain(x, data, scale, out_dtype=out_dtype)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    out = _launch(x, data, scale.reshape(K), out_dtype, int4=True)
    mixed4_matmul_2d.launches += 1
    return out


mixed4_matmul_2d.launches = 0


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
