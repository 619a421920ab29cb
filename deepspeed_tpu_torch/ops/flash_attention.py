"""Flash attention: three Hopper kernels, their plain versions, the autograd
seam and the drop-in ``attention_fn``.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py`` (the Pallas TPU
kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` behind the
custom VJP ``_flash``).  The kernels are CUDA C++ in
``csrc/flash_attention.cu`` (see the note at its top for their design and
what bounds them), built by ``ops/builder.py`` at first use and bound
through ``ctypes``.

* :func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv` are the kernel
  wrappers, in the kernels' ``[B, H, S, D]`` layout.  Tensors on the CPU
  take the plain versions (:func:`flash_fwd_plain`, :func:`flash_dq_plain`,
  :func:`flash_dkv_plain`); tensors on a CUDA device launch the kernel
  (bf16, head_dim 64 or 128) and bump the wrapper's ``.launches``, or
  raise.  Nothing falls back from a kernel to a plain version.
* :class:`FlashAttentionFunction` is the ``torch.autograd.Function``: its
  forward saves ``(q, k, v, o, lse)``; its backward computes
  ``delta = rowsum(dO * O)`` in fp32 and calls dq and dkv (``_bwd``
  ``:264``).
* :func:`flash_attention` is the ``attention_fn`` of
  ``attention_impl="flash"`` in the ``[B, S, H, D]`` layout, with the JAX
  package's routing (``:361-368``): a padding mask, cross-length k,
  uneven tiling or ``H % Hkv`` go to ``causal_attention`` (counted in
  ``flash_attention.fallbacks``).

The plain versions compute what each TPU kernel computes: scores and
products accumulated in fp32, the probabilities (and ``dS``) rounded to
the input dtype before their products, masked scores at -1e30.  They take
the whole row at once instead of a block at a time; the result differs
only in fp32 summation order.  The LSE is ``[B, H, S]`` (the JAX
package's is ``[B, H, S, 1]``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..models.layers import causal_attention
from .builder import CUDAOpBuilder

NEG_INF = -1e30

# what the kernels take (csrc/flash_attention.cu)
HEAD_DIMS = (64, 128)

BUILDER = CUDAOpBuilder("flash_attention", ["flash_attention.cu"])

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "flash_fwd_bf16": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "flash_dq_bf16": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "flash_dkv_bf16": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
}


def _kernel_fn(name: str):
    fn = getattr(BUILDER.load(), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check_operands(q, k, v, extra_bf16=(), fp32=()) -> Tuple[int, ...]:
    """Validate what the CUDA kernels take; returns (B, H, Hkv, S, D)."""
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
           "must be [B, H, S, D] / [B, Hkv, S, D]")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    _check(k.shape == (B, Hkv, S, D) and v.shape == k.shape,
           f"k {tuple(k.shape)} / v {tuple(v.shape)} vs q {tuple(q.shape)}")
    _check(H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v), *extra_bf16):
        _check(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        _check(x.dtype == torch.bfloat16, f"needs bf16 {name}, got {x.dtype}")
        _check(x.is_contiguous(), f"{name} is not contiguous")
        _check(x.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    for name, x in fp32:
        _check(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        _check(x.dtype == torch.float32, f"{name} must be fp32, got {x.dtype}")
        _check(x.is_contiguous() and x.shape == (B, H, S),
               f"{name} must be a contiguous [B, H, S], got {tuple(x.shape)}")
    return B, H, Hkv, S, D


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,S,D], k/v [B,Hkv,S,D] -> (o [B,H,S,D], lse [B,H,S] fp32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    B, H, Hkv, S, D = _check_operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _raise_on(_kernel_fn("flash_fwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, Hkv, S, D, float(scale), int(causal),
        _stream(q)), "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale: float,
             causal: bool = True) -> torch.Tensor:
    """dq [B,H,S,D] from q, k, v, dO, lse and delta (``[B,H,S]`` fp32)."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal)
    B, H, Hkv, S, D = _check_operands(
        q, k, v, extra_bf16=(("do", do),),
        fp32=(("lse", lse), ("delta", delta)))
    _check(do.shape == q.shape, f"do {tuple(do.shape)} vs q {tuple(q.shape)}")
    dq = torch.empty_like(q)
    _raise_on(_kernel_fn("flash_dq_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, S, D,
        float(scale), int(causal), _stream(q)), "flash_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,S,D], summed over each KV head's query-head group."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    B, H, Hkv, S, D = _check_operands(
        q, k, v, extra_bf16=(("do", do),),
        fp32=(("lse", lse), ("delta", delta)))
    _check(do.shape == q.shape, f"do {tuple(do.shape)} vs q {tuple(q.shape)}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _raise_on(_kernel_fn("flash_dkv_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Hkv, S, D, float(scale), int(causal), _stream(q)), "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _grouped_scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """fp32 scores [B, Hkv, rep, S, S], masked entries at NEG_INF."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def _grouped(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, H, S, ...] -> [B, Hkv, rep, S, ...] (fp32)."""
    B, H = x.shape[:2]
    return x.float().reshape(B, Hkv, H // Hkv, *x.shape[2:])


def flash_fwd_plain(q, k, v, scale: float, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_fwd_kernel`` computes: (o [B,H,S,D] in q's dtype,
    lse [B,H,S] fp32)."""
    B, H, S, D = q.shape
    s = _grouped_scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), v.float())
    o = (o / l).reshape(B, H, S, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, S)
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, scale: float, causal: bool):
    Hkv = k.shape[1]
    s = _grouped_scores(q, k, scale, causal)
    p = torch.exp(s - _grouped(lse, Hkv)[..., None])
    dog = _grouped(do, Hkv)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog, v.float())
    ds = (p * (dp - _grouped(delta, Hkv)[..., None])).to(q.dtype).float()
    return p, ds, dog


def flash_dq_plain(q, k, v, do, lse, delta, scale: float,
                   causal: bool = True) -> torch.Tensor:
    """What ``_dq_kernel`` computes: dq [B,H,S,D] in q's dtype."""
    _, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, scale: float,
                    causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_dkv_kernel`` computes: (dk, dv) [B,Hkv,S,D], each summed
    over the KV head's ``rep`` query heads."""
    p, ds, dog = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds,
                      _grouped(q, k.shape[1])) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# autograd seam and the attention_fn
# ---------------------------------------------------------------------------

class FlashAttentionFunction(torch.autograd.Function):
    """o = attention(q, k, v) in ``[B, H, S, D]`` (the JAX ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, causal: bool = True) -> torch.Tensor:
    """Drop-in ``attention_fn``: q [B, S, H, D], GQA k/v [B, S, Hkv, D].

    Routes exactly as the JAX package's ``flash_attention`` does: a mask,
    a k of another length, an S that the (clamped) blocks do not tile, or
    ``H % Hkv`` go to ``causal_attention``.  The blocks only decide the
    routing; the kernels tile by their own sizes."""
    B, S, H, D = q.shape
    bq, bk = min(block_q, S), min(block_k, S)
    if (mask is not None or k.shape[1] != S or S % bq or S % bk
            or H % k.shape[2]):
        flash_attention.fallbacks += 1
        return causal_attention(q, k, v, mask=mask, scale=scale,
                                causal=causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qt = q.transpose(1, 2).contiguous()            # [B, H, S, D]
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    o = FlashAttentionFunction.apply(qt, kt, vt, float(scale), bool(causal))
    return o.transpose(1, 2)


flash_attention.fallbacks = 0
