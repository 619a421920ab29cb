"""Flash attention: three Hopper kernels in bf16, fp16 and fp32, their
plain versions, the autograd seam and the drop-in ``attention_fn``.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py`` (the Pallas TPU
kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` behind the
custom VJP ``_flash``), which take any float dtype and any head dim.  The
kernels are CUDA C++: in bf16 and fp16 on the tensor cores, all three at
every head dim in ``csrc/flash_attention_sm90.cuh`` (wgmma, TMA, warp
specialisation), dispatched by ``csrc/flash_attention.cuh`` behind the
entry points of ``flash_attention.cu`` and ``flash_attention_fp16.cu``;
in fp32 on the CUDA cores, in
``csrc/flash_attention_fp32.cu`` (all three register-blocked; see the notes
at their tops for their design and what bounds them): three libraries built
by ``ops/builder.py`` at first use and bound through ``ctypes``.

* :func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv` are the kernel
  wrappers, in the kernels' ``[B, H, S, D]`` layout.  Tensors on the CPU
  take the plain versions (:func:`flash_fwd_plain`, :func:`flash_dq_plain`,
  :func:`flash_dkv_plain`); tensors on a CUDA device launch the kernel of
  their dtype (bf16, fp16 or fp32; q, k, v and dO of one dtype) and count
  it (:func:`_count`), or raise.  A head dim the kernels are not
  instantiated for (they are for :data:`HEAD_DIMS`) is zero-padded to the
  next one and the outputs sliced back (:func:`at_kernel_head_dim`; exact:
  zero columns add nothing to q.k, and the scale stays the caller's);
  above 256 it raises.  Nothing falls back from a kernel to a plain
  version.
* ``torch.ops.deepspeed_tpu_torch.flash_fwd`` is the forward as a custom
  op, returning ``(o, lse)``: a selective-checkpoint policy sees it (a
  ctypes call inside an ``autograd.Function`` is invisible to a
  ``TorchDispatchMode``) and can save its outputs, as the JAX ``flash``
  remat policy saves ``flash_out`` (``:377-379``).  ``flash_dq`` and
  ``flash_dkv`` are custom ops too, and all three carry flop formulas
  (:func:`flash_products_flops`), so ``torch.utils.flop_counter`` counts
  the kernels it cannot see inside.
* :class:`FlashAttentionFunction` is the ``torch.autograd.Function``: its
  forward calls that op and saves ``(q, k, v, o, lse)``; its backward
  computes ``delta = rowsum(dO * O)`` in fp32 and calls dq and dkv
  (``_bwd`` ``:264``).
* :func:`flash_attention` is the ``attention_fn`` of
  ``attention_impl="flash"`` in the ``[B, S, H, D]`` layout, with the JAX
  package's routing (``:361-368``): a padding mask, cross-length k,
  uneven tiling or ``H % Hkv`` go to ``causal_attention`` (counted in
  ``flash_attention.fallbacks``).

The plain versions compute what each TPU kernel computes: scores and
products accumulated in fp32 (fp64 for fp64 inputs, a reference one step
wider than fp32), the probabilities (and ``dS``) rounded to the input
dtype before their products, masked scores at -1e30.  They take the whole
row at once instead of a block at a time; the result differs only in
summation order.  The LSE is ``[B, H, S]`` (the JAX package's is
``[B, H, S, 1]``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import causal_attention
from .builder import CUDAOpBuilder

NEG_INF = -1e30

# the head dims the kernels are instantiated for (csrc/*.cu*); any other
# D <= 256 is zero-padded to the next of these
HEAD_DIMS = (32, 64, 80, 96, 128, 256)

_HEADER = ["flash_attention.cuh", "flash_attention_sm90.cuh", "sm90.cuh",
           "sm90_wgmma.cuh"]
BUILDER = CUDAOpBuilder("flash_attention", ["flash_attention.cu"], _HEADER)
BUILDER_FP16 = CUDAOpBuilder("flash_attention_fp16",
                             ["flash_attention_fp16.cu"], _HEADER)
# the fp32 file's 36 register-blocked kernels keep nvcc's optimizer in
# one thread for the longest build by far; split compilation runs it on
# every core (chip_smoke.py's build phase prints each library's seconds;
# tools/flash_ab.py times its kernels against another checkout's)
BUILDER_FP32 = CUDAOpBuilder("flash_attention_fp32",
                             ["flash_attention_fp32.cu"],
                             extra_flags=["--split-compile=0"])
BUILDERS = [BUILDER, BUILDER_FP16, BUILDER_FP32]

# dtype -> (entry-point suffix, library)
_KERNEL_DTYPES = {torch.bfloat16: ("bf16", BUILDER),
                  torch.float16: ("fp16", BUILDER_FP16),
                  torch.float32: ("fp32", BUILDER_FP32)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {"flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
             "flash_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
             "flash_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _P]}


def _kernel_fn(kind: str, dtype: torch.dtype):
    tag, builder = _KERNEL_DTYPES[dtype]
    fn = getattr(builder.load(), f"{kind}_{tag}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def kernel_head_dim(D: int) -> int:
    """The instantiated head dim a head dim ``D`` runs at: the smallest of
    :data:`HEAD_DIMS` that is ``>= D``."""
    for d in HEAD_DIMS:
        if d >= D:
            return d
    raise ValueError(f"flash attention kernel: head_dim {D} above the "
                     f"largest instantiated one ({HEAD_DIMS[-1]})")


def at_kernel_head_dim(fn, *tensors, **kw):
    """``fn(*tensors, **kw)`` at the instantiated head dim: the
    ``[B, H|Hkv, S, D]`` operands zero-padded to ``kernel_head_dim(D)``
    (the ``[B, H, S]`` ones pass as they are) and the 4-d outputs sliced
    back to ``D``.  Exact: the padded columns add zeros to every q.k and
    dO.v, and their outputs are dropped."""
    D = tensors[0].shape[-1]
    Dp = kernel_head_dim(D)
    if Dp == D:
        return fn(*tensors, **kw)
    out = fn(*(F.pad(t, (0, Dp - D)) if t.dim() == 4 else t
               for t in tensors), **kw)

    def cut(x):
        return x[..., :D].contiguous() if x.dim() == 4 else x
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


def _check_operands(q, k, v, extra=(), fp32=()) -> Tuple[int, ...]:
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
    _check(q.dtype in _KERNEL_DTYPES,
           f"needs bf16, fp16 or fp32 q, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), *extra):
        _check(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        _check(x.dtype == q.dtype, f"{name} is {x.dtype}, q is {q.dtype}")
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
    return at_kernel_head_dim(_fwd_launch, q, k, v, scale=scale,
                              causal=causal)


def _fwd_launch(q, k, v, scale, causal):
    B, H, Hkv, S, D = _check_operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _raise_on(_kernel_fn("flash_fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, Hkv, S, D, float(scale), int(causal),
        _stream(q)), "flash_fwd")
    _count(flash_fwd, q)
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale: float,
             causal: bool = True) -> torch.Tensor:
    """dq [B,H,S,D] from q, k, v, dO, lse and delta (``[B,H,S]`` fp32)."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal)
    return at_kernel_head_dim(_dq_launch, q, k, v, do, lse, delta,
                              scale=scale, causal=causal)


def _dq_launch(q, k, v, do, lse, delta, scale, causal):
    B, H, Hkv, S, D = _check_operands(
        q, k, v, extra=(("do", do),), fp32=(("lse", lse), ("delta", delta)))
    _check(do.shape == q.shape, f"do {tuple(do.shape)} vs q {tuple(q.shape)}")
    dq = torch.empty_like(q)
    _raise_on(_kernel_fn("flash_dq", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, S, D,
        float(scale), int(causal), _stream(q)), "flash_dq")
    _count(flash_dq, q)
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,S,D], summed over each KV head's query-head group."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    return at_kernel_head_dim(_dkv_launch, q, k, v, do, lse, delta,
                              scale=scale, causal=causal)


def _dkv_launch(q, k, v, do, lse, delta, scale, causal):
    B, H, Hkv, S, D = _check_operands(
        q, k, v, extra=(("do", do),), fp32=(("lse", lse), ("delta", delta)))
    _check(do.shape == q.shape, f"do {tuple(do.shape)} vs q {tuple(q.shape)}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _raise_on(_kernel_fn("flash_dkv", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Hkv, S, D, float(scale), int(causal), _stream(q)), "flash_dkv")
    _count(flash_dkv, q)
    return dk, dv


def _count(wrapper, q) -> None:
    """One call of ``wrapper``'s kernel entry point on ``q`` (already at
    the instantiated head dim): ``wrapper.launches`` counts every call,
    ``wrapper.variant_launches[(dtype name, D)]`` the calls of each
    variant.  Every entry point launches one kernel a call."""
    wrapper.launches += 1
    key = (str(q.dtype).removeprefix("torch."), q.shape[-1])
    wrapper.variant_launches[key] = wrapper.variant_launches.get(key, 0) + 1


def reset_launches() -> None:
    """Set every launch count of the three wrappers to 0."""
    for wrapper in (flash_fwd, flash_dq, flash_dkv):
        wrapper.launches = 0
        wrapper.variant_launches = {}


reset_launches()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the accumulation dtype: fp32, or fp64 for fp64 inputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _grouped_scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """fp32 scores [B, Hkv, rep, S, S], masked entries at NEG_INF."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    qg = _acc(q).reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, _acc(k)) * scale
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def _grouped(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, H, S, ...] -> [B, Hkv, rep, S, ...] (fp32)."""
    B, H = x.shape[:2]
    return _acc(x).reshape(B, Hkv, H // Hkv, *x.shape[2:])


def flash_fwd_plain(q, k, v, scale: float, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_fwd_kernel`` computes: (o [B,H,S,D] in q's dtype,
    lse [B,H,S] fp32; fp64 for fp64 inputs)."""
    B, H, S, D = q.shape
    s = _grouped_scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bgrqk,bgkd->bgrqd", _acc(p.to(v.dtype)), _acc(v))
    o = (o / l).reshape(B, H, S, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, S)
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, scale: float, causal: bool):
    Hkv = k.shape[1]
    s = _grouped_scores(q, k, scale, causal)
    p = torch.exp(s - _grouped(lse, Hkv)[..., None])
    dog = _grouped(do, Hkv)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog, _acc(v))
    ds = _acc((p * (dp - _grouped(delta, Hkv)[..., None])).to(q.dtype))
    return p, ds, dog


def flash_dq_plain(q, k, v, do, lse, delta, scale: float,
                   causal: bool = True) -> torch.Tensor:
    """What ``_dq_kernel`` computes: dq [B,H,S,D] in q's dtype."""
    _, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, _acc(k)) * scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, scale: float,
                    causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_dkv_kernel`` computes: (dk, dv) [B,Hkv,S,D], each summed
    over the KV head's ``rep`` query heads."""
    p, ds, dog = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", _acc(p.to(do.dtype)), dog)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds,
                      _grouped(q, k.shape[1])) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# autograd seam and the attention_fn
# ---------------------------------------------------------------------------

@torch.library.custom_op(
    "deepspeed_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool causal) "
           "-> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, scale, causal):
    """:func:`flash_fwd` as a dispatcher op (``(o, lse)``), so that a
    selective-checkpoint policy can see and save the forward."""
    return flash_fwd(q, k, v, scale, causal)


@flash_fwd_op.register_fake
def _(q, k, v, scale, causal):
    B, H, S, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32)


@torch.library.custom_op(
    "deepspeed_tpu_torch::flash_dq", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
           "Tensor delta, float scale, bool causal) -> Tensor")
def flash_dq_op(q, k, v, do, lse, delta, scale, causal):
    """:func:`flash_dq` as a dispatcher op (a flop counter sees it)."""
    return flash_dq(q, k, v, do, lse, delta, scale, causal)


@flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, scale, causal):
    return torch.empty_like(q)


@torch.library.custom_op(
    "deepspeed_tpu_torch::flash_dkv", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
           "Tensor delta, float scale, bool causal) -> (Tensor, Tensor)")
def flash_dkv_op(q, k, v, do, lse, delta, scale, causal):
    """:func:`flash_dkv` as a dispatcher op (a flop counter sees it)."""
    return flash_dkv(q, k, v, do, lse, delta, scale, causal)


@flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, scale, causal):
    return torch.empty_like(k), torch.empty_like(v)


def flash_products_flops(q_shape, k_shape, products: int,
                         causal: bool) -> int:
    """2 x the multiply-adds of ``products`` [S, S] x [S, D] matrix
    products per (batch, query head), half of them under the causal mask:
    the count ``chip_smoke.flash_bound`` takes (fwd 2 products: QK^T and
    PV; dq 3: QK^T, dO V^T, dS K; dk/dv 4: those less dS K, plus
    P^T dO and dS^T Q)."""
    B, H, S, D = q_shape
    return products * 2 * B * H * ((S * S // 2) if causal else S * S) * D


# the products each kernel computes, read by torch.utils.flop_counter
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula
    ops = torch.ops.deepspeed_tpu_torch
    for name, n in FLASH_PRODUCTS.items():
        def formula(q, k, *rest, out_shape=None, _n=n, **kw):
            return flash_products_flops(q, k, _n, bool(rest[-1]))
        register_flop_formula(getattr(ops, name))(formula)


_register_flop_formulas()


class FlashAttentionFunction(torch.autograd.Function):
    """o = attention(q, k, v) in ``[B, H, S, D]`` (the JAX ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd_op(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq_op(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv_op(q, k, v, do, lse, delta, ctx.scale,
                              ctx.causal)
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
