"""Weight quantization for serving: grouped and row-wise int8/int4.

Counterpart of the serving subset of ``deepspeed_tpu/ops/quant.py``:
:class:`QuantizedTensor`, the grouped sym/asym :func:`quantize`, the
row-wise int8 layout the mixed-input GEMM consumes
(:func:`quantize_rowwise`, weight-shaped payload, one scale per leading
row) and the packed row-wise int4 layout (:func:`quantize_rowwise4`:
``[K/2, N]`` bytes whose low nibble is contraction row j and high nibble
row j + K/2), with their dequantizers.

Payload codes and scales are bitwise equal to the JAX package's on the
same input, so one quantized checkpoint feeds both packages: the same
fp32 divisions, ``torch.round`` (half to even, as ``jnp.round``), the
same clips.  Stochastic rounding, the quantized collectives and the
fp6/fp12 minifloat layouts are not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# serving config strings -> bit widths (the JAX package's table)
WEIGHT_QUANT_BITS = {"int8": 8, "int4": 4, "fp6": 6, "fp12": 12}
MINIFLOAT_BY_BITS = {6: "fp6_e3m2", 12: "fp12_e4m7"}
_MINIFLOAT_ITEM = ("the fp6/fp12 minifloat weight layouts are not ported "
                   "yet (ROADMAP Queue 1, quantized serving: minifloat "
                   "layouts)")


class QuantizedTensor:
    """Quantized payload + per-group or per-row scales (and zero points
    for asymmetric grouped data).  ``layout``: "grouped" (flat
    ``[G, gsz]``), "rowwise" (int8 in the weight's own shape, scales on
    the leading dims) or "rowwise4" (packed ``[*lead, K/2, N]`` nibbles).
    ``operands``: of a stacked row-wise weight, its per-layer operands of
    the mixed-input GEMM once built
    (``inference.quantization.mixed_operand``), else None."""

    __slots__ = ("data", "scale", "zero", "bits", "shape", "dtype",
                 "layout", "operands")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 zero: Optional[torch.Tensor], bits: int,
                 shape: Tuple[int, ...], dtype: torch.dtype,
                 layout: str = "grouped"):
        self.data = data
        self.scale = scale
        self.zero = zero
        self.bits = bits
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout
        self.operands = None

    def tensors(self):
        """The tensors this payload holds (data, scale, zero if any)."""
        return [t for t in (self.data, self.scale, self.zero)
                if t is not None]

    def __repr__(self):
        return (f"QuantizedTensor(bits={self.bits}, shape={self.shape}, "
                f"dtype={self.dtype}, layout={self.layout})")


def _group(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    flat = x.reshape(-1)
    if flat.numel() % num_groups:
        raise ValueError(f"size {flat.numel()} not divisible into "
                         f"{num_groups} groups")
    return flat.reshape(num_groups, -1)


def default_groups(size: int, target_group_size: int = 2048) -> int:
    """Largest group count dividing ``size`` with groups >= the target
    group size."""
    groups = max(1, size // target_group_size)
    while size % groups:
        groups -= 1
    return groups


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Two int4 values per byte: element 2i in the low nibble, 2i+1 in
    the high one (int8 bits, as the JAX package stores them)."""
    q = q.reshape(q.shape[0], -1, 2).view(torch.uint8)
    return ((q[..., 0] & 0x0F) | ((q[..., 1] & 0x0F) << 4)).view(torch.int8)


def unpack_nibbles(p: torch.Tensor):
    """(lo, hi) int8 nibbles of a packed byte tensor, sign-extended from
    4-bit two's complement."""
    u = p.view(torch.uint8)
    lo = (u & 0x0F).to(torch.int8)
    hi = (u >> 4).to(torch.int8)
    return torch.where(lo > 7, lo - 16, lo), torch.where(hi > 7, hi - 16, hi)


def _unpack_int4(p: torch.Tensor) -> torch.Tensor:
    lo, hi = unpack_nibbles(p)
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[0], -1)


def quantize(x: torch.Tensor, bits: int = 8,
             num_groups: Optional[int] = None, symmetric: bool = True,
             stochastic: bool = False) -> QuantizedTensor:
    """Group-wise sym/asym quantization with round-half-to-even."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: grouped quantization is 4 or 8 bit")
    if stochastic:
        raise NotImplementedError(
            "stochastic rounding is not ported (ROADMAP Queue 1, multi-GPU "
            "training breadth: ZeRO++ quantized collectives)")
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    if num_groups is None:
        num_groups = default_groups(x.numel())
    g = _group(x.float(), num_groups)
    qmax = float(2 ** (bits - 1) - 1)          # 127 / 7
    qmin = -qmax - 1
    if symmetric:
        scale = g.abs().amax(dim=1, keepdim=True) / qmax
        scale = torch.where(scale == 0, 1.0, scale)
        zero = None
        t = g / scale
    else:
        gmin = g.amin(dim=1, keepdim=True)
        gmax = g.amax(dim=1, keepdim=True)
        scale = (gmax - gmin) / (qmax - qmin)
        scale = torch.where(scale == 0, 1.0, scale)
        zero = gmin - qmin * scale
        t = (g - zero) / scale
    q = torch.clamp(torch.round(t), qmin, qmax).to(torch.int8)
    if bits == 4:
        q = _pack_int4(q)
    return QuantizedTensor(q, scale, zero, bits, orig_shape, orig_dtype)


def quantize_rowwise(x: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """int8 with one scale per first-dim row, data in the weight's own
    shape (the serving layout the int8 mixed-input GEMM consumes)."""
    if bits != 8:
        raise ValueError("the row-wise layout is int8-only "
                         "(int4 is quantize_rowwise4)")
    return _quantize_leading(x, lead_dims=1)


def _quantize_leading(x: torch.Tensor, lead_dims: int) -> QuantizedTensor:
    """Row-wise int8 with scales over the first ``lead_dims`` dims."""
    xf = x.float()
    red = tuple(range(lead_dims, x.dim()))
    scale = xf.abs().amax(dim=red, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
    return QuantizedTensor(q, scale, None, 8, tuple(x.shape), x.dtype,
                           layout="rowwise")


def is_rowwise_int8(qt: QuantizedTensor) -> bool:
    """Symmetric int8 in the weight's own shape (the int8 GEMM layout)."""
    return (qt.bits == 8 and qt.zero is None
            and tuple(qt.data.shape) == tuple(qt.shape))


def is_rowwise_int4(qt: QuantizedTensor) -> bool:
    """Packed strided-half nibbles (the int4 GEMM layout)."""
    return qt.bits == 4 and qt.zero is None and qt.layout == "rowwise4"


def is_mixed_gemm_layout(qt: QuantizedTensor) -> bool:
    return is_rowwise_int8(qt) or is_rowwise_int4(qt)


def quantize_rowwise4(x: torch.Tensor, contract_dims: int = 1,
                      lead_dims: int = 0) -> QuantizedTensor:
    """Packed int4: ``x [*lead, K..., N...]``, the first ``contract_dims``
    dims after ``lead_dims`` flatten into K.  One symmetric scale per
    (lead, first-K-dim row), values in [-7, 7]; byte row j of the packed
    ``[*lead, K/2, N]`` payload holds flat rows j (low nibble) and
    j + K/2 (high nibble)."""
    orig_shape = tuple(x.shape)
    lead = orig_shape[:lead_dims]
    K = 1
    for d in orig_shape[lead_dims:lead_dims + contract_dims]:
        K *= d
    N = 1
    for d in orig_shape[lead_dims + contract_dims:]:
        N *= d
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction ({K})")
    xf = x.float()
    red = tuple(range(lead_dims + 1, x.dim()))
    scale = (xf.abs().amax(dim=red) if red else xf.abs()) / 7.0
    scale = torch.where(scale == 0, 1.0, scale)          # [*lead, S]
    S = scale.shape[-1]
    sb = scale.reshape(*lead, S, *([1] * (x.dim() - lead_dims - 1)))
    q = torch.clamp(torch.round(xf / sb), -7, 7).to(torch.int8)
    q = q.reshape(*lead, K, N).view(torch.uint8)
    lo, hi = q[..., :K // 2, :], q[..., K // 2:, :]
    packed = ((lo & 0x0F) | ((hi & 0x0F) << 4)).view(torch.int8)
    return QuantizedTensor(packed, scale.reshape(*lead, S, 1), None, 4,
                           orig_shape, x.dtype, layout="rowwise4")


def dequantize_rowwise4(qt: QuantizedTensor,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Unpack a :func:`quantize_rowwise4` payload to the weight's shape,
    ``code * scale`` computed in the output dtype."""
    out_dt = dtype or qt.dtype
    lo, hi = unpack_nibbles(qt.data)                    # [*lead, K/2, N]
    flat = torch.cat([lo, hi], dim=-2)                  # [*lead, K, N]
    K, N = flat.shape[-2], flat.shape[-1]
    s = qt.scale.reshape(qt.scale.shape[:-1])           # [*lead, S]
    S = s.shape[-1]
    w = (flat.reshape(*flat.shape[:-2], S, K // S, N).to(out_dt)
         * s[..., None, None].to(out_dt))
    return w.reshape(qt.shape)


def dequantize(qt: QuantizedTensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Grouped, row-wise int8 or packed row-wise int4 -> dense."""
    if qt.layout == "rowwise4":
        return dequantize_rowwise4(qt, dtype)
    out_dt = dtype or qt.dtype
    q = _unpack_int4(qt.data) if qt.bits == 4 else qt.data
    if qt.bits == 8 and qt.zero is None \
            and tuple(q.shape) == tuple(qt.shape):
        # row-wise: the scale broadcasts; computed in the output dtype
        return q.to(out_dt) * qt.scale.to(out_dt)
    g = q.float() * qt.scale
    if qt.zero is not None:
        g = g + qt.zero
    return g.reshape(qt.shape).to(out_dt)


def dequantize_any(qt: QuantizedTensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense value of an int layout; the minifloat layouts raise."""
    if qt.layout in ("rowwise6", "rowwise12") or qt.bits in MINIFLOAT_BY_BITS:
        raise NotImplementedError(_MINIFLOAT_ITEM)
    return dequantize(qt, dtype)
