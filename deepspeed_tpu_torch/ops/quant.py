"""Weight quantization for serving: grouped and row-wise int8/int4, and
the fp6/fp12 minifloat layouts.

Counterpart of the serving subset of ``deepspeed_tpu/ops/quant.py``:
:class:`QuantizedTensor`, the grouped sym/asym :func:`quantize`, the
row-wise int8 layout the mixed-input GEMM consumes
(:func:`quantize_rowwise`, weight-shaped payload, one scale per leading
row) and the packed row-wise int4 layout (:func:`quantize_rowwise4`:
``[K/2, N]`` bytes whose low nibble is contraction row j and high nibble
row j + K/2), with their dequantizers; the emulated minifloat formats
(:func:`minifloat_quantize`: fp6 e3m2 and fp12 e4m7 codes with the sign
folded in, one int8 or int16 container a value, per-group scales), the
packed row-wise minifloat layouts (:func:`quantize_rowwise6` and
:func:`quantize_rowwise12`: sign-magnitude codes, four 6-bit or two
12-bit codes a 24-bit word of three bytes, one scale per leading row:
0.75 and 1.5 bytes a weight), :func:`selective_dequantize` and
:func:`dequantize_any`.

Payload codes and scales are bitwise equal to the JAX package's on the
same input, so one quantized checkpoint feeds both packages: the same
fp32 divisions, ``torch.round`` (half to even, as ``jnp.round``), the
same clips; a minifloat code is the left insertion point of the scaled
magnitude among the midpoints of the format's table
(``torch.searchsorted``, as ``jnp.searchsorted``).  The reference has no
kernel for the minifloat layouts (XLA ops dequantize them), and neither
has the port: plain torch ops, the format's table a device tensor made
once per device (before any CUDA graph captures a dequantization).
:func:`fp_quantize` (fp8 e4m3 / e5m2 with per-group scales, the frozen
base of LoRA's quantized layers) casts with PyTorch's round-to-nearest-
even fp8 conversion; it knows the fp8 formats only, as the JAX one does.
Stochastic rounding and the quantized collectives are not ported
(ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# serving config strings -> bit widths (the JAX package's table)
WEIGHT_QUANT_BITS = {"int8": 8, "int4": 4, "fp6": 6, "fp12": 12}
MINIFLOAT_BY_BITS = {6: "fp6_e3m2", 12: "fp12_e4m7"}


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


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device: PyTorch's CUDA division by
    a Python scalar multiplies by the scalar's reciprocal (a second
    rounding, which moves a scale off the JAX package's by an ulp), so the
    divisor is a 0-dim tensor on ``x``'s device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


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
             stochastic: bool = False,
             rng: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Group-wise sym/asym quantization with round-half-to-even.  ``rng``
    (the key of stochastic rounding, the reference's sixth positional)
    is taken and unused: stochastic rounding is not ported."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: grouped quantization is 4 or 8 bit")
    if stochastic:
        raise NotImplementedError(
            "stochastic rounding is not ported (ROADMAP Queue 1 item 6, "
            "multi-GPU training breadth: ZeRO++ quantized collectives)")
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    if num_groups is None:
        num_groups = default_groups(x.numel())
    g = _group(x.float(), num_groups)
    qmax = float(2 ** (bits - 1) - 1)          # 127 / 7
    qmin = -qmax - 1
    if symmetric:
        scale = _div(g.abs().amax(dim=1, keepdim=True), qmax)
        scale = torch.where(scale == 0, 1.0, scale)
        zero = None
        t = g / scale
    else:
        gmin = g.amin(dim=1, keepdim=True)
        gmax = g.amax(dim=1, keepdim=True)
        scale = _div(gmax - gmin, qmax - qmin)
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
    scale = _div(xf.abs().amax(dim=red, keepdim=True), 127.0)
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
    scale = _div(xf.abs().amax(dim=red) if red else xf.abs(), 7.0)
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


_FP8_FORMATS = {
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}


def fp_quantize(x: torch.Tensor, fmt: str = "fp8_e4m3",
                num_groups: Optional[int] = None) -> QuantizedTensor:
    """Float-to-float quantization: per-group scales stretch each group
    onto the fp8 format's range, the payload is that format.  fp6/fp12
    have no hardware type: :func:`minifloat_quantize` and the packed
    :func:`quantize_rowwise6` / :func:`quantize_rowwise12` emulate them."""
    if fmt not in _FP8_FORMATS:
        raise ValueError(f"unknown fp format {fmt!r}; "
                         f"known: {sorted(_FP8_FORMATS)}")
    dtype, fmax = _FP8_FORMATS[fmt]
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    if num_groups is None:
        num_groups = default_groups(x.numel())
    g = _group(x.float(), num_groups)
    scale = _div(g.abs().amax(dim=1, keepdim=True), fmax)
    scale = torch.where(scale == 0, 1.0, scale)
    q = (g / scale).to(dtype)
    return QuantizedTensor(q, scale, None, 8, orig_shape, orig_dtype)




# --------------------------------------------------------------------------
# emulated minifloat formats, the packed row-wise minifloat layouts and
# selective dequantization
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _minifloat_table(exp_bits: int, man_bits: int) -> np.ndarray:
    """All non-negative representable values of a (1, e, m) minifloat
    with IEEE-style subnormals, ascending."""
    bias = (1 << (exp_bits - 1)) - 1
    vals = []
    for e in range(1 << exp_bits):
        for m in range(1 << man_bits):
            if e == 0:
                v = (m / (1 << man_bits)) * 2.0 ** (1 - bias)
            else:
                v = (1 + m / (1 << man_bits)) * 2.0 ** (e - bias)
            vals.append(v)
    return np.asarray(vals, np.float32)


_MINIFLOAT_FORMATS = {
    # name: (exp_bits, man_bits, container dtype)
    "fp6_e3m2": (3, 2, torch.int8),
    "fp12_e4m7": (4, 7, torch.int16),
}

# (fmt, device) -> the format's tables on that device
_TABLES: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}


def minifloat_tables(fmt: str, device) -> Dict[str, torch.Tensor]:
    """The format's tables on ``device``, made once and kept: ``mids``
    (the midpoints of the table, the quantizer's boundaries), ``signed``
    (``[-t[n-1], ..., -t[0], t[0], ..., t[n-1]]``, indexed by an emulated
    code + n), ``packed`` (``[t, -t]``, indexed by a sign-magnitude
    code), and ``shifts`` (each code's offset in a 24-bit word).  A
    CUDA graph may then dequantize: nothing is copied from the host once
    the tables exist (the engine makes them before it captures)."""
    key = (fmt, str(torch.device(device)))
    tabs = _TABLES.get(key)
    if tabs is None:
        eb, mb, _ = _MINIFLOAT_FORMATS[fmt]
        table = _minifloat_table(eb, mb)
        t = torch.from_numpy(table).to(device)
        bits = eb + mb + 1
        tabs = {"mids": torch.from_numpy(
                    (table[1:] + table[:-1]) / 2.0).to(device),
                "signed": torch.cat([-t.flip(0), t]),
                "packed": torch.cat([t, -t]),
                "shifts": torch.arange(0, 24, bits, dtype=torch.int32,
                                       device=device)}
        _TABLES[key] = tabs
    return tabs


def _fmt_of(qt: QuantizedTensor) -> str:
    if qt.layout in _PACKED_MINIFLOAT:
        return _PACKED_MINIFLOAT[qt.layout][0]
    return MINIFLOAT_BY_BITS[qt.bits]


def is_minifloat(qt: QuantizedTensor) -> bool:
    """An emulated or packed minifloat payload."""
    return qt.layout in _PACKED_MINIFLOAT or qt.bits in MINIFLOAT_BY_BITS


def dequantize_any(qt: QuantizedTensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dispatch on layout and bit width: packed row-wise fp6/fp12,
    emulated minifloat (6/12), or grouped / row-wise int (4/8)."""
    if qt.layout == "rowwise6":
        return dequantize_rowwise6(qt, dtype)
    if qt.layout == "rowwise12":
        return dequantize_rowwise12(qt, dtype)
    if qt.bits in MINIFLOAT_BY_BITS:
        return minifloat_dequantize(qt, dtype)
    return dequantize(qt, dtype)


def _codes_of(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """Magnitude codes of ``t`` (fp32, already scaled): the left insertion
    point of ``|t|`` among the table's midpoints, int32."""
    mids = minifloat_tables(fmt, t.device)["mids"]
    return torch.searchsorted(mids, t.abs(), out_int32=True)


def minifloat_quantize(x: torch.Tensor, fmt: str = "fp6_e3m2",
                       num_groups: Optional[int] = None) -> QuantizedTensor:
    """Emulated fp6/fp12 grouped quantization: a per-group scale onto the
    format's range, then the nearest representable value; codes (the
    sign folded in: ``-code - 1`` for a negative value) in the smallest
    integer container (int8 for fp6, int16 for fp12)."""
    if fmt not in _MINIFLOAT_FORMATS:
        raise ValueError(f"unknown minifloat format {fmt!r}; "
                         f"known: {sorted(_MINIFLOAT_FORMATS)}")
    eb, mb, container = _MINIFLOAT_FORMATS[fmt]
    fmax = float(_minifloat_table(eb, mb)[-1])
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    if num_groups is None:
        num_groups = default_groups(x.numel())
    g = _group(x.float(), num_groups)
    scale = _div(g.abs().amax(dim=1, keepdim=True), fmax)
    scale = torch.where(scale == 0, 1.0, scale)
    t = g / scale
    code = _codes_of(t, fmt)
    signed = torch.where(t < 0, -code - 1, code)
    return QuantizedTensor(signed.to(container), scale, None, eb + mb + 1,
                           orig_shape, orig_dtype)


def minifloat_dequantize(qt: QuantizedTensor,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense value of an emulated minifloat payload: the signed table at
    ``code + n``, times the group's scale in fp32, cast."""
    signed = minifloat_tables(_fmt_of(qt), qt.data.device)["signed"]
    n = signed.shape[0] // 2
    val = signed[qt.data.int() + n] * qt.scale
    return val.reshape(qt.shape).to(dtype or qt.dtype)


def _pack_codes(u: torch.Tensor, per_word: int, bits: int) -> torch.Tensor:
    """``[..., N]`` codes -> packed bytes: ``per_word`` codes a 24-bit word
    (3 bytes), little-endian bit order.  Serves the fp6 (4 x 6 b) and
    fp12 (2 x 12 b) layouts.  The words are int32 (24 bits fit)."""
    g = u.int().reshape(*u.shape[:-1], -1, per_word)
    word = g[..., 0]
    for i in range(1, per_word):
        word = word | (g[..., i] << (bits * i))
    b = torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                    dim=-1).to(torch.uint8)
    return b.reshape(*u.shape[:-1], -1)


def _unpack_codes(p: torch.Tensor, per_word: int, bits: int) -> torch.Tensor:
    """``[..., 3M]`` bytes -> ``[..., per_word * M]`` int32 codes.  Each
    word's three bytes are copied beside a zero byte and read as one
    little-endian int32 (the byte order of the CPU and the card), and every
    code of a word comes out of one broadcast shift (the shifts are the
    format's device table)."""
    shifts = minifloat_tables(MINIFLOAT_BY_BITS[bits], p.device)["shifts"]
    b = p.reshape(*p.shape[:-1], -1, 3)
    w4 = torch.zeros(*b.shape[:-1], 4, dtype=torch.uint8, device=p.device)
    w4[..., :3] = b
    word = w4.view(torch.int32)                         # [..., M, 1]
    codes = (word >> shifts) & ((1 << bits) - 1)
    return codes.reshape(*p.shape[:-1], -1)


# layout -> (fmt, codes per 24-bit word, code bits)
_PACKED_MINIFLOAT = {
    "rowwise6": ("fp6_e3m2", 4, 6),
    "rowwise12": ("fp12_e4m7", 2, 12),
}


def minifloat_layout(bits: int, shape: Sequence[int]) -> Optional[str]:
    """The packed row-wise layout of a ``bits``-bit minifloat weight of
    ``shape``: "rowwise6" / "rowwise12" when its trailing dim divides into
    24-bit words, else None (the emulated grouped codes, or no minifloat
    width)."""
    for layout, (_, per_word, b) in _PACKED_MINIFLOAT.items():
        if b == bits and shape[-1] % per_word == 0:
            return layout
    return None


def minifloat_payload_bytes(bits: int, shape: Sequence[int],
                            layout: Optional[str]) -> int:
    """Bytes of a ``bits``-bit minifloat payload of ``shape`` in
    ``layout`` (a packed one, or None: the emulated codes), scales aside:
    bits / 8 a weight packed, the container's width emulated."""
    n = math.prod(shape)
    if layout is not None:
        return n * bits // 8
    return n * _MINIFLOAT_FORMATS[MINIFLOAT_BY_BITS[bits]][2].itemsize


def _quantize_rowwise_minifloat(x: torch.Tensor, layout: str,
                                lead_dims: int = 0) -> QuantizedTensor:
    """Packed minifloat weight storage: sign-magnitude codes packed along
    the last dim, one symmetric scale per leading row (the dims up to
    and including ``lead_dims``), as the other serving layouts; fp6 =
    0.75 and fp12 = 1.5 bytes an element."""
    fmt, per_word, bits = _PACKED_MINIFLOAT[layout]
    eb, mb, _ = _MINIFLOAT_FORMATS[fmt]
    fmax = float(_minifloat_table(eb, mb)[-1])
    sign_bit = 1 << (bits - 1)
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    if orig_shape[-1] % per_word:
        raise ValueError(f"{layout} packs {per_word} codes a word: the "
                         f"trailing dim of {orig_shape} does not divide")
    if x.dim() <= lead_dims + 1:
        raise ValueError(f"{layout} needs at least one data dim beyond the "
                         f"scale rows (shape {orig_shape}, "
                         f"lead_dims={lead_dims})")
    xf = x.float()
    red = tuple(range(lead_dims + 1, x.dim()))
    scale = _div(xf.abs().amax(dim=red), fmax)
    scale = torch.where(scale == 0, 1.0, scale)          # [*lead, S]
    S = scale.shape[-1]
    sb = scale.reshape(*scale.shape, *([1] * (x.dim() - lead_dims - 1)))
    t = xf / sb
    mag = _codes_of(t, fmt)
    ucode = torch.where(t < 0, mag | sign_bit, mag)
    return QuantizedTensor(_pack_codes(ucode, per_word, bits),
                           scale.reshape(*scale.shape[:lead_dims], S, 1),
                           None, eb + mb + 1, orig_shape, orig_dtype,
                           layout=layout)


def _dequantize_rowwise_minifloat(qt: QuantizedTensor,
                                  dtype: Optional[torch.dtype] = None
                                  ) -> torch.Tensor:
    """Unpack the codes, look up their signed values (fp32), times the
    row's scale in fp32, cast to ``dtype``."""
    fmt, per_word, bits = _PACKED_MINIFLOAT[qt.layout]
    packed = minifloat_tables(fmt, qt.data.device)["packed"]
    codes = _unpack_codes(qt.data, per_word, bits)
    s = qt.scale.reshape(qt.scale.shape[:-1])            # [*lead, S]
    val = packed[codes].reshape(*s.shape, -1, codes.shape[-1])
    return (val * s[..., None, None]).reshape(qt.shape).to(dtype or qt.dtype)


def quantize_rowwise6(x: torch.Tensor, lead_dims: int = 0) -> QuantizedTensor:
    return _quantize_rowwise_minifloat(x, "rowwise6", lead_dims)


def dequantize_rowwise6(qt: QuantizedTensor,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return _dequantize_rowwise_minifloat(qt, dtype)


def quantize_rowwise12(x: torch.Tensor,
                       lead_dims: int = 0) -> QuantizedTensor:
    return _quantize_rowwise_minifloat(x, "rowwise12", lead_dims)


def dequantize_rowwise12(qt: QuantizedTensor,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return _dequantize_rowwise_minifloat(qt, dtype)


def selective_dequantize(qt: QuantizedTensor, rows,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dequantize only the selected first-dim rows of a grouped
    QuantizedTensor (e.g. the routed experts' weights).  The groups must
    not straddle rows (the row size a multiple of the group size), which
    ``default_groups`` gives whenever the first dim divides the group
    count."""
    n_rows = qt.shape[0]
    G = qt.data.shape[0]
    if G % n_rows:
        raise ValueError(
            f"groups ({G}) must align with rows ({n_rows}) for "
            "selective dequantize; quantize with num_groups a multiple "
            "of the first dim")
    gpr = G // n_rows                       # groups per row
    rows = torch.as_tensor(rows, dtype=torch.long, device=qt.data.device)
    gidx = (rows[:, None] * gpr + torch.arange(
        gpr, device=rows.device)[None, :]).reshape(-1)
    sub = QuantizedTensor(
        qt.data[gidx], qt.scale[gidx],
        None if qt.zero is None else qt.zero[gidx],
        qt.bits, (int(rows.shape[0]),) + tuple(qt.shape[1:]), qt.dtype)
    return dequantize_any(sub, dtype)
