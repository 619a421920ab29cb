"""Threefry keys and the random draws the serving path samples with.

Counterpart of the slice of ``jax.random`` that the JAX package's sampler
calls (``PRNGKey``, ``split``, ``fold_in``, ``uniform``, ``gumbel``,
``categorical``), with jax's defaults: the ``threefry2x32`` generator in
its partitionable form (``jax_threefry_partitionable``).  The JAX package
keeps no module of its own for these; it calls ``jax.random`` directly.
The same key gives the same bits, uniforms and Gumbel noise here as in
jax 0.9 on the CPU, bit for bit, on the CPU and on the card: every step
below is integer arithmetic or one correctly rounded float operation.

A key is a ``[..., 2]`` int64 tensor holding the two uint32 words of a
JAX key (``np.asarray(key)``); :func:`key_from_numpy` and
:func:`key_to_numpy` carry keys across.  The words live in int64 with
every result masked to 32 bits, because ``torch.uint32`` lacks
arithmetic on some devices.  Functions that take a key accept a batch of
keys (leading dims) where noted; results then gain those dims.

Constants enter the arithmetic as Python scalars (kernel arguments) and
fp32 constants are rounded to fp32 first: nothing here copies from the
host to the card, which would synchronise the serving pipeline.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

# float32 constants as jax's uniform and gumbel use them
_ONE_BITS = 0x3F800000                       # 1.0f
_TINY = float(np.finfo(np.float32).tiny)     # smallest normal float32


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function with 20 rounds (jax
    ``_threefry2x32_lowering``): key words ``k1, k2`` and counter words
    ``x1, x2`` (int64 tensors holding uint32 values, broadcast together)
    -> the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with jax's 32-bit default types: the
    key ``[0, seed mod 2**32]``.  A key is eight bytes of data; it is
    made on the host unless ``device`` says otherwise, and the engine
    moves it to its own device."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def key_from_numpy(key) -> torch.Tensor:
    """A JAX key's words (``np.asarray(key)``, uint32 ``[..., 2]``) as a
    key of this module, on the CPU."""
    a = np.asarray(key)
    if a.dtype != np.uint32 or a.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 [..., 2] key words, got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(a.astype(np.int64))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The words of ``key`` as uint32, as ``np.asarray`` of a JAX key."""
    return key.cpu().numpy().astype(np.uint32)


def _check_key(key: torch.Tensor) -> None:
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"expected an int64 [..., 2] key, got {key.dtype} "
                         f"{tuple(key.shape)}")


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low words of the 64-bit iota 0..n-1 (jax
    ``iota_2x32_shape``)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` (the partitionable,
    fold-like form: new key i is the block function of counter i)."""
    _check_key(key)
    if key.dim() != 1:
        raise ValueError("split takes a single [2] key")
    hi, lo = _counters(num, key.device)
    y1, y2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the block function of the
    counter ``[0, data mod 2**32]``.  ``key`` [..., 2] and ``data`` (an
    int, or an integer tensor holding uint32 bits in any integer dtype)
    broadcast together."""
    _check_key(key)
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=key.device)
    data = data.to(device=key.device, dtype=torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` for 32-bit words: counter i of the
    flattened ``shape`` gives the XOR of the two output words.  ``key``
    [..., 2] -> [..., *shape] int64 (uint32 values)."""
    _check_key(key)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    hi, lo = _counters(n, key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return (y1 ^ y2).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled to ``[minval, maxval)`` and
    clamped below at ``minval``.  ``key`` [..., 2] -> [..., *shape]."""
    bits = random_bits(key, shape)
    one = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)              # an fp32 subtraction
    return _fma32(one, span, float(lo)).clamp_min(float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, its default ``mode="low"``:
    ``-log(-log(u))`` for ``u = uniform(key, shape, tiny, 1)``, with the
    logarithm jax's CPU backend computes (:func:`_log_xla`)."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -_log_xla(-_log_xla(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    Gumbel noise of ``logits.shape`` (float32 logits) plus the logits ->
    int64 indices of shape ``logits.shape[:-1]``.  One key for the whole
    array, as jax draws it."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical takes float32 logits, got "
                         f"{logits.dtype}")
    noise = gumbel(key.to(logits.device), tuple(logits.shape))
    return torch.argmax(noise + logits, dim=-1)


# --------------------------------------------------------------------------
# float32 arithmetic as jax's CPU backend emits it
# --------------------------------------------------------------------------

def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with ONE rounding (a fused multiply-add),
    from float64 operations that are exact or correctly rounded on every
    device: the product of two float32 values is exact in float64; the
    sum is rounded to odd (TwoSum gives its exact error, and an inexact
    sum with an even last bit steps one unit toward it), and a
    round-to-odd result with 29 spare bits rounds to the nearest float32
    exactly as the exact sum would.  ``b`` and ``c`` are float32 tensors
    or Python floats holding float32 values."""
    as64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    p = a.double() * as64(b)
    cd = as64(c)
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).float()


# Cephes' logf polynomial, as XLA's CPU backend evaluates log: the
# mantissa is reduced to [sqrt(1/2) - 1, sqrt(2) - 1), a degree-8
# polynomial in three interleaved parts by fused multiply-adds, and the
# exponent added back in two parts of log(2)
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)


def _log_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit for bit the value jax's CPU backend gives,
    for positive finite ``x`` (the only inputs :func:`gumbel` feeds it;
    zero, negative and non-finite inputs are not handled)."""
    x = x.float().clamp_min(_TINY)                    # no subnormals
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    # x > 0: the sign bit is clear
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _SQRT_HALF
    m = torch.where(small, m + m - 1.0, m - 1.0)      # exact
    e = torch.where(small, e - 1.0, e)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(m, p[0], p[1])
    y1 = _fma32(m, p[3], p[4])
    y2 = _fma32(m, p[6], p[7])
    y = _fma32(y, m, p[2])
    y1 = _fma32(y1, m, p[5])
    y2 = _fma32(y2, m, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * _LOG_Q1)
    return (m - 0.5 * x2 + y) + e * _LOG_Q2
