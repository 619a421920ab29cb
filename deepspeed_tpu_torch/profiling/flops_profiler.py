"""FLOPs / params / latency profiler.

Counterpart of ``deepspeed_tpu/profiling/flops_profiler.py``, which reads
XLA's cost analysis of the compiled step.  Here the step runs once under
``torch.utils.flop_counter.FlopCounterMode`` (:func:`count_flops`),
which counts every matrix product the dispatcher sees as 2 x M x N x K.
The port's kernels are ctypes calls the dispatcher does not see, so:

* flash attention's forward, dq and dk/dv are custom ops with flop
  formulas (``ops.flash_attention.flash_products_flops``: the causal
  products of ``chip_smoke.flash_bound``);
* the paged attention (K2) and the mixed-input GEMM (K3) wrappers add
  their reckoned flops to the open count when they launch on the card
  (:func:`note_kernel_flops`: K2 2 products of 2 x H x D x context per
  token, K3 2 x M x K x N); on the CPU the count sees their plain
  versions' own products.

The string helpers are the JAX package's, copied as they are.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import logger


# ---- formatting helpers ------------------------------------------------------

def number_to_string(num: float, units: Optional[str] = None,
                     precision: int = 2) -> str:
    scale = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "": 1.0}
    if units is None:
        for units, s in scale.items():
            if abs(num) >= s and s > 1:
                break
        else:
            units = ""
    return f"{num / scale[units]:.{precision}f} {units}".rstrip()


def flops_to_string(flops: float, units=None, precision: int = 2) -> str:
    return number_to_string(flops, units, precision) + "FLOPs"


def params_to_string(n: float, units=None, precision: int = 2) -> str:
    return number_to_string(n, units, precision).rstrip() + ""


def macs_to_string(macs: float, units=None, precision: int = 2) -> str:
    return number_to_string(macs, units, precision) + "MACs"


def duration_to_string(seconds: float, precision: int = 2) -> str:
    if seconds >= 1:
        return f"{seconds:.{precision}f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.{precision}f} ms"
    return f"{seconds * 1e6:.{precision}f} us"


# ---- counting ------------------------------------------------------------------

# the open counts (innermost last): kernel name -> flops the dispatcher
# could not see
_ACTIVE: List[Dict[str, float]] = []


def note_kernel_flops(name: str, flops: float) -> None:
    """A kernel wrapper's launch on the card, ``flops`` reckoned from its
    shapes, added to the innermost open :func:`count_flops`."""
    if _ACTIVE:
        _ACTIVE[-1][name] = _ACTIVE[-1].get(name, 0.0) + float(flops)


class FlopCount:
    """What :func:`count_flops` counted: ``total`` and ``by_op`` (the
    dispatcher ops' names and the kernels')."""

    def __init__(self):
        self.by_op: Dict[str, float] = {}

    @property
    def total(self) -> float:
        return float(sum(self.by_op.values()))


@contextlib.contextmanager
def count_flops():
    """Count the flops of what runs inside (forward and backward), as a
    :class:`FlopCount` filled in on exit."""
    from torch.utils.flop_counter import FlopCounterMode
    out = FlopCount()
    kernels: Dict[str, float] = {}
    mode = FlopCounterMode(display=False)
    _ACTIVE.append(kernels)
    try:
        with mode:
            yield out
    finally:
        _ACTIVE.remove(kernels)
        for op, n in mode.get_flop_counts().get("Global", {}).items():
            out.by_op[str(op)] = out.by_op.get(str(op), 0.0) + float(n)
        for name, n in kernels.items():
            out.by_op[name] = out.by_op.get(name, 0.0) + n


def _sync(args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            torch.cuda.synchronize(a.device)
            return


def analyze_fn(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args)`` once under :func:`count_flops`: ``{"flops"}``
    (the JAX package reads its compiled program's cost analysis instead;
    there is no compiled program here to ask)."""
    with count_flops() as c:
        fn(*args, **kwargs)
    return {"flops": c.total}


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall seconds of a call, the card synchronised after each."""
    for _ in range(warmup):
        fn(*args)
        _sync(args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return int(np.prod(tuple(tree.shape))) if hasattr(tree, "shape") else 0


class FlopsProfiler:
    """Profile one step function::

        prof = FlopsProfiler()
        stats = prof.profile(step_fn, state, batch)
        print(prof.report(stats))
    """

    def __init__(self, config=None):
        self.config = config

    def profile(self, fn: Callable, *args, params: Any = None,
                time_it: bool = True) -> Dict[str, float]:
        stats = analyze_fn(fn, *args)
        if params is not None:
            stats["params"] = float(_numel(params))
        if time_it:
            stats["latency_s"] = time_fn(fn, *args)
            if stats.get("flops"):
                stats["tflops_per_s"] = (
                    stats["flops"] / stats["latency_s"] / 1e12)
        return stats

    @staticmethod
    def report(stats: Dict[str, float], batch_size: Optional[int] = None,
               world_size: int = 1) -> str:
        lines = ["-" * 60, "DeepSpeed-TPU Flops Profiler", "-" * 60]
        if "params" in stats:
            lines.append(f"params:               "
                         f"{params_to_string(stats['params'])}")
        if "flops" in stats:
            lines.append(f"flops per step:       "
                         f"{flops_to_string(stats['flops'])}")
        if "bytes_accessed" in stats:
            lines.append(f"HBM bytes per step:   "
                         f"{number_to_string(stats['bytes_accessed'])}B")
        if "latency_s" in stats:
            lines.append(f"step latency:         "
                         f"{duration_to_string(stats['latency_s'])}")
        if "tflops_per_s" in stats:
            lines.append(f"achieved throughput:  "
                         f"{stats['tflops_per_s']:.2f} TFLOPS/device")
        if batch_size and "latency_s" in stats:
            sps = batch_size / stats["latency_s"]
            lines.append(f"samples/second:       {sps:.1f}")
        lines.append("-" * 60)
        return "\n".join(lines)


def get_model_profile(fn: Callable, args: Tuple = (), kwargs=None,
                      print_profile: bool = True,
                      as_string: bool = True):
    """(flops, macs, params) of one call of ``fn``."""
    kwargs = kwargs or {}
    prof = FlopsProfiler()
    stats = prof.profile(lambda *a: fn(*a, **kwargs), *args, time_it=False)
    flops = stats.get("flops", 0.0)
    macs = flops / 2
    params = stats.get("params", 0.0)
    if print_profile:
        logger.info("\n%s", prof.report(stats))
    if as_string:
        return (flops_to_string(flops), macs_to_string(macs),
                params_to_string(params))
    return flops, macs, params
