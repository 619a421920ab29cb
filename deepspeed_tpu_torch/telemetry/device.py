"""Device observability for the port (docs/OBSERVABILITY.md "Device &
compiler telemetry"): per-program cost figures, the derived
achieved-utilization gauges (``serving_mfu`` / ``serving_hbm_bw_util``,
computed at *read* time from the step-timing counters, never on the hot
path), and the CUDA caching allocator's memory statistics polled at
phase boundaries.

Counterpart of the JAX package's ``telemetry/device.py``.  What differs:

* **No compiler cost analysis.**  A CUDA graph has no
  ``cost_analysis()``, and ``torch.utils.flop_counter`` does not see the
  port's ctypes kernels.  The engine reckons each captured graph's
  flops and bytes from the shapes of the step it was captured from
  (:func:`step_cost`: the weights read once, 2 x params x tokens,
  attention over the keys the step's rows see) and hands the figures to
  :meth:`DeviceTelemetry.probe_program`, once per captured graph, never
  on the replay path.
* **Peaks by card name.**  The published bf16 dense peak and memory
  rate come from the port's own table keyed by
  ``torch.cuda.get_device_name()``; an unknown card (and the CPU) has
  none, and the gauges stay absent.
* **Memory from the caching allocator.**  :func:`poll_memory_stats`
  reads ``torch.cuda.memory_stats`` (current and peak allocated bytes)
  and ``torch.cuda.mem_get_info`` (the card's capacity); on the CPU it
  returns nothing, as the JAX module does there.

Zero cost when off: an engine with device telemetry disabled constructs
no :class:`DeviceTelemetry` (no reckoning, no polls, no clock reads).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..utils.logging import logger
from .metrics import MetricsRegistry

# bf16 dense peak FLOP/s and memory rate (bytes/s) by card, matched in
# order by substring against the lower-cased device name (an H100 SXM
# names itself "NVIDIA H100 80GB HBM3"); unknown cards and the CPU have
# no entry, and their gauges stay absent
PEAK_FLOPS = (("h100 pcie", 756e12), ("h100", 989e12))
PEAK_HBM_BW = (("h100 pcie", 2.0e12), ("h100", 3.35e12))


def _match_peak(table, kind: str) -> Optional[float]:
    kind = (kind or "").lower()
    for k, v in table:
        if k in kind:
            return v
    return None


def _default_device():
    """The current card, or None without one (no CUDA call is made on a
    machine without a card)."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    import torch
    dev = device if device is not None else _default_device()
    if dev is None or torch.device(dev).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(torch.device(dev))


def peak_flops(device=None) -> Optional[float]:
    """Published bf16 dense peak FLOP/s of ``device`` (default: the
    current card); None when unknown: the CPU has no honest peak, and a
    made-up one would make the MFU gauge a lie."""
    return _match_peak(PEAK_FLOPS, device_kind(device))


def peak_hbm_bw(device=None) -> Optional[float]:
    """Published memory rate (bytes/s); None when unknown."""
    return _match_peak(PEAK_HBM_BW, device_kind(device))


def step_cost(param_count: int, weight_bytes: int, tokens: int,
              attn_pairs: int, kv_keys: int, layers: int, heads: int,
              kv_heads: int, head_dim: int,
              kv_elem_bytes: float) -> Dict[str, float]:
    """The flops and bytes of one serving step reckoned from its shapes:
    ``2 * param_count * tokens`` for the projections and the head plus
    ``4 * heads * head_dim`` per (token, key) pair the attention scores
    (``attn_pairs``, per layer); the weights read once
    (``weight_bytes``) plus each cached key and value of the step's
    sequences read once (``kv_keys`` positions, per layer)."""
    flops = 2.0 * param_count * tokens \
        + 4.0 * heads * head_dim * attn_pairs * layers
    kv_read = 2.0 * kv_heads * head_dim * kv_elem_bytes * kv_keys * layers
    return {"flops": flops, "bytes_accessed": float(weight_bytes) + kv_read}


def poll_memory_stats() -> Dict[str, Dict[str, int]]:
    """The caching allocator's figures for every card this process has
    touched, keyed by device index: current and peak allocated bytes,
    and the card's capacity.  Nothing on a machine without a card, or
    before CUDA was initialised (the probe never starts a context)."""
    import torch
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            s = torch.cuda.memory_stats(i)
            _, total = torch.cuda.mem_get_info(i)
        except RuntimeError as e:
            logger.debug("memory_stats unavailable on cuda:%d: %r", i, e)
            continue
        out[str(i)] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
    return out


class DeviceTelemetry:
    """The gated half of device observability for ONE engine: the
    program cost table, per-dispatch flop/byte accumulation, the derived
    utilization gauges and memory polling.  Constructed ONLY when device
    telemetry is enabled.

    ``prefix``: ``"serving"`` or ``"training"``.  ``step_ms_fn``:
    zero-arg callable returning the cumulative device-busy milliseconds
    the gauges divide by (read at export time, so the hot path takes no
    new clock reads).  ``peak_flops`` / ``peak_hbm_bw``: explicit
    overrides, default the table's entry for ``device`` (None leaves the
    gauge absent)."""

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 step_ms_fn, peak_flops: Optional[float] = None,
                 peak_hbm_bw: Optional[float] = None, device=None):
        self.registry = registry
        self.prefix = prefix
        self._step_ms_fn = step_ms_fn
        kind = device_kind(device)
        self.peak_flops = peak_flops if peak_flops is not None \
            else _match_peak(PEAK_FLOPS, kind)
        self.peak_hbm_bw = peak_hbm_bw if peak_hbm_bw is not None \
            else _match_peak(PEAK_HBM_BW, kind)
        if self.peak_flops is None:
            logger.warning(
                "device telemetry: no published peak for device %r — "
                "%s_mfu/%s_hbm_bw_util gauges stay absent", kind, prefix,
                prefix)
        # program key -> {"flops", "bytes_accessed", ...}
        self.program_costs: Dict[Any, Dict[str, float]] = {}
        self._c_flops = registry.counter(
            f"{prefix}_model_flops_total",
            "model FLOPs dispatched, attributed from each program's "
            "shape-reckoned cost")
        self._c_bytes = registry.counter(
            f"{prefix}_hbm_bytes_total",
            "device memory bytes accessed by dispatched programs, "
            "attributed from each program's shape-reckoned cost")
        registry.gauge_fn(
            f"{prefix}_mfu", self._mfu,
            "achieved model-FLOPs utilization over the measured steps "
            "(reckoned flops / device-busy time / published peak; absent "
            "without a published peak)")
        registry.gauge_fn(
            f"{prefix}_hbm_bw_util", self._bw_util,
            "achieved memory-bandwidth utilization (reckoned bytes / "
            "device-busy time / published peak rate; absent when "
            "unavailable)")
        # memory gauges register on the first poll that returns data, so
        # the CPU exports no fake zero series
        self._mem_registered = False
        self._warned_mem = False

    # ---- program costs -------------------------------------------------
    def probe_program(self, key, reckon: Callable[[], Dict[str, float]]
                      ) -> Dict[str, float]:
        """Record one program's cost (memoized by ``key``): ``reckon()``
        returns its ``flops`` / ``bytes_accessed``.  The engine calls
        this once per captured graph, outside the replay path."""
        cached = self.program_costs.get(key)
        if cached is not None:
            return cached
        cost = dict(reckon())
        self.program_costs[key] = cost
        return cost

    def on_dispatch(self, key, n: int = 1) -> None:
        """Attribute ``n`` dispatched executions of program ``key``."""
        cost = self.program_costs.get(key)
        if not cost:
            return
        f = cost.get("flops")
        b = cost.get("bytes_accessed")
        if f:
            self._c_flops.inc(f * n)
        if b:
            self._c_bytes.inc(b * n)

    # ---- derived utilization gauges (read time) ------------------------
    def _busy_s(self) -> Optional[float]:
        try:
            ms = float(self._step_ms_fn())
        except Exception:  # tpulint: disable=silent-except — a dead engine's counters read as no sample
            return None
        return ms / 1e3 if ms > 0 else None

    def _mfu(self) -> Optional[float]:
        busy = self._busy_s()
        flops = self._c_flops.value()
        if busy is None or not flops or not self.peak_flops:
            return None
        return flops / busy / self.peak_flops

    def _bw_util(self) -> Optional[float]:
        busy = self._busy_s()
        nbytes = self._c_bytes.value()
        if busy is None or not nbytes or not self.peak_hbm_bw:
            return None
        return nbytes / busy / self.peak_hbm_bw

    # ---- memory accounting ---------------------------------------------
    def poll_memory(self) -> Dict[str, Dict[str, int]]:
        """Poll the allocator for every card and publish the per-device
        gauges.  Called at phase boundaries only (health checks, dumps),
        never per step; without a card this warns once and the gauges
        stay absent."""
        stats = poll_memory_stats()
        if not stats:
            if not self._warned_mem:
                self._warned_mem = True
                logger.warning(
                    "device telemetry: no CUDA memory statistics here — "
                    "%s_hbm_* gauges stay absent", self.prefix)
            return stats
        if not self._mem_registered:
            self._mem_registered = True
            p = self.prefix
            self._g_in_use = self.registry.gauge(
                f"{p}_hbm_bytes_in_use", "device bytes allocated at the "
                "last phase-boundary poll")
            self._g_peak = self.registry.gauge(
                f"{p}_hbm_peak_bytes_in_use", "peak device bytes allocated")
            self._g_limit = self.registry.gauge(
                f"{p}_hbm_bytes_limit", "device memory capacity")
        for did, s in stats.items():
            self._g_in_use.set(s["bytes_in_use"], device=did)
            self._g_peak.set(s["peak_bytes_in_use"], device=did)
            self._g_limit.set(s["bytes_limit"], device=did)
        return stats

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able summary: per-program costs, the derived
        utilizations (None when absent) and the last memory poll."""
        mfu = self._mfu()
        bw = self._bw_util()
        return {
            "programs": {self._key_str(k): dict(v)
                         for k, v in self.program_costs.items()},
            "model_flops_total": self._c_flops.value(),
            "hbm_bytes_total": self._c_bytes.value(),
            "mfu": None if mfu is None else round(mfu, 6),
            "hbm_bw_util": None if bw is None else round(bw, 6),
            "peak_flops": self.peak_flops,
            "peak_hbm_bw": self.peak_hbm_bw,
            "memory": self.poll_memory(),
        }

    @staticmethod
    def _key_str(key) -> str:
        return key if isinstance(key, str) else repr(key)
