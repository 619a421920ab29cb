"""Per-collective latency/size logging with algbw/busbw accounting.

Carries over the reference's comms profiling design
(``deepspeed/utils/comms_logging.py:34`` bandwidth math, ``comm/comm.py:422``
``log_summary`` with straggler detection) — the one part of the NCCL comm
stack the survey marked "worth keeping" verbatim in spirit (SURVEY.md §2.3).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List

from ..utils.logging import log_dist, logger


def convert_size(size_bytes: float) -> str:
    if size_bytes == 0:
        return "0B"
    names = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    return f"{round(size_bytes / p, 2)} {names[i]}"


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float, n: int) -> tuple:
    """algbw/busbw for a collective over ``n`` participants.

    Bus-bandwidth correction factors follow the standard NCCL accounting the
    reference uses (utils/comms_logging.py:34): ring all-gather /
    reduce-scatter move (n-1)/n of the data per link; all-reduce moves
    2(n-1)/n; all-to-all and p2p move the full payload.
    """
    duration_s = max(duration_s, 1e-9)
    algbw = size_bytes / duration_s  # bytes/s
    if comm_op in ("all_gather", "reduce_scatter", "all_gather_into_tensor",
                   "reduce_scatter_tensor"):
        busbw = algbw * (n - 1) / max(n, 1)
    elif comm_op in ("all_reduce", "psum"):
        busbw = algbw * 2 * (n - 1) / max(n, 1)
    else:  # all_to_all, broadcast, send/recv, ppermute
        busbw = algbw
    # report in Gbps like the reference
    return algbw * 8 / 1e9, busbw * 8 / 1e9


class CommsLogger:
    """Accumulates per-op records; ``log_summary`` prints the table
    (reference: comm/comm.py:422)."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, prof_ops: List[str] = None, debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.debug = debug
        # op_name -> msg_size -> [count, total_lat_s, total_algbw, total_busbw]
        self.comms_dict: Dict[str, Dict[int, List[float]]] = defaultdict(dict)
        # optional PR-5 metrics mirror (attach_registry)
        self._c_time = self._c_bytes = self._c_ops = None

    def attach_registry(self, registry) -> None:
        """Mirror every profiled op record into a
        :class:`~deepspeed_tpu_torch.telemetry.metrics.MetricsRegistry` as
        ``training_comm_*`` counters (op as a label), so comm time
        reaches the Prometheus exposition and flight dumps instead of
        only the ad-hoc :meth:`log_all` table.  One registry at a time
        — the latest attach wins (this is a module singleton; the
        training engine attaches its registry at construction)."""
        self._c_time = registry.counter(
            "training_comm_time_ms_total",
            "cumulative wall ms in profiled eager collectives "
            "(comms_logger; label op)")
        self._c_bytes = registry.counter(
            "training_comm_msg_bytes_total",
            "cumulative message bytes through profiled eager "
            "collectives (comms_logger; label op)", int_valued=True)
        self._c_ops = registry.counter(
            "training_comm_ops_profiled_total",
            "profiled eager collective calls (comms_logger; label op)",
            int_valued=True)

    def configure(self, enabled=None, verbose=None, prof_all=None, prof_ops=None):
        if enabled is not None:
            self.enabled = enabled
        if verbose is not None:
            self.verbose = verbose
        if prof_all is not None:
            self.prof_all = prof_all
        if prof_ops is not None:
            self.prof_ops = prof_ops

    def should_profile(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        return self.prof_all or op_name in self.prof_ops

    def append(self, op_name: str, raw_name: str, latency_s: float,
               msg_size: int, n_participants: int) -> None:
        algbw, busbw = calc_bw_log(op_name, msg_size, latency_s, n_participants)
        if self._c_time is not None:
            self._c_time.inc(latency_s * 1e3, op=op_name)
            self._c_bytes.inc(msg_size, op=op_name)
            self._c_ops.inc(1, op=op_name)
        per_size = self.comms_dict[raw_name]
        if msg_size in per_size:
            rec = per_size[msg_size]
            rec[0] += 1
            rec[1] += latency_s
            rec[2] += algbw
            rec[3] += busbw
        else:
            per_size[msg_size] = [1, latency_s, algbw, busbw]
        if self.verbose:
            logger.info(
                f"comm op: {raw_name} | time(ms): {latency_s*1000:.2f} | "
                f"msg size: {convert_size(msg_size)} | algbw(Gbps): {algbw:.2f} | "
                f"busbw(Gbps): {busbw:.2f}")

    def log_all(self, print_log: bool = True, show_straggler: bool = False) -> Dict:
        """Summarize all recorded collectives; returns the table dict."""
        out = {}
        lines = [f"{'Comm. Op':20s} {'Message Size':>14s} {'Count':>8s} "
                 f"{'Total Lat(ms)':>14s} {'Avg Lat(ms)':>12s} "
                 f"{'tput_avg(Gbps)':>15s} {'busbw_avg(Gbps)':>16s}"]
        for op, sizes in sorted(self.comms_dict.items()):
            for size, (cnt, lat, algbw, busbw) in sorted(sizes.items()):
                avg_lat = lat / cnt
                out.setdefault(op, {})[size] = dict(
                    count=cnt, total_latency_ms=lat * 1000,
                    avg_latency_ms=avg_lat * 1000,
                    algbw_gbps=algbw / cnt, busbw_gbps=busbw / cnt)
                lines.append(
                    f"{op:20s} {convert_size(size):>14s} {cnt:>8d} "
                    f"{lat*1000:>14.2f} {avg_lat*1000:>12.2f} "
                    f"{algbw/cnt:>15.2f} {busbw/cnt:>16.2f}")
        if print_log:
            log_dist("\n".join(lines))
        return out

    def reset(self) -> None:
        self.comms_dict.clear()


# module-level singleton, configured via Config.comms_logger
comms_logger = CommsLogger()
