"""Low-overhead host-side telemetry (docs/OBSERVABILITY.md), the
counterpart of the JAX package's ``telemetry/``:

* :class:`SpanTracer` — ring-buffer span tracer on ``perf_counter_ns``
  with Chrome-trace / JSONL export;
* :class:`MetricsRegistry` — labeled counters / gauges / fixed-bucket
  histograms with Prometheus text exposition, JSONL snapshots and the
  ``monitor/`` fan-out;
* :class:`RequestTracker` — per-request lifecycle records;
* the flight recorder, streaming anomaly detection and SLO scorecards
  (copied: they import no JAX there);
* device telemetry on the CUDA caching allocator and shape-reckoned
  step costs, and deep-capture windows on ``torch.profiler``.
"""

from .anomaly import (AnomalyConfig, AnomalyEvent, AnomalyMonitor,
                      EwmaMadDetector, RollingPercentileDetector,
                      ThresholdDetector, default_serving_detectors,
                      default_training_detectors)
from .device import (DeviceTelemetry, peak_flops, peak_hbm_bw,
                     poll_memory_stats, step_cost)
from .flight import FlightRecorder, config_fingerprint, validate_flight_dump
from .lifecycle import (QUEUE_WAIT_BUCKETS_MS, TERMINAL_STATUSES,
                        TPOT_BUCKETS_MS, TTFT_BUCKETS_MS, RequestRecord,
                        RequestTracker)
from .metrics import (Counter, CounterDictView, FnGauge, Gauge, Histogram,
                      MetricsRegistry, parse_prometheus_text)
from .profiler import (ProfilerCapture, prime_profiler,
                       profiler_available)
from .slo import (DEFAULT_SLO_CLASS, BurnRateDetector, SloObjective,
                  SloTracker, default_slo_objectives, merge_scorecards)
from .tracer import SpanTracer

__all__ = ["SpanTracer", "MetricsRegistry", "Counter", "Gauge", "FnGauge",
           "Histogram", "CounterDictView", "parse_prometheus_text",
           "RequestTracker", "RequestRecord", "TERMINAL_STATUSES",
           "TTFT_BUCKETS_MS", "TPOT_BUCKETS_MS", "QUEUE_WAIT_BUCKETS_MS",
           "DeviceTelemetry", "step_cost", "peak_flops", "peak_hbm_bw",
           "poll_memory_stats", "FlightRecorder", "config_fingerprint",
           "validate_flight_dump", "AnomalyConfig", "AnomalyEvent",
           "AnomalyMonitor", "EwmaMadDetector", "RollingPercentileDetector",
           "ThresholdDetector", "default_serving_detectors",
           "default_training_detectors", "ProfilerCapture",
           "prime_profiler", "profiler_available", "SloObjective",
           "SloTracker", "BurnRateDetector", "DEFAULT_SLO_CLASS",
           "default_slo_objectives", "merge_scorecards"]
