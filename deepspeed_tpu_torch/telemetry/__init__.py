"""Host-side telemetry the serving engine needs (copied from the JAX
package's ``telemetry/``, which imports no JAX there): the metrics
registry and the request-lifecycle records.  The tracer, the
exposition, anomaly detection, the flight recorder, SLOs and device
telemetry are ROADMAP Queue 1 item 5."""

from .lifecycle import (QUEUE_WAIT_BUCKETS_MS, TERMINAL_STATUSES,
                        TPOT_BUCKETS_MS, TTFT_BUCKETS_MS, RequestRecord,
                        RequestTracker)
from .metrics import (Counter, CounterDictView, Gauge, Histogram,
                      MetricsRegistry)

__all__ = ["Counter", "CounterDictView", "Gauge", "Histogram",
           "MetricsRegistry", "QUEUE_WAIT_BUCKETS_MS", "RequestRecord",
           "RequestTracker", "TERMINAL_STATUSES", "TPOT_BUCKETS_MS",
           "TTFT_BUCKETS_MS"]
