"""Network gateway: the wire tier above the engine/fleet
(docs/SERVING.md "Network gateway").

A stdlib-asyncio HTTP/1.1 server with an OpenAI-style
``POST /v1/completions`` surface (SSE token streaming), built as a
thin translation layer: admission verdicts -> 429/503 + Retry-After,
``x-slo-class`` header -> priority/deadline defaults, client
disconnect -> ``cancel()``, ``/healthz`` -> the health ladder,
``/metrics`` -> the Prometheus exposition, SIGTERM -> ``drain()``.

Copied from the JAX package's ``gateway/__init__.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from .protocol import (CompletionRequest, ProtocolError,
                       health_status_code, parse_completion_body,
                       parse_request_head, retry_after_s, shed_decision,
                       sse_event)
from .server import (Gateway, GatewayConfig, GatewayError, GatewayHandle,
                     spawn_gateway)
from .sloclass import (SLO_CLASS_HEADER, SloClass, default_slo_classes,
                       resolve_slo)

__all__ = ["Gateway", "GatewayConfig", "GatewayError", "GatewayHandle",
           "spawn_gateway", "SloClass", "SLO_CLASS_HEADER",
           "default_slo_classes", "resolve_slo", "CompletionRequest",
           "ProtocolError", "parse_request_head", "parse_completion_body",
           "sse_event", "retry_after_s", "shed_decision",
           "health_status_code"]
