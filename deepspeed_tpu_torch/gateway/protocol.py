"""Wire protocol: HTTP/1.1 + SSE framing + shed-to-status translation.

Everything here is a pure function over bytes/dicts — no sockets, no
event loop, no engine — so the whole wire surface unit-tests without a
server (tests/test_gateway.py).  ``server.py`` owns the asyncio side
and calls down into these.

Design rule (docs/SERVING.md "Network gateway"): wire semantics are
*translations* of contracts the engine already exposes, never new
policy.  The one place that looks like policy — which HTTP status a
shed maps to, and what ``Retry-After`` promises — is derived entirely
from the :class:`~deepspeed_tpu_torch.inference.overload.AdmissionVerdict`
and the queue depth the gateway can see (:func:`shed_decision`).

Copied from the JAX package's ``gateway/protocol.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

# bounded request head + body: a gateway that reads unbounded client
# bytes before admission control is a memory DoS ahead of the engine's
# own shed policy
MAX_HEAD_BYTES = 16 * 1024
MAX_BODY_BYTES = 1024 * 1024

_REASONS = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}

SSE_DONE = b"data: [DONE]\n\n"


class ProtocolError(Exception):
    """A client-attributable wire error -> one HTTP error response.
    ``status`` is the HTTP code, ``code`` a machine-readable slug the
    error body carries (OpenAI-style ``{"error": {...}}``)."""

    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = int(status)
        self.code = code


# --------------------------------------------------------------------------
# request head
# --------------------------------------------------------------------------

def parse_request_head(head: bytes) -> Tuple[str, str, Dict[str, str]]:
    """Parse the request line + headers (everything before the blank
    line).  Header names are lowercased (HTTP headers are
    case-insensitive); duplicate headers keep the LAST value —
    none of the headers this surface reads are list-valued.  Raises
    :class:`ProtocolError` (400) on anything malformed."""
    if len(head) > MAX_HEAD_BYTES:
        raise ProtocolError(400, "head_too_large",
                            f"request head exceeds {MAX_HEAD_BYTES} bytes")
    try:
        text = head.decode("ascii")
    except UnicodeDecodeError as e:
        raise ProtocolError(400, "bad_head",
                            f"non-ASCII bytes in request head: {e}")
    lines = text.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ProtocolError(400, "bad_request_line",
                            f"malformed request line {lines[0]!r}")
    method, target, _version = parts
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise ProtocolError(400, "bad_header",
                                f"malformed header line {line!r}")
        headers[name.lower()] = value.strip()
    return method.upper(), target, headers


# --------------------------------------------------------------------------
# completion request body
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CompletionRequest:
    """A validated ``POST /v1/completions`` body.  The stack is
    tokenizer-free end to end (models speak token ids), so ``prompt``
    is a list of ints — exactly what ``engine.put`` takes.  ``uid`` is
    optional: the gateway assigns one when absent; an explicit uid is
    how seeded clients pin the (uid, position)-folded sampling keys for
    reproducible streams."""
    prompt: List[int]
    max_tokens: int
    stream: bool
    uid: Optional[int] = None
    priority: Optional[int] = None
    deadline_ms: Optional[float] = None
    echo: bool = False


def parse_completion_body(raw: bytes, max_tokens_default: int,
                          max_tokens_cap: int) -> CompletionRequest:
    """Validate a completions body.  Unknown fields are ignored
    (OpenAI clients send ``model``/``temperature``/... we don't act
    on); wrong *types* on fields we do act on are 400s — a silently
    coerced prompt is a corrupted request."""
    if len(raw) > MAX_BODY_BYTES:
        raise ProtocolError(413, "body_too_large",
                            f"body exceeds {MAX_BODY_BYTES} bytes")
    try:
        body = json.loads(raw.decode("utf-8") or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, "bad_json", f"body is not JSON: {e}")
    if not isinstance(body, dict):
        raise ProtocolError(400, "bad_json", "body must be a JSON object")

    prompt = body.get("prompt")
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt):
        raise ProtocolError(
            400, "bad_prompt",
            "'prompt' must be a non-empty list of token ids (ints) — "
            "this serving stack is tokenizer-free; clients tokenize")

    max_tokens = body.get("max_tokens", max_tokens_default)
    if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
            or max_tokens < 1:
        raise ProtocolError(400, "bad_max_tokens",
                            "'max_tokens' must be a positive int")
    max_tokens = min(max_tokens, max_tokens_cap)

    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise ProtocolError(400, "bad_stream", "'stream' must be a bool")

    uid = body.get("uid")
    if uid is not None and (not isinstance(uid, int)
                            or isinstance(uid, bool) or uid < 0):
        raise ProtocolError(400, "bad_uid",
                            "'uid' must be a non-negative int")

    priority = body.get("priority")
    if priority is not None and (not isinstance(priority, int)
                                 or isinstance(priority, bool)):
        raise ProtocolError(400, "bad_priority",
                            "'priority' must be an int (lower = more "
                            "important)")

    deadline_ms = body.get("deadline_ms")
    if deadline_ms is not None:
        if not isinstance(deadline_ms, (int, float)) \
                or isinstance(deadline_ms, bool) or deadline_ms <= 0:
            raise ProtocolError(400, "bad_deadline",
                                "'deadline_ms' must be a positive number")
        deadline_ms = float(deadline_ms)

    return CompletionRequest(prompt=[int(t) for t in prompt],
                             max_tokens=max_tokens, stream=stream,
                             uid=uid, priority=priority,
                             deadline_ms=deadline_ms,
                             echo=bool(body.get("echo", False)))


# --------------------------------------------------------------------------
# responses
# --------------------------------------------------------------------------

def http_response(status: int, body: bytes,
                  content_type: str = "application/json",
                  extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    """One complete non-streaming HTTP/1.1 response.  Connections are
    one-request (``Connection: close``): the gateway's unit of
    admission is the request, and close-per-request keeps disconnect
    detection unambiguous — EOF on the read side always means the
    client is gone."""
    reason = _REASONS.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}",
             f"Content-Type: {content_type}",
             f"Content-Length: {len(body)}",
             "Connection: close"]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("ascii") + body


def sse_head(extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    """The response head that opens an SSE stream (no Content-Length —
    the connection closes when the stream does)."""
    lines = ["HTTP/1.1 200 OK",
             "Content-Type: text/event-stream",
             "Cache-Control: no-store",
             "Connection: close"]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("ascii")


def sse_event(obj: Dict) -> bytes:
    """One ``data: <json>\\n\\n`` frame."""
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode(
        "utf-8") + b"\n\n"


def completion_chunk(rid: str, created: int, model: str,
                     token: Optional[int] = None,
                     finish_reason: Optional[str] = None) -> Dict:
    """One streamed completion chunk (OpenAI-shaped; ``token`` carries
    the raw token id where a tokenizer'd server would put text)."""
    return {"id": rid, "object": "text_completion.chunk",
            "created": created, "model": model,
            "choices": [{"index": 0, "token": token,
                         "finish_reason": finish_reason}]}


def completion_response(rid: str, created: int, model: str,
                        tokens: List[int], finish_reason: str,
                        prompt_tokens: int,
                        echo_prompt: Optional[List[int]] = None) -> Dict:
    """The non-streaming completion body."""
    choice = {"index": 0, "tokens": list(tokens),
              "finish_reason": finish_reason}
    if echo_prompt is not None:
        choice["prompt"] = list(echo_prompt)
    return {"id": rid, "object": "text_completion", "created": created,
            "model": model, "choices": [choice],
            "usage": {"prompt_tokens": int(prompt_tokens),
                      "completion_tokens": len(tokens)}}


def error_body(status: int, code: str, message: str) -> bytes:
    return json.dumps({"error": {"message": message, "type": "api_error"
                                 if status >= 500 else "client_error",
                                 "code": code, "status": status}}).encode(
        "utf-8")


# --------------------------------------------------------------------------
# shed translation: AdmissionVerdict -> (HTTP status, Retry-After)
# --------------------------------------------------------------------------

def retry_after_s(queue_depth: int, est_ms_per_request: float,
                  max_retry_after_s: int) -> int:
    """Computed backoff for a load shed: the time the current backlog
    needs to drain at the gateway's estimated per-request service time,
    clamped to ``[1, max_retry_after_s]``.  Deterministic in its inputs
    — the SLO tests pin the math."""
    est = math.ceil(max(queue_depth, 1) * max(est_ms_per_request, 0.0)
                    / 1e3)
    return max(1, min(int(est), int(max_retry_after_s)))


def shed_decision(verdict_status: str, verdict_reason: str,
                  queue_depth: int, est_ms_per_request: float,
                  max_retry_after_s: int,
                  drain_retry_after_s: int) -> Tuple[int, int, str]:
    """Map a non-admitted :class:`AdmissionVerdict` onto
    ``(http_status, retry_after_s, code)``.

    The split follows the verdict's own semantics, not the gateway's
    mood: a shed from the *shed policy* (bounded queue ``reject`` /
    ``evict-lowest``, or the fleet-saturation verdict — every routable
    replica's own bound rejected it, retrying after the backlog drains
    CAN help) is load -> **429** with the computed backoff; a shed
    because the engine is ``draining``/``dead`` or the fleet has **no
    routable replica at all** is availability — retrying THIS endpoint
    sooner won't help -> **503** with the drain's own horizon.  (The
    match is the phrase ``"no routable"``: the saturation reason also
    contains the word "routable" — "every routable replica shed..." —
    and that one is genuinely load.)  Anything else non-admitted
    (future verdict vocabulary) conservatively maps to 503 so clients
    back off."""
    reason = (verdict_reason or "").lower()
    if "dead" in reason or "draining" in reason \
            or "no routable" in reason:
        return 503, max(1, int(drain_retry_after_s)), "unavailable"
    if verdict_status == "shed":
        return (429,
                retry_after_s(queue_depth, est_ms_per_request,
                              max_retry_after_s),
                "overloaded")
    return 503, max(1, int(drain_retry_after_s)), "unavailable"


# --------------------------------------------------------------------------
# health ladder -> status code
# --------------------------------------------------------------------------

def health_status_code(state: str) -> int:
    """The engine health ladder -> ``/healthz`` status: ``healthy`` and
    ``degraded`` still serve (load balancers must not eject a replica
    for a transient degraded window — the body says which it is);
    ``draining`` and ``dead`` are 503 so upstreams stop routing."""
    return 200 if state in ("healthy", "degraded") else 503
