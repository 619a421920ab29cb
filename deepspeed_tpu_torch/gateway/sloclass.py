"""SLO classes: the wire's name for a (priority, deadline) pair.

The overload policy (inference/overload.py) has spoken ``priority`` /
``deadline_ms`` already, but nothing on the outside ever produced
them — callers passed raw integers.  The gateway closes that loop: a
client names a *class* (``x-slo-class: interactive``) and the class map
supplies the admission defaults, so the wire contract is "what kind of
request is this", not "which scheduler knob do I turn".  Explicit
``priority`` / ``deadline_ms`` fields in the request body still win —
the class only fills what the client left unsaid
(docs/SERVING.md "Network gateway").

Copied from the JAX package's ``gateway/sloclass.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# the request header naming the class (case-insensitive, like all
# HTTP header names; values are matched case-sensitively — classes
# are identifiers, not prose)
SLO_CLASS_HEADER = "x-slo-class"


@dataclasses.dataclass(frozen=True)
class SloClass:
    """One wire-visible service class -> admission defaults.

    ``priority``: nice-level semantics (lower = more important),
    handed to ``engine.put(priority=)`` verbatim.  ``deadline_ms``:
    relative deadline from arrival (None = no deadline) — the producer
    ``OverloadConfig`` always wanted and never had."""
    name: str
    priority: int
    deadline_ms: Optional[float]


def default_slo_classes() -> Dict[str, SloClass]:
    """The stock three-tier map (override via
    ``GatewayConfig.slo_classes``): ``interactive`` — human-waiting
    traffic, top tier, tight deadline so an overloaded engine sheds it
    honestly instead of serving it late; ``standard`` — the default
    tier; ``batch`` — background tier, no deadline, first to be
    preempted/degraded under pressure."""
    return {
        "interactive": SloClass("interactive", priority=0,
                                deadline_ms=30_000.0),
        "standard": SloClass("standard", priority=1, deadline_ms=None),
        "batch": SloClass("batch", priority=2, deadline_ms=None),
    }


def resolve_slo(header_value: Optional[str],
                classes: Dict[str, SloClass],
                default_class: str,
                priority: Optional[int],
                deadline_ms: Optional[float],
                ) -> Tuple[int, Optional[float], str]:
    """Fold the ``x-slo-class`` header and the body's explicit fields
    into the ``(priority, deadline_ms)`` pair ``engine.put`` takes.

    Resolution order: explicit body field > class default.  An unknown
    class name is a client error (the caller maps the raised
    ``KeyError`` to HTTP 400) — silently serving an unknown class at
    some default tier would hide client-side typos forever.  Returns
    ``(priority, deadline_ms, class_name)``."""
    name = header_value if header_value is not None else default_class
    if name not in classes:
        raise KeyError(name)
    cls = classes[name]
    return (cls.priority if priority is None else int(priority),
            cls.deadline_ms if deadline_ms is None else float(deadline_ms),
            name)
