"""Fleet serving: a multi-replica front-end over hardened inference
engines (docs/SERVING.md "Fleet: routing, failover, migration").

The scheduler/engine boundary split makes every placement and
migration decision portable: prompts and replicas share one
engine-independent affinity key (`placement.prompt_digests` vs
``StateManager.prefix_digests()``), and open work moves between
replicas as restore()-compatible per-request records
(``engine.snapshot_requests`` / ``migrate_out`` /
``load_snapshot(merge=True)``).

Copied from the JAX package's ``serving/__init__.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from .autoscaler import (Autoscaler, AutoscalerConfig,
                         WeightStreamColdStart)
from .fleet_telemetry import (FLEET_DUMP_VERSION, FleetRegistry,
                              FleetTelemetry, FleetTelemetryConfig,
                              default_fleet_detectors,
                              fleet_request_metrics,
                              fleet_request_records,
                              reconciled_terminal_statuses,
                              validate_fleet_dump)
from .placement import (PLACEMENT_POLICIES, REPLICA_ROLES,
                        affinity_chain_len, prompt_digests,
                        rank_replicas, split_by_pool)
from .replica import CircuitBreaker, ReplicaHandle
from .router import FleetConfig, FleetRouter

__all__ = ["FleetConfig", "FleetRouter", "ReplicaHandle",
           "CircuitBreaker", "PLACEMENT_POLICIES", "REPLICA_ROLES",
           "prompt_digests", "affinity_chain_len", "rank_replicas",
           "split_by_pool",
           "Autoscaler", "AutoscalerConfig", "WeightStreamColdStart",
           "FleetTelemetry", "FleetTelemetryConfig", "FleetRegistry",
           "default_fleet_detectors", "fleet_request_metrics",
           "fleet_request_records", "reconciled_terminal_statuses",
           "validate_fleet_dump", "FLEET_DUMP_VERSION"]
