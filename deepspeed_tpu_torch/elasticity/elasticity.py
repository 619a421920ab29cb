"""Elastic training: device-count-compatible batch size planning.

Counterpart of ``deepspeed_tpu/elasticity/elasticity.py``, copied (it is
pure Python): candidate batch composition, the valid device counts of a
batch, ``compute_elastic_config`` (the v0.1 plan, and v0.2's plan at node
granularity under model parallelism) and the fingerprint that keeps the
elasticity block fixed across restarts.  Membership changes restart the
job (the launcher's ``--elastic_training`` loop) and the script resumes
from its checkpoint, so elasticity reduces to planning: a train batch
size divisible under every admissible device count.  The training engine
accepts the ``elasticity`` block and reads none of it, as the JAX engine
does.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Sequence, Tuple

from ..utils.logging import logger

LATEST_ELASTICITY_VERSION = 0.2


class ElasticityError(ValueError):
    pass


def get_candidate_batch_sizes(base_list: Sequence[int],
                              max_acc_step: int) -> List[int]:
    """All micro_batch * gas products under the cap
    (reference: elasticity.py:83 get_candidate_batch_sizes)."""
    out = set()
    for base in base_list:
        for acc in range(1, max_acc_step + 1):
            out.add(base * acc)
    return sorted(out)


def get_valid_devices(batch_size: int, micro_batches: Sequence[int],
                      min_devices: int, max_devices: int) -> List[int]:
    """Device counts that evenly tile ``batch_size`` with some micro batch
    (reference: elasticity.py:126 get_valid_gpus)."""
    valid = set()
    for mb in micro_batches:
        if batch_size % mb:
            continue
        replicas = batch_size // mb
        for n in range(min_devices, max_devices + 1):
            if replicas % n == 0:
                valid.add(n)
    return sorted(valid)


def _best_candidate(candidates: Sequence[int], micro_batches: Sequence[int],
                    min_devices: int, max_devices: int,
                    prefer_larger: bool) -> Tuple[int, List[int]]:
    best_batch, best_valid = -1, []
    for b in sorted(candidates, reverse=prefer_larger):
        valid = get_valid_devices(b, micro_batches, min_devices, max_devices)
        if len(valid) > len(best_valid) or (
                len(valid) == len(best_valid) and best_batch < 0):
            best_batch, best_valid = b, valid
    if best_batch < 0 or not best_valid:
        raise ElasticityError(
            f"no compatible batch size for micro_batches={micro_batches} "
            f"devices [{min_devices}, {max_devices}]")
    return best_batch, best_valid


def compute_elastic_config(ds_config: Dict, target_deviation: float = 0.0,
                           world_size: int = 0):
    """(reference: elasticity.py:233 compute_elastic_config).

    Returns ``(final_batch_size, valid_device_counts, micro_batch)`` —
    micro batch only when ``world_size`` is given.
    """
    ecfg = ds_config.get("elasticity", {})
    if not ecfg.get("enabled", False):
        raise ElasticityError("elasticity block missing or disabled")
    version = float(ecfg.get("version", LATEST_ELASTICITY_VERSION))
    micro_batches = list(ecfg.get("micro_batch_sizes", [2, 4, 6]))
    max_batch = int(ecfg.get("max_train_batch_size", 2000))
    min_dev = int(ecfg.get("min_devices", ecfg.get("min_gpus", 1)))
    max_dev = int(ecfg.get("max_devices", ecfg.get("max_gpus", 10000)))
    prefer_larger = bool(ecfg.get("prefer_larger_batch", True))
    if version not in (0.1, 0.2):
        raise ElasticityError(f"unknown elasticity version {version}")
    if any(mb <= 0 for mb in micro_batches):
        raise ElasticityError(f"bad micro_batch_sizes {micro_batches}")

    if version >= 0.2:
        return _plan_v02(ecfg, micro_batches, max_batch, min_dev, max_dev,
                         prefer_larger, world_size)
    final_batch, valid = _plan_v01(micro_batches, max_batch, min_dev,
                                   max_dev, prefer_larger)
    if world_size > 0:
        if world_size not in valid:
            raise ElasticityError(
                f"world size {world_size} incompatible with elastic batch "
                f"{final_batch} (valid: {valid})")
        for mb in sorted(micro_batches, reverse=True):
            if final_batch % (mb * world_size) == 0:
                return final_batch, valid, mb
        raise ElasticityError(
            f"no micro batch fits batch={final_batch} world={world_size}")
    return final_batch, valid


def _plan_v01(micro_batches: Sequence[int], max_batch: int, min_dev: int,
              max_dev: int, prefer_larger: bool) -> Tuple[int, List[int]]:
    """v0.1 heuristic (reference: _get_compatible_gpus_v01): every
    micro batch scaled by every accumulation step up to the cap; keep
    the candidate with the most compatible device counts.  (The
    reference also seeds the LCM of the micro batches, but every
    lcm*k <= cap is already generated as min(micro)*k', so the extra
    base is provably redundant.)"""
    max_acc = max_batch // min(micro_batches)
    candidates = [b for b in
                  get_candidate_batch_sizes(micro_batches, max_acc)
                  if b <= max_batch]
    return _best_candidate(candidates, micro_batches, min_dev, max_dev,
                           prefer_larger)


def _plan_v02(ecfg: Dict, micro_batches: Sequence[int], max_batch: int,
              min_dev: int, max_dev: int, prefer_larger: bool,
              world_size: int):
    """v0.2 (reference: _get_compatible_gpus_v02): model-parallel-aware
    planning at NODE granularity — each node contributes
    ``devices_per_node // model_parallel_size`` data replicas, so the
    v0.1 search runs over node counts with the batch cap scaled down by
    the per-node DP degree, then scales back to device counts."""
    mp = int(ecfg.get("model_parallel_size", 1))
    dpn = int(ecfg.get("devices_per_node",
                       ecfg.get("num_gpus_per_node", 1)))
    if dpn % mp:
        raise ElasticityError(
            f"elasticity v0.2: devices_per_node={dpn} must divide by "
            f"model_parallel_size={mp}")
    dp_per_node = dpn // mp
    max_nodes = max_dev // dpn
    if max_nodes < 1:
        raise ElasticityError(
            f"elasticity v0.2: max_devices={max_dev} cannot fit one "
            f"{dpn}-device node")
    min_nodes = max(-(-min_dev // dpn), 1)      # ceiling: respect floor
    node_batch, valid_nodes = _plan_v01(
        micro_batches, max_batch // dp_per_node,
        min_nodes, max_nodes, prefer_larger)
    final_batch = node_batch * dp_per_node
    valid = [n * dpn for n in valid_nodes]
    if world_size > 0:
        if world_size not in valid:
            raise ElasticityError(
                f"world size {world_size} incompatible with elastic batch "
                f"{final_batch} (valid device counts: {valid})")
        dp_world = world_size // mp
        micro = None
        for mb in micro_batches:
            if (final_batch // dp_world) % mb == 0:
                if micro is None or (mb > micro if prefer_larger
                                     else mb < micro):
                    micro = mb
        if micro is None:
            raise ElasticityError(
                f"no micro batch fits batch={final_batch} "
                f"world={world_size} mp={mp}")
        return final_batch, valid, micro
    return final_batch, valid


def elasticity_fingerprint(ds_config: Dict) -> str:
    """Hash of the elasticity block — runs must not silently change it
    (reference: elasticity.py:208 enforced immutability)."""
    blob = json.dumps(ds_config.get("elasticity", {}), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def ensure_immutable(ds_config: Dict, recorded_fingerprint: str) -> None:
    fp = elasticity_fingerprint(ds_config)
    if fp != recorded_fingerprint:
        raise ElasticityError(
            "elasticity config changed across runs "
            f"({recorded_fingerprint} -> {fp}); elastic jobs must keep it "
            "fixed so every restart computes the same batch plan")
