"""Named-axis process mesh over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/mesh.py``.  The JAX package lays its
devices out as one ``jax.sharding.Mesh`` with named axes and lets XLA
place every collective.  Here each process (a rank) drives one device,
and the world of ``torch.distributed`` is laid out row-major over
:data:`AXIS_ORDER`, the tensor axis innermost: rank ``r`` stands where
JAX device ``r`` stands on a row-major mesh of the same shape.  Each axis
of size > 1 gets one process group per line of ranks along it
(:meth:`MeshTopology.group`), and :meth:`MeshTopology.axis_rank` is this
rank's coordinate on an axis.

Axis names (outermost first):

* ``pipe``   — pipeline stages
* ``data``   — pure data-parallel replicas
* ``fsdp``   — ZeRO shard axis
* ``expert`` — MoE expert parallel
* ``seq``    — sequence/context parallel
* ``tensor`` — tensor parallel (per-layer all-reduce; innermost)

A sharding is a :class:`PartitionSpec`: a tuple with one entry per
tensor dim, each ``None``, an axis name or a tuple of axis names, as
JAX's ``PartitionSpec`` is, so the two compare element by element.
There is no ``NamedSharding``: a rank holds its own slice of a tensor
(``parallel.sharding.named``), not a global array.

At world size 1 with no process group, :meth:`MeshTopology.build` works
as the JAX one does on one device: every axis has size 1 and no group
exists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..config.config import MeshConfig
from ..utils.logging import log_dist

# canonical axis order, outermost first
AXIS_ORDER: Tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"

# axes over which the batch dimension is split
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, FSDP_AXIS)


class PartitionSpec(tuple):
    """One entry per tensor dim: None (not split), an axis name, or a
    tuple of axis names (split over their product, the first major).
    Trailing unsplit dims may be left out, as in JAX's spec."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


@dataclasses.dataclass
class MeshTopology:
    """Resolved mesh + conventional sharding specs.  ``mesh``: the ranks
    laid out in the mesh's shape over :data:`AXIS_ORDER` (an int array);
    ``rank``: this process's rank (0 without a process group)."""

    mesh: np.ndarray
    axis_sizes: Dict[str, int]
    rank: int = 0
    _groups: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False)
    _lines: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict, repr=False)

    # ---- constructors ----------------------------------------------------
    @classmethod
    def build(cls, config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> "MeshTopology":
        """Size the axes over ``devices`` (default: one per rank of the
        process group, or one device without a group) with the JAX
        package's inference and errors, lay the ranks out and make each
        axis's process groups (a collective call: every rank builds the
        same topology in the same order)."""
        config = config or MeshConfig()
        dist = _dist()
        world = dist.get_world_size() if dist is not None else 1
        devices = list(devices) if devices is not None else list(range(world))
        n = len(devices)
        if dist is not None and n != world:
            raise ValueError(f"{n} devices given, but the process group has "
                             f"{world} ranks (one device a rank)")

        sizes = {
            PIPE_AXIS: config.pipe,
            DATA_AXIS: config.data,
            FSDP_AXIS: config.fsdp,
            EXPERT_AXIS: config.expert,
            SEQ_AXIS: config.seq,
            TENSOR_AXIS: config.tensor,
        }
        # normalize: <=0 means infer (at most one axis may infer; default data)
        infer = [a for a, s in sizes.items() if s is None or s <= 0]
        fixed = math.prod(s for a, s in sizes.items() if a not in infer)
        if len(infer) > 1:
            raise ValueError(f"Only one mesh axis may be inferred, got {infer}")
        if infer:
            if n % fixed != 0:
                raise ValueError(
                    f"{n} devices not divisible by product of fixed axes {fixed}")
            sizes[infer[0]] = n // fixed
        total = math.prod(sizes.values())
        if total != n:
            raise ValueError(
                f"Mesh axes {sizes} multiply to {total} but there are {n} devices")

        shape = tuple(sizes[a] for a in AXIS_ORDER)
        ranks = _arrange_devices(list(range(n)), shape,
                                 config.devices_per_slice)
        topo = cls(mesh=ranks, axis_sizes=dict(sizes),
                   rank=dist.get_rank() if dist is not None else 0)
        if dist is not None:
            topo._make_groups(dist)
        global _CURRENT
        _CURRENT = topo
        log_dist(f"MeshTopology: {sizes} over {n} devices")
        return topo

    def _make_groups(self, dist) -> None:
        """One group per line of ranks along each axis, size-1 axes too
        (so that an eager collective over one rank still runs on the
        backend), made in the same order on every rank (``new_group`` is
        collective)."""
        for ai, axis in enumerate(AXIS_ORDER):
            lines = np.moveaxis(self.mesh, ai, -1).reshape(
                -1, self.axis_sizes[axis])
            for line in lines:
                line = tuple(int(r) for r in line)
                g = dist.new_group(list(line))
                if self.rank in line:
                    self._groups[axis], self._lines[axis] = g, line

    # ---- groups ----------------------------------------------------------
    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """A rank's coordinate on every axis (default: this rank)."""
        r = self.rank if rank is None else rank
        where = np.argwhere(self.mesh == r)[0]
        return {a: int(i) for a, i in zip(AXIS_ORDER, where)}

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (its rank in the axis's
        group)."""
        return self.coords()[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None
        for an axis of size 1 without a process group."""
        if self.axis_sizes[axis] > 1 and axis not in self._groups:
            raise RuntimeError(f"axis {axis!r} has size "
                               f"{self.axis_sizes[axis]} but no process "
                               "group was made for it (build the topology "
                               "after init_distributed)")
        return self._groups.get(axis)

    def group_ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        return self._lines.get(axis, (self.rank,))

    # ---- sizes -----------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def dp_world_size(self) -> int:
        """Number of ways the global batch is split (data × fsdp)."""
        return self.axis_sizes[DATA_AXIS] * self.axis_sizes[FSDP_AXIS]

    @property
    def device_count(self) -> int:
        return math.prod(self.axis_sizes.values())

    @property
    def pp_size(self) -> int:
        return self.axis_sizes[PIPE_AXIS]

    @property
    def tp_size(self) -> int:
        return self.axis_sizes[TENSOR_AXIS]

    @property
    def sp_size(self) -> int:
        return self.axis_sizes[SEQ_AXIS]

    @property
    def ep_size(self) -> int:
        return self.axis_sizes[EXPERT_AXIS]

    # ---- conventional shardings -----------------------------------------
    def sharding(self, *spec) -> PartitionSpec:
        return PartitionSpec(*spec)

    @property
    def replicated(self) -> PartitionSpec:
        return PartitionSpec()

    def batch_spec(self, extra_seq: bool = False) -> PartitionSpec:
        """Spec for a [batch, seq, ...] input: batch split over data+fsdp,
        optionally sequence split over the seq axis."""
        if extra_seq and self.sp_size > 1:
            return PartitionSpec(BATCH_AXES, SEQ_AXIS)
        return PartitionSpec(BATCH_AXES)

    def batch_sharding(self, extra_seq: bool = False) -> PartitionSpec:
        return self.batch_spec(extra_seq)

    def active_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if self.axis_sizes[a] > 1)


_CURRENT: Optional[MeshTopology] = None


def current_topology() -> Optional[MeshTopology]:
    """The topology built last in this process: the mesh whose groups the
    ``lax_*`` collectives use when they are given none."""
    return _CURRENT


def _arrange_devices(devices: Sequence, shape: Tuple[int, ...],
                     devices_per_slice: int) -> np.ndarray:
    """Arrange devices into the mesh shape, row-major.  With
    ``devices_per_slice`` (a multi-node world, that many ranks a node)
    the outer axes must split over the nodes (``_split_outer``); ranks
    numbered node by node then make the row-major layout the one
    ``mesh_utils.create_hybrid_device_mesh`` builds: each node a
    contiguous block of the inner axes."""
    n = len(devices)
    if devices_per_slice and 0 < devices_per_slice < n:
        _split_outer(shape, n // devices_per_slice)
    return np.asarray(devices).reshape(shape)


def _split_outer(shape: Tuple[int, ...], n_slices: int) -> Tuple[int, ...]:
    """Factor n_slices into the outermost mesh axes (greedy)."""
    out = []
    remaining = n_slices
    for s in shape:
        g = math.gcd(s, remaining)
        out.append(g)
        remaining //= g
    if remaining != 1:
        raise ValueError(f"Cannot split {n_slices} slices over mesh shape {shape}")
    return tuple(out)
