"""Logical-axis sharding rules.

Counterpart of ``deepspeed_tpu/parallel/sharding.py``.  Every parameter
carries a tuple of logical axis names (``('embed', 'mlp')`` …), and a
table of rules maps logical axes to mesh axes, giving each leaf a
:class:`~..comm.mesh.PartitionSpec` equal to the JAX package's entry for
entry.  The JAX package hands the specs to XLA, which places every
collective.  Here a spec says which slice of a leaf a rank holds:
:func:`named` returns the function that cuts a full leaf to this rank's
slice, and :func:`local_slice` does the arithmetic.  Carrying a JAX tree
across is then ``models.params_from_numpy`` plus this cut.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..comm.mesh import (DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, MeshTopology,
                         PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS, PartitionSpec as P)

# A logical axis annotation: tuple of names, one per tensor dim (None = never shard)
LogicalAxes = Tuple[Optional[str], ...]

# Default logical->mesh rules (tensor parallelism).  Multiple candidates are
# tried in order; first mesh axis with size>1 that still divides wins.
DEFAULT_RULES: Dict[str, Sequence[str]] = {
    # activations / batch-like
    "batch": (DATA_AXIS, FSDP_AXIS),
    "seq": (SEQ_AXIS,),
    # stacked layer dim: pipeline stages own contiguous layer slices
    "layers": (PIPE_AXIS,),
    # parameter axes
    "vocab": (TENSOR_AXIS,),
    "embed": (),                      # residual stream: replicated under TP
    "mlp": (TENSOR_AXIS,),            # MLP hidden (column-parallel in, row-parallel out)
    "heads": (TENSOR_AXIS,),          # attention heads (Megatron-style head split)
    "kv_heads": (TENSOR_AXIS,),
    "head_dim": (),
    "expert": (EXPERT_AXIS,),         # MoE expert dimension
    "norm": (),
    "conv_in": (), "conv_out": (TENSOR_AXIS,), "conv_k": (),
}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _map(fn: Callable, tree: Any, *rest: Any, leaf: Callable = _is_axes):
    """Map over nested dicts / lists to the leaves ``leaf`` picks."""
    if leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), leaf=leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), leaf=leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def spec_for_axes(axes: LogicalAxes, rules: Optional[Dict[str, Sequence[str]]],
                  topology: MeshTopology, shape: Optional[Tuple[int, ...]] = None) -> P:
    """Map one parameter's logical axes to a PartitionSpec under `rules`.

    A mesh axis is only assigned once per spec and only if it has size > 1
    (size-1 axes would be no-ops but pollute the spec) and, when `shape` is
    given, only if it divides the dim size.
    """
    rules = {**DEFAULT_RULES, **(rules or {})}
    used = set()
    entries = []
    for i, name in enumerate(axes):
        assigned = None
        for mesh_axis in rules.get(name, ()) if name else ():
            size = topology.axis_sizes.get(mesh_axis, 1)
            if mesh_axis in used or size <= 1:
                continue
            if shape is not None and shape[i] % size != 0:
                continue
            assigned = mesh_axis
            used.add(mesh_axis)
            break
        entries.append(assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry splits its dim over."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def add_fsdp_to_spec(spec: P, shape: Tuple[int, ...], topology: MeshTopology,
                     min_size: int = 0, axis: str = FSDP_AXIS) -> P:
    """Layer ZeRO/FSDP sharding on top of a TP spec: shard the largest
    still-unsharded dim that the fsdp axis size divides (after the
    existing shards)."""
    n = topology.axis_sizes.get(axis, 1)
    if n <= 1 or int(np.prod(shape)) < max(min_size, 1):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, dim in enumerate(shape):
        cur_axes = entry_axes(entries[i])
        if axis in cur_axes:
            return spec
        denom = 1
        for a in cur_axes:
            denom *= topology.axis_sizes.get(a, 1)
        local = dim // denom
        if local % n == 0 and local > best_size:
            best, best_size = i, local
    if best is None:
        return spec
    cur = entries[best]
    if cur is None:
        entries[best] = axis
    elif isinstance(cur, str):
        entries[best] = (cur, axis)
    else:
        entries[best] = tuple(cur) + (axis,)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def tree_specs(axes_tree: Any, topology: MeshTopology,
               rules: Optional[Dict[str, Sequence[str]]] = None,
               shapes: Any = None) -> Any:
    """Map a tree of LogicalAxes (+ optional matching shapes tree) to specs."""
    if shapes is None:
        return _map(lambda ax: spec_for_axes(ax, rules, topology), axes_tree)
    return _map(lambda ax, sh: spec_for_axes(ax, rules, topology, tuple(sh)),
                axes_tree, shapes)


def _chunk(entry, topology: MeshTopology, coords: Dict[str, int]):
    """(chunk count, this rank's chunk index) of a dim split over
    ``entry``'s axes, the first axis major."""
    count, idx = 1, 0
    for a in entry_axes(entry):
        n = topology.axis_sizes[a]
        count, idx = count * n, idx * n + coords[a]
    return count, idx


def local_shape(shape: Tuple[int, ...], spec: P,
                topology: MeshTopology) -> Tuple[int, ...]:
    """The shape of one rank's slice of a ``shape`` leaf under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        count = 1
        for a in entry_axes(entry):
            count *= topology.axis_sizes[a]
        if out[d] % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry!r} ({count})")
        out[d] //= count
    return tuple(out)


def local_slice(x, spec: P, topology: MeshTopology,
                rank: Optional[int] = None):
    """This rank's (or ``rank``'s) slice of the full leaf ``x`` under
    ``spec`` (a view where the slice is one; numpy arrays and torch
    tensors alike)."""
    coords = topology.coords(rank)
    for d, entry in enumerate(spec):
        count, idx = _chunk(entry, topology, coords)
        if count == 1:
            continue
        if x.shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {entry!r} ({count})")
        step = x.shape[d] // count
        index = [slice(None)] * x.ndim
        index[d] = slice(idx * step, (idx + 1) * step)
        x = x[tuple(index)]
    return x


def named(topology: MeshTopology, spec: P) -> Callable:
    """The function that cuts a full leaf to this rank's slice under
    ``spec`` (where the JAX package places the leaf with a
    ``NamedSharding``)."""
    return lambda x: local_slice(x, spec, topology)


def tree_named(topology: MeshTopology, spec_tree: Any) -> Any:
    return _map(lambda s: named(topology, s), spec_tree,
                leaf=lambda x: isinstance(x, P))


def infer_logical_axes(params: Any) -> Any:
    """Fallback when a model provides no logical axes: mark every dim None
    (replicated under TP; fsdp layering still applies by shape)."""
    return _map(lambda p: tuple([None] * len(p.shape)), params,
                leaf=lambda x: not isinstance(x, (dict, list, tuple)))
