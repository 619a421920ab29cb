"""Collectives over the mesh's process groups.

Counterpart of ``deepspeed_tpu/comm/collectives.py``.  The JAX ops take
one global array sharded over the mesh, from a single controller, and
run as ``jax.lax`` collectives inside ``shard_map``.  The port runs one
process a rank, so every op here takes THIS rank's local tensor (the
JAX shard ``r`` is rank ``r``'s tensor) and returns this rank's result.

Two usage modes, as in the reference:

* **The hot path** (the tensor-parallel serving forward): the ``lax_*``
  functions, rank-local collectives over an axis's group with
  ``torch.profiler.record_function`` labels of the JAX scope names.
  ``lax_psum`` reduces in rank order (an all-gather of the summands and
  a sum in rank order), so an element's sum does not depend on where it
  sits in the tensor: a row tile's sum is bitwise the whole tensor's, as
  XLA's ``psum`` is.  A ring all-reduce (gloo's, NCCL's) sums each chunk
  from a different rank and is not.
* **Eager, engine/host level** (microbenchmarks, broadcast at init,
  barrier, metric reduction): :class:`Collectives` bound to a
  :class:`MeshTopology`, on the backend's own collectives, profiled
  through ``comms_logger`` like the reference's ``timed_op``.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import torch

from .comms_logging import comms_logger
from .mesh import MeshTopology, _dist, current_topology
from ..utils.logging import logger


def _group_of(axis_name: str, topology: Optional[MeshTopology]):
    """(group, size, rank in it) of ``axis_name`` on ``topology`` (default:
    the last topology built)."""
    topo = topology if topology is not None else current_topology()
    if topo is None:
        raise RuntimeError(f"collective over {axis_name!r}: no MeshTopology "
                           "has been built in this process")
    n = topo.size(axis_name)
    if n == 1:
        return None, 1, 0
    return topo.group(axis_name), n, topo.axis_rank(axis_name)


def _label(name: str):
    return torch.profiler.record_function(name)


def gather_parts(x: torch.Tensor, group, n: int, async_op: bool = False):
    """Every rank's ``x`` of the group, in group-rank order (the list form
    of all-gather, which every backend takes for CPU and CUDA tensors).
    With ``async_op`` returns (parts, work)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    import torch.distributed as dist
    work = dist.all_gather(parts, x, group=group, async_op=async_op)
    return (parts, work) if async_op else parts


def ordered_sum(parts):
    """Sum of the gathered summands in rank order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def exact_psum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over the group, reduced in rank order."""
    if n == 1:
        return x
    return ordered_sum(gather_parts(x, group, n))


def gather_dim(x: torch.Tensor, dim: int, group, n: int,
               tiled: bool = True) -> torch.Tensor:
    """All-gather along ``dim`` (tiled: concatenated; else stacked)."""
    if n == 1:
        return x if tiled else x.unsqueeze(dim)
    parts = gather_parts(x, group, n)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim)


def exact_reduce_scatter(x: torch.Tensor, dim: int, group,
                         n: int) -> torch.Tensor:
    """This rank's ``dim`` chunk of the group's sum, reduced in rank
    order: an all-to-all of the chunks, then the sum of the n received
    chunks in rank order ((n-1)/n of the payload on the wire, as a
    reduce-scatter)."""
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) "
                         f"over {n} ranks")
    return ordered_sum(list(all_to_all_local(x, dim, 0, group, n,
                                             tiled=False)))


def all_to_all_local(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group, n: int, tiled: bool = True,
                     force: bool = False) -> torch.Tensor:
    """``lax.all_to_all`` of a local tensor: chunk j of ``split_dim`` goes
    to rank j, and the chunks received are concatenated along
    ``concat_dim`` in rank order (``tiled=False``: stacked as a new leading
    dim)."""
    import torch.distributed as dist
    if n == 1 and not force:
        return x if tiled else x.unsqueeze(0)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]})"
                         f" does not split over {n} ranks")
    inp = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(list(out), dim=concat_dim) if tiled else out


# --------------------------------------------------------------------------
# The hot path: rank-local collectives over an axis's group
# --------------------------------------------------------------------------

def lax_psum(x, axis_name, topology: Optional[MeshTopology] = None):
    group, n, _ = _group_of(axis_name, topology)
    with _label(f"all_reduce_{axis_name}"):
        return exact_psum(x, group, n)


def lax_pmean(x, axis_name, topology: Optional[MeshTopology] = None):
    group, n, _ = _group_of(axis_name, topology)
    with _label(f"all_reduce_mean_{axis_name}"):
        return _mean(exact_psum(x, group, n), n)


def lax_all_gather(x, axis_name, axis: int = 0, tiled: bool = True,
                   topology: Optional[MeshTopology] = None):
    group, n, _ = _group_of(axis_name, topology)
    with _label(f"all_gather_{axis_name}"):
        return gather_dim(x, axis, group, n, tiled=tiled)


def lax_reduce_scatter(x, axis_name, scatter_dimension: int = 0,
                       topology: Optional[MeshTopology] = None):
    group, n, _ = _group_of(axis_name, topology)
    with _label(f"reduce_scatter_{axis_name}"):
        return exact_reduce_scatter(x, scatter_dimension, group, n)


def lax_all_to_all(x, axis_name, split_axis: int, concat_axis: int,
                   tiled: bool = True,
                   topology: Optional[MeshTopology] = None):
    group, n, _ = _group_of(axis_name, topology)
    with _label(f"all_to_all_{axis_name}"):
        if tiled:
            return all_to_all_local(x, split_axis, concat_axis, group, n)
        # untiled: split_axis has size n, concat_axis gains a new dim
        y = all_to_all_local(x, split_axis, 0, group, n, tiled=False)
        return torch.movedim(y.squeeze(split_axis + 1), 0, concat_axis)


def lax_ppermute(x, axis_name, perm,
                 topology: Optional[MeshTopology] = None):
    """Send to each ``(src, dst)`` pair's dst (axis ranks); a rank no pair
    sends to gets zeros, as ``lax.ppermute`` gives."""
    topo = topology if topology is not None else current_topology()
    group, n, me = _group_of(axis_name, topo)
    with _label(f"ppermute_{axis_name}"):
        if n == 1:
            return x if (0, 0) in perm else torch.zeros_like(x)
        return p2p_shift(x, perm, topo.group_ranks(axis_name), group, me)


def p2p_shift(x, perm, ranks, group, me):
    """One batched round of sends and receives along ``perm`` (pairs of
    axis ranks) over ``group`` whose global ranks are ``ranks``."""
    import torch.distributed as dist
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out = x.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[d],
                                  group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()
    return out


# --------------------------------------------------------------------------
# init_distributed
# --------------------------------------------------------------------------

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None) -> None:
    """Join the process group (reference: comm/comm.py:619).

    ``coordinator_address``: ``host:port`` (a ``tcp://`` rendezvous), or a
    ``tcp://`` / ``file://`` URL; from ``COORDINATOR_ADDRESS`` when not
    given, with ``num_processes`` from ``WORLD_SIZE`` and ``process_id``
    from ``RANK``.  With neither a coordinator nor ``WORLD_SIZE`` this is
    a no-op (one process), as the reference's is on one host.
    ``backend``: ``"nccl"`` for ranks that each drive a card, ``"gloo"``
    for CPU ranks or ranks that share one card; None leaves torch's
    device -> backend map.  Safe to call repeatedly: a no-op while a
    process group is up, so a group torn down with
    ``dist.destroy_process_group()`` can be joined again."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return

    explicit = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if explicit or os.environ.get("WORLD_SIZE"):
        url = explicit or "env://"
        if "://" not in url:
            url = "tcp://" + url
        world = num_processes or int(os.environ.get("WORLD_SIZE", 0)) or None
        rank = (process_id if process_id is not None
                else int(os.environ["RANK"]) if "RANK" in os.environ
                else None)
        if world is None or rank is None:
            raise ValueError("init_distributed: a coordinator needs "
                             "num_processes and process_id (or WORLD_SIZE "
                             "and RANK)")
        dist.init_process_group(backend=backend, init_method=url,
                                world_size=world, rank=rank)
        logger.info("torch.distributed up: process %d/%d (%s)",
                    dist.get_rank(), dist.get_world_size(),
                    dist.get_backend())


def get_world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def get_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


# --------------------------------------------------------------------------
# Eager collectives over a mesh axis
# --------------------------------------------------------------------------

def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _mean(x: torch.Tensor, n: int) -> torch.Tensor:
    # a 0-dim divisor: rounded once on every device (a CUDA division by a
    # Python scalar multiplies by its reciprocal)
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _timed(op_name: str):
    """Profiling wrapper — the reference's ``timed_op`` (comm/comm.py:101)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self: "Collectives", x, *args, **kwargs):
            self._count(op_name, x, kwargs.get("axis_name")
                        or (args[0] if args else "data"))
            profile = comms_logger.should_profile(op_name)
            if profile:
                _sync(x)
                t0 = time.perf_counter()
            out = fn(self, x, *args, **kwargs)
            if profile:
                _sync(out)
                dt = time.perf_counter() - t0
                axis = kwargs.get("axis_name") or (args[0] if args else "data")
                n = self.topology.axis_sizes.get(axis, 1)
                size = x.numel() * x.element_size()
                comms_logger.append(op_name, kwargs.get("log_name", op_name),
                                    dt, size, n)
            return out

        return wrapper

    return deco


class Collectives:
    """Eager collectives bound to a mesh, for host-level orchestration and
    comm microbenchmarks, on the backend's own collectives.  Each takes
    this rank's tensor: a dim-0 shard for ``all_gather``, the rank's
    summand for ``all_reduce`` / ``reduce_scatter``.

    There is nothing to compile: the JAX package's executable-cache
    counters (``training_comm_collective_compiles_total`` /
    ``_retraces_total``) count here the first call of each (op, axis,
    shape, dtype) key and never a retrace, and
    ``training_comm_collective_calls_total`` (label op) every call, on
    ``metrics`` (an optional shared
    :class:`~deepspeed_tpu_torch.telemetry.metrics.MetricsRegistry`; a
    private one is created when none is passed)."""

    def __init__(self, topology: MeshTopology, metrics=None):
        self.topology = topology
        self._seen = set()
        if metrics is None:
            from ..telemetry.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self.metrics = metrics
        self._c_compiles = metrics.counter(
            "training_comm_collective_compiles_total",
            "eager-collective keys seen (first call of an op, axis, "
            "shape and dtype)", int_valued=True)
        self._c_retraces = metrics.counter(
            "training_comm_collective_retraces_total",
            "re-builds of an eager-collective key (none: nothing is "
            "compiled)", int_valued=True)
        self._c_calls = metrics.counter(
            "training_comm_collective_calls_total",
            "eager-collective calls (label op)", int_valued=True)

    @property
    def mesh(self):
        return self.topology.mesh

    def _count(self, op: str, x: torch.Tensor, axis: str) -> None:
        key = (op, axis, tuple(x.shape), str(x.dtype))
        if key not in self._seen:
            self._seen.add(key)
            self._c_compiles.inc()
        self._c_calls.inc(op=op)

    def _axis(self, axis_name: str):
        """(group, size): with a process group, an axis of size 1 has its
        one-rank group too, and the op still runs on the backend."""
        return self.topology.group(axis_name), self.topology.size(axis_name)

    # -- ops ---------------------------------------------------------------
    @_timed("all_reduce")
    def all_reduce(self, x, axis_name: str = "data", op: str = "sum", **_):
        import torch.distributed as dist
        group, n = self._axis(axis_name)
        out = x.clone()
        with _label(f"all_reduce_{axis_name}"):
            if group is not None:
                dist.all_reduce(out, group=group)
        return _mean(out, n) if op == "mean" else out

    @_timed("all_gather")
    def all_gather(self, x, axis_name: str = "data", **_):
        """This rank's dim-0 shard -> the concatenation of every rank's."""
        group, n = self._axis(axis_name)
        with _label(f"all_gather_{axis_name}"):
            if group is None:
                return x.clone()
            return torch.cat(gather_parts(x, group, n))

    @_timed("reduce_scatter")
    def reduce_scatter(self, x, axis_name: str = "data", **_):
        """This rank's summand -> its dim-0 shard of the sum."""
        import torch.distributed as dist
        group, n = self._axis(axis_name)
        if group is None:
            return x.clone()
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not "
                             f"split over {n} ranks")
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with _label(f"reduce_scatter_{axis_name}"):
            dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out

    @_timed("all_to_all")
    def all_to_all(self, x, axis_name: str = "data", split_dim: int = 0,
                   concat_dim: int = 0, **_):
        group, n = self._axis(axis_name)
        with _label(f"all_to_all_{axis_name}"):
            if group is None:
                return x.clone()
            return all_to_all_local(x, split_dim, concat_dim, group, n,
                                    force=True)

    @_timed("broadcast")
    def broadcast(self, x, axis_name: str = "data", src: int = 0, **_):
        """Replicate axis rank ``src``'s tensor to all ranks along axis."""
        import torch.distributed as dist
        group, n = self._axis(axis_name)
        out = x.clone()
        if group is not None:
            with _label(f"broadcast_{axis_name}"):
                dist.broadcast(out, self.topology.group_ranks(axis_name)[src],
                               group=group)
        return out

    def barrier(self) -> None:
        """Block until every rank reaches this point (reference: comm
        barrier)."""
        dist = _dist()
        if dist is not None:
            dist.barrier()


def log_summary(show_straggler: bool = False):
    """Print the accumulated comm table (reference: comm/comm.py:422)."""
    return comms_logger.log_all(print_log=True, show_straggler=show_straggler)
