"""T3-style decomposed collectives over a mesh axis's process group.

Counterpart of ``deepspeed_tpu/comm/overlap.py``.  The tensor-parallel
serving step's two heavy collectives are the row-parallel all-reduce
after the MLP down-projection and the logits all-gather after the
vocab-split unembed.  T3 (arxiv 2401.16677) hides their wire time by
cutting the GEMM into row tiles whose collectives carry no dependency on
the next tile's product: here tile *i*'s collective is issued with
``async_op=True`` and tile *i+1*'s product runs while it drains.

Every function takes this rank's local tensors (the JAX ones run inside
``shard_map`` on the rank's shard) and a mesh axis name, resolved to its
process group on ``topology`` (default: the last topology built).  Every
comm stage carries a ``torch.profiler.record_function`` label of the JAX
package's scope name.

The exactness ladder:

* ``strategy="psum"`` (default) — each tile is reduced in rank order
  (``collectives.exact_psum``).  The reduction is elementwise and its
  order does not depend on an element's position, so the result is
  **bitwise-identical** to the serial path for any tile count (given
  row tiles whose products are bitwise the whole product's rows, which
  the tests check; tiles of one row are never cut, see
  ``_MIN_TILE_ROWS``).
* ``strategy="ring"`` — explicit ring hops (``batch_isend_irecv``):
  reduce-scatter then all-gather.  Exact arithmetic over the same
  summands, but each destination accumulates in a ring rotation, so
  results can differ from ``psum`` in the last ulp.
* ``quant_bits`` — the quantized wire (EQuARX, arxiv 2506.17615) is not
  ported yet: it raises ``NotImplementedError`` naming ROADMAP Queue 1
  item 6 (the quantized collectives).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .collectives import (_group_of, _label, exact_psum,
                          exact_reduce_scatter, gather_parts, ordered_sum,
                          p2p_shift)
from .mesh import MeshTopology, current_topology

STRATEGIES = ("psum", "ring")

_QUANT_ITEM = ("ROADMAP Queue 1 item 6, the quantized collectives "
               "(ops/quant.py quantized_all_reduce)")


def _no_quant(quant_bits) -> None:
    if quant_bits:
        raise NotImplementedError(
            f"quant_bits={quant_bits}: the quantized wire is not ported yet "
            f"({_QUANT_ITEM})")


def _resolve_tiles(rows: int, tiles: int) -> int:
    """Largest tile count <= ``tiles`` that divides ``rows``."""
    t = max(1, min(int(tiles), int(rows) or 1))
    while rows % t:
        t -= 1
    return t


# a one-row tile's product takes a GEMV, whose summation order differs
# from the GEMM of the whole (CPU and cuBLAS alike): row tiles hold two
# rows or more, or the product runs as one tile
_MIN_TILE_ROWS = 2


def _row_tiles(rows: int, tiles: int) -> int:
    """The tile count a row-tiled matmul takes: :func:`_resolve_tiles`
    with every tile at least ``_MIN_TILE_ROWS`` rows."""
    return _resolve_tiles(rows, min(int(tiles), rows // _MIN_TILE_ROWS))


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _ring(axis_name: str, topology: Optional[MeshTopology]):
    """(n, this rank's axis rank, one hop to the next rank)."""
    group, n, r = _group_of(axis_name, topology)
    if n == 1:
        return 1, 0, None
    topo = topology if topology is not None else current_topology()
    ranks = topo.group_ranks(axis_name)
    perm = _ring_perm(n)
    return n, r, lambda t: p2p_shift(t, perm, ranks, group, r)


# --------------------------------------------------------------------------
# ring primitives (send/recv chains)
# --------------------------------------------------------------------------

def ring_all_gather(x, axis_name: str, axis: int = 0,
                    scope: str = "ring_ag", *,
                    topology: Optional[MeshTopology] = None):
    """All-gather along ``axis`` as an n-1 hop send/recv chain.  Pure data
    movement, bitwise the tiled all-gather.  After ``s`` hops rank ``r``
    holds rank ``r-s``'s shard; the parts are put in absolute-rank order
    before the concat, so every rank assembles the same layout."""
    n, r, hop = _ring(axis_name, topology)
    if n == 1:
        return x
    parts = [None] * n
    parts[r] = cur = x.contiguous()
    for s in range(n - 1):
        with _label(f"{scope}_hop{s}"):
            cur = hop(cur)
        parts[(r - s - 1) % n] = cur
    return torch.cat(parts, dim=axis)


def ring_reduce_scatter(x, axis_name: str, scatter_dim: int = 0,
                        scope: str = "ring_rs", *,
                        topology: Optional[MeshTopology] = None):
    """Ring reduce-scatter: the partial destined for each rank travels the
    ring accumulating every rank's chunk — n-1 hops of 1/n-sized payload.
    Exact arithmetic over the same summands as the reduce-scatter, in a
    ring rotation's order (not bitwise the ``psum`` rung)."""
    n, r, hop = _ring(axis_name, topology)
    if n == 1:
        return x
    if scatter_dim != 0:
        x = torch.movedim(x, scatter_dim, 0)
    D = x.shape[0]
    assert D % n == 0, (tuple(x.shape), n)
    chunks = x.reshape(n, D // n, *x.shape[1:])
    # the partial for destination d starts at rank d+1 and accumulates
    # chunks_j[d] at every rank j it visits, landing home after n-1 hops
    acc = chunks[(r - 1) % n].contiguous()
    for s in range(1, n):
        with _label(f"{scope}_hop{s - 1}"):
            acc = hop(acc)
        acc = acc + chunks[(r - 1 - s) % n]
    if scatter_dim != 0:
        acc = torch.movedim(acc, 0, scatter_dim)
    return acc


def ring_all_reduce(x, axis_name: str, scope: str = "ring_ar", *,
                    topology: Optional[MeshTopology] = None):
    """Ring all-reduce = ring reduce-scatter + ring all-gather over the
    flattened (zero-padded to a multiple of n) payload."""
    n = _group_of(axis_name, topology)[1]
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    red = ring_reduce_scatter(flat, axis_name, scope=scope,
                              topology=topology)
    out = ring_all_gather(red, axis_name, scope=scope, topology=topology)
    if pad:
        out = out[:x.numel()]
    return out.reshape(x.shape)


# --------------------------------------------------------------------------
# tiled (overlapped) collectives
# --------------------------------------------------------------------------

class _Pending:
    """A tile's collective in flight: its gathered parts and the work to
    wait on, finished into the tile's result by ``finish``."""

    def __init__(self, parts, work, finish):
        self.parts, self.work, self.finish = parts, work, finish

    def result(self):
        if self.work is not None:
            self.work.wait()
        return self.finish(self.parts)


def _tile_all_reduce(p, axis_name: str, strategy: str,
                     quant_bits: Optional[int], scope: str,
                     topology: Optional[MeshTopology]):
    """Start one tile's partial-sum reduction on the chosen rung of the
    exactness ladder; the ring runs to its end here, the psum rung is
    left in flight."""
    _no_quant(quant_bits)
    if strategy == "ring":
        out = ring_all_reduce(p, axis_name, scope=scope, topology=topology)
        return _Pending(out, None, lambda o: o)
    group, n, _ = _group_of(axis_name, topology)
    if n == 1:
        return _Pending(p, None, lambda o: o)
    with _label(f"{scope}_ar"):
        parts, work = gather_parts(p, group, n, async_op=True)
    return _Pending(parts, work, ordered_sum)


def overlapped_matmul_allreduce(x, w, axis_name: str, tiles: int = 4,
                                strategy: str = "psum",
                                quant_bits: Optional[int] = None,
                                out_dtype=None,
                                scope: str = "t3_mm_ar", *,
                                topology: Optional[MeshTopology] = None):
    """Row-parallel matmul + all-reduce, tile-decomposed T3-style.

    ``x``: [rows, K_local]; ``w``: [K_local, N] — this rank's contraction
    shard.  The rows split into ``tiles`` tiles; tile *i*'s reduction is
    in flight while tile *i+1*'s GEMM runs.  ``strategy="psum"`` is
    bitwise the serial ``psum(x @ w)`` for any tile count."""
    assert strategy in STRATEGIES, strategy
    _no_quant(quant_bits)
    dt = out_dtype or x.dtype
    rows = x.shape[0]
    t = _row_tiles(rows, tiles)
    step = rows // t
    wt = w.to(dt)
    pending = []
    for i in range(t):
        with _label(f"{scope}_gemm_t{i}"):
            p = (x[i * step:(i + 1) * step] @ wt).to(dt)
        pending.append(_tile_all_reduce(p, axis_name, strategy, quant_bits,
                                        f"{scope}_comm_t{i}", topology))
    outs = [q.result() for q in pending]
    return outs[0] if t == 1 else torch.cat(outs, dim=0)


def overlapped_matmul_allgather(x, w, axis_name: str, tiles: int = 4,
                                out_dtype=None,
                                scope: str = "t3_mm_ag", *,
                                topology: Optional[MeshTopology] = None):
    """Column-parallel matmul + all-gather (the unembed shape),
    tile-decomposed.

    ``x``: [rows, K] (replicated contraction); ``w``: [K, N_local].  Tile
    *i*'s gather is in flight while tile *i+1*'s GEMM runs (an
    asynchronous all-gather per tile; the JAX package chains ppermute
    hops, which XLA schedules).  The gather moves data and never rounds,
    so the result is bitwise the serial matmul + all-gather for any tile
    count."""
    dt = out_dtype or x.dtype
    group, n, _ = _group_of(axis_name, topology)
    rows = x.shape[0]
    t = _row_tiles(rows, tiles)
    step = rows // t
    wt = w.to(dt)
    pending = []
    for i in range(t):
        with _label(f"{scope}_gemm_t{i}"):
            p = (x[i * step:(i + 1) * step] @ wt).to(dt)
        if n == 1:
            pending.append(_Pending(p, None, lambda o: o))
            continue
        with _label(f"{scope}_comm_t{i}"):
            parts, work = gather_parts(p, group, n, async_op=True)
        pending.append(_Pending(parts, work,
                                lambda ps: torch.cat(ps, dim=1)))
    outs = [q.result() for q in pending]
    return outs[0] if t == 1 else torch.cat(outs, dim=0)


def overlapped_all_reduce(x, axis_name: str, tiles: int = 4,
                          strategy: str = "psum",
                          quant_bits: Optional[int] = None,
                          scope: str = "t3_ar", *,
                          topology: Optional[MeshTopology] = None):
    """Tiled all-reduce for replicated leaves.  Tiles along dim 0 when it
    divides; scalars and indivisible leaves run as one tile."""
    assert strategy in STRATEGIES, strategy
    _no_quant(quant_bits)
    if x.dim() == 0:
        # a scalar has no ring chunk; the exact psum stands in on every
        # rung of the ladder
        group, n, _ = _group_of(axis_name, topology)
        with _label(f"{scope}_ar"):
            return exact_psum(x, group, n)
    t = _resolve_tiles(x.shape[0], tiles)
    step = x.shape[0] // t
    pending = [_tile_all_reduce(x[i * step:(i + 1) * step], axis_name,
                                strategy, quant_bits, f"{scope}_t{i}",
                                topology)
               for i in range(t)]
    outs = [q.result() for q in pending]
    return outs[0] if t == 1 else torch.cat(outs, dim=0)


def _rs_tile_dim(shape, scatter_dim: int, tiles: int) -> Optional[int]:
    """Largest dim other than ``scatter_dim`` that ``tiles`` divides —
    tiling along the scattered dim itself would permute the output
    layout relative to the serial reduce-scatter."""
    best = None
    for d, s in enumerate(shape):
        if d == scatter_dim or tiles <= 1 or s % tiles or s < tiles:
            continue
        if best is None or s > shape[best]:
            best = d
    return best


def overlapped_reduce_scatter(x, axis_name: str, scatter_dim: int = 0,
                              tiles: int = 4, strategy: str = "psum",
                              quant_bits: Optional[int] = None,
                              scope: str = "t3_rs", *,
                              topology: Optional[MeshTopology] = None):
    """Tiled reduce-scatter: the leaf is split into ``tiles`` slices along
    its largest non-scattered dim (a leaf with no such dim runs serial),
    each slice reduced in rank order (bitwise the serial exact
    reduce-scatter) or by a ring."""
    assert strategy in STRATEGIES, strategy
    _no_quant(quant_bits)
    group, n, _ = _group_of(axis_name, topology)

    def one(xt, sc):
        if strategy == "ring" and xt.shape[scatter_dim] % n == 0:
            return ring_reduce_scatter(xt, axis_name,
                                       scatter_dim=scatter_dim, scope=sc,
                                       topology=topology)
        with _label(f"{sc}_rs"):
            return exact_reduce_scatter(xt, scatter_dim, group, n)

    td = _rs_tile_dim(tuple(x.shape), scatter_dim, tiles)
    if td is None:
        return one(x, f"{scope}_t0")
    t = _resolve_tiles(x.shape[td], tiles)
    step = x.shape[td] // t
    outs = [one(x.narrow(td, i * step, step), f"{scope}_t{i}")
            for i in range(t)]
    return outs[0] if t == 1 else torch.cat(outs, dim=td)


# --------------------------------------------------------------------------
# wire accounting
# --------------------------------------------------------------------------

def wire_bytes(op: str, elems: int, itemsize: float, n: int,
               quant_bits: Optional[int] = None) -> float:
    """Modeled per-rank bytes on the wire for one collective over ``n``
    ranks, NCCL-style (the ``comms_logging.calc_bw_log`` factors):
    all-reduce moves 2(n-1)/n of the payload, reduce-scatter /
    all-gather (n-1)/n, everything else the payload.  A quantized op's
    payload is ``bits/8`` bytes per element instead of ``itemsize``."""
    if n <= 1:
        return 0.0
    payload = elems * ((quant_bits / 8.0) if quant_bits else itemsize)
    if op == "all_reduce":
        return payload * 2 * (n - 1) / n
    if op in ("reduce_scatter", "all_gather"):
        return payload * (n - 1) / n
    return payload


# --------------------------------------------------------------------------
# The serving forward's entry points
# --------------------------------------------------------------------------

class ServingComm(NamedTuple):
    """Resolved serving-side comm plan, built once by
    ``InferenceEngine._resolve_serving_comm`` and passed to the forward:
    which of the two heavy TP collectives run decomposed, over which
    mesh (the :class:`MeshTopology`) and axis, at what tile count."""
    mesh: object                 # the MeshTopology
    axis_name: str               # the tensor-parallel mesh axis
    tiles: int
    quant_bits: Optional[int]    # None = exact (the only rung ported)
    downproj: bool               # MLP down-projection all-reduce
    unembed: bool                # logits all-gather


def shard_matmul_allreduce(x, w, comm: ServingComm, dt):
    """Tile-decomposed row-parallel matmul + all-reduce.  ``x``: [..., K]
    this rank's K slice; ``w``: [K, N] its rows.  Returns the summed
    [..., N] product in ``dt``, on every rank."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = overlapped_matmul_allreduce(
        x2, w, comm.axis_name, tiles=comm.tiles, quant_bits=comm.quant_bits,
        out_dtype=dt, topology=comm.mesh)
    return out.reshape(*lead, w.shape[-1])


def shard_matmul_allgather(x, w, comm: ServingComm, dt):
    """Tile-decomposed column-parallel matmul + all-gather (the unembed).
    ``x``: [..., K] replicated; ``w``: [K, N_local] this rank's columns.
    Returns the [..., N] logits in ``dt`` on every rank, bitwise the
    serial path."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = overlapped_matmul_allgather(x2, w, comm.axis_name,
                                      tiles=comm.tiles, out_dtype=dt,
                                      topology=comm.mesh)
    return out.reshape(*lead, out.shape[-1])
