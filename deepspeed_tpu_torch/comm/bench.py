"""Collective-sweep microbenchmark CLI — the ``ds_bench`` analog.

Counterpart of ``deepspeed_tpu/comm/bench.py``: all_reduce / all_gather /
reduce_scatter / all_to_all / broadcast over a doubling message-size
sweep, reporting latency and algbw/busbw per size (NCCL-style
accounting), on the backend's own collectives over the world's process
group (or one mesh axis's).

Usage (one process a card, under a launcher that sets ``WORLD_SIZE``,
``RANK`` and ``COORDINATOR_ADDRESS``, or one process alone)::

    python -m deepspeed_tpu_torch.comm.bench --ops all_reduce,all_gather \
        --maxsize 28 --trials 20

Timing: a device synchronize before the clock starts and after the last
trial.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..platform.cuda import resolve_device
from .collectives import _label, exact_psum, get_world_size
from .comms_logging import calc_bw_log, convert_size
from .mesh import TENSOR_AXIS, MeshTopology

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "broadcast")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _axis(mesh, axis: str):
    """(topology, axis) of the sweep: ``mesh``'s ``axis``, or without a
    mesh the world as one tensor axis."""
    return (mesh, axis) if mesh is not None else (_world_topology(),
                                                  TENSOR_AXIS)


def _build_op(op: str, group, n: int, ranks):
    """One collective as ``x -> x`` of the same shape (input split on dim 0
    for the scatter/gather family, replicated for all_reduce/broadcast),
    as the JAX bench shapes its programs."""
    import torch.distributed as dist

    if op == "all_reduce":
        def fn(x):
            with _label("bench_all_reduce"):
                dist.all_reduce(x, group=group)
            return x
        return fn
    if op == "all_gather":
        # per-rank shard -> full tensor, then keep the local slice
        def fn(x):
            with _label("bench_all_gather"):
                g = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                                dtype=x.dtype, device=x.device)
                dist.all_gather_into_tensor(g, x, group=group)
            me = dist.get_rank(group)
            return g[me * x.shape[0]:(me + 1) * x.shape[0]]
        return fn
    if op == "reduce_scatter":
        def fn(x):
            with _label("bench_reduce_scatter"):
                s = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                                dtype=x.dtype, device=x.device)
                dist.reduce_scatter_tensor(s, x, group=group)
            return torch.cat([s] * n, dim=0)
        return fn
    if op == "all_to_all":
        def fn(x):
            with _label("bench_all_to_all"):
                out = torch.empty_like(x)
                dist.all_to_all_single(out, x, group=group)
            return out
        return fn
    if op == "broadcast":
        def fn(x):
            with _label("bench_broadcast"):
                dist.broadcast(x, ranks[0], group=group)
            return x
        return fn
    raise ValueError(f"unknown op {op!r} (choose from {OPS})")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sweep(ops: List[str], min_pow: int = 12, max_pow: int = 26,
          trials: int = 10, warmups: int = 3, dtype: str = "bfloat16",
          axis: str = "x", mesh=None,
          print_table: bool = True, *, device=None) -> List[Dict]:
    """Run the sweep; returns one record per (op, size) with latency
    and algbw/busbw in Gbps (NCCL-style accounting).  ``mesh``: a
    MeshTopology whose ``axis`` the sweep runs over; None = the world (a
    process group must exist).
    ``device``: where the messages live (default the card)."""
    dev = resolve_device(device)
    dt = _DTYPES[dtype]
    topo, ax = _axis(mesh, axis)
    group, n, ranks = topo.group(ax), topo.size(ax), topo.group_ranks(ax)
    itemsize = torch.empty((), dtype=dt).element_size()
    out: List[Dict] = []
    for op in ops:
        fn = _build_op(op, group, n, ranks)
        if print_table:  # tpulint: disable-file=print — bench CLI table output
            print(f"\n---- {op} over {n} ranks ({dev.type}) ----")
            print(f"{'size':>10} {'latency':>12} {'algbw Gbps':>12} "
                  f"{'busbw Gbps':>12}")
        for p in range(min_pow, max_pow + 1):
            nbytes = 1 << p
            elems = max(n * n, nbytes // itemsize)
            # reduce_scatter/all_to_all split the LOCAL shard n ways
            # again, so round to a multiple of n^2
            elems = (elems // (n * n)) * (n * n)
            x = torch.ones((elems,), dtype=dt, device=dev)
            for _ in range(warmups):
                x = fn(x)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(trials):
                x = fn(x)
            _sync(dev)
            lat = (time.perf_counter() - t0) / trials
            size_bytes = elems * itemsize
            algbw, busbw = calc_bw_log(op, size_bytes, lat, n)
            rec = dict(op=op, bytes=size_bytes, latency_us=lat * 1e6,
                       algbw_gbps=round(algbw, 4),
                       busbw_gbps=round(busbw, 4), devices=n)
            out.append(rec)
            if print_table:
                print(f"{convert_size(size_bytes):>10} "
                      f"{lat * 1e6:>10.1f}us {algbw:>12.2f} "
                      f"{busbw:>12.2f}")
    return out


def overlap_bench(mesh=None, axis: str = "x", rows: int = 256,
                  k: int = 4096, nmodel: int = 1024, tiles: int = 4,
                  trials: int = 20, warmups: int = 3,
                  dtype: str = "float32",
                  profile_dir: Optional[str] = None, *,
                  device=None) -> Dict:
    """Overlapped-vs-serial matmul+allreduce microbench — the T3 leg.

    One row-parallel GEMM ([rows, k] x [k, nmodel], contraction split
    over the axis's ranks) under three comm plans: serial (the product,
    then the exact all-reduce), tile-decomposed psum (``tiles`` tiles,
    bitwise) and the tile-decomposed ring.  The quantized plan of the
    JAX bench waits on the quantized collectives (ROADMAP Queue 1 item
    6).  Values are checked before timing (psum tiles bitwise the
    serial plan, the ring close).  With ``profile_dir`` the timed
    overlapped run executes under ``torch.profiler`` and its trace is
    written there."""
    from .overlap import overlapped_matmul_allreduce, wire_bytes

    dev = resolve_device(device)
    dt = _DTYPES[dtype]
    topo, ax = _axis(mesh, axis)
    group, n = topo.group(ax), topo.size(ax)
    me = topo.axis_rank(ax)
    if k % n:
        raise ValueError(f"overlap_bench: k={k} does not split over {n}")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(rows, k).astype(np.float32))
    w = torch.from_numpy(rng.randn(k, nmodel).astype(np.float32))
    kl = k // n
    x = x[:, me * kl:(me + 1) * kl].to(device=dev, dtype=dt).contiguous()
    w = w[me * kl:(me + 1) * kl].to(device=dev, dtype=dt).contiguous()

    def serial(a, b):
        with _label("serial_mm_ar"):
            return exact_psum((a @ b).to(dt), group, n)

    def tiled(strategy):
        return lambda a, b: overlapped_matmul_allreduce(
            a, b, ax, tiles=tiles, strategy=strategy, topology=topo)

    plans = {"serial": serial, "overlapped": tiled("psum"),
             "ring": tiled("ring")}
    ref = plans["serial"](x, w)
    if not torch.equal(plans["overlapped"](x, w), ref):
        raise AssertionError("overlapped plan is not bitwise-equal to "
                             "the serial all-reduce")
    if not torch.allclose(plans["ring"](x, w).float(), ref.float(),
                          rtol=1e-4, atol=1e-4):
        raise AssertionError("ring plan diverged from the serial "
                             "all-reduce beyond rounding order")

    out: Dict = {"devices": int(n), "rows": rows, "k": k, "n": nmodel,
                 "tiles": tiles, "dtype": dtype}
    for name, fn in plans.items():
        y = fn(x, w)
        for _ in range(warmups):
            y = fn(x, w)
        _sync(dev)
        prof = None
        if profile_dir and name == "overlapped":
            prof = torch.profiler.profile()
            prof.__enter__()
        t0 = time.perf_counter()
        for _ in range(trials):
            y = fn(x, w)
        _sync(dev)
        ms = (time.perf_counter() - t0) / trials * 1e3
        if prof is not None:
            prof.__exit__(None, None, None)
            import os
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"overlap_rank{me}.trace.json"))
        out[f"comm_{name}_ms"] = round(ms, 4)
    for name, metric in (("overlapped", "comm_overlap_speedup"),
                         ("ring", "comm_ring_speedup")):
        out[metric] = round(
            out["comm_serial_ms"] / max(out[f"comm_{name}_ms"], 1e-9), 4)
    itemsize = torch.empty((), dtype=dt).element_size()
    out["wire_bytes_exact"] = wire_bytes("all_reduce", rows * nmodel,
                                         itemsize, n)
    # what the serial and psum plans send: the rank-ordered sum
    # all-gathers every rank's partial ((n-1) x the payload a rank)
    out["wire_bytes_sent"] = wire_bytes("all_gather", n * rows * nmodel,
                                        itemsize, n)
    return out


_WORLD_TOPO = []


def _world_topology():
    """A topology with every rank of the world on the tensor axis (built
    once: building makes process groups, a collective call)."""
    if not _WORLD_TOPO:
        from ..config.config import MeshConfig
        _WORLD_TOPO.append(MeshTopology.build(
            MeshConfig(data=1, tensor=get_world_size())))
    return _WORLD_TOPO[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.comm.bench",
        description="collective sweep microbenchmark (ds_bench analog)")
    ap.add_argument("--ops", default="all_reduce",
                    help=f"comma list from {','.join(OPS)} or 'all'")
    ap.add_argument("--minsize", type=int, default=12,
                    help="log2 of smallest message bytes")
    ap.add_argument("--maxsize", type=int, default=26,
                    help="log2 of largest message bytes")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--warmups", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line per record instead of a table")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (nccl | gloo; default: "
                         "torch's choice for the device)")
    ap.add_argument("--device", default=None,
                    help="where the messages live (default: the card)")
    ap.add_argument("--overlap", action="store_true",
                    help="run the overlapped-vs-serial matmul+allreduce "
                         "leg (T3) instead of the op sweep")
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--profile-dir", default=None,
                    help="with --overlap: torch.profiler trace dir for "
                         "the overlapped timed run")
    args = ap.parse_args(argv)
    _join(args.backend, args.device)
    if args.overlap:
        rec = overlap_bench(tiles=args.tiles, trials=args.trials,
                            warmups=args.warmups, dtype=args.dtype,
                            profile_dir=args.profile_dir,
                            device=args.device)
        print(json.dumps(rec))  # tpulint: disable=print — the leg's one JSON line
        return 0
    ops = list(OPS) if args.ops == "all" else args.ops.split(",")
    recs = sweep(ops, args.minsize, args.maxsize, args.trials,
                 args.warmups, args.dtype, print_table=not args.json,
                 device=args.device)
    if args.json:
        for r in recs:
            print(json.dumps(r))
    return 0


def _join(backend: Optional[str], device) -> None:
    """Join the launcher's process group, or make a one-process world on
    a free local port."""
    import os
    import torch.distributed as dist
    from .collectives import init_distributed
    if dist.is_initialized():
        return
    if os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("WORLD_SIZE"):
        init_distributed(backend=backend)
        return
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = resolve_device(device)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)


if __name__ == "__main__":
    sys.exit(main())
