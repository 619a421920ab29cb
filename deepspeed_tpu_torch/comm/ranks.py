"""Spawned ranks of one process group, taking cases over queues.

A :class:`RankPool` starts ``world`` processes once (spawned), joins them
into one process group (``init_distributed`` with the given rendezvous
and backend), and then runs cases sent over queues: ``pool.run(case,
*args)`` calls the function ``case`` of the module named ``module`` on
every rank and returns each rank's result in rank order.  A rank imports
only that module and this package, so the module decides what the ranks
load (a script's ``__main__`` is the script, re-run as
``__mp_main__`` in each rank).  Ranks that share one card join over
``gloo``: NCCL puts no two ranks of one communicator on one device.

    pool = RankPool(2, "my_cases", init_method="file:///tmp/store",
                    device="cuda")
    try:
        results = pool.run("serve", seed)     # [rank 0's, rank 1's]
    finally:
        pool.close()
"""

from __future__ import annotations

import importlib
import queue
import time
import traceback
from typing import Any, List, Optional, Sequence

import torch


def _worker(rank, world, module, init_method, backend, device, threads,
            inq, outq):
    if threads:
        torch.set_num_threads(threads)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    import torch.distributed as dist

    from .collectives import init_distributed
    init_distributed(init_method, world, rank, backend=backend)
    cases = importlib.import_module(module)
    while True:
        item = inq.get()
        if item is None:
            break
        name, args = item
        try:
            outq.put((rank, True, getattr(cases, name)(*args)))
        except BaseException:  # tpulint: disable=silent-except — sent to the parent
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` ranks, spawned once, each running the cases of
    ``module`` sent to it; ``threads`` caps each rank's intra-op threads
    (None leaves torch's default); a case that gives no result within
    ``timeout`` seconds, or a rank that dies, raises."""

    def __init__(self, world: int, module: str, *, init_method: str,
                 backend: str = "gloo", device: str = "cpu",
                 threads: Optional[int] = None, timeout: float = 240.0):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, world, module, init_method, backend, device, threads,
            self.inqs[r], self.outq)) for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, case: str, *args: Any,
            per_rank: Optional[Sequence[Any]] = None) -> List[Any]:
        """Run ``case(*args)`` (with ``per_rank[r]`` appended on rank r) on
        every rank; each rank's result, in rank order."""
        for r, q in enumerate(self.inqs):
            extra = () if per_rank is None else (per_rank[r],)
            q.put((case, args + extra))
        got, t0 = {}, time.perf_counter()
        while len(got) < self.world:
            try:
                rank, ok, res = self.outq.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead or time.perf_counter() - t0 > self.timeout:
                    raise RuntimeError(
                        f"{case}: ranks "
                        f"{sorted(set(range(self.world)) - set(got))} gave "
                        f"no result in {self.timeout} s (dead ranks: {dead})")
                continue
            if not ok:
                raise RuntimeError(f"{case} failed on rank {rank}:\n{res}")
            got[rank] = res
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop every rank (terminated if it does not leave in time)."""
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
