"""ZeRO-Infinity: the optimizer state on NVMe, updated on the host.

Counterpart of ``deepspeed_tpu/runtime/zero_infinity.py`` on one process
(``HostAdam`` :39, ``LazyNVMeLeaf`` :115, ``NVMeOptimizer`` :186): the fp32
master parameters and the optimizer moments live in files on NVMe,
written and read through the native aio pool; only the compute-dtype
working copy stays on the card.  The update runs group by group on the
host, with group g+1's read in flight while group g updates.

Leaves are taken in ``jax.tree_util`` order (dict keys sorted), so the
swap groups of a tree are the reference's at the same ``buffer_size``.
The multi-process parts of the reference (shard fragments) belong to
multi-GPU training and are not here.
"""

from __future__ import annotations

import os
import shutil
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.engine import _leaf_paths, _map_with_path
from ..config.config import ConfigError
from ..utils.logging import log_dist
from .optimizers import sqrt
from .runtime_utils import HOST_CHUNK
from .swap_tensor import OptimizerSwapper, TensorSpec


def host_f32(x) -> torch.Tensor:
    """A leaf (a tensor anywhere, a numpy array, a lazy reader) as an
    fp32 CPU tensor; no copy when it is one."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32))


class HostAdam:
    """Host optimizer on fp32 CPU tensors, in place: the mirror of the
    JAX package's numpy ``HostAdam`` (the DeepSpeedCPUAdam / CPUAdagrad /
    CPULion family), operation for operation.  Every variant keeps the
    (m, v) pair so that the swap layout is one: adagrad keeps its
    accumulator in v, lion and sgd leave v alone."""

    SUPPORTED = ("adam", "adamw", "lion", "adagrad", "sgd")

    def __init__(self, opt_type: str, params: Dict[str, Any]):
        t = opt_type.lower()
        if t not in self.SUPPORTED:
            raise ConfigError(
                f"offload_optimizer.device=nvme supports "
                f"{'/'.join(self.SUPPORTED)}, got {opt_type!r}")
        self.type = t
        default_betas = (0.9, 0.99) if t == "lion" else (0.9, 0.999)
        self.b1, self.b2 = params.get("betas", default_betas)
        self.eps = params.get("eps", 1e-10 if t == "adagrad" else 1e-8)
        self.weight_decay = params.get("weight_decay",
                                       0.01 if t == "adamw" else 0.0)
        self.adam_w_mode = params.get("adam_w_mode", t == "adamw")
        self.bias_correction = params.get("bias_correction", True)
        self.momentum = params.get("momentum", 0.0)
        self.nesterov = params.get("nesterov", False)

    @torch.no_grad()
    def update(self, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               g, lr: float, step: int) -> None:
        """In-place fp32 update of (p, m, v) with gradient g."""
        g = host_f32(g)
        if self.type == "lion":
            # sign step on the interpolated moment, decoupled decay
            # against the pre-step p, then the moment's EMA
            delta = lr * torch.sign(self.b1 * m + (1.0 - self.b1) * g)
            if self.weight_decay:
                delta = delta + lr * self.weight_decay * p
            p.sub_(delta)
            m.mul_(self.b2)
            m.add_((1.0 - self.b2) * g)
            return
        if self.type == "adagrad":
            if self.weight_decay:
                g = g + self.weight_decay * p
            v.add_(torch.square(g))
            p.sub_(lr * g / (sqrt(v) + self.eps))
            return
        if self.type == "sgd":
            if self.weight_decay:
                g = g + self.weight_decay * p
            if self.momentum:
                m.mul_(self.momentum)
                m.add_(g)
                # nesterov as optimizers.sgd: d = g + mu * b_new
                g = g + self.momentum * m if self.nesterov else m
            p.sub_(lr * g)
            return
        if not self.adam_w_mode and self.weight_decay:
            g = g + self.weight_decay * p
        m.mul_(self.b1)
        m.add_((1.0 - self.b1) * g)
        v.mul_(self.b2)
        v.add_((1.0 - self.b2) * torch.square(g))
        if self.bias_correction:
            c1 = 1.0 - self.b1 ** step
            c2 = 1.0 - self.b2 ** step
        else:
            c1 = c2 = 1.0
        # a true division by the bias corrections, as numpy's: torch
        # divides by a Python number through its reciprocal, which can
        # round one ulp away; sqrt correctly rounded (optimizers.sqrt)
        denom = sqrt(v / torch.full_like(v, c2))
        denom.add_(self.eps)
        if self.adam_w_mode and self.weight_decay:
            p.mul_(1.0 - lr * self.weight_decay)
        p.sub_(lr * (m / torch.full_like(m, c1)) / denom)


class LazyNVMeLeaf:
    """A checkpoint leaf that reads itself from NVMe only when
    materialized (``np.asarray``): the checkpoint path of state larger
    than host memory.  ``shape`` and ``dtype`` are there without a read."""

    __slots__ = ("_read", "_g", "_col", "_j", "shape", "dtype")

    def __init__(self, read, g: int, col: int, j: int, shape, dtype):
        self._read = read
        self._g, self._col, self._j = g, col, j
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def __array__(self, dtype=None, copy=None):
        arr = self._read(self._g, self._col, self._j)
        if dtype is not None and np.dtype(dtype) != arr.dtype:
            return arr.astype(dtype)            # astype copies
        return arr.copy() if copy else arr     # each read is a fresh buffer


class NVMeOptimizer:
    """Group-partitioned NVMe state store and the pipelined host update."""

    def __init__(self, nvme_path: str, opt_type: str,
                 opt_params: Dict[str, Any],
                 buffer_size: int = 100_000_000,
                 aio_config=None):
        if not nvme_path:
            raise ConfigError(
                "offload_optimizer.device=nvme requires nvme_path")
        # one directory per process and engine: two runs sharing a mount
        # never overwrite each other's state
        token = f"r0_{os.getpid()}_{id(self):x}"
        self.dir = os.path.join(nvme_path, "zero_infinity", token)
        # the swap files are scratch: reclaimed when the engine goes
        # (weakref.finalize also fires at exit)
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir,
                                         True)
        self.adam = HostAdam(opt_type, opt_params)
        self.buffer_size = max(int(buffer_size), 1)
        self.aio_config = aio_config
        self.groups: List[List[int]] = []      # leaf indices per group
        self.swapper: Optional[OptimizerSwapper] = None
        self._tpl = None                        # the tree, of TensorSpecs
        self._leaf_meta: List[Tuple[tuple, Any]] = []
        self._group_bytes: List[int] = []
        # optional ResidencyMeter (param_stream.py) counting the host
        # bytes of the swap groups in flight
        self.meter = None
        self.bytes_read = 0
        self.bytes_written = 0

    # ------------------------------------------------------------------
    @staticmethod
    def flatten(tree) -> List[Any]:
        """The leaves of ``tree`` in the store's order (jax's)."""
        return [x for _, x in _leaf_paths(tree)]

    def initialize(self, params: Any, shardings: Any = None) -> None:
        """Partition the leaves into groups of about ``buffer_size``
        bytes and write the fp32 master and zero moments to NVMe.
        ``shardings`` (the reference's gradient layout of a multi-host
        run, whose processes each store their own fragments) must be
        None: one process holds every leaf."""
        if shardings is not None:
            raise NotImplementedError(
                "NVMeOptimizer.initialize(shardings=...) is not ported yet "
                "(ROADMAP Queue 1 item 6, multi-GPU breadth: per-process "
                "NVMe fragments)")
        paths = _leaf_paths(params)
        self._leaf_meta = [(tuple(x.shape), np.float32) for _, x in paths]
        self._tpl = _map_with_path(
            lambda _, x: TensorSpec(x.shape, torch.float32), params)
        leaf_bytes = [int(np.prod(s) or 1) * 4 for s, _ in self._leaf_meta]
        self.groups = []
        cur, cur_bytes = [], 0
        for i, nbytes in enumerate(leaf_bytes):
            if cur and cur_bytes + nbytes > self.buffer_size:
                self.groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            self.groups.append(cur)
        # p + m + v host bytes of each group
        self._group_bytes = [3 * sum(leaf_bytes[i] for i in idxs)
                             for idxs in self.groups]
        self.swapper = OptimizerSwapper(self.dir, len(self.groups),
                                        aio_config=self.aio_config)
        leaves = [x for _, x in paths]
        for g, idxs in enumerate(self.groups):
            ps = [host_f32(leaves[i]).clone() for i in idxs]
            zeros = [torch.zeros_like(p) for p in ps]
            self.swapper.write_group(g, (ps, zeros, zeros))
            self.bytes_written += self._group_bytes[g]
        log_dist(f"ZeRO-Infinity: {len(leaves)} leaves in "
                 f"{len(self.groups)} NVMe swap groups under {self.dir}")

    def _template(self, g: int):
        mk = lambda: [TensorSpec(self._leaf_meta[i][0], torch.float32)
                      for i in self.groups[g]]
        return (mk(), mk(), mk())

    # ------------------------------------------------------------------
    def step(self, grad_leaves: Sequence[Any], lr: float, step_num: int,
             consume: Optional[Callable[[int, torch.Tensor], None]] = None
             ) -> Optional[List[torch.Tensor]]:
        """One optimizer step over every group, group g+1's read in
        flight while g updates.  ``grad_leaves``: the leaves in the
        store's order (tensors on any device, or lazy readers), fetched
        one at a time; each leaf is updated in spans of ``HOST_CHUNK``
        elements (small temporaries).  Returns the fp32 master leaves, unless
        ``consume`` is given: then each fresh master leaf goes to
        ``consume(leaf_index, p_new)`` and is released (the streaming
        path: the fp32 tree never exists whole)."""
        assert self.swapper is not None, "initialize() first"
        new_leaves: Optional[List[Optional[torch.Tensor]]] = \
            None if consume else [None] * len(self._leaf_meta)
        G = len(self.groups)
        gb = self._group_bytes
        if G:
            self.swapper.prefetch_group(0, self._template(0))
        for g, idxs in enumerate(self.groups):
            if g + 1 < G:       # overlap: the next group's read
                self.swapper.prefetch_group(g + 1, self._template(g + 1))
            held = gb[g] + (gb[g + 1] if g + 1 < G else 0)
            if self.meter is not None:
                self.meter.alloc(held)
            ps, ms, vs = self.swapper.read_group(g, self._template(g))
            self.bytes_read += gb[g]
            for j, i in enumerate(idxs):
                p, m, v = (x.view(-1) for x in (ps[j], ms[j], vs[j]))
                gr = host_f32(grad_leaves[i]).reshape(-1)
                for a in range(0, p.numel(), HOST_CHUNK):
                    b = a + HOST_CHUNK
                    self.adam.update(p[a:b], m[a:b], v[a:b], gr[a:b], lr,
                                     step_num)
                if consume is not None:
                    consume(i, ps[j])
                else:
                    new_leaves[i] = ps[j]
            self.swapper.write_group(g, (ps, ms, vs))
            self.bytes_written += gb[g]
            if self.meter is not None:
                self.meter.free(held)
        return new_leaves

    # ------------------------------------------------------------------
    # checkpoints: the full fp32 state out and in
    # ------------------------------------------------------------------
    def state_trees(self, lazy: bool = False) -> Tuple[Any, Any, Any]:
        """(master, m, v) as whole trees, in one pass over the groups.

        ``lazy=True`` gives trees of :class:`LazyNVMeLeaf`: each leaf is
        read from NVMe (its own swap file: one leaf of one column of one
        group) when touched, so a checkpoint writer walking the leaves
        holds one leaf in host memory and reads the state once, whatever
        order it walks in (the reference caches a whole column of a group,
        which a walk over stacked leaves re-reads once per leaf)."""
        if lazy:
            cols = [[None] * len(self._leaf_meta) for _ in range(3)]
            for g, idxs in enumerate(self.groups):
                for col in range(3):
                    for j, i in enumerate(idxs):
                        shape, dtype = self._leaf_meta[i]
                        cols[col][i] = LazyNVMeLeaf(self._read_leaf, g, col,
                                                    j, shape, dtype)
            return tuple(self._unflatten(c) for c in cols)
        cols = [[None] * len(self._leaf_meta) for _ in range(3)]
        for g, idxs in enumerate(self.groups):
            parts = self.swapper.read_group(g, self._template(g))
            for col, vals in zip(cols, parts):
                for j, i in enumerate(idxs):
                    col[i] = vals[j]
        return tuple(self._unflatten(c) for c in cols)

    def _unflatten(self, leaves: List[Any]) -> Any:
        it = iter(leaves)
        by_path = {path: next(it) for path, _ in _leaf_paths(self._tpl)}
        return _map_with_path(lambda path, _: by_path[path], self._tpl)

    def _read_leaf(self, g: int, col: int, j: int) -> np.ndarray:
        """Leaf j of column ``col`` (0 master, 1 m, 2 v) of group g."""
        keys = self.swapper._keys(g, self._template(g))
        buf = self.swapper._swapper(g).swap_in(
            keys[col * len(self.groups[g]) + j])
        self.bytes_read += buf.numel() * 4
        return buf.numpy()

    def master_tree(self) -> Any:
        return self.state_trees()[0]

    def restore(self, master: Any, m: Any = None, v: Any = None) -> None:
        """Overwrite the NVMe state from whole trees (checkpoint load)."""
        p_leaves = self.flatten(master)
        m_leaves = self.flatten(m) if m is not None else None
        v_leaves = self.flatten(v) if v is not None else None
        for g, idxs in enumerate(self.groups):
            ps = [host_f32(p_leaves[i]).clone() for i in idxs]
            ms = ([host_f32(m_leaves[i]).clone() for i in idxs] if m_leaves
                  else [torch.zeros_like(p) for p in ps])
            vs = ([host_f32(v_leaves[i]).clone() for i in idxs] if v_leaves
                  else [torch.zeros_like(p) for p in ps])
            self.swapper.write_group(g, (ps, ms, vs))
            self.bytes_written += self._group_bytes[g]


__all__ = ["HostAdam", "LazyNVMeLeaf", "NVMeOptimizer", "host_f32"]
