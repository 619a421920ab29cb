"""NVMe tensor swapping (the ZeRO-Infinity storage layer).

Counterpart of ``deepspeed_tpu/runtime/swap_tensor.py`` (``TensorSwapper``,
``OptimizerSwapper``): the leaves of a tree are spilled to files on NVMe
through the native aio pool (``ops/aio.py``) and read back with double
buffering, so the read of group g+1 overlaps the work on group g.

A tree is a nest of dicts, lists and tuples whose leaves are host tensors
or numpy arrays; a template's leaves are :class:`TensorSpec` (shape,
dtype) pairs, the port's ``jax.ShapeDtypeStruct``.  A leaf's swap key is
``g<group>`` followed by its ``jax.tree_util.keystr`` path, as in the
reference, and leaves are read back as CPU tensors (``pin=True``: in
pinned memory, ready for a non-blocking copy to the card).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.engine import _leaf_paths, _map_with_path
from ..ops.aio import AsyncIOHandle


class TensorSpec:
    """Shape and dtype of a swapped leaf (a torch dtype)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * torch.empty((), dtype=self.dtype).element_size()

    def __repr__(self) -> str:
        return f"TensorSpec({self.shape}, {self.dtype})"


def spec_of(x) -> TensorSpec:
    """The :class:`TensorSpec` of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return TensorSpec(x.shape, x.dtype)
    a = np.asarray(x)
    return TensorSpec(a.shape, torch.from_numpy(a[:0].copy()).dtype)


def tree_bytes(tree) -> int:
    """Bytes of a tree of tensors, arrays or specs."""
    total = 0
    for _, x in _leaf_paths(tree):
        s = x if isinstance(x, TensorSpec) else spec_of(x)
        total += s.nbytes
    return total


def _host(x) -> torch.Tensor:
    """A contiguous CPU tensor of ``x`` (no copy when it is one)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(x))


class TensorSwapper:
    """Spill and restore named host buffers to files under ``swap_dir``."""

    def __init__(self, swap_dir: str, aio: Optional[AsyncIOHandle] = None):
        self.dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.aio = aio or AsyncIOHandle()
        self._meta: Dict[str, TensorSpec] = {}
        self._hold: Dict[str, torch.Tensor] = {}

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_").replace("'", "").replace("[", "_") \
            .replace("]", "_")
        return os.path.join(self.dir, f"{safe}.swp")

    def swap_out(self, key: str, array, async_op: bool = False) -> None:
        buf = _host(array)
        self._meta[key] = spec_of(buf)
        self._hold[key] = buf                     # alive until wait()
        # whole-file rewrite: truncate so a shrunk leaf leaves no tail
        self.aio.async_pwrite(buf, self._path(key), truncate=True)
        if not async_op:
            self.wait()

    def swap_in(self, key: str, async_op: bool = False,
                out: Optional[torch.Tensor] = None,
                pin: bool = False) -> torch.Tensor:
        spec = self._meta[key]
        buf = out if out is not None else torch.empty(
            spec.shape, dtype=spec.dtype, pin_memory=pin)
        self.aio.async_pread(buf, self._path(key))
        if not async_op:
            self.wait()
        return buf

    def wait(self) -> None:
        errs = self.aio.wait()
        self._hold = {}
        if errs:
            raise IOError(f"{errs} swap chunks failed in {self.dir}")

    def remove(self, key: str) -> None:
        self._meta.pop(key, None)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class OptimizerSwapper:
    """Double-buffered swapping of trees over numbered groups:
    ``prefetch_group(g + 1)`` is issued before group g is consumed, so
    the NVMe read hides behind the work on g (the reference's
    pipelined_optimizer_swapper schedule)."""

    def __init__(self, swap_dir: str, num_groups: int,
                 aio: Optional[AsyncIOHandle] = None,
                 aio_config=None, *, pin: bool = False):
        # two swappers with their own aio pools alternate over even and
        # odd groups, so waiting on group g's reads never drains the
        # prefetch of group g+1 in flight
        if aio is None and aio_config is not None:
            self._swappers = (
                TensorSwapper(swap_dir, AsyncIOHandle.from_config(aio_config)),
                TensorSwapper(swap_dir, AsyncIOHandle.from_config(aio_config)))
        else:
            self._swappers = (TensorSwapper(swap_dir, aio),
                              TensorSwapper(swap_dir))
        self.num_groups = num_groups
        self.pin = pin
        self._buffers: Dict[int, Any] = {}

    def _swapper(self, group: int) -> TensorSwapper:
        return self._swappers[group % 2]

    def _keys(self, group: int, tree) -> List[str]:
        return [f"g{group}{path}" for path, _ in _leaf_paths(tree)]

    def write_group(self, group: int, tree: Any) -> None:
        sw = self._swapper(group)
        for (path, leaf) in _leaf_paths(tree):
            sw.swap_out(f"g{group}{path}", leaf, async_op=True)
        sw.wait()

    def _read(self, group: int, template: Any, async_op: bool) -> Any:
        sw = self._swapper(group)
        bufs = {path: sw.swap_in(f"g{group}{path}", async_op=async_op,
                                 pin=self.pin)
                for path, _ in _leaf_paths(template)}
        return _map_with_path(lambda path, _: bufs[path], template)

    def prefetch_group(self, group: int, template: Any) -> None:
        """Start the reads of a group (double buffering)."""
        self._buffers[group] = self._read(group, template, async_op=True)

    def read_group(self, group: int, template: Any = None) -> Any:
        if group in self._buffers:
            self._swapper(group).wait()
            return self._buffers.pop(group)
        assert template is not None, "no prefetch and no template"
        return self._read(group, template, async_op=False)


__all__ = ["OptimizerSwapper", "TensorSpec", "TensorSwapper", "spec_of",
           "tree_bytes"]
