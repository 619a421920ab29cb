"""Per-layer NVMe weight streaming for serving.

Counterpart of ``deepspeed_tpu/inference/weight_stream.py``
(``NVMeWeightStore``): the serving engine spills its stacked per-layer
block weights (the quantized payloads under ``weight_quant``, so the
stream is int8/int4-sized) to one ``.npy`` file per (layer, leaf), and
the forward reads them back one layer at a time.  Device memory then
holds two layer slots, not the block weights.

The JAX store reads a layer from inside the compiled scan through
``io_callback``.  Here the forward asks the store for each layer in turn
(:meth:`NVMeWeightStore.fetch_layer`) and the store runs a two-slot
pipeline on the port's aio pool (``ops/aio.py``):

* layer ``l`` is read into pinned host slot ``l % 2`` by
  ``AsyncIOHandle.async_pread`` (one read per leaf, at the payload offset
  cached at spill time), then copied into device slot ``l % 2`` on a copy
  stream, and the compute stream waits for that copy's event;
* while layer ``l`` computes, layer ``l + 1``'s read is in flight (after
  the last layer, the next step's first layer's);
* a host slot is read into only after the copy out of it has finished
  (the host waits on its event), and a device slot is copied into only
  after the compute stream has passed the event of its last reader
  (:meth:`release_layer`, which the forward calls after each layer).
  The host blocks on the read of the layer the forward needs next, and
  on nothing else.

A file read cannot be replayed by a CUDA graph, so a streamed serving
step runs eagerly.  On the CPU (``device="cpu"``) the slots are CPU
tensors and the copies synchronous: the same code, as the tests run it.

Leaves whose dtype numpy lacks (bfloat16, float8) are saved as integer
words of the same width; the store records each leaf's torch dtype.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..platform.cuda import host_empty, resolve_device

# byte alignment of each leaf inside a slot (the kernels' operands start
# on 16-byte boundaries; 256 keeps every dtype view legal too)
_ALIGN = 256
# integer words for the torch dtypes numpy has no type for
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_NUMPY_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int8,
                 torch.uint8, torch.int16, torch.int32, torch.int64,
                 torch.bool)


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(key path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``'s bytes (integer words where numpy has
    no such dtype)."""
    t = t.detach().contiguous()
    if t.dtype not in _NUMPY_DTYPES:
        t = t.view(_WORDS[t.element_size()])
    return t.cpu().numpy()


class NVMeWeightStore:
    """Spill a stacked per-layer tree to per-layer files; serve it back one
    layer at a time through two pinned host slots and two device slots."""

    # set by the engine at spill time: whether every quantized projection
    # payload is a layout the mixed-input GEMM consumes (row-wise int8 or
    # packed row-wise int4), and each payload's (bits, per-layer shape,
    # dtype, layout)
    mixed_gemm_eligible = False
    qmeta = None

    def __init__(self, path: str, num_layers: int, *, device=None):
        """``device``: where the layer slots live (None = the card)."""
        self.dir = path
        self.num_layers = num_layers
        self.device = resolve_device(device)
        os.makedirs(path, exist_ok=True)
        self._paths: Tuple[Tuple[str, ...], ...] = ()
        self._shapes: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...] = ()
        self._offsets: Dict[Tuple[int, int], int] = {}
        from ..ops.aio import AsyncIOHandle
        self._aio = AsyncIOHandle(thread_count=2)
        self._cuda = self.device.type == "cuda"
        # slots: made at the first fetch (sized from the spilled layout)
        self._host: List[torch.Tensor] = []
        self._dev: List[torch.Tensor] = []
        self._trees: List[Dict[str, Any]] = []
        self._copy_stream = None
        self._h2d = [None, None]        # event behind the copy into slot s
        self._free = [None, None]       # event behind slot s's last reader
        self._turn = 0                  # layer fetches so far: slot = turn % 2
        self._read: Optional[Tuple[int, int]] = None   # (layer, slot)
        self._slot: Optional[int] = None  # the slot the forward holds
        # what a step cost: bytes read, seconds the host blocked on reads;
        # with ``measure`` the compute stream's waits on a slot as event
        # pairs (:meth:`stall_ms`)
        self.bytes_read = 0
        self.read_wait_s = 0.0
        self.spill_s = 0.0
        self.measure = False
        self._stalls: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    # ---- spill -----------------------------------------------------------
    def spill(self, stacked_tree: Any) -> None:
        """``stacked_tree``: a nested dict whose tensor leaves have a
        leading ``num_layers`` dim.  Writes the layer slices; frees
        nothing itself (the caller drops its references)."""
        t0 = time.perf_counter()
        pairs = _flatten(stacked_tree)
        self._paths = tuple(p for p, _ in pairs)
        shapes = []
        for j, (_, leaf) in enumerate(pairs):
            assert leaf.shape[0] == self.num_layers, (
                f"leaf {j} has no leading layer dim: {tuple(leaf.shape)}")
            shapes.append((tuple(leaf.shape[1:]), leaf.dtype))
            for li in range(self.num_layers):
                arr = _as_numpy(leaf[li])
                path = self._file(li, j)
                np.save(path, arr)
                # the payload's offset, cached once: a fetch never parses
                # a header
                self._offsets[(li, j)] = os.path.getsize(path) - arr.nbytes
        self._shapes = tuple(shapes)
        self.spill_s = time.perf_counter() - t0

    def _file(self, li: int, j: int) -> str:
        return os.path.join(self.dir, f"layer{li:04d}_leaf{j:03d}.npy")

    @property
    def layer_bytes(self) -> int:
        """Payload bytes of one layer (what a fetch reads)."""
        return sum(_nbytes(s, d) for s, d in self._shapes)

    # ---- the slots ---------------------------------------------------------
    def _layout(self) -> Tuple[List[int], int]:
        offs, o = [], 0
        for shape, dtype in self._shapes:
            offs.append(o)
            o += -(-_nbytes(shape, dtype) // _ALIGN) * _ALIGN
        return offs, o

    def _make_slots(self) -> None:
        assert self._shapes, "fetch before spill"
        offs, total = self._layout()
        for _ in range(2):
            host = host_empty((total,), torch.uint8, pin=self._cuda)
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            self._host.append(host)
            self._dev.append(dev)
            self._trees.append(_unflatten(self._paths, [
                _view(dev, o, shape, dtype)
                for o, (shape, dtype) in zip(offs, self._shapes)]))
        self._offs = offs
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device=self.device)

    def pinned(self) -> bool:
        """Whether both host slots are page-locked (the card's slots)."""
        return bool(self._host) and all(h.is_pinned() for h in self._host)

    def slot_bytes(self) -> int:
        """Bytes of the device slots (0 before the first fetch)."""
        return sum(d.numel() for d in self._dev)

    def _start_read(self, li: int, s: int) -> None:
        if self._h2d[s] is not None:
            # the copy out of host slot s must finish before the read
            # overwrites it
            self._h2d[s].synchronize()
        host = self._host[s]
        for j, (o, (shape, dtype)) in enumerate(zip(self._offs,
                                                   self._shapes)):
            n = _nbytes(shape, dtype)
            self._aio.async_pread(host[o:o + n], self._file(li, j),
                                  offset=self._offsets[(li, j)])
        self._read = (li, s)

    def _finish_read(self) -> None:
        if self._read is None:
            return
        t0 = time.perf_counter()
        failed = self._aio.wait()
        self.read_wait_s += time.perf_counter() - t0
        self._read = None
        if failed:
            from ..ops.aio import AioError
            raise AioError(f"weight store {self.dir!r}: {failed} failed "
                           "chunk(s) reading a layer")

    # ---- fetch -----------------------------------------------------------
    def fetch_layer(self, li: int) -> Dict[str, Any]:
        """Layer ``li``'s payload tree, as views of a device slot that the
        current stream may read once this returns (it waits for the
        slot's copy).  Starts the next layer's read.  The views stay
        valid until :meth:`release_layer` and the fetch after next."""
        if not self._host:
            self._make_slots()
        s = self._turn % 2
        self._turn += 1
        if self._read != (li, s):
            self._finish_read()          # a read of another layer: drop it
            self._start_read(li, s)
        self._finish_read()
        self.bytes_read += self.layer_bytes
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            cs = self._copy_stream
            if self._free[s] is not None:
                cs.wait_event(self._free[s])
            with torch.cuda.stream(cs):
                self._dev[s].copy_(self._host[s], non_blocking=True)
            self._h2d[s] = self._record(self._h2d[s], cs)
            if self.measure:
                before = torch.cuda.Event(enable_timing=True)
                before.record(cur)
            cur.wait_event(self._h2d[s])
            if self.measure:
                after = torch.cuda.Event(enable_timing=True)
                after.record(cur)
                self._stalls.append((before, after))
        else:
            self._dev[s].copy_(self._host[s])
        self._slot = s
        self._start_read((li + 1) % self.num_layers, self._turn % 2)
        return self._trees[s]

    def release_layer(self) -> None:
        """The forward is done with the last fetched layer: its device
        slot may be copied into once the current stream passes here."""
        s, self._slot = self._slot, None
        if s is not None and self._cuda:
            self._free[s] = self._record(
                self._free[s], torch.cuda.current_stream(self.device))

    @staticmethod
    def _record(ev, stream):
        """``ev`` (made at its first use) recorded on ``stream``."""
        ev = ev or torch.cuda.Event()
        ev.record(stream)
        return ev

    def stall_ms(self) -> float:
        """Milliseconds the compute stream waited on a slot's copy since
        the last call (``measure`` on; synchronizes)."""
        total = 0.0
        for before, after in self._stalls:
            after.synchronize()
            total += before.elapsed_time(after)
        self._stalls = []
        return total

    def _read_layer_host(self, li: int) -> List[torch.Tensor]:
        """Layer ``li``'s leaves read synchronously into fresh host
        tensors (nothing of the slots is touched)."""
        self._finish_read()
        out = []
        for j, (shape, dtype) in enumerate(self._shapes):
            buf = torch.empty(_nbytes(shape, dtype), dtype=torch.uint8)
            self._aio.sync_pread(buf, self._file(li, j),
                                 offset=self._offsets[(li, j)])
            out.append(_view(buf, 0, shape, dtype))
        return out

    def restore_stacked(self) -> Any:
        """Read every layer back through the aio pool and rebuild the
        stacked tree, resident on the store's device: the cold start of a
        new replica from a store spilled once at deploy (its engine then
        serves with resident weights)."""
        assert self._shapes, "restore before spill"
        cols = list(zip(*(self._read_layer_host(li)
                          for li in range(self.num_layers))))
        return _unflatten(self._paths, [
            torch.stack(col).to(self.device) for col in cols])

    def close(self) -> None:
        """Land any read in flight (a prefetch) before the slots go."""
        if self._read is not None:
            self._aio.wait()
            self._read = None

    def __del__(self):
        if self.__dict__.get("_read") is not None:
            self.close()


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= s
    return n


def _view(flat: torch.Tensor, offset: int, shape, dtype: torch.dtype
          ) -> torch.Tensor:
    """The ``dtype`` tensor of ``shape`` at byte ``offset`` of a flat uint8
    buffer."""
    n = _nbytes(shape, dtype)
    return flat[offset:offset + n].view(dtype).view(tuple(shape))
