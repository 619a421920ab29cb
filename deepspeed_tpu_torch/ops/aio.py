"""Python handle over the port's native aio pool (``csrc/aio.cpp``).

Counterpart of ``deepspeed_tpu/ops/aio.py``: ``AioError`` and
``AsyncIOHandle`` (block_size/queue_depth/thread_count ctor; sync and
async pread/pwrite; wait), consumed by the swap layer
(``runtime/swap_tensor.py``).  The library is host C++ built by g++ at
first use (``builder.HostOpBuilder``), here and on the card's machine.

A buffer is a C-contiguous numpy array or a contiguous CPU
``torch.Tensor``, pinned or not: the pool reads and writes its memory
through its address, so a swap can land straight in pinned memory and go
on to the card from there.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .builder import HostOpBuilder

BUILDER = HostOpBuilder("aio", ["aio.cpp"], headers=["uring.h"])

Buffer = Union[np.ndarray, torch.Tensor]


class AioError(OSError):
    """Typed failure from the aio pool: a read against a missing or
    short file, or chunks the backend reported failed.  A partial buffer
    is never returned silently.

    ``path`` names the file, ``expected`` the bytes the caller needed,
    ``actual`` the bytes available (or the failed-chunk count for a
    backend failure; ``None`` when the file is missing outright)."""

    def __init__(self, msg: str, path: Optional[str] = None,
                 expected: Optional[int] = None,
                 actual: Optional[int] = None):
        super().__init__(msg)
        self.path = path
        self.expected = expected
        self.actual = actual


def _address(buffer: Buffer) -> Tuple[int, int]:
    """(address, bytes) of a contiguous host buffer."""
    if isinstance(buffer, torch.Tensor):
        if buffer.device.type != "cpu":
            raise ValueError("aio buffers live in host memory; got a "
                             f"tensor on {buffer.device}")
        if not buffer.is_contiguous():
            raise ValueError("buffer must be contiguous")
        return buffer.data_ptr(), buffer.numel() * buffer.element_size()
    if not buffer.flags["C_CONTIGUOUS"]:
        raise ValueError("buffer must be C-contiguous")
    return buffer.ctypes.data, buffer.nbytes


def _load():
    lib = BUILDER.load()
    lib.aio_create3.restype = ctypes.c_void_p
    lib.aio_create3.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
    lib.aio_backend.argtypes = [ctypes.c_void_p]
    lib.aio_backend.restype = ctypes.c_int
    lib.aio_uring_available.restype = ctypes.c_int
    lib.aio_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("aio_pread", "aio_pwrite", "aio_pwrite_trunc"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_void_p, ctypes.c_long,
                                     ctypes.c_long]
    for fn in ("aio_wait", "aio_pending"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("aio_odirect_ops", "aio_tasks_total"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_long
    return lib


def uring_available() -> bool:
    """Whether this kernel (and sandbox) lets the pool use io_uring."""
    return bool(_load().aio_uring_available())


class AsyncIOHandle:
    """Chunked, threaded file I/O for host buffers.

    Every knob is consumed by ``csrc/aio.cpp``: ``queue_depth`` bounds the
    chunks in flight, ``single_submit`` turns chunking off (and with it
    O_DIRECT), ``overlap_events=False`` drains each submit before
    returning, ``use_odirect`` sends 4096-aligned spans through O_DIRECT
    with aligned bounce buffers (a filesystem without it, such as tmpfs,
    falls back per chunk; ``odirect_ops()`` counts what went direct)."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 128,
                 thread_count: int = 4, single_submit: bool = False,
                 overlap_events: bool = True, use_odirect: bool = False,
                 backend: str = "auto"):
        """``backend``: "uring" (io_uring), "threads" (a pread/pwrite
        worker pool) or "auto" (io_uring where the kernel allows it).
        Where io_uring is refused the pool is the thread pool whatever was
        asked; ``self.backend`` names the one built."""
        if backend not in ("auto", "uring", "threads"):
            raise ValueError(f"backend={backend!r}: expected 'auto', "
                             "'uring' or 'threads'")
        self._lib = lib = _load()
        want = {"auto": -1, "threads": 0, "uring": 1}[backend]
        self._h = lib.aio_create3(thread_count, block_size, queue_depth,
                                  int(single_submit), int(overlap_events),
                                  int(use_odirect), want)
        self.backend = ("uring" if lib.aio_backend(self._h) == 1
                        else "threads")
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count
        self.single_submit = single_submit
        self.overlap_events = overlap_events
        self.use_odirect = use_odirect
        # buffers of queued ops, kept alive until wait()
        self._inflight = []

    @classmethod
    def from_config(cls, aio_cfg, **overrides) -> "AsyncIOHandle":
        """Build from a :class:`~deepspeed_tpu_torch.config.config.AioConfig`
        (every field read)."""
        kw = dict(block_size=aio_cfg.block_size,
                  queue_depth=aio_cfg.queue_depth,
                  thread_count=aio_cfg.thread_count,
                  single_submit=aio_cfg.single_submit,
                  overlap_events=aio_cfg.overlap_events,
                  use_odirect=aio_cfg.use_odirect,
                  backend=aio_cfg.backend)
        kw.update(overrides)
        return cls(**kw)

    def odirect_ops(self) -> int:
        """Chunks that actually went through O_DIRECT so far."""
        return int(self._lib.aio_odirect_ops(self._h))

    def tasks_total(self) -> int:
        return int(self._lib.aio_tasks_total(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        lib = getattr(self, "_lib", None)
        if not h or lib is None:
            return
        leaked = int(lib.aio_pending(h))
        if leaked:
            # a handle dropped with ops queued is a caller bug (the
            # buffers may go while the pool still targets them): say so,
            # then drain so that destruction is safe
            warnings.warn(
                f"AsyncIOHandle destroyed with {leaked} pending op(s); "
                "call wait() before dropping the handle", ResourceWarning,
                stacklevel=2)
            lib.aio_wait(h)
        lib.aio_destroy(h)
        self._h = None

    # ---- async ----------------------------------------------------------
    def async_pread(self, buffer: Buffer, path: str, offset: int = 0):
        """Queue a read of exactly the buffer's bytes at ``offset``.

        Raises :class:`AioError` up front when the file is missing or
        shorter than the span: queueing would fill part of the buffer and
        leave the rest stale."""
        addr, nbytes = _address(buffer)
        p = os.fspath(path)
        need = offset + nbytes
        try:
            have = os.stat(p).st_size
        except OSError as e:
            raise AioError(f"async_pread: {p!r}: {e.strerror or e}",
                           path=p, expected=need) from e
        if have < need:
            raise AioError(
                f"async_pread: short file {p!r}: need {need} bytes, "
                f"file has {have} — refusing a partial read",
                path=p, expected=need, actual=have)
        self._inflight.append(buffer)
        self._lib.aio_pread(self._h, p.encode(), addr, nbytes, offset)

    def async_pwrite(self, buffer: Buffer, path: str, offset: int = 0,
                     truncate: bool = False):
        """``truncate=True`` marks a whole-file rewrite: the file is cut
        to ``offset + nbytes`` first, so a smaller rewrite leaves no stale
        tail.  Off by default: a partial write keeps the bytes around
        it."""
        addr, nbytes = _address(buffer)
        fn = (self._lib.aio_pwrite_trunc if truncate
              else self._lib.aio_pwrite)
        self._inflight.append(buffer)
        fn(self._h, os.fspath(path).encode(), addr, nbytes, offset)

    def wait(self) -> int:
        """Drain outstanding requests; returns the number of failed
        chunks.  A no-op once the handle is destroyed (its destructor
        drained it): an owner's finalizer may run after the handle's,
        when the collector frees both in one cycle."""
        if not self._h:
            return 0
        failed = self._lib.aio_wait(self._h)
        self._inflight = []
        return failed

    def pending(self) -> int:
        return self._lib.aio_pending(self._h) if self._h else 0

    # ---- sync -----------------------------------------------------------
    def sync_pread(self, buffer: Buffer, path: str, offset: int = 0) -> int:
        """Read and drain; raises :class:`AioError` when any chunk fails
        (a file that shrank or went after the size check, an EIO).
        Returns 0, the reference's failed-chunk count."""
        self.async_pread(buffer, path, offset)
        failed = self.wait()
        if failed:
            raise AioError(
                f"sync_pread: {failed} failed chunk(s) reading "
                f"{os.fspath(path)!r}", path=os.fspath(path),
                expected=offset + _address(buffer)[1], actual=failed)
        return 0

    def sync_pwrite(self, buffer: Buffer, path: str, offset: int = 0,
                    truncate: bool = False) -> int:
        self.async_pwrite(buffer, path, offset, truncate=truncate)
        return self.wait()


__all__ = ["AioError", "AsyncIOHandle", "BUILDER", "uring_available"]
