"""The port's aio pool (``deepspeed_tpu_torch/ops/aio.py`` over
``ops/csrc/aio.cpp``), built with g++ here, against the JAX package's
(``deepspeed_tpu/ops/aio.py`` over ``deepspeed_tpu/native/aio.cpp``).

Round trips are bitwise (the pool copies bytes).  The io_uring legs skip
with a reason where the kernel refuses ``io_uring_setup``.  The poisoned
engine's destructor must return within DESTROY_LIMIT_S.
"""

import os
import re
import threading

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxAsyncIOHandle
from deepspeed_tpu_torch.ops import aio as port_aio
from deepspeed_tpu_torch.ops.aio import AioError, AsyncIOHandle
from deepspeed_tpu_torch.ops.builder import GXX_FLAGS
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

DESTROY_LIMIT_S = 10.0
BACKENDS = ["threads", "uring"]


def _need(backend):
    if backend == "uring" and not port_aio.uring_available():
        pytest.skip("io_uring_setup (or its read/write opcodes) is refused "
                    "by this kernel or sandbox")


def _buffer(kind, n, seed):
    a = np.random.RandomState(seed).randn(n).astype(np.float32)
    return a if kind == "numpy" else torch.from_numpy(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def test_library_builds_with_gxx():
    """The host builder: g++ with the reference's flags, cached under
    build/kernels/ by a hash of aio.cpp and uring.h."""
    assert GXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17",
                         "-pthread"]
    lib = port_aio.BUILDER.load()
    so = port_aio.BUILDER.library_path()
    assert so.exists() and so.parent.name == "kernels"
    assert so.name.startswith("aio_")
    assert lib.aio_uring_available() in (0, 1)
    assert port_aio.BUILDER.compiler().endswith("g++")
    # every header the source includes is in the cache key
    src = (so.parents[2] / "deepspeed_tpu_torch" / "ops" / "csrc" /
           "aio.cpp").read_text()
    assert set(re.findall(r'#include "([^"]+)"', src)) == set(
        port_aio.BUILDER.headers) == {"uring.h"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("odirect", [False, True])
def test_sync_and_async_round_trips(tmp_path, backend, kind, odirect):
    _need(backend)
    h = AsyncIOHandle(block_size=1 << 16, queue_depth=8, thread_count=4,
                      use_odirect=odirect, backend=backend)
    assert h.backend == backend
    x = _buffer(kind, 300_001, 0)               # not a 4096 multiple
    path = str(tmp_path / "x.bin")
    assert h.sync_pwrite(x, path) == 0
    y = _buffer(kind, 300_001, 1)
    assert h.sync_pread(y, path) == 0
    np.testing.assert_array_equal(_np(y), _np(x))
    # async: two writes in flight, then two reads
    a, b = _buffer(kind, 70_000, 2), _buffer(kind, 50_000, 3)
    h.async_pwrite(a, str(tmp_path / "a.bin"))
    h.async_pwrite(b, str(tmp_path / "b.bin"))
    assert h.pending() >= 0
    assert h.wait() == 0
    ra, rb = _buffer(kind, 70_000, 4), _buffer(kind, 50_000, 5)
    h.async_pread(ra, str(tmp_path / "a.bin"))
    h.async_pread(rb, str(tmp_path / "b.bin"))
    assert h.wait() == 0 and h.pending() == 0
    np.testing.assert_array_equal(_np(ra), _np(a))
    np.testing.assert_array_equal(_np(rb), _np(b))
    assert h.tasks_total() > 0
    assert h.odirect_ops() >= 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_offsets_and_truncate(tmp_path, backend):
    _need(backend)
    h = AsyncIOHandle(block_size=4096, backend=backend)
    path = str(tmp_path / "o.bin")
    whole = np.arange(10_000, dtype=np.float32)
    h.sync_pwrite(whole, path)
    part = torch.full((1000,), -1.0)
    h.sync_pwrite(part, path, offset=4 * 2000)   # keeps the bytes around
    back = np.empty(10_000, np.float32)
    h.sync_pread(back, path)
    want = whole.copy()
    want[2000:3000] = -1.0
    np.testing.assert_array_equal(back, want)
    sub = torch.empty(500)
    h.sync_pread(sub, path, offset=4 * 2500)
    np.testing.assert_array_equal(sub.numpy(), want[2500:3000])
    h.sync_pwrite(np.ones(10, np.float32), path, truncate=True)
    assert os.path.getsize(path) == 40


def test_missing_and_short_files_raise(tmp_path):
    h = AsyncIOHandle()
    with pytest.raises(AioError) as e:
        h.sync_pread(np.empty(10, np.float32), str(tmp_path / "none.bin"))
    assert e.value.actual is None and e.value.expected == 40
    path = str(tmp_path / "short.bin")
    h.sync_pwrite(np.ones(5, np.float32), path)
    with pytest.raises(AioError, match="short file") as e:
        h.sync_pread(torch.empty(10), path)
    assert (e.value.expected, e.value.actual) == (40, 20)
    with pytest.raises(ValueError, match="contiguous"):
        h.sync_pwrite(torch.ones(4, 4).t(), path)
    with pytest.raises(ValueError, match="backend"):
        AsyncIOHandle(backend="libaio")


def test_from_config_reads_every_knob():
    from deepspeed_tpu_torch.config.config import AioConfig
    cfg = AioConfig(block_size=8192, queue_depth=16, thread_count=2,
                    single_submit=True, overlap_events=False,
                    use_odirect=True, backend="threads")
    h = AsyncIOHandle.from_config(cfg)
    assert (h.block_size, h.queue_depth, h.thread_count, h.single_submit,
            h.overlap_events, h.use_odirect, h.backend) == (
        8192, 16, 2, True, False, True, "threads")


@pytest.mark.parametrize("backend", BACKENDS)
def test_files_cross_with_the_jax_pool(tmp_path, backend):
    """What the port's pool writes the JAX package's reads, and the
    reverse."""
    _need(backend)
    port = AsyncIOHandle(block_size=1 << 15, backend=backend)
    ref = JaxAsyncIOHandle(block_size=1 << 15, backend=backend)
    x = np.random.RandomState(0).randn(123_457).astype(np.float32)
    port.sync_pwrite(torch.from_numpy(x), str(tmp_path / "p.bin"))
    y = np.empty_like(x)
    ref.sync_pread(y, str(tmp_path / "p.bin"))
    np.testing.assert_array_equal(y, x)
    ref.sync_pwrite(x[::-1].copy(), str(tmp_path / "j.bin"))
    z = torch.empty(x.size)
    port.sync_pread(z, str(tmp_path / "j.bin"))
    np.testing.assert_array_equal(z.numpy(), x[::-1])


def _uring_fds():
    out = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            if "io_uring" in os.readlink(f"/proc/self/fd/{fd}"):
                out.add(int(fd))
        except OSError:
            pass
    return out


def test_poisoned_engine_is_destroyed_within_a_limit(tmp_path):
    """A submit that fails fatally poisons the io_uring engine (the ring
    fd is swapped for /dev/null: io_uring_enter then fails with an errno
    outside EINTR/EAGAIN/EBUSY).  The failed chunks come back from
    ``wait``, and the destructor returns: the reaper leaves on its
    eventfd wake, with no sentinel submission to depend on."""
    _need("uring")
    before = _uring_fds()
    h = AsyncIOHandle(block_size=4096, queue_depth=4, backend="uring")
    ring = sorted(_uring_fds() - before)
    assert len(ring) == 1, ring
    null = os.open(os.devnull, os.O_RDWR)
    try:
        os.dup2(null, ring[0])
    finally:
        os.close(null)
    x = np.ones(3 * 4096, np.float32)
    h.async_pwrite(x, str(tmp_path / "p.bin"))
    assert h.wait() > 0                  # the failed chunks are reported
    assert h.pending() == 0
    done = threading.Event()

    def destroy(handle=h):
        handle.__del__()
        done.set()

    del h
    t = threading.Thread(target=destroy, daemon=True)
    t.start()
    assert done.wait(DESTROY_LIMIT_S), "the destructor did not return"
