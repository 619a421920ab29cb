"""Offload on the card: ZeRO-Offload's pinned ring, an aio read into
pinned memory, and a streamed step through the flash kernels.

Marked ``cuda``: without a CUDA device every test here skips (the
streamed step runs the flash kernels, which have no interpret mode, and
pinned memory needs the CUDA driver).  This file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_offload_cuda.py

Tolerances: the offloaded run's losses bitwise the device-resident
twin's (the device work is the same, and the host's AdamW rounds as the
card's: IEEE elementwise operations, a correctly rounded square root);
masters within 1e-6 absolute (2^-20 at the weights' scale: the same
operations, which may still be fused differently by the two compilers).
"""

import importlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves

fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned memory, the flash kernels)")


def _gpt2():
    return build_model("gpt2", num_layers=2, d_model=128, num_heads=4,
                       vocab_size=512, max_seq_len=128,
                       attention_impl="flash", seed=1)


def _config(zero):
    return {"train_micro_batch_size_per_device": 2, "bf16": {"enabled": True},
            "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
            "gradient_clipping": 1.0, "steps_per_print": 1000,
            "zero_optimization": {"stage": 2, **zero}}


def _batches(n):
    r = np.random.RandomState(0)
    return [{"input_ids": r.randint(0, 512, (2, 128))} for _ in range(n)]


@pytest.mark.cuda
def test_pinned_offload_step_equals_the_resident_twin():
    plain = tds.initialize(model=_gpt2(), config=_config({}))
    off = tds.initialize(model=_gpt2(), config=_config({
        "offload_optimizer": {"device": "cpu", "buffer_count": 2,
                              "buffer_size": 1 << 16}}))
    host = tree_leaves(off.state.master) + tree_leaves(off.state.opt_state)
    assert all(t.device.type == "cpu" and t.is_pinned() for t in host)
    for b in _batches(3):
        lp = float(plain.train_batch(b)["loss"])
        lo = float(off.train_batch(b)["loss"])
        assert lo == lp
    for x, y in zip(tree_leaves(off.state.master),
                    tree_leaves(plain.state.master)):
        torch.testing.assert_close(x, y.cpu(), atol=1e-6, rtol=0)
    assert off.offload_times["h2d_bytes"] > 0


@pytest.mark.cuda
def test_aio_read_into_pinned_memory_then_to_the_card(tmp_path):
    x = torch.randn(1 << 20)
    h = AsyncIOHandle(block_size=1 << 16)
    h.sync_pwrite(x, str(tmp_path / "x.bin"))
    pinned = torch.empty(1 << 20, pin_memory=True)
    h.sync_pread(pinned, str(tmp_path / "x.bin"))
    dev = pinned.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu(), x)


@pytest.mark.cuda
def test_streamed_step_launches_the_flash_kernels(tmp_path):
    nvme = {"device": "nvme", "nvme_path": str(tmp_path)}
    eng = tds.initialize(model=_gpt2(), config=_config({
        "stage": 3, "offload_optimizer": nvme, "offload_param": nvme}))
    assert eng._stream is not None
    fa.reset_launches()
    met = eng.train_batch(_batches(1)[0])
    assert np.isfinite(float(met["loss"]))
    # the sweep's forward and the recompute's, one backward a layer
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (4, 2, 2)
