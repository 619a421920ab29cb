"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a CUDA device every test here skips (a
CUDA kernel has no interpret mode).

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX, where tests/conftest.py (which imports JAX) cannot
load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 24, 64, 256])
@pytest.mark.parametrize("H, Hkv, D", [(32, 8, 128), (12, 12, 64),
                                       (8, 1, 64)],
                         ids=["llama3-8b", "gpt2", "mqa"])
def test_paged_attention_kernel_matches_plain(cuda_device, H, Hkv, D, bs):
    """bf16: a prefill chunk, a decode token whose table aliases the
    chunk's first blocks, a position-0 token and a decode token at an
    8192-token context; atol = rtol = 2e-2 (the bar of
    tests/test_paged_attention.py)."""
    rng = np.random.RandomState(bs)
    nb = -(-8192 // bs)                      # blocks of the longest row
    nblocks = nb + 16
    tables = np.full((5, nblocks), -1, np.int32)
    chunk_blocks = -(-96 // bs)
    tables[0, :chunk_blocks] = rng.permutation(nblocks)[:chunk_blocks]
    tables[1, :1] = tables[0, :1]                   # aliased prefix
    tables[1, 1:-(-120 // bs)] = nblocks - 1
    tables[2, 0] = tables[0, 0]
    tables[3, :nb] = rng.randint(0, nblocks, nb)     # long context
    toks = ([(0, p) for p in range(32, 96)] + [(1, 119), (2, 0),
                                                (3, 8191)])
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(bs)
    kv = torch.randn(nblocks + 1, bs, 2, Hkv, D, device=dev,
                     dtype=torch.bfloat16, generator=gen)
    q = torch.randn(len(toks), H, D, device=dev, dtype=torch.bfloat16,
                    generator=gen)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    args = (kv, q, as_t([s for s, _ in toks]), as_t([p for _, p in toks]),
            as_t(tables), bs, nb, D ** -0.5)
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    kv = torch.zeros(3, 16, 2, 2, 128, device=cuda_device,
                     dtype=torch.bfloat16)
    q = torch.zeros(2, 4, 128, device=cuda_device, dtype=torch.bfloat16)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=cuda_device)  # noqa: E731
    ok = (kv, q, i32(2), i32(2), i32(2, 2), 16, 2, 0.1)
    paged_attention(*ok)
    with pytest.raises(ValueError, match="bf16"):
        paged_attention(kv.float(), q.float(), *ok[2:])
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(kv[..., :32].contiguous(), q[..., :32].contiguous(),
                        *ok[2:])
    with pytest.raises(ValueError, match="rep"):
        paged_attention(kv[:, :, :, :1].contiguous(),
                        torch.zeros(2, 16, 128, device=cuda_device,
                                    dtype=torch.bfloat16), *ok[2:])
    with pytest.raises(ValueError, match="int32"):
        paged_attention(kv, q, i32(2).long(), *ok[3:])
    torch.cuda.synchronize()
