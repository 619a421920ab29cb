"""K2-TP on the card: paged attention (K2) on each tensor-parallel rank's
head group, two ranks sharing one card over gloo (NCCL puts no two ranks
of one communicator on one device).

Marked ``cuda``: without a CUDA device every test here skips.  At
Llama-3-8B's heads (32 query heads over 8 KV heads of 128) under
``tensor=2``, each rank launches the hand-written K2 on its 16 query and
4 KV heads (an int8 cache's codes and scales cut with them) and must lie
within NOISE_FACTOR x the bf16 noise floor of the plain version in fp32
(the floor: the plain version in bf16 against it in fp32); the ranks'
outputs gathered over the head dim must be the full heads' kernel output
within twice that tolerance (each lies within it of the fp32 plain
version).  This file imports neither JAX nor the JAX
package, and its ranks run ``tests/torch_ranks.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tp_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

# by its own name (a spawned rank imports it so): an installed package
# named ``tests`` would shadow the repo's ``tests`` directory
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import rank_pool  # noqa: E402

NOISE_FACTOR = 2.0


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K2 on each rank's head group)")
    p = rank_pool(2, tmp_path_factory.mktemp("tp_cuda_store"), device="cuda")
    yield p
    p.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_k2_on_each_rank_head_group_within_noise(pool, kv_quant):
    for r, o in enumerate(pool.run("k2_tp", 0, kv_quant)):
        assert o["launched"] == 1, (r, o)
        assert o["finite"] and o["shape"][1] == 16
        tol = NOISE_FACTOR * o["noise"]
        assert o["err"] <= tol, (r, o)
        assert o["gathered_err"] <= 2 * tol, (r, o)
