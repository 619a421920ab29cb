"""The port's training engine follows the JAX engine step for step on a
tiny GPT-2 (2 layers, d_model 128, S=128, learned positions, tied
embeddings, biases) with ``attention_impl="flash"``: 8 AdamW steps at
gas 1 and 2 in fp32, and one bf16 run.

Tolerances: fp32 — per-step loss and grad norm rtol 1e-4, final params
atol 1e-4 (the same arithmetic, sums in another order; see
tests/test_torch_train.py for the one leaf left out).  bf16 — loss rtol
2e-3 and grad norm rtol 1e-2, final params atol 2e-2: bf16 keeps 8
significant bits (2^-8 = 3.9e-3 relative per rounding) and the two
frameworks round activations and probabilities at different places."""

import numpy as np
import pytest

from tests.test_torch_train import (  # noqa: F401 (one_thread: autouse)
    NULL_GRAD_LEAVES, assert_trajectories_agree, one_thread,
    run_trajectories)


@pytest.mark.parametrize("gas", [1, 2])
def test_fp32_trajectory_matches_jax(gas):
    assert_trajectories_agree(*run_trajectories("gpt2", gas), rtol=1e-4,
                              atol=1e-4)


def test_bf16_trajectory_matches_jax():
    jtraj, ttraj, jp, tp = run_trajectories("gpt2", 1, bf16=True)
    np.testing.assert_allclose(ttraj[:, 0], jtraj[:, 0], rtol=2e-3)
    np.testing.assert_allclose(ttraj[:, 1], jtraj[:, 1], rtol=1e-2)
    for key in jp:
        if key not in NULL_GRAD_LEAVES:
            np.testing.assert_allclose(tp[key], jp[key], atol=2e-2,
                                       err_msg=key)
