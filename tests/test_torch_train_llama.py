"""The port's training engine follows the JAX engine step for step on a
tiny Llama (2 layers, d_model 128, S=128, GQA rep 2, rope, rmsnorm, gated
silu MLP, untied head, no biases) with ``attention_impl="flash"``: 8
AdamW steps in fp32 at gas 1 and 2.  Tolerances as in
tests/test_torch_train_gpt2.py: loss and grad norm rtol 1e-4, final
params atol 1e-4."""

import pytest

from tests.test_torch_train import (  # noqa: F401 (one_thread: autouse)
    assert_trajectories_agree, one_thread, run_trajectories)


@pytest.mark.parametrize("gas", [1, 2])
def test_fp32_trajectory_matches_jax(gas):
    assert_trajectories_agree(*run_trajectories("llama", gas), rtol=1e-4,
                              atol=1e-4)
