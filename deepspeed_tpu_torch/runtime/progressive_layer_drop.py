"""Progressive layer drop: the theta schedule
theta(t) = (1 - theta) * exp(-gamma * t) + theta that the transformer's
per-layer keep probability reads.

Counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py``
(host arithmetic only, copied as it is)."""

from __future__ import annotations

import math


class ProgressiveLayerDrop:
    """(reference: ProgressiveLayerDrop.__init__/update_state)."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = ((1.0 - self.theta) *
                              math.exp(-self.gamma * global_step) +
                              self.theta)
        return self.current_theta

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def layer_keep_prob(self, layer_idx: int, num_layers: int) -> float:
        """Per-layer keep probability: deeper layers drop more,
        1 - (i / L) (1 - theta)."""
        return 1.0 - (layer_idx / max(1, num_layers)) * \
            (1.0 - self.current_theta)
