"""Hybrid engine: one set of weights for RLHF training and fast generation.

Counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py`` (the
DeepSpeed-Chat actor loop).  The training half is the ordinary
:class:`~.engine.Engine`; the generation half the serving
:class:`~..inference.InferenceEngine` (paged KV cache, CUDA graphs,
paged attention).  ``generate()`` refreshes the served weights from the
training masters when a train step has run since the last refresh: the
engine's ``compute_params`` (the masters cast, MoQ applied), LoRA nodes
fused (``fuse_lora_tree``), then ``InferenceEngine.refresh_params``,
which copies them into the served tensors in place (the captured graphs
keep their addresses), re-quantizes under ``weight_quant`` and resets
the prefix cache.  Live sequences are flushed first: every rollout starts
against the new policy.

Usage::

    he = HybridEngine(model, config, inference_config=InferenceConfig(...))
    rollouts = he.generate({0: prompt_tokens}, SamplingParams(...))
    metrics = he.train_batch(ppo_batch)
    rollouts = he.generate(...)               # sees the updated policy
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..utils.logging import logger


def fuse_lora_tree(params: Any, lora_config) -> Any:
    """Every ``{base, lora_a, lora_b}`` node merged into ``{base: dense
    fused weight}`` (a new tree; the trainable factors are untouched)."""
    from ..linear.optimized_linear import merge_lora

    if isinstance(params, dict):
        if "lora_a" in params:
            merged = {k: v for k, v in params.items()
                      if k not in ("lora_a", "lora_b")}
            merged["base"] = merge_lora(params, lora_config)
            return merged
        return {k: fuse_lora_tree(v, lora_config) for k, v in params.items()}
    return params


class HybridEngine:
    """``initialize(model=model, config=config, device=device)`` plus a
    lazily built serving engine on the same model.  ``device`` None is
    the card (raising without one); the model must live on the training
    engine's device."""

    def __init__(self, model, config, inference_config=None,
                 lora_config=None, *, device=None, **engine_kw):
        from .. import initialize
        from ..inference import InferenceConfig

        self.model = model
        self.engine = initialize(model=model, config=config, device=device,
                                 **engine_kw)
        if getattr(model, "device", self.engine.device) != self.engine.device:
            raise ValueError(
                f"HybridEngine: the model lives on {model.device}, the "
                f"training engine on {self.engine.device}; build the model "
                "on the engine's device")
        self.lora_config = lora_config
        self._icfg = inference_config or InferenceConfig()
        self._infer = None
        self._params_step = -1          # train step the served weights match
        self.refresh_seconds: List[float] = []

    # ------------------------------------------------------------ training
    def train_batch(self, batch):
        """One actor optimizer step (the training engine's)."""
        return self.engine.train_batch(batch)

    def eval_batch(self, batch):
        return self.engine.eval_batch(batch)

    def save_checkpoint(self, *a, **kw):
        return self.engine.save_checkpoint(*a, **kw)

    def load_checkpoint(self, *a, **kw):
        out = self.engine.load_checkpoint(*a, **kw)
        self._params_step = -1          # the served weights are stale
        return out

    # ---------------------------------------------------------- generation
    def _serving_params(self):
        """Training masters -> serving weights: the compute cast, then the
        LoRA fuse."""
        params = self.engine.compute_params
        if self.lora_config is not None:
            params = fuse_lora_tree(params, self.lora_config)
        return params

    def _refresh(self) -> None:
        import time

        step = int(self.engine.state.step)
        if self._infer is not None and step == self._params_step:
            return
        from ..inference import InferenceEngine

        t0 = time.perf_counter()
        if self._infer is None:
            self._infer = InferenceEngine(self.model, self._icfg)
        else:
            # a new policy invalidates every live sequence's KV
            for uid in list(self._infer.state.seqs):
                self._infer.flush(uid)
        params = self._serving_params()
        self._infer.refresh_params(params)
        del params
        if self._infer.device.type == "cuda":
            torch.cuda.synchronize(self._infer.device)
        self.refresh_seconds.append(time.perf_counter() - t0)
        self._params_step = step
        logger.info(f"hybrid-engine: serving weights refreshed @ step {step}")

    def generate(self, prompts: Dict[int, Sequence[int]], sampling=None,
                 rng: Optional[torch.Tensor] = None) -> Dict[int, List[int]]:
        """Generation against the CURRENT policy weights."""
        from ..inference.sampler import SamplingParams

        self._refresh()
        return self._infer.generate(prompts, sampling or SamplingParams(),
                                    rng=rng)

    @property
    def inference_engine(self):
        """The live serving engine (refreshed first)."""
        self._refresh()
        return self._infer
