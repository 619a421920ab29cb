"""Training engine on one device.

Counterpart of ``deepspeed_tpu/runtime/engine.py``: ``TrainState``,
``Engine`` and ``initialize`` (:2238), the single-device, non-offloaded
path.  One ``train_batch`` is one optimizer step:

1. ``_compute_params``: the fp32 master cast to the compute dtype (:918);
2. the grad pipeline (:1471): a Python loop over the ``gas``
   micro-batches, each ``torch.autograd.grad`` of ``loss * scale / gas``
   w.r.t. the compute parameters, cast to fp32 and summed (bf16 grads of
   bf16 parameters, then fp32, as in the JAX step);
3. the epilogue (:1546): unscale, ``all_finite`` (fp16 only), clip;
4. the update (:1562): ``step + 1``, the optimizer's deltas added to the
   master, skipped on an fp16 overflow, the loss-scaler update and
   ``lr = schedule(new_step)``.

The port owns its master, moments and gradients, and updates them in
place where that saves memory: the gradients are cast, unscaled and
clipped in place, and the update runs one leaf at a time (its delta added
to the master and its new moments replacing the old as each is made), so
the step never holds a second copy of the optimizer state or a tree of
updates.  The arithmetic is the same, element for element.

The JAX engine fuses the step into one jitted program; here it runs
eagerly.  bf16 and fp32 steps never wait for the device (the metrics stay
on it until read); an fp16 step reads its overflow flag on the host.

ZeRO stages 0-3 are accepted: on one device partitioning is the identity,
as on the JAX engine's one-device mesh.  Every other engine feature raises
``NotImplementedError`` naming its ROADMAP item when it is configured.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config.config import Config, load_config
from ..platform.cuda import resolve_device
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .loss_scaler import LossScaler, LossScaleState, all_finite
from .lr_schedules import build_schedule, constant
from .optimizers import Optimizer, build_optimizer
from .runtime_utils import (clip_by_global_norm_, param_count, tree_leaves,
                            tree_map, tree_unflatten)

PRECISION_DTYPE = {"fp32": torch.float32, "fp16": torch.float16,
                   "bf16": torch.bfloat16}

_MULTI = "ROADMAP Queue 1 item 6 (multi-GPU training breadth)"
_HOST = "ROADMAP Queue 1 item 5 (host layers: telemetry, monitor)"
_AUX = "ROADMAP Queue 1 item 7 (aux subsystems)"


class TrainState(NamedTuple):
    """Everything that persists across steps."""
    step: int                  # optimizer steps applied
    master: Any                # fp32 master params
    opt_state: Any             # optimizer moments (fp32 or moment_dtype)
    loss_scale: LossScaleState
    skipped: int               # overflow-skipped steps


class _StagedBatch(dict):
    """Marker: this batch is already on the engine's device (and, when
    staged with accumulate=True and gas > 1, reshaped to [gas, micro, ...])."""

    accumulate: bool = True


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


def _reject_unported(config: Config) -> None:
    """Raise for every configured feature the one-device engine lacks."""
    mesh = config.mesh
    for axis in ("data", "fsdp", "tensor", "seq", "expert", "pipe"):
        if getattr(mesh, axis) > 1:
            raise _not_ported(f"mesh.{axis}={getattr(mesh, axis)} (more than "
                              "one device)", _MULTI)
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise _not_ported("data parallelism over a process group", _MULTI)
    z = config.zero_optimization
    checks = [
        (z.offload_optimizer.device != "none",
         f"offload_optimizer.device={z.offload_optimizer.device!r}", _MULTI),
        (z.offload_param.device != "none",
         f"offload_param.device={z.offload_param.device!r}", _MULTI),
        (z.zero_quantized_gradients, "zero_quantized_gradients (qgZ)", _MULTI),
        (z.zero_quantized_weights, "zero_quantized_weights (qwZ)", _MULTI),
        (z.zero_hpz_partition_size > 1, "zero_hpz_partition_size", _MULTI),
        (z.mics_shard_size > 0, "mics_shard_size", _MULTI),
        (config.comm.overlap or config.comm.quantized_allreduce is not None,
         "comm.overlap / comm.quantized_allreduce", _MULTI),
        (config.sparse_gradients, "sparse_gradients", _MULTI),
        (config.progressive_layer_drop.enabled, "progressive_layer_drop",
         _AUX),
        (config.data_efficiency.enabled or config.curriculum_learning.enabled,
         "data_efficiency / curriculum_learning (random-LTD, curriculum)",
         _AUX),
        (config.quantize_training.enabled, "quantize_training (MoQ)", _AUX),
        (config.flops_profiler.enabled, "flops_profiler", _AUX),
        (config.telemetry.trace or config.telemetry.device
         or config.telemetry.anomaly or config.telemetry.profile is not None,
         "telemetry", _HOST),
        (config.tensorboard.enabled or config.csv_monitor.enabled
         or config.wandb.enabled or config.comet.enabled, "monitor", _HOST),
    ]
    for configured, what, item in checks:
        if configured:
            raise _not_ported(what, item)


class Engine:
    """One-device training engine (``deepspeed_tpu.runtime.engine.Engine``)."""

    def __init__(self, loss_fn: Callable, params: Any, config: Config,
                 topology=None, param_axes: Any = None,
                 sharding_rules: Optional[Dict] = None,
                 eval_fn: Optional[Callable] = None, monitor=None,
                 model: Any = None, device=None):
        """``loss_fn(params, batch, rng) -> loss`` or ``(loss, aux_dict)``;
        ``params`` a tree of tensors (any dtype and device; copied into
        the fp32 master on ``device``, None = the card).  ``rng`` is an int
        seed for the micro-batch (the JAX engine's key).  ``param_axes``
        and ``sharding_rules`` (tensor-parallel layout hints) are kept and
        have no effect on one device."""
        if topology is not None:
            raise _not_ported("a prebuilt mesh topology", _MULTI)
        if monitor is not None:
            raise _not_ported("monitor", _HOST)
        _reject_unported(config)
        self.config = config
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.param_axes = param_axes
        self.sharding_rules = sharding_rules
        self._model = model

        self.train_batch_size, self.micro_batch_size, self.gas = \
            config.resolve_batch_sizes(1)
        self.precision = config.precision
        self.compute_dtype = PRECISION_DTYPE[self.precision]
        self.scaler = LossScaler.from_config(config.fp16)
        self.zero_stage = config.zero_optimization.stage

        opt_cfg = config.optimizer
        lr = opt_cfg.params.get("lr", 1e-3)
        if config.scheduler is not None:
            sched_params = dict(config.scheduler.params)
            if config.scheduler.type in ("WarmupCosineLR",):
                sched_params.setdefault("lr", lr)
            self.lr_schedule = build_schedule(config.scheduler.type,
                                              sched_params)
        else:
            self.lr_schedule = constant(lr)
        self.optimizer: Optimizer = build_optimizer(
            opt_cfg.type, self.lr_schedule, opt_cfg.params)

        self.state = self._init_state(params)
        self.global_steps = 0
        self.global_samples = 0
        self.timers = SynchronizedWallClockTimer()
        self.tput = ThroughputTimer(batch_size=self.train_batch_size)
        self._last_metrics: Optional[Dict[str, Any]] = None
        self._last_metrics_host: Optional[Dict[str, Any]] = None
        log_dist(
            f"Engine: {param_count(self.state.master):,} params | "
            f"precision={self.precision} | zero_stage={self.zero_stage} | "
            f"device={self.device} | batch={self.train_batch_size} "
            f"(micro={self.micro_batch_size} x gas={self.gas} x dp=1)")

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _init_state(self, params) -> TrainState:
        master = tree_map(lambda p: torch.as_tensor(p).detach().to(
            device=self.device, dtype=torch.float32, copy=True), params)
        return TrainState(step=0, master=master,
                          opt_state=self.optimizer.init(master),
                          loss_scale=self.scaler.init(), skipped=0)

    def _compute_params(self, master, requires_grad: bool = False):
        """The master cast to the compute dtype (a fresh tensor per leaf,
        also in fp32, so the update never writes into a live graph)."""
        def cast(p):
            c = p.detach().to(self.compute_dtype, copy=True)
            return c.requires_grad_(requires_grad)
        return tree_map(cast, master)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _micro_loss(self, cparams, batch, rng):
        out = self.loss_fn(cparams, batch, rng)
        if isinstance(out, tuple):
            return out
        return out, {}

    def _grads(self, cparams, batch, rng: int, scale: float):
        """(mean loss, last aux, fp32 grads as a leaf list)."""
        gas = self.gas
        leaves = tree_leaves(cparams)
        acc = None
        loss_sum = None
        aux: Dict[str, Any] = {}
        for g in range(gas):
            mb = {k: v[g] for k, v in batch.items()} if gas > 1 else batch
            loss, aux = self._micro_loss(cparams, mb, rng * gas + g)
            grads = list(torch.autograd.grad(loss * scale / gas, leaves,
                                             allow_unused=True))
            for i, p in enumerate(leaves):     # each 16-bit grad freed as cast
                gr = grads[i]
                grads[i] = (torch.zeros_like(p, dtype=torch.float32)
                            if gr is None else gr.float())
                del gr
            if acc is None:
                acc = grads
            else:
                for a, gr in zip(acc, grads):
                    a.add_(gr)
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / gas, aux, acc

    def _train_step(self, batch, rng: int) -> Dict[str, Any]:
        use_scaling = self.precision == "fp16"
        loss_scale = self.state.loss_scale
        scale = loss_scale.scale if use_scaling else 1.0
        cparams = self._compute_params(self.state.master, requires_grad=True)
        loss, aux, grads = self._grads(cparams, batch, rng, scale)
        del cparams

        # epilogue: unscale, overflow check, clip
        cfg = self.config
        denom = scale * (cfg.gradient_predivide_factor
                         if cfg.prescale_gradients else 1.0)
        if denom != 1.0:
            for gr in grads:
                gr.div_(denom)
        finite = bool(all_finite(grads)) if use_scaling else True
        gnorm = clip_by_global_norm_(grads, cfg.gradient_clipping)

        step = self.state.step
        if finite:
            self._apply_update(grads, step + 1)
        del grads
        new_step = step + 1 if finite else step
        self.state = self.state._replace(
            step=new_step,
            loss_scale=self.scaler.update(loss_scale, not finite),
            skipped=self.state.skipped + (0 if finite else 1))
        return {"loss": loss, "grad_norm": gnorm,
                "lr": float(self.lr_schedule(float(new_step))),
                "loss_scale": float(loss_scale.scale),
                "overflow": int(not finite),
                **{f"aux/{k}": v for k, v in aux.items()}}

    def _apply_update(self, grads, step: int) -> None:
        """``optimizer.update_leaf`` one leaf at a time: each leaf's delta
        is added to the master in place, its new moments replace the old
        and its gradient is dropped before the next leaf, so the old and
        the new optimizer state never live side by side."""
        state = self.state
        kind, master = type(state.opt_state), state.master
        fields = [tree_leaves(f) for f in state.opt_state]
        self.state = state._replace(opt_state=None)
        del state
        with torch.no_grad():
            for i, p in enumerate(tree_leaves(master)):
                delta, new = self.optimizer.update_leaf(
                    grads[i], tuple(f[i] for f in fields), p, step)
                p.add_(delta)
                del delta
                for f, x in zip(fields, new):
                    f[i] = x
                grads[i] = None
        self.state = self.state._replace(opt_state=kind(
            *(tree_unflatten(master, f) for f in fields)))

    def train_batch(self, batch, rng: Optional[int] = None) -> Dict[str, Any]:
        """One full optimizer step over ``batch`` (leading dim
        ``gas * micro``; with gas > 1 reshaped to [gas, micro, ...])."""
        if rng is None:
            rng = self.config.seed + self.global_steps
        batch = self.shard_batch(batch)
        self.tput.start()
        metrics = self._train_step(batch, rng)
        return self._finish_step(metrics)

    def _finish_step(self, metrics) -> Dict[str, Any]:
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        # metrics stay on the device: reading them every step would make
        # the host wait for the card; fetch at the print cadence only
        self._last_metrics = metrics
        self._last_metrics_host = None
        self.tput.stop()
        if self.global_steps % self.config.steps_per_print == 0:
            fetched = self._fetch(metrics)
            self._last_metrics_host = fetched
            log_dist(
                f"step={self.global_steps} loss={fetched['loss']:.4f} "
                f"lr={fetched['lr']:.3e} gnorm={fetched['grad_norm']:.3f} "
                f"tput={self.tput.avg_samples_per_sec():.1f} samples/s")
            metrics = fetched
        return metrics

    @staticmethod
    def _fetch(metrics) -> Dict[str, Any]:
        return {k: (float(v) if isinstance(v, torch.Tensor) else v)
                for k, v in metrics.items()}

    def eval_batch(self, batch, rng: Optional[int] = None):
        """The loss (``eval_fn`` or ``loss_fn``) on the current parameters,
        without gradients, as a numpy scalar."""
        fn = self.eval_fn or self.loss_fn
        batch = self.shard_batch(batch, accumulate=False)
        with torch.no_grad():
            out = fn(self._compute_params(self.state.master), batch,
                     0 if rng is None else rng)
        out = out[0] if isinstance(out, tuple) else out
        return np.asarray(out.detach().float().cpu().numpy())

    def shard_batch(self, batch, accumulate: bool = True):
        """Host batch (a dict of arrays) -> tensors on the engine's device
        (from pinned host memory, non-blocking, on the card); with gas > 1
        each leaf is reshaped to [gas, micro, ...].  A batch already staged
        passes through, but only for the mode it was staged for."""
        if isinstance(batch, _StagedBatch):
            if batch.accumulate != (accumulate and self.gas > 1):
                raise ValueError(
                    "batch was staged for "
                    f"{'training' if batch.accumulate else 'eval'} "
                    "(gas reshape mismatch); re-stage the host batch "
                    "instead of reusing the staged one")
            return batch
        if not isinstance(batch, dict):
            raise TypeError(f"batch must be a dict of arrays, got "
                            f"{type(batch).__name__}")
        gas = self.gas if accumulate else 1
        on_card = self.device.type == "cuda"

        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            b = t.shape[0]
            if b % gas:
                raise ValueError(
                    f"batch dim {b} not divisible by gas={gas}; for a "
                    "partial tail batch use eval or drop_last=True")
            if gas > 1:
                t = t.reshape((gas, b // gas) + tuple(t.shape[1:]))
            if on_card and t.device.type == "cpu":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        out = _StagedBatch({k: put(v) for k, v in batch.items()})
        out.accumulate = gas > 1
        return out

    # ------------------------------------------------------------------
    # introspection / params access
    # ------------------------------------------------------------------
    @property
    def compute_params(self):
        """Current params in the compute dtype (copies)."""
        return self._compute_params(self.state.master)

    def get_lr(self) -> float:
        # schedule position = optimizer steps actually applied
        return float(self.lr_schedule(float(self.state.step)))

    def get_global_grad_norm(self) -> Optional[float]:
        if self._last_metrics is None:
            return None
        if self._last_metrics_host is None:
            self._last_metrics_host = self._fetch(self._last_metrics)
        return float(self._last_metrics_host["grad_norm"])

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        **kwargs):
        raise _not_ported("save_checkpoint", _MULTI + ", checkpoints")

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        **kwargs):
        raise _not_ported("load_checkpoint", _MULTI + ", checkpoints")


def initialize(loss_fn: Callable = None, params: Any = None,
               config: Any = None, topology=None, param_axes: Any = None,
               sharding_rules: Optional[Dict] = None, model: Any = None,
               device=None, **kwargs) -> Engine:
    """Build an :class:`Engine`: either ``loss_fn`` + ``params``, or a
    ``model`` exposing ``.loss_fn`` and ``.params`` (the port's
    ``models.Model`` does).  ``device`` None = the card."""
    cfg = load_config(config)
    if max(cfg.mesh.seq, cfg.sequence_parallel.size) > 1:
        raise _not_ported("sequence parallelism", _MULTI)
    if max(cfg.mesh.pipe, cfg.pipeline.stages) > 1:
        raise _not_ported("pipeline parallelism", _MULTI)
    if model is not None:
        params = params if params is not None else model.params
        param_axes = param_axes if param_axes is not None else getattr(
            model, "param_axes", None)
        sharding_rules = sharding_rules or getattr(model, "sharding_rules",
                                                   None)
        loss_fn = loss_fn or model.loss_fn
    if loss_fn is None or params is None:
        raise ValueError("initialize() needs loss_fn+params or model=")
    return Engine(loss_fn=loss_fn, params=params, config=cfg,
                  topology=topology, param_axes=param_axes,
                  sharding_rules=sharding_rules, model=model, device=device,
                  **kwargs)


__all__ = ["Engine", "PRECISION_DTYPE", "TrainState", "initialize"]
