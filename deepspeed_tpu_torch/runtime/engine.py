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
as on the JAX engine's one-device mesh.

Offload (``zero_optimization.offload_optimizer`` / ``offload_param``)
either runs or raises; nothing falls back to device-resident state:

* ``cpu`` (ZeRO-Offload, :meth:`Engine._offload_update`): the fp32 master
  and the moments live in host memory (pinned unless ``pin_memory`` is
  False).  After the device epilogue each fp32 grad goes to the host
  through a ring of ``buffer_count`` pinned chunks of ``buffer_size``
  bytes, the host runs ``optimizer.update_leaf`` chunk by chunk, and the
  new compute-dtype values come back through the same ring, the copies of
  chunks i+1 and i-1 overlapping the update of chunk i.  With
  ``offload_param=cpu`` the compute-dtype working copy lives in host
  memory too and is staged to the card for each step;
* ``offload_optimizer=nvme`` (ZeRO-Infinity, ``zero_infinity.py``): the
  fp32 state on NVMe, updated group by group on the host; the card keeps
  the compute-dtype working copy;
* plus ``offload_param=nvme`` with a stacked-layer ``model=``
  (``param_stream.py``): the layers stream from NVMe, one at a time.  ``save_checkpoint`` /
``load_checkpoint`` / ``wait_checkpoint`` write and read the JAX
package's fragment format (``checkpoint/engine.py``), synchronously or,
with ``checkpoint.async_save``, from a worker thread.  Telemetry (the
``telemetry`` config: phase spans, device telemetry, anomaly detection,
capture windows on ``torch.profiler``) and the ``monitor`` writers run as
in the reference, and so do the data-efficiency hooks (:meth:`Engine.
_data_efficiency_pre_step`: the seqlen curriculum, random-LTD's loss
swap, PLD's theta column, MoQ's bits with eigenvalue pacing; the metric
curriculum's :meth:`Engine.curriculum_dataloader`), MoQ's fake
quantization in the compute cast, and the flops profiler (the profiled
step runs under ``profiling.count_flops``).  Every other engine feature
raises ``NotImplementedError`` naming its ROADMAP item when it is
configured.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint import engine as ckpt
from ..config.config import Config, load_config
from ..platform.cuda import host_empty, resolve_device
from ..telemetry import (AnomalyConfig, AnomalyMonitor, DeviceTelemetry,
                         MetricsRegistry, ProfilerCapture, SpanTracer,
                         default_training_detectors)
from ..utils.logging import log_dist
from ..utils.prng import PRNGKey, split
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from ..config.config import ConfigError
from ..utils.logging import logger
from .loss_scaler import LossScaler, LossScaleState, all_finite
from .lr_schedules import build_schedule, constant
from .optimizers import AdamState, Optimizer, build_optimizer
from .runtime_utils import (HOST_CHUNK, clip_by_global_norm_,
                            keep_host_heap, param_count, tree_leaves,
                            tree_map, tree_unflatten)

PRECISION_DTYPE = {"fp32": torch.float32, "fp16": torch.float16,
                   "bf16": torch.bfloat16}

_MULTI = "ROADMAP Queue 1 item 6 (multi-GPU training breadth)"


class TrainState(NamedTuple):
    """Everything that persists across steps."""
    step: int                  # optimizer steps applied
    master: Any                # fp32 master params
    opt_state: Any             # optimizer moments (fp32 or moment_dtype)
    loss_scale: LossScaleState
    skipped: int               # overflow-skipped steps


# batch columns that stay in host memory when a batch is staged (the loss
# reads them on the host: PLD's theta)
_HOST_KEYS = ("_pld_theta",)


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
        (z.zero_quantized_gradients, "zero_quantized_gradients (qgZ)", _MULTI),
        (z.zero_quantized_weights, "zero_quantized_weights (qwZ)", _MULTI),
        (z.zero_hpz_partition_size > 1, "zero_hpz_partition_size", _MULTI),
        (z.mics_shard_size > 0, "mics_shard_size", _MULTI),
        (config.comm.overlap or config.comm.quantized_allreduce is not None,
         "comm.overlap / comm.quantized_allreduce", _MULTI),
        (config.sparse_gradients, "sparse_gradients", _MULTI),
    ]
    for configured, what, item in checks:
        if configured:
            raise _not_ported(what, item)


def _check_offload(config: Config) -> None:
    """Raise for an offload setting that neither package runs."""
    z = config.zero_optimization
    opt_dev, par_dev = z.offload_optimizer.device, z.offload_param.device
    for key, cfg in (("offload_optimizer", z.offload_optimizer),
                     ("offload_param", z.offload_param)):
        if cfg.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"{key}.device={cfg.device!r}: expected "
                              "'none', 'cpu' or 'nvme'")
        if cfg.device != "none" and cfg.ratio != 1.0:
            raise ConfigError(
                f"{key}.ratio={cfg.ratio}: partial offload is not "
                "supported (every leaf is offloaded; ratio must be 1.0)")
    if par_dev == "nvme" and opt_dev != "nvme":
        raise ConfigError(
            "offload_param.device=nvme needs offload_optimizer.device="
            "nvme (the streamed parameters are updated from the NVMe "
            "optimizer state)")
    if "cpu" in (opt_dev, par_dev) and opt_dev != "nvme":
        if "lamb" in config.optimizer.type.lower():
            raise ConfigError(
                "optimizer offload is not supported with LAMB: trust "
                "ratios need whole-tensor parameter/update norms, but "
                "the offloaded update runs per-shard inside shard_map "
                "and would silently compute per-shard ratios. Use "
                "adam/adamw/lion/adagrad/sgd with offload, or drop "
                "offload_optimizer/offload_param for LAMB.")
        ring = z.offload_optimizer if opt_dev == "cpu" else z.offload_param
        if ring.buffer_count < 2 or ring.buffer_size < 4:
            raise ConfigError(
                "ZeRO-Offload's staging ring needs buffer_count >= 2 and "
                f"buffer_size >= 4 bytes, got {ring.buffer_count} x "
                f"{ring.buffer_size}")


class _HostMemory:
    """Host tensors of offloaded state (``platform.cuda.host_empty``:
    page-locked when ``pin``, a failure raising with the bytes asked for,
    the registration undone when the tensor is freed)."""

    def __init__(self, pin: bool):
        self.pin = pin

    def empty(self, shape, dtype) -> torch.Tensor:
        return host_empty(shape, dtype, pin=self.pin)

    def copy(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return self.empty(x.shape, dtype).copy_(x)


class Engine:
    """One-device training engine (``deepspeed_tpu.runtime.engine.Engine``)."""

    def __init__(self, loss_fn: Callable, params: Any, config: Config,
                 topology=None, param_axes: Any = None,
                 sharding_rules: Optional[Dict] = None,
                 eval_fn: Optional[Callable] = None, monitor=None,
                 model: Any = None, device=None):
        """``loss_fn(params, batch, rng) -> loss`` or ``(loss, aux_dict)``;
        ``params`` a tree of tensors (any dtype and device; copied into
        the fp32 master on ``device``, None = the card).  ``rng`` is the
        micro-batch's threefry key (``utils.prng``, on the host), derived
        as the JAX engine derives it: ``PRNGKey(seed + global_steps)``, split
        over the micro-batches when gas > 1.  ``param_axes``
        and ``sharding_rules`` (tensor-parallel layout hints) are kept and
        have no effect on one device."""
        if topology is not None:
            raise _not_ported("a prebuilt mesh topology", _MULTI)
        _reject_unported(config)
        _check_offload(config)
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

        # offload: "none", "host" (ZeRO-Offload) or "nvme" (ZeRO-Infinity)
        z = config.zero_optimization
        self._nvme = None
        self._stream = None
        self._work = None          # the compute-dtype working copy
        self.offload_times: Dict[str, float] = {}
        if z.offload_optimizer.device == "nvme":
            from .zero_infinity import NVMeOptimizer
            self._offload = "nvme"
            self._nvme = NVMeOptimizer(
                z.offload_optimizer.nvme_path, opt_cfg.type, opt_cfg.params,
                buffer_size=z.offload_optimizer.buffer_size,
                aio_config=config.aio)
        elif "cpu" in (z.offload_optimizer.device, z.offload_param.device):
            self._offload = "host"
        else:
            self._offload = "none"
        if self._offload != "none":
            keep_host_heap()           # the host update's temporaries
        self._stream_params = (
            self._nvme is not None and z.offload_param.device == "nvme"
            and model is not None and hasattr(model, "config")
            and isinstance(params, dict) and "blocks" in params)
        # the working copy lives in host memory between steps (staged to
        # the device for each step) with offload_param=cpu, or =nvme
        # without a stacked-layer model
        self._host_params = (
            z.offload_param.device == "cpu"
            or (z.offload_param.device == "nvme" and not self._stream_params))
        if z.offload_param.device == "nvme" and not self._stream_params:
            logger.warning(
                "offload_param.device=nvme without a stacked-layer model: "
                "staging the full compute-dtype working copy in host "
                "memory; pass model= (models.transformer) to stream "
                "parameters per layer instead")
        on_card = self.device.type == "cuda"
        self._pin_state = on_card and z.offload_optimizer.pin_memory
        self._pin_params = on_card and z.offload_param.pin_memory
        ring = (z.offload_optimizer if z.offload_optimizer.device == "cpu"
                else z.offload_param)
        self._ring_cfg = (ring.buffer_count, ring.buffer_size)

        self.state = self._init_state(params)
        self.global_steps = 0
        self.global_samples = 0
        self.timers = SynchronizedWallClockTimer()
        self.tput = ThroughputTimer(batch_size=self.train_batch_size)
        self._last_metrics: Optional[Dict[str, Any]] = None
        self._last_metrics_host: Optional[Dict[str, Any]] = None
        if monitor is None and (config.tensorboard.enabled
                                or config.csv_monitor.enabled
                                or config.wandb.enabled
                                or config.comet.enabled):
            # the writers the monitor sub-configs name (rank 0 only)
            from ..monitor import MonitorMaster
            monitor = MonitorMaster(config)
            if not monitor.enabled:
                monitor = None
        self.monitor = monitor
        self._setup_telemetry()
        self._setup_data_efficiency()
        self._async_saver = None
        if self._offload == "host":
            log_dist(
                f"ZeRO-Offload: master and moments in "
                f"{'pinned' if self._pin_state else 'pageable'} host memory, "
                f"staging ring {self._ring_cfg[0]} x {self._ring_cfg[1]:,} "
                f"bytes, host update on {torch.get_num_threads()} threads")
        log_dist(
            f"Engine: {self.num_params:,} params | "
            f"precision={self.precision} | zero_stage={self.zero_stage} | "
            f"device={self.device} | batch={self.train_batch_size} "
            f"(micro={self.micro_batch_size} x gas={self.gas} x dp=1)")

    # ------------------------------------------------------------------
    # telemetry (docs/OBSERVABILITY.md)
    # ------------------------------------------------------------------
    def _setup_telemetry(self) -> None:
        """The metrics registry and span tracer of the training step's
        host phases (pre-step, batch staging, the step's dispatch, the
        metrics fetch), and, each only when ``telemetry`` turns it on,
        device telemetry, anomaly detection and the capture manager.
        The step runs eagerly, so no program is built: the compile
        counters are registered for the reference's exposition and stay
        0, and the retrace signal with them."""
        tcfg = self.config.telemetry
        self.metrics = reg = MetricsRegistry()
        self.tracer = SpanTracer(capacity=tcfg.trace_capacity,
                                 enabled=tcfg.trace)
        self._phase_ms = {
            k: reg.counter(f"training_{k}_ms_total",
                           f"cumulative host milliseconds in the {k} "
                           "phase of train_batch")
            for k in ("pre_step", "stage", "dispatch", "fetch")}
        self._c_steps = reg.counter("training_steps_total",
                                    "optimizer steps taken", int_valued=True)
        self._h_step_host = reg.histogram(
            "training_step_host_ms",
            (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
             1000.0, 2000.0, 5000.0, 10000.0, 60000.0),
            "host-side wall ms per train_batch call")
        # the grad-sync collectives' and step programs' counters stay 0
        # (one card, no compiled programs); registered so the exposition
        # names every series the reference's does
        reg.counter("training_comm_ops_total", "explicit grad-sync "
                    "collectives dispatched (kind: exact|quant)",
                    int_valued=True)
        reg.counter("training_comm_tiles_total", "tiles across dispatched "
                    "grad-sync collectives", int_valued=True)
        reg.counter("training_comm_bytes_total", "modeled bytes on the wire "
                    "for explicit grad-sync collectives (kind: exact|quant)")
        reg.counter("training_compiles_total", "training step programs "
                    "built", int_valued=True)
        self._c_retraces = reg.counter(
            "training_compile_retraces_total", "re-builds of a program key "
            "this engine had already built", int_valued=True)
        # the utilization gauges divide by the throughput timer's step
        # wall; the memory gauges poll at the steps_per_print boundary
        self.devtel = DeviceTelemetry(
            reg, "training", device=self.device,
            step_ms_fn=lambda: self.tput.total_elapsed_time * 1e3) \
            if tcfg.device else None
        self._acfg = AnomalyConfig()
        self._anom = None
        self._anom_prev: Dict[str, float] = {}
        if tcfg.anomaly:
            self._anom = AnomalyMonitor(self._acfg, reg, "training")
            self._anom.watch_all(default_training_detectors(self._acfg))
        self._cap = None
        if tcfg.profile:
            self._cap = ProfilerCapture(tcfg.profile, tracer=self.tracer,
                                        max_captures=self._acfg.max_captures)
            if tcfg.profile_steps > 0:
                self._cap.arm(tcfg.profile_steps, "config")

    def anomaly_summary(self) -> Optional[Dict[str, Any]]:
        """Anomaly tally (total, by signal, recent events) and the
        completed capture directories; None while detection is off."""
        if self._anom is None:
            return None
        return {**self._anom.summary(), "captures": self.capture_dirs}

    @property
    def capture_dirs(self) -> List[str]:
        return [] if self._cap is None else list(self._cap.captures)

    def capture(self, steps: Optional[int] = None, reason: str = "manual",
                out_dir: Optional[str] = None) -> Optional[str]:
        """Arm an explicit deep-capture window over the next ``steps``
        train steps (a ``torch.profiler`` trace and the host phase spans,
        merged by ``tools/tracemerge.py``); returns the capture directory,
        or None when a window is already armed or active."""
        if self._cap is None:
            if not out_dir:
                raise ValueError("no capture directory: pass out_dir= "
                                 "or set config telemetry.profile")
            self._cap = ProfilerCapture(out_dir, tracer=self.tracer,
                                        max_captures=self._acfg.max_captures)
        return self._cap.arm(steps or self._acfg.capture_steps, reason,
                             budgeted=False)

    def finish_capture(self) -> Optional[str]:
        """Close an active capture window now, with the steps it has."""
        if self._cap is None or not self._cap.active:
            return None
        return self._cap.finish_now()

    def _feed_step_signals(self, t0: float, t3: float) -> None:
        """Per-step anomaly feed from timestamps already taken; called
        only when the monitor exists."""
        anom, prev = self._anom, self._anom_prev
        step = self.global_steps
        fired = []
        last_t0 = prev.get("t0")
        prev["t0"] = t0
        if last_t0 is not None:
            fired.append(anom.observe("step_interval_ms",
                                      (t0 - last_t0) * 1e3, step))
        fired.append(anom.observe("step_host_ms", (t3 - t0) * 1e3, step))
        retr = self._c_retraces.value()
        fired.append(anom.observe("retrace", retr - prev.get("retrace", 0),
                                  step))
        prev["retrace"] = retr
        for ev in fired:
            if ev is not None:
                logger.warning(
                    "training anomaly: %s observed=%.3f baseline=%.3f "
                    "score=%.1f (step %d)", ev.signal, ev.observed,
                    ev.baseline, ev.score, ev.step)
                if self._cap is not None:
                    self._cap.arm(self._acfg.capture_steps,
                                  f"anomaly_{ev.signal}", budgeted=True)

    def _step_cost(self, batch) -> Dict[str, float]:
        """One step's flops and bytes from its shapes (device telemetry):
        6 x params x tokens, and each parameter's compute-dtype copy read
        twice and its gradient written once, its fp32 master and two
        moments read and written once."""
        leaves = [x for x in tree_leaves(dict(batch))
                  if isinstance(x, torch.Tensor)]
        ids = batch.get("input_ids") if isinstance(batch, dict) else None
        tokens = (ids.numel() if isinstance(ids, torch.Tensor)
                  else leaves[0].numel() if leaves else 0)
        n = self.num_params
        elem = PRECISION_DTYPE[self.precision].itemsize
        return {"flops": 6.0 * n * tokens,
                "bytes_accessed": float(n * (3 * elem + 6 * 4))}

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-able snapshot of the training metrics registry; see also
        ``metrics.prometheus_text()`` and ``metrics.write_jsonl(path)``."""
        return self.metrics.snapshot()

    # ------------------------------------------------------------------
    # data efficiency: curriculum, random-LTD, PLD, MoQ (the JAX engine's
    # config-driven hooks, :734-916)
    # ------------------------------------------------------------------
    def _setup_data_efficiency(self) -> None:
        cfg = self.config
        self.curriculum = None
        self.curriculum_sampler = None
        ccfg = cfg.curriculum_learning
        de = cfg.data_efficiency
        if de.enabled and de.data_sampling.enabled \
                and de.data_sampling.curriculum_learning.enabled:
            ccfg = de.data_sampling.curriculum_learning
        if ccfg.enabled:
            from .data_pipeline import (CurriculumDataSampler,
                                        CurriculumScheduler)

            def sched():
                return CurriculumScheduler({
                    "min_difficulty": ccfg.min_difficulty,
                    "max_difficulty": ccfg.max_difficulty,
                    "schedule_type": ccfg.schedule_type,
                    "schedule_config": ccfg.schedule_config})

            if ccfg.curriculum_type == "seqlen":
                # the batch-shape curriculum: each batch truncated in
                # _data_efficiency_pre_step
                self.curriculum = sched()
            else:
                # a metric curriculum: a DataAnalyzer metric drives the
                # sampling order (curriculum_dataloader)
                if not ccfg.data_analyzer_path:
                    raise ConfigError(
                        f"curriculum_type={ccfg.curriculum_type!r}: a "
                        "metric curriculum needs data_analyzer_path "
                        "pointing at a DataAnalyzer save dir containing "
                        f"{ccfg.curriculum_type}/sample_to_metric.npy")
                try:
                    self.curriculum_sampler = CurriculumDataSampler\
                        .from_analyzer(
                            ccfg.data_analyzer_path, ccfg.curriculum_type,
                            sched(), self.train_batch_size, seed=cfg.seed)
                except FileNotFoundError as e:
                    raise ConfigError(
                        f"curriculum_type={ccfg.curriculum_type!r}: no "
                        f"analyzer index under "
                        f"{ccfg.data_analyzer_path!r} ({e}); run "
                        "runtime.data_analyzer.DataAnalyzer first") from e

        self.pld = None
        if cfg.progressive_layer_drop.enabled:
            if not getattr(self.loss_fn, "uses_pld", False):
                raise ConfigError(
                    "progressive_layer_drop: this loss_fn does not "
                    "consume _pld_theta — initialize with model=")
            from .progressive_layer_drop import ProgressiveLayerDrop
            self.pld = ProgressiveLayerDrop(
                cfg.progressive_layer_drop.theta,
                cfg.progressive_layer_drop.gamma)

        self._ltd_cfg = None
        self._ltd_sched = None
        self._ltd_keep = None
        rl = de.data_routing.random_ltd
        if de.enabled and de.data_routing.enabled and rl.enabled:
            if not hasattr(self.loss_fn, "with_ltd"):
                raise ConfigError(
                    "random_ltd: this loss_fn has no with_ltd hook — "
                    "initialize with model=")
            self._ltd_base_loss = self.loss_fn
            # max_value=0 means the batch's seqlen, resolved against the
            # first batch
            self._ltd_cfg = rl

        self.moq = None
        self._moq_bits = None
        self._moq_eig0 = None
        self._eig = None
        self.eigenvalue_seconds: List[float] = []
        qt = cfg.quantize_training
        if qt.enabled:
            from .quantize import Quantizer
            self.moq = Quantizer(
                q_start_bits=qt.start_bits, q_target_bits=qt.target_bits,
                q_period=qt.quantize_period, q_groups=qt.quantize_groups)
            if qt.eigenvalue.enabled:
                from .eigenvalue import Eigenvalue
                self._eig = Eigenvalue(max_iter=qt.eigenvalue.max_iter,
                                       tol=qt.eigenvalue.tol,
                                       stability=qt.eigenvalue.stability)
        self.flops_profile: Optional[Dict[str, Any]] = None

    def _data_efficiency_pre_step(self, batch, rng):
        """The scheduled per-step transforms of a host batch; returns the
        (possibly new) batch."""
        step = self.global_steps
        if self.curriculum is not None:
            from .data_pipeline import truncate_to_difficulty
            batch = truncate_to_difficulty(
                batch, self.curriculum.get_difficulty(step + 1))
        if self._ltd_cfg is not None:
            from .data_pipeline import RandomLTDScheduler
            S = int(np.shape(batch["input_ids"])[1])
            max_t = min(self._ltd_cfg.max_value or S, S)
            if self._ltd_sched is None or self._ltd_sched.max != max_t:
                self._ltd_sched = RandomLTDScheduler(
                    total_layers=0,
                    start_tokens=min(self._ltd_cfg.min_value, max_t),
                    max_tokens=max_t,
                    schedule_steps=self._ltd_cfg.require_steps,
                    step_size=self._ltd_cfg.seq_per_step)
            keep = min(self._ltd_sched.kept_tokens(step), S)
            keep_eff = None if keep >= S else keep
            if keep_eff != self._ltd_keep:
                self._ltd_keep = keep_eff
                self.loss_fn = (self._ltd_base_loss if keep_eff is None
                                else self._ltd_base_loss.with_ltd(keep_eff))
        if self.pld is not None:
            # before MoQ: the eigenvalue reads this batch's theta column
            theta = self.pld.update_state(step)
            B = int(np.shape(batch["input_ids"])[0])
            batch = dict(batch)
            batch["_pld_theta"] = np.full((B,), theta, np.float32)
        if self.moq is not None:
            bits = self.moq.current_bits(step)
            boundary = (step > 0 and step % self.moq.period == 0
                        and bits > self.moq.target_bits)
            if self._eig is not None and boundary:
                # eigenvalue pacing: growing curvature postpones the next
                # bit reduction
                eig = self._measure_eigenvalue(batch, rng)
                if self._moq_eig0 is None:
                    self._moq_eig0 = abs(eig)
                elif abs(eig) > 1.5 * self._moq_eig0:
                    self.moq.period *= 2
                    logger.info(
                        f"MoQ: |eigenvalue| grew {abs(eig):.3g} vs "
                        f"{self._moq_eig0:.3g}; quantize_period -> "
                        f"{self.moq.period}")
                    bits = self.moq.current_bits(step)
            self._moq_bits = bits
        return batch

    def curriculum_dataloader(self, data, **kwargs):
        """A :class:`~.dataloader.DataLoader` whose sampling order follows
        the configured metric curriculum (``curriculum_type`` other than
        ``seqlen``, with ``data_analyzer_path``)."""
        if self.curriculum_sampler is None:
            raise ConfigError(
                "curriculum_dataloader() needs a metric curriculum "
                "(curriculum_learning with curriculum_type != 'seqlen' "
                "and data_analyzer_path set)")
        from .dataloader import DataLoader
        return DataLoader(data, self.train_batch_size,
                          sampler=self.curriculum_sampler, **kwargs)

    def _measure_eigenvalue(self, batch, rng) -> float:
        """Dominant Hessian eigenvalue of the micro-loss at the current
        parameters (host-driven power iteration; period boundaries only),
        through the loss's twice-differentiable ``hvp_loss``.  Its
        seconds are appended to ``eigenvalue_seconds``."""
        t0 = time.perf_counter()
        micro = self.shard_batch(
            {k: v[:self.micro_batch_size] for k, v in batch.items()},
            accumulate=False)
        cparams = self._step_params()
        fn = getattr(self.loss_fn, "hvp_loss", self.loss_fn)

        def scalar_loss(p):
            out = fn(p, micro, rng)
            return out[0] if isinstance(out, tuple) else out

        eig, _ = self._eig.compute_eigenvalue(scalar_loss, cparams, rng)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.eigenvalue_seconds.append(time.perf_counter() - t0)
        return float(eig)

    def _moq_quantize(self, c: torch.Tensor) -> torch.Tensor:
        """MoQ's fake quantization of a 2-D+ compute weight at the
        scheduled bits (nothing above 8 bits)."""
        bits = self._moq_bits
        if bits is None or bits > 8 or c.dim() < 2:
            return c
        from ..compression.compress import weight_quantization
        with torch.no_grad():
            return weight_quantization(
                c, bits=bits,
                groups=self.config.quantize_training.quantize_groups
            ).to(c.dtype)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    @property
    def offload_active(self) -> bool:
        """Whether optimizer or parameter offload is configured (it
        always runs when it is: nothing turns it off)."""
        return self._offload != "none"

    @property
    def num_params(self) -> int:
        if self._stream is not None:
            return self._stream.num_params
        return param_count(self.state.master)

    def _init_state(self, params) -> TrainState:
        if self._offload == "nvme":
            return self._init_state_nvme(params)
        if self._offload == "host":
            return self._init_state_host(params)
        master = tree_map(lambda p: torch.as_tensor(p).detach().to(
            device=self.device, dtype=torch.float32, copy=True), params)
        return TrainState(step=0, master=master,
                          opt_state=self.optimizer.init(master),
                          loss_scale=self.scaler.init(), skipped=0)

    def _host_memory(self, pin: bool) -> _HostMemory:
        return _HostMemory(pin)

    def _working_copy(self, params):
        """The compute-dtype working copy of ``params``: on the device, or
        in (pinned) host memory with ``_host_params``."""
        mem = self._host_memory(self._pin_params) if self._host_params \
            else None

        def one(p):
            p = torch.as_tensor(p).detach()
            if mem is not None:
                return mem.copy(p, self.compute_dtype)
            return p.to(device=self.device, dtype=self.compute_dtype,
                        copy=True)
        return tree_map(one, params)

    def _init_state_host(self, params) -> TrainState:
        """ZeRO-Offload: the fp32 master and the moments in host memory,
        made one leaf at a time (never whole on the device, and never a
        second whole copy on the host)."""
        mem = self._host_memory(self._pin_state)
        master = tree_map(
            lambda p: mem.copy(torch.as_tensor(p).detach(), torch.float32),
            params)
        # every optimizer here starts its state at a constant: take it
        # from a one-element leaf and fill, so no pageable copy of a
        # whole leaf's moments is ever made
        kind, fields = None, None
        for p in tree_leaves(master):
            st = self.optimizer.init([p.view(-1)[:1]])
            if fields is None:
                kind, fields = type(st), [[] for _ in st]
            for f, x in zip(fields, st):
                f.append(mem.empty(p.shape, x[0].dtype).fill_(x[0].item()))
            del st
        opt_state = self.optimizer.init(master) if fields is None else \
            kind(*(tree_unflatten(master, f) for f in fields))
        self._work = self._working_copy(params)
        # the staging ring is pinned on the card whatever pin_memory says:
        # its copies are the asynchronous ones
        n, b = self._ring_cfg
        ring = self._host_memory(self.device.type == "cuda")
        self._ring = [ring.empty((b,), torch.uint8) for _ in range(n)]
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        return TrainState(step=0, master=master, opt_state=opt_state,
                          loss_scale=self.scaler.init(), skipped=0)

    def _init_state_nvme(self, params) -> TrainState:
        """ZeRO-Infinity: the fp32 master and zero moments written to
        NVMe; the state's ``master`` is the compute-dtype working copy
        (with streaming, the resident leaves only)."""
        if self._stream_params:
            from .param_stream import StreamedInfinityTrainer
            self._stream = StreamedInfinityTrainer(self, self._model, params)
            return TrainState(step=0, master=self._stream.resident,
                              opt_state=(), loss_scale=self.scaler.init(),
                              skipped=0)
        self._nvme.initialize(params)
        self._work = self._working_copy(params)
        return TrainState(step=0, master=self._work, opt_state=(),
                          loss_scale=self.scaler.init(), skipped=0)

    def _step_params(self, requires_grad: bool = False):
        """The parameters a step or an eval computes with: the master cast
        (no offload), or the working copy, staged to the device when it
        lives on the host."""
        if self._offload == "none":
            return self._compute_params(self.state.master, requires_grad)

        def one(w):
            if self._host_params:
                w = w.to(self.device, non_blocking=True)
            return self._moq_quantize(w.detach()).requires_grad_(
                requires_grad)
        return tree_map(one, self._work)

    def _compute_params(self, master, requires_grad: bool = False):
        """The master cast to the compute dtype (a fresh tensor per leaf,
        also in fp32, so the update never writes into a live graph), and
        fake-quantized at MoQ's scheduled bits (the gradient taken at the
        quantized weights and applied to the master: straight through)."""
        def cast(p):
            c = self._moq_quantize(p.detach().to(self.compute_dtype,
                                                 copy=True))
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

    def _grads(self, cparams, batch, rng: torch.Tensor, scale: float):
        """(mean loss, last aux, fp32 grads as a leaf list)."""
        gas = self.gas
        keys = split(rng, gas) if gas > 1 else rng[None]
        leaves = tree_leaves(cparams)
        acc = None
        loss_sum = None
        aux: Dict[str, Any] = {}
        for g in range(gas):
            mb = {k: v[g] for k, v in batch.items()} if gas > 1 else batch
            loss, aux = self._micro_loss(cparams, mb, keys[g])
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
        aux = {k: v.detach() for k, v in aux.items()}
        return loss_sum / gas, aux, acc

    def _train_step(self, batch, rng: torch.Tensor) -> Dict[str, Any]:
        use_scaling = self.precision == "fp16"
        loss_scale = self.state.loss_scale
        scale = loss_scale.scale if use_scaling else 1.0
        t0 = time.perf_counter()
        cparams = self._step_params(requires_grad=True)
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
            if self._offload == "host":
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                self.offload_times = {"fwd_bwd_s": time.perf_counter() - t0}
                self._offload_update(grads, step + 1)
            elif self._offload == "nvme":
                self._nvme_update(grads, step + 1)
            else:
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

    def _offload_update(self, grads, step: int) -> None:
        """ZeRO-Offload's update (``_offload_update`` of the JAX engine):
        ``optimizer.update_leaf`` on the host, over chunks of at most
        ``buffer_size`` bytes of fp32 grads, each updated in spans of
        ``HOST_CHUNK`` elements.  Chunk k's grads come to the host
        through ring slot ``k % buffer_count`` on the copy stream;
        the host updates the chunk's master and moments in place, writes
        its new compute-dtype values into the same slot, and the copy
        stream takes them to the working copy.  The D2H of chunk k+1 is
        issued before chunk k updates, and chunk k's H2D runs while chunk
        k+1 updates; the copy stream's order keeps a slot from being
        overwritten before its H2D has read it.  ``offload_times`` gets
        the host seconds spent waiting for grads, updating, and waiting
        for the last H2D, and the bytes each way."""
        state = self.state
        masters = tree_leaves(state.master)
        fields = [tree_leaves(f) for f in state.opt_state]
        works = tree_leaves(self._work)
        ring = self._ring
        nbuf, chunk = len(ring), ring[0].numel() // 4
        cuda = self.device.type == "cuda"
        to_host = self._host_params or not cuda
        copy = self._copy_stream
        pieces = [(i, a, min(a + chunk, g.numel()))
                  for i, g in enumerate(grads)
                  for a in range(0, g.numel(), chunk)]
        wait_s = update_s = 0.0
        if cuda:
            copy.wait_stream(torch.cuda.current_stream(self.device))

        def d2h(k: int):
            i, a, b = pieces[k]
            buf = ring[k % nbuf].view(torch.float32)[:b - a]
            src = grads[i].view(-1)[a:b]
            if not cuda:
                buf.copy_(src)
                return None
            with torch.cuda.stream(copy):
                buf.copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy)
            return ev

        with torch.no_grad():
            pending = d2h(0) if pieces else None
            for k, (i, a, b) in enumerate(pieces):
                ev = pending
                pending = d2h(k + 1) if k + 1 < len(pieces) else None
                t = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                t1 = time.perf_counter()
                slot = ring[k % nbuf]
                g = slot.view(torch.float32)[:b - a]
                p = masters[i].view(-1)[a:b]
                state = [f[i].view(-1)[a:b] for f in fields]

                for a2 in range(0, b - a, HOST_CHUNK):
                    b2 = min(a2 + HOST_CHUNK, b - a)
                    pp = p[a2:b2]
                    delta, new = self.optimizer.update_leaf(
                        g[a2:b2], tuple(x[a2:b2] for x in state), pp, step)
                    pp.add_(delta)
                    for x, y in zip(state, new):
                        x[a2:b2].copy_(y)
                    del delta, new
                dst = works[i].view(-1)[a:b]
                if to_host:
                    dst.copy_(p)
                else:
                    out = slot.view(self.compute_dtype)[:b - a]
                    out.copy_(p)
                    with torch.cuda.stream(copy):
                        dst.copy_(out, non_blocking=True)
                wait_s += t1 - t
                update_s += time.perf_counter() - t1
            grads.clear()
            t = time.perf_counter()
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(copy)
                copy.synchronize()
        moved = sum(b - a for _, a, b in pieces)
        self.offload_times.update(
            d2h_wait_s=wait_s, host_update_s=update_s,
            h2d_tail_s=time.perf_counter() - t, d2h_bytes=4 * moved,
            h2d_bytes=0 if to_host else moved * torch.empty(
                (), dtype=self.compute_dtype).element_size())

    def _nvme_update(self, grads, step: int) -> None:
        """ZeRO-Infinity's update (``_train_batch_nvme``): the grouped NVMe
        step on the host, each fresh master cast into the working copy."""
        flat = self._nvme.flatten(tree_unflatten(self._work, list(grads)))
        grads.clear()
        works = self._nvme.flatten(self._work)
        lr = float(self.lr_schedule(float(step)))
        t = time.perf_counter()

        def consume(i: int, p_new: torch.Tensor) -> None:
            works[i].copy_(p_new)
            flat[i] = None                    # this grad is done with

        with torch.no_grad():
            self._nvme.step(flat, lr, step, consume=consume)
        self.offload_times = {"host_update_s": time.perf_counter() - t}

    def train_batch(self, batch, rng: Optional[torch.Tensor] = None
                    ) -> Dict[str, Any]:
        """One full optimizer step over ``batch`` (leading dim
        ``gas * micro``; with gas > 1 reshaped to [gas, micro, ...]).
        ``rng``: a threefry key, default ``PRNGKey(seed + global_steps)``
        (the JAX engine's)."""
        if self._cap is not None and self._cap.armed:
            # an armed capture window opens at the step boundary
            self._cap.begin(step=self.global_steps)
        t0 = time.perf_counter()
        if rng is None:
            rng = PRNGKey(self.config.seed + self.global_steps)
        if self.curriculum or self.pld or self._ltd_cfg or self.moq:
            batch = self._data_efficiency_pre_step(batch, rng)
        if self._stream is not None:
            # per-layer streaming: the host loop is the step, and its
            # phases are not the four this instrumentation names
            self.tput.start()
            return self._finish_step(self._stream.train_batch(batch, rng))
        t1 = time.perf_counter()
        batch = self.shard_batch(batch)
        t2 = time.perf_counter()
        self.tput.start()
        fp_cfg = self.config.flops_profiler
        if fp_cfg.enabled and self.global_steps + 1 == fp_cfg.profile_step:
            # the profiled step itself runs under the flop count (no
            # extra execution)
            from ..profiling import count_flops
            with count_flops() as counted:
                metrics = self._train_step(batch, rng)
            self.flops_profile = {"flops": counted.total,
                                  "by_op": dict(counted.by_op)}
        else:
            metrics = self._train_step(batch, rng)
        t3 = time.perf_counter()
        if self.devtel is not None:
            if "train_step" not in self.devtel.program_costs:
                self.devtel.probe_program("train_step",
                                          lambda: self._step_cost(batch))
            self.devtel.on_dispatch("train_step")
        self._phase_ms["pre_step"].inc((t1 - t0) * 1e3)
        self._phase_ms["stage"].inc((t2 - t1) * 1e3)
        self._phase_ms["dispatch"].inc((t3 - t2) * 1e3)
        self._h_step_host.observe((t3 - t0) * 1e3)
        if self._anom is not None:
            self._feed_step_signals(t0, t3)
        tr = self.tracer
        if tr.enabled:
            sid = self.global_steps + 1
            tr.record("pre_step", t0, t1, track="pre_step", step=sid)
            tr.record("stage", t1, t2, track="stage", step=sid)
            tr.record("dispatch", t2, t3, track="dispatch", step=sid)
        return self._finish_step(metrics)

    def _finish_step(self, metrics) -> Dict[str, Any]:
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self._c_steps.inc()
        if self._cap is not None and self._cap.active:
            self._cap.end_step(step=self.global_steps)
        # metrics stay on the device: reading them every step would make
        # the host wait for the card; fetch at the print cadence (or for
        # a monitor) only
        self._last_metrics = metrics
        self._last_metrics_host = None
        self.tput.stop()
        fp_cfg = self.config.flops_profiler
        if fp_cfg.enabled and self.global_steps == fp_cfg.profile_step \
                and self.flops_profile is not None:
            self._write_flops_profile()
        printing = self.global_steps % self.config.steps_per_print == 0
        if printing or self.monitor is not None:
            if self.devtel is not None and printing:
                # the print boundary is the loop's phase boundary
                self.devtel.poll_memory()
            t_f0 = time.perf_counter()
            fetched = self._fetch(metrics)
            t_f1 = time.perf_counter()
            self._phase_ms["fetch"].inc((t_f1 - t_f0) * 1e3)
            if self.tracer.enabled:
                self.tracer.record("fetch", t_f0, t_f1, track="fetch",
                                   step=self.global_steps)
            self._last_metrics_host = fetched
            if printing:
                log_dist(
                    f"step={self.global_steps} loss={fetched['loss']:.4f} "
                    f"lr={fetched['lr']:.3e} "
                    f"gnorm={fetched['grad_norm']:.3f} "
                    f"tput={self.tput.avg_samples_per_sec():.1f} samples/s")
            if self.monitor is not None:
                self.monitor.write_scalars(self.global_steps, {
                    "Train/loss": float(fetched["loss"]),
                    "Train/lr": float(fetched["lr"]),
                    "Train/grad_norm": float(fetched["grad_norm"]),
                    "Train/loss_scale": float(fetched["loss_scale"]),
                })
                # the registry rides the same writers, at the print cadence
                if printing:
                    self.metrics.publish(self.monitor, self.global_steps)
            metrics = fetched
        return metrics

    @staticmethod
    def _fetch(metrics) -> Dict[str, Any]:
        return {k: (float(v) if isinstance(v, torch.Tensor) else v)
                for k, v in metrics.items()}

    def _write_flops_profile(self) -> None:
        """The flops profiler's report of the profiled step: its counted
        flops (``profiling.count_flops``), the parameter count, and the
        mean host seconds a step and TFLOP/s over the steps the
        throughput timer counts (none before its start step).  Kept on
        ``flops_profile``; written to ``output_file`` when set."""
        from ..profiling import FlopsProfiler
        stats = {"flops": self.flops_profile["flops"],
                 "params": float(self.num_params)}
        counted = self.tput.global_step_count - self.tput.start_step
        if counted > 0 and self.tput.total_elapsed_time:
            stats["latency_s"] = self.tput.total_elapsed_time / counted
            stats["tflops_per_s"] = (stats["flops"] / stats["latency_s"]
                                     / 1e12)
        self.flops_profile.update(stats)
        report = FlopsProfiler.report(stats,
                                      batch_size=self.train_batch_size)
        log_dist("\n" + report)
        if self.config.flops_profiler.output_file:
            with open(self.config.flops_profiler.output_file, "w") as f:
                f.write(report + "\n")

    def eval_batch(self, batch, rng: Optional[torch.Tensor] = None):
        """The loss (``eval_fn`` or ``loss_fn``) on the current parameters,
        without gradients, as a numpy scalar."""
        if self._stream is not None:
            out = self._stream.eval_batch(batch, rng)
            return np.asarray(out.detach().float().cpu().numpy())
        fn = self.eval_fn or self.loss_fn
        # PLD / random-LTD losses carry a clean variant for evaluation
        fn = getattr(fn, "base_eval", None) or fn
        batch = self.shard_batch(batch, accumulate=False)
        with torch.no_grad():
            out = fn(self._step_params(), batch,
                     PRNGKey(0) if rng is None else rng)
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

        def host(x):          # PLD's theta column, read by the host
            t = torch.as_tensor(np.asarray(x))
            return t.reshape((gas, -1) + tuple(t.shape[1:])) if gas > 1 \
                else t

        out = _StagedBatch({k: host(v) if k in _HOST_KEYS else put(v)
                            for k, v in batch.items()})
        out.accumulate = gas > 1
        return out

    # ------------------------------------------------------------------
    # introspection / params access
    # ------------------------------------------------------------------
    @property
    def compute_params(self):
        """Current params in the compute dtype (copies, on the device)."""
        if self._stream is not None:
            raise ConfigError(
                "compute_params is unavailable under param streaming "
                "(offload_param.device=nvme): the full compute tree never "
                "materializes; load a checkpoint instead")
        if self._offload == "none":
            return self._compute_params(self.state.master)
        return tree_map(lambda w: w.to(self.device, copy=True), self._work)

    def get_lr(self) -> float:
        # schedule position = optimizer steps actually applied
        return float(self.lr_schedule(float(self.state.step)))

    def get_global_grad_norm(self) -> Optional[float]:
        if self._last_metrics is None:
            return None
        if self._last_metrics_host is None:
            self._last_metrics_host = self._fetch(self._last_metrics)
        return float(self._last_metrics_host["grad_norm"])

    # ------------------------------------------------------------------
    # checkpointing (delegates to deepspeed_tpu_torch.checkpoint)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None) -> str:
        """Write the state as ``save_dir/tag`` (default
        ``global_step<N>``) in the JAX package's fragment format and point
        ``save_dir/latest`` at it; with ``checkpoint.async_save`` the state
        is copied to the host now and written on a worker thread
        (:meth:`wait_checkpoint` joins it).  NVMe state is written in
        fp32 (the master and moments, not the working copy), one swap
        group at a time, synchronously.  Returns the tag's directory."""
        if self._nvme is not None:
            if self.config.checkpoint.async_save:
                raise ConfigError(
                    "checkpoint.async_save is not supported for NVMe-"
                    "offloaded state: it is written from NVMe one swap "
                    "group at a time, synchronously")
            return self._save_checkpoint_nvme(save_dir, tag, client_state)
        if self.config.checkpoint.async_save:
            if self._async_saver is None:
                self._async_saver = ckpt.AsyncCheckpointSaver()
            return ckpt.save_checkpoint_async(self, self._async_saver,
                                              save_dir, tag=tag,
                                              client_state=client_state)
        return ckpt.save_checkpoint(self, save_dir, tag=tag,
                                    client_state=client_state)

    def _save_checkpoint_nvme(self, save_dir, tag, client_state) -> str:
        """The fp32 NVMe state through lazy leaves: the writer reads one
        column of one swap group at a time (the state may exceed host
        memory), in the format of every other run."""
        source = self._stream if self._stream is not None else self._nvme
        master, m, v = source.state_trees(lazy=True)
        saved = self.state
        self.state = saved._replace(master=master,
                                    opt_state=AdamState(m=m, v=v))
        try:
            return ckpt.save_checkpoint(self, save_dir, tag=tag,
                                        client_state=client_state)
        finally:
            self.state = saved

    def wait_checkpoint(self) -> None:
        """Join an in-flight async checkpoint save (no-op otherwise);
        re-raises a failed save's error."""
        if self._async_saver is not None:
            self._async_saver.wait()

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        """Load ``load_dir/tag`` (``latest`` when None), saved here or by
        the JAX engine on any mesh: every leaf lands on the engine's
        device in the port's dtype, and ``global_steps`` /
        ``global_samples`` are restored, so the next step's rng
        (``seed + global_steps``) continues an uninterrupted run.  Returns
        (checkpoint dir, client_state)."""
        self.wait_checkpoint()        # never read a half-written save
        if self._offload == "nvme":
            return self._load_checkpoint_nvme(load_dir, tag)
        if self._offload == "host":
            return self._load_checkpoint_host(load_dir, tag)
        return ckpt.load_checkpoint(self, load_dir, tag=tag)

    def _loaded(self, ckpt_dir: str, meta: Dict, where: str):
        self.global_steps = int(meta.get("global_steps", 0))
        self.global_samples = int(meta.get("global_samples", 0))
        log_dist(f"loaded checkpoint {ckpt_dir} into {where} "
                 f"(step {self.global_steps})")
        return ckpt_dir, meta.get("client_state", {})

    def _load_checkpoint_host(self, load_dir: str, tag: Optional[str]):
        """ZeRO-Offload: the master and moments are filled in place, in
        their (pinned) host memory; the working copy is cast from the
        master."""
        ckpt_dir = os.path.join(load_dir, tag if tag is not None
                                else ckpt.read_latest(load_dir))
        self.state, meta = ckpt.load_tree_into(self.state, ckpt_dir)
        with torch.no_grad():
            for w, p in zip(tree_leaves(self._work),
                            tree_leaves(self.state.master)):
                w.copy_(p)
        return self._loaded(ckpt_dir, meta, "host memory")

    def _load_checkpoint_nvme(self, load_dir: str, tag: Optional[str]):
        """The fp32 master and moments go to the NVMe store and the working
        copy is cast from the master (``_load_checkpoint_nvme`` of the JAX
        engine).  A checkpoint of a run without NVMe loads too: the
        master / AdamState keys are the same."""
        ckpt_dir = os.path.join(load_dir, tag if tag is not None
                                else ckpt.read_latest(load_dir))
        f32 = lambda x: torch.empty(tuple(x.shape), dtype=torch.float32,
                                    device="meta")
        master_tpl = tree_map(f32, self._stream.master_template()
                              if self._stream is not None else self._work)
        template = self.state._replace(
            master=master_tpl, opt_state=AdamState(m=master_tpl,
                                                   v=master_tpl))
        host, meta = ckpt.load_tree_host(template, ckpt_dir)
        if self._stream is not None:
            self._stream.restore(host.master, host.opt_state.m,
                                 host.opt_state.v)
            master = self._stream.resident
        else:
            self._nvme.restore(host.master, host.opt_state.m,
                               host.opt_state.v)
            with torch.no_grad():
                for w, p in zip(tree_leaves(self._work),
                                tree_leaves(host.master)):
                    w.copy_(p)
            master = self._work
        self.state = host._replace(master=master, opt_state=())
        return self._loaded(ckpt_dir, meta, "NVMe state")

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
    de_routing = cfg.data_efficiency.enabled \
        and cfg.data_efficiency.data_routing.enabled \
        and cfg.data_efficiency.data_routing.random_ltd.enabled
    if (cfg.progressive_layer_drop.enabled or de_routing) \
            and loss_fn is None:
        # PLD / random-LTD change the transformer forward: the loss is
        # rebuilt with their hooks from the model's config
        if model is None or not hasattr(model, "config"):
            raise ConfigError(
                "progressive_layer_drop / random_ltd need model= with a "
                "TransformerConfig (the loss must expose the layer stack)")
        if de_routing and model.config.position == "alibi":
            raise ConfigError(
                "random_ltd does not compose with position='alibi' "
                "(the distance bias would see gathered, not original, "
                "token positions)")
        from ..models.transformer import lm_loss_fn
        loss_fn = lm_loss_fn(model.config,
                             getattr(model, "attention_fn", None),
                             pld=cfg.progressive_layer_drop.enabled)
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
