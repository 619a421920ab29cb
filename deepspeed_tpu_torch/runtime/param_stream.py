"""Per-layer NVMe parameter streaming for training (ZeRO-Infinity).

Counterpart of ``deepspeed_tpu/runtime/param_stream.py`` on one process
(``ResidencyMeter`` :50, ``StreamedInfinityTrainer`` :72, ``_LazyStack``
:826): the layers' parameters live on NVMe in the compute dtype and pass
through the card one layer at a time, so a model larger than the card
(and than host memory) trains.  The layer loop runs on the host; each
per-layer program is a plain torch function over the port's own block
(``models.transformer.block_apply``), whose attention is the model's
``attention_fn`` (the K1 kernels on the card, as on the resident path).

* **forward sweep**: layer l+1's parameters are read from the store
  through aio (into pinned memory on the card's machine) while layer l
  runs, and copied to the card on a side stream; each layer's input is
  kept as its activation checkpoint.
* **backward sweep**: the parameters are fetched again in reverse order,
  the layer's forward is recomputed under autograd and
  ``torch.autograd.grad`` taken for its parameters and its input; the
  fp32 layer grads are spilled to the grad store, and the grad-norm and
  overflow terms summed as the sweep goes.
* **update sweep**: :meth:`NVMeOptimizer.step` walks the fp32 master and
  moments group by group, reads the grads lazily (one grad group
  resident) and writes each fresh compute-dtype layer back to the store.

The card holds the resident parameters (embeddings, final norm, head),
two layers' weights and the activation checkpoints; host memory one
optimizer swap group and one layer's grads (:class:`ResidencyMeter`).
"""

from __future__ import annotations

import os
import shutil
import time
import weakref
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.engine import _leaf_paths, _map_with_path
from ..config.config import ConfigError
from ..models import layers as Lx
from ..models import transformer as T
from ..utils.logging import log_dist
from .runtime_utils import tree_leaves, tree_map, tree_unflatten
from .swap_tensor import OptimizerSwapper, TensorSpec, tree_bytes


class ResidencyMeter:
    """Bytes of the live host buffers of the streaming path (the
    instrument behind "peak host memory < the model's bf16 bytes")."""

    def __init__(self):
        self.cur = 0
        self.peak = 0

    def alloc(self, n: int) -> None:
        self.cur += int(n)
        self.peak = max(self.peak, self.cur)

    def free(self, n: int) -> None:
        self.cur -= int(n)


def _specs(tree, dtype=None, drop_lead: bool = False):
    def one(x):
        shape = tuple(x.shape)[1:] if drop_lead else tuple(x.shape)
        return TensorSpec(shape, dtype or x.dtype)
    return tree_map(one, tree)


class StreamedInfinityTrainer:
    """Owns the NVMe stores and the host-driven streamed step of one
    engine.  Built by the engine for ``offload_param.device=nvme`` with a
    stacked-layer model (``models.transformer``)."""

    def __init__(self, engine, model, params):
        self.eng = engine
        cfg = model.config
        self.cfg = cfg
        self.attention_fn = getattr(model, "attention_fn", None)
        self._check_supported(engine, cfg)
        self.L = int(cfg.num_layers)
        self.meter = ResidencyMeter()
        self.device = engine.device
        self._cuda = self.device.type == "cuda"

        off = engine.config.zero_optimization.offload_optimizer
        offp = engine.config.zero_optimization.offload_param
        # the parameter and grad stores go where offload_param points;
        # the optimizer state stays under offload_optimizer.nvme_path
        root = os.path.join(offp.nvme_path or off.nvme_path, "param_stream",
                            f"r0_{os.getpid()}_{id(self):x}")
        self._cleanup = weakref.finalize(self, shutil.rmtree, root, True)

        if not (isinstance(params, dict) and "blocks" in params):
            raise ConfigError(
                "offload_param.device=nvme streaming needs the stacked-"
                "layer param layout (a 'blocks' subtree with a leading "
                "num_layers dim, models.transformer.init_params)")
        blocks = params["blocks"]
        resident = {k: v for k, v in params.items() if k != "blocks"}
        dt = engine.compute_dtype
        self._blocks_tpl = _specs(blocks, dt)
        self._layer_tpl = _specs(blocks, dt, drop_lead=True)
        self._lgrad_tpl = _specs(blocks, torch.float32, drop_lead=True)
        self._rgrad_tpl = _specs(resident, torch.float32)

        aio_cfg = engine.config.aio
        # compute-dtype working copies, one swap group per layer (read
        # into pinned memory on the card's machine, for the side-stream
        # copy)
        self._pstore = OptimizerSwapper(os.path.join(root, "params"), self.L,
                                        aio_config=aio_cfg, pin=self._cuda)
        # fp32 grads: one group per layer, one for the resident leaves
        self._gstore = OptimizerSwapper(os.path.join(root, "grads"),
                                        self.L + 1, aio_config=aio_cfg)
        # the fp32 master and moments live in the engine's NVMeOptimizer,
        # over the UNSTACKED tree: per-layer leaves, so swap groups align
        # with layers instead of one stacked leaf
        self._opt = engine._nvme
        self._opt.meter = self.meter
        unstacked = {"layers": [tree_map(lambda x, l=l: x[l], blocks)
                                for l in range(self.L)],
                     "resident": resident}
        self._opt.initialize(unstacked)
        # the store's flat leaf i -> (kind, layer, path in its subtree)
        self._leafmap: List[Tuple[str, int, str]] = []
        for path, _ in _leaf_paths(unstacked):
            if path.startswith("['layers']"):
                l = int(path[len("['layers']["):].split("]")[0])
                self._leafmap.append(
                    ("layer", l, path[len(f"['layers'][{l}]"):]))
            else:
                self._leafmap.append(
                    ("resident", -1, path[len("['resident']"):]))
        self._lpaths = [p for p, _ in _leaf_paths(self._layer_tpl)]
        self._rpaths = [p for p, _ in _leaf_paths(self._rgrad_tpl)]

        for l in range(self.L):
            self._pstore.write_group(
                l, tree_map(lambda x: x[l].detach().to("cpu", dt), blocks))
        self.resident = tree_map(
            lambda x: x.detach().to(self.device, dt, copy=True), resident)
        self._res_bytes = tree_bytes(_specs(resident, dt))
        self.num_params = sum(x.numel() for x in tree_leaves(params))
        self._layer_bytes = tree_bytes(self._layer_tpl)
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self._cuda else None
        self._cos_sin = None
        self.io = {"read": 0, "written": 0}
        self.last_times: Dict[str, float] = {}
        log_dist(
            f"ZeRO-Infinity param streaming: {self.L} layers "
            f"({self._layer_bytes / 1e6:.1f} MB/layer) stream via {root}; "
            f"resident {self._res_bytes / 1e6:.1f} MB stays on "
            f"{self.device}")

    @staticmethod
    def _check_supported(engine, model_cfg) -> None:
        cfg = engine.config
        bad = []
        if max(cfg.mesh.pipe, cfg.pipeline.stages) > 1:
            bad.append("pipeline parallelism")
        if max(cfg.mesh.seq, cfg.sequence_parallel.size) > 1:
            bad.append("sequence parallelism")
        if cfg.progressive_layer_drop.enabled:
            bad.append("progressive_layer_drop")
        if cfg.data_efficiency.enabled \
                and cfg.data_efficiency.data_routing.enabled \
                and cfg.data_efficiency.data_routing.random_ltd.enabled:
            bad.append("random_ltd")
        if cfg.quantize_training.enabled:
            bad.append("quantize_training (MoQ)")
        if "onebit" in cfg.optimizer.type.lower() \
                or "zeroone" in cfg.optimizer.type.lower():
            bad.append("1-bit optimizers")
        if cfg.zero_optimization.zero_quantized_weights \
                or cfg.zero_optimization.zero_quantized_gradients:
            bad.append("ZeRO++ quantized collectives")
        if cfg.sparse_gradients:
            bad.append("sparse_gradients")
        if getattr(model_cfg, "num_experts", 1) > 1:
            # the sweep drops block_apply's metrics, and with them the
            # MoE load-balancing aux loss
            bad.append("MoE (the streamed sweep cannot carry the "
                       "load-balancing aux loss)")
        if engine.eval_fn is not None:
            # eval_batch streams the built-in LM loss; replacing a custom
            # eval metric would report the wrong quantity
            bad.append("a custom eval_fn")
        if bad:
            raise ConfigError(
                "offload_param.device=nvme (per-layer param streaming) "
                f"does not compose with: {', '.join(bad)}")

    # ------------------------------------------------------------------
    # the per-layer programs
    # ------------------------------------------------------------------
    def _attention(self):
        cfg = self.cfg
        if self.attention_fn is not None:
            return self.attention_fn
        if cfg.position == "alibi":
            return Lx.make_alibi_attention(
                partial(Lx.causal_attention, scale=T.attn_scale(cfg)))
        return None

    def _cos_sin_arrays(self):
        if self._cos_sin is None:
            cfg = self.cfg
            self._cos_sin = (Lx.rope_freqs(cfg.rotary_dim, cfg.max_seq_len,
                                           cfg.rope_theta,
                                           device=self.device)
                             if cfg.position == "rope" else (None, None))
        return self._cos_sin

    def _embed(self, resident, ids):
        cfg = self.cfg
        dt = self.eng.compute_dtype
        x = Lx.embed(resident["embed"], ids).to(dt)
        if cfg.embed_norm:
            x = T._norm(cfg)(resident["ln_embed"], x)
        if cfg.position == "learned":
            x = x + resident["pos_embed"]["table"][:ids.shape[1]].to(dt)
        return x

    def _layer(self, lp, x, mask):
        cos, sin = self._cos_sin_arrays()
        y, _ = T.block_apply(self.cfg, lp, x, cos, sin, mask=mask,
                             attention_fn=self._attention())
        return y

    def _head_loss(self, resident, x, ids, mask):
        cfg = self.cfg
        dt = self.eng.compute_dtype
        xh = T._norm(cfg)(resident["ln_f"], x)
        if cfg.tie_embeddings:
            logits = xh @ resident["embed"]["table"].to(dt).T
        else:
            logits = xh @ resident["lm_head"]["kernel"].to(dt)
            if cfg.head_bias:
                logits = logits + resident["lm_head"]["bias"].to(dt)
        labels, tmask = T.rolled_lm_targets(ids, mask)
        return T.cross_entropy_loss(logits, labels, tmask)

    @staticmethod
    def _grad_leaves(tree):
        """(detached leaves requiring grad, the tree over them)."""
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
        return leaves, tree_unflatten(tree, leaves)

    # ------------------------------------------------------------------
    # layer fetches
    # ------------------------------------------------------------------
    def _fetch_layer(self, l: int):
        """Layer l's compute-dtype params on the device (prefetched from
        the store when the sweep is in order): on the card, copied from
        pinned memory on the side stream, which the compute stream then
        waits for."""
        host = self._pstore.read_group(l, self._layer_tpl)
        self.io["read"] += self._layer_bytes
        self.meter.alloc(self._layer_bytes)
        if not self._cuda:
            dev = host
        else:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                dev = tree_map(lambda t: t.to(self.device, non_blocking=True),
                               host)
            compute.wait_stream(self._copy_stream)
            for t in tree_leaves(dev):
                # allocated on the copy stream, used on the compute one
                t.record_stream(compute)
        # the pinned buffers go back to the caching host allocator, which
        # holds them until the copies that read them are done
        self.meter.free(self._layer_bytes)
        return dev

    # ------------------------------------------------------------------
    # the streamed step
    # ------------------------------------------------------------------
    def _unstage(self, batch, gas: int):
        """A pre-staged batch fetched back to host rows: the streamed loop
        slices and stages the micro-batches itself."""
        from .engine import _StagedBatch
        if not isinstance(batch, _StagedBatch):
            return batch

        def back(x):
            a = x.detach().cpu().numpy()
            if batch.accumulate:                  # undo the gas reshape
                a = a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
            return a
        return {k: back(v) for k, v in dict(batch).items()}

    def _stage(self, rows):
        return self.eng.shard_batch({"x": rows}, accumulate=False)["x"]

    def train_batch(self, batch, rng) -> Dict[str, Any]:
        eng = self.eng
        gas = eng.gas
        batch = self._unstage(batch, gas)
        ids_all = np.asarray(batch["input_ids"])
        rows = int(ids_all.shape[0])
        if rows % gas:
            raise ValueError(f"batch dim {rows} not divisible by gas={gas}")
        micro = rows // gas
        use_scaling = eng.precision == "fp16"
        scale = float(eng.state.loss_scale.scale) if use_scaling else 1.0
        denom = scale * (eng.config.gradient_predivide_factor
                         if eng.config.prescale_gradients else 1.0)
        mask_all = batch.get("attention_mask")
        mask_all = None if mask_all is None else np.asarray(mask_all)

        self.last_times = {"forward": 0.0, "backward": 0.0, "update": 0.0}
        losses = []
        sq_norm = 0.0
        finite = True
        for mb in range(gas):
            sl = slice(mb * micro, (mb + 1) * micro)
            ids = self._stage(ids_all[sl])
            mask = None if mask_all is None else self._stage(mask_all[sl])
            loss, sq, ok = self._micro_fwd_bwd(ids, mask, scale, denom, mb,
                                               gas, mb == gas - 1)
            losses.append(loss)
            sq_norm += sq
            finite = finite and ok

        gnorm = float(np.sqrt(sq_norm))
        metrics: Dict[str, Any] = {
            "loss": torch.tensor(float(np.mean(losses)), dtype=torch.float32),
            "grad_norm": torch.tensor(gnorm, dtype=torch.float32),
            "loss_scale": float(scale),
            "overflow": int(not finite),
        }
        new_scale_state = eng.scaler.update(eng.state.loss_scale,
                                            not finite)
        step_next = eng.state.step + 1
        lr = float(eng.lr_schedule(float(step_next)))
        metrics["lr"] = lr
        if finite:
            clip = eng.config.gradient_clipping
            factor = 1.0 if not clip or clip <= 0 else min(
                1.0, clip / (gnorm + 1e-6))
            t0 = time.perf_counter()
            self._update_sweep(lr, step_next, factor / gas)
            self.last_times["update"] = time.perf_counter() - t0
            new_step, skipped = step_next, eng.state.skipped
        else:
            new_step, skipped = eng.state.step, eng.state.skipped + 1
        from .engine import TrainState
        eng.state = TrainState(step=new_step, master=self.resident,
                               opt_state=(), loss_scale=new_scale_state,
                               skipped=skipped)
        return metrics

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def _micro_fwd_bwd(self, ids, mask, scale: float, denom: float,
                       mb: int, gas: int, last: bool
                       ) -> Tuple[float, float, bool]:
        """One micro-batch: the forward sweep, the head, the backward
        sweep with its grad spills.  Returns (loss, sq-norm term,
        finite); the last two only on the last micro-batch."""
        L = self.L
        t0 = time.perf_counter()
        acts: List[Optional[torch.Tensor]] = [None] * L
        with torch.no_grad():
            x = self._embed(self.resident, ids)
            if L:
                self._pstore.prefetch_group(0, self._layer_tpl)
            for l in range(L):
                lp = self._fetch_layer(l)
                if l + 1 < L:
                    self._pstore.prefetch_group(l + 1, self._layer_tpl)
                acts[l] = x
                x = self._layer(lp, x, mask)
                del lp
        # the head: loss * scale differentiated w.r.t. the resident
        # params and the last activation
        res_leaves, res = self._grad_leaves(self.resident)
        xh = x.detach().requires_grad_(True)
        loss = self._head_loss(res, xh, ids, mask)
        grads = torch.autograd.grad(loss * scale, res_leaves + [xh],
                                    allow_unused=True)
        d_x = grads[-1]
        res_grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                     else g.float() for p, g in zip(res_leaves, grads[:-1])]
        del grads, xh, x
        self._sync()
        t1 = time.perf_counter()
        self.last_times["forward"] += t1 - t0

        sq, finite = 0.0, True
        if L:
            self._pstore.prefetch_group(L - 1, self._layer_tpl)
        for l in range(L - 1, -1, -1):
            lp = self._fetch_layer(l)
            if l - 1 >= 0:
                self._pstore.prefetch_group(l - 1, self._layer_tpl)
            p_leaves, lp = self._grad_leaves(lp)
            x_in = acts[l].detach().requires_grad_(True)
            acts[l] = None
            y = self._layer(lp, x_in, mask)
            out = torch.autograd.grad(y, p_leaves + [x_in], grad_outputs=d_x,
                                      allow_unused=True)
            d_x = out[-1]
            d_lp = [torch.zeros_like(p, dtype=torch.float32) if g is None
                    else g.float() for p, g in zip(p_leaves, out[:-1])]
            del out, y, x_in, p_leaves, lp
            s, f = self._accum_spill(
                l, self._lgrad_tpl, tree_unflatten(self._lgrad_tpl, d_lp),
                denom, mb, last, gas)
            sq += s
            finite = finite and f
        # the embedding's share of the resident grads
        res_leaves, res = self._grad_leaves(self.resident)
        out = torch.autograd.grad(self._embed(res, ids), res_leaves,
                                  grad_outputs=d_x, allow_unused=True)
        for i, g in enumerate(out):
            if g is not None:
                res_grads[i] = res_grads[i] + g.float()
        del out, d_x
        s, f = self._accum_spill(self.L, self._rgrad_tpl,
                                 tree_unflatten(self._rgrad_tpl, res_grads),
                                 denom, mb, last, gas)
        self.last_times["backward"] += time.perf_counter() - t1
        return float(loss.detach()), sq + s, finite and f

    def _accum_spill(self, group: int, tpl, new, denom: float, mb: int,
                     last: bool, gas: int) -> Tuple[float, bool]:
        """Write (or add into) a grad-store group; on the last micro-batch
        the sq-norm and finite terms of (sum / gas)."""
        nbytes = tree_bytes(tpl)
        self.meter.alloc(nbytes)
        try:
            # unscale THIS micro-batch's grads before adding (the stored
            # partial sums are unscaled already)
            new = tree_map(lambda a: a.to("cpu"), new)
            if denom != 1.0:
                new = tree_map(lambda a: a / denom, new)
            if mb > 0:
                prev = self._gstore.read_group(group, tpl)
                self.io["read"] += nbytes
                self.meter.alloc(nbytes)
                new = tree_map(lambda a, b: a + b, prev, new)
                del prev
                self.meter.free(nbytes)
            sq, finite = 0.0, True
            if last:
                for g in tree_leaves(new):
                    ga = g / gas
                    s = float(torch.sum(ga.double() ** 2))
                    sq += s
                    finite = finite and bool(np.isfinite(s))
            self._gstore.write_group(group, new)
            self.io["written"] += nbytes
            return sq, finite
        finally:
            self.meter.free(nbytes)

    # ------------------------------------------------------------------
    # the update sweep
    # ------------------------------------------------------------------
    def _update_sweep(self, lr: float, step_num: int,
                      grad_scale: float) -> None:
        """The grouped NVMe master update, reading the grad store lazily;
        the fresh compute-dtype leaves go back to the param store layer
        by layer."""
        trainer = self
        cache: Dict[int, Dict[str, torch.Tensor]] = {}
        held = [0]

        class _LazyGrad:
            __slots__ = ("i",)

            def __init__(self, i):
                self.i = i

            def __array__(self, dtype=None, copy=None):
                kind, l, path = trainer._leafmap[self.i]
                gkey = l if kind == "layer" else trainer.L
                if gkey not in cache:
                    tpl = (trainer._lgrad_tpl if kind == "layer"
                           else trainer._rgrad_tpl)
                    cache.clear()
                    trainer.meter.free(held[0])
                    cache[gkey] = dict(_leaf_paths(
                        trainer._gstore.read_group(gkey, tpl)))
                    held[0] = tree_bytes(tpl)
                    trainer.io["read"] += held[0]
                    trainer.meter.alloc(held[0])
                g = (cache[gkey][path] * grad_scale).numpy()
                return g.astype(dtype) if dtype is not None and \
                    np.dtype(dtype) != g.dtype else g

        grads = [_LazyGrad(i) for i in range(len(self._leafmap))]
        dt = self.eng.compute_dtype
        staging: Dict[int, Dict[str, torch.Tensor]] = {}
        new_resident: Dict[str, torch.Tensor] = {}
        n_layer = len(self._lpaths)

        def consume(i: int, p_new: torch.Tensor) -> None:
            kind, l, path = self._leafmap[i]
            if kind == "layer":
                lay = staging.setdefault(l, {})
                lay[path] = p_new.to(dt)
                if len(lay) == n_layer:
                    self._pstore.write_group(l, _map_with_path(
                        lambda p, _: lay[p], self._layer_tpl))
                    self.io["written"] += self._layer_bytes
                    del staging[l]
            else:
                new_resident[path] = p_new.to(dt)

        self._opt.step(grads, lr, step_num, consume=consume)
        cache.clear()
        self.meter.free(held[0])
        assert not staging and len(new_resident) == len(self._rpaths)
        self.resident = _map_with_path(
            lambda p, _: new_resident[p].to(self.device),
            self._rgrad_tpl)

    # ------------------------------------------------------------------
    # eval and checkpoints
    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_batch(self, batch, rng) -> torch.Tensor:
        ids = self._stage(np.asarray(batch["input_ids"]))
        mask = batch.get("attention_mask")
        mask = None if mask is None else self._stage(np.asarray(mask))
        x = self._embed(self.resident, ids)
        if self.L:
            self._pstore.prefetch_group(0, self._layer_tpl)
        for l in range(self.L):
            lp = self._fetch_layer(l)
            if l + 1 < self.L:
                self._pstore.prefetch_group(l + 1, self._layer_tpl)
            x = self._layer(lp, x, mask)
        return self._head_loss(self.resident, x, ids, mask)

    def master_template(self):
        """fp32 specs in the ORIGINAL stacked structure (the checkpoint
        template)."""
        f32 = lambda s: TensorSpec(s.shape, torch.float32)
        return {**tree_map(f32, self._rgrad_tpl),
                "blocks": tree_map(f32, self._blocks_tpl)}

    def state_trees(self, lazy: bool = False):
        """fp32 (master, m, v) in the ORIGINAL stacked structure, so that
        a checkpoint loads into a run without streaming.  Stacked leaves
        materialize one at a time; ``lazy`` defers each leaf's read and
        stack to ``np.asarray``."""
        def restack(un):
            blocks = tree_map(
                lambda *ls: _LazyStack(ls) if lazy
                else np.stack([np.asarray(x) for x in ls]), *un["layers"])
            return {**un["resident"], "blocks": blocks}
        return tuple(restack(t) for t in self._opt.state_trees(lazy=lazy))

    def restore(self, master, m=None, v=None) -> None:
        """Load whole stacked fp32 trees into the NVMe stores and refresh
        the compute-dtype working copies (checkpoint load)."""
        def unstack(tree):
            if tree is None:
                return None
            return {"layers": [tree_map(lambda x, l=l: x[l], tree["blocks"])
                               for l in range(self.L)],
                    "resident": {k: x for k, x in tree.items()
                                 if k != "blocks"}}

        self._opt.restore(unstack(master), unstack(m), unstack(v))
        dt = self.eng.compute_dtype
        for l in range(self.L):
            self._pstore.write_group(l, tree_map(
                lambda x: torch.as_tensor(x[l]).to("cpu", dt),
                master["blocks"]))
        self.resident = tree_map(
            lambda x: torch.as_tensor(x).to(self.device, dt),
            {k: x for k, x in master.items() if k != "blocks"})


class _LazyStack:
    """A lazily stacked checkpoint leaf over per-layer lazy NVMe leaves;
    [L, ...] materializes only when ``np.asarray`` touches it."""

    __slots__ = ("_leaves", "shape", "dtype")

    def __init__(self, leaves):
        self._leaves = leaves
        self.shape = (len(leaves),) + tuple(leaves[0].shape)
        self.dtype = np.dtype(leaves[0].dtype)

    def __array__(self, dtype=None, copy=None):
        out = np.stack([np.asarray(x) for x in self._leaves])
        return out.astype(dtype) if dtype is not None and \
            np.dtype(dtype) != out.dtype else out


__all__ = ["ResidencyMeter", "StreamedInfinityTrainer"]
