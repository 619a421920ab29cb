"""Autotuner: search over ZeRO stage x micro-batch x remat x mesh.

Counterpart of ``deepspeed_tpu/autotuning/autotuner.py``: ``Experiment``,
``mesh_factorizations``, ``build_space``, ``estimate_state_bytes`` and
``_apply_overrides`` are copied (pure Python); ``prune_by_memory`` takes
the card's total memory from ``torch.cuda.get_device_properties``; an
experiment (``evaluate``) is the port's ``initialize(model=..., config=...)``
and a few ``train_batch`` calls in-process, timed with the card
synchronised.  The JAX package reads two signals off its compiled program
(XLA's flop count and peak-memory estimate); the port has no compiled
program, so ``flops_per_step`` is ``profiling.analyze_fn``'s count over one
``train_batch`` and ``peak_bytes`` is ``torch.cuda.max_memory_allocated``
over that step after a reset.  With one card ``build_space`` drops every
ZeRO stage >= 1 (nothing to shard over), so the space is micro-batch x
remat policy.  ``autotune(..., device=None)`` runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..utils.logging import log_dist

REMAT_CHOICES = ("nothing", "dots_no_batch", "everything")


@dataclasses.dataclass
class Experiment:
    """One candidate configuration and its measured/estimated metrics."""
    overrides: Dict[str, Any]
    # filled by evaluation:
    step_time_s: Optional[float] = None
    compile_time_s: Optional[float] = None
    flops_per_step: Optional[float] = None
    peak_bytes: Optional[int] = None
    est_state_bytes: Optional[int] = None
    error: Optional[str] = None
    pruned: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.pruned is None and \
            self.step_time_s is not None

    def label(self) -> str:
        o = self.overrides
        mesh = o.get("mesh", {})
        return (f"z{o.get('zero_stage', 0)}"
                f"_mb{o.get('micro_batch', '?')}"
                f"_{o.get('remat_policy', 'nothing')}"
                f"_d{mesh.get('data', 1)}f{mesh.get('fsdp', 1)}"
                f"t{mesh.get('tensor', 1)}")


def mesh_factorizations(n_devices: int,
                        max_tensor: Optional[int] = None) -> List[Dict[str, int]]:
    """All (data, fsdp, tensor) factorizations of ``n_devices``.

    The reference has nothing like this (its DP degree is fixed by the
    launcher); on TPU the factorization decides which collectives ride
    which ICI axes, so it is a first-class tuning dimension."""
    out = []
    for tensor in sorted({d for d in range(1, n_devices + 1)
                          if n_devices % d == 0}):
        if max_tensor is not None and tensor > max_tensor:
            continue
        rest = n_devices // tensor
        for fsdp in sorted({d for d in range(1, rest + 1) if rest % d == 0}):
            out.append({"data": rest // fsdp, "fsdp": fsdp,
                        "tensor": tensor})
    return out


def build_space(n_devices: int,
                stages: Sequence[int] = (0, 1, 2, 3),
                micro_batches: Sequence[int] = (1, 2, 4, 8),
                remat_policies: Sequence[str] = REMAT_CHOICES,
                meshes: Optional[Sequence[Dict[str, int]]] = None,
                max_tensor: Optional[int] = None) -> List[Experiment]:
    """Enumerate the experiment space (reference:
    Autotuner._generate_experiments autotuner.py — tuning_space product
    over zero stages and micro-batch candidates)."""
    meshes = list(meshes) if meshes is not None else \
        mesh_factorizations(n_devices, max_tensor=max_tensor)
    exps = []
    for stage, mb, remat, mesh in itertools.product(
            stages, micro_batches, remat_policies, meshes):
        if stage >= 1 and mesh["fsdp"] == 1 and mesh["data"] == 1:
            continue        # nothing to shard over
        exps.append(Experiment(overrides={
            "zero_stage": stage, "micro_batch": mb,
            "remat_policy": remat, "mesh": dict(mesh)}))
    return exps


# --------------------------------------------------------------------------
# analytic memory model (pre-compile pruning)
# --------------------------------------------------------------------------

def estimate_state_bytes(n_params: int, stage: int, mesh: Dict[str, int],
                         compute_bytes: int = 2,
                         moment_count: int = 2) -> int:
    """Per-device persistent-state bytes under a ZeRO stage — the analog
    of the reference's memory estimators
    (``runtime/zero/stage3.py`` estimate_zero3_model_states_mem_needs):
    compute params + fp32 master + moments, sharded per stage."""
    fsdp = max(mesh.get("fsdp", 1), 1)
    tensor = max(mesh.get("tensor", 1), 1)
    dp_shard = fsdp if stage >= 1 else 1
    param_shard = (fsdp * tensor) if stage >= 3 else tensor
    compute = n_params * compute_bytes // param_shard
    master = n_params * 4 // (dp_shard * tensor)
    moments = n_params * 4 * moment_count // (dp_shard * tensor)
    return compute + master + moments


def prune_by_memory(exps: List[Experiment], n_params: int,
                    hbm_bytes: Optional[int] = None,
                    headroom: float = 0.6) -> List[Experiment]:
    """Mark experiments whose *persistent state alone* exceeds the memory
    budget (activations still need the headroom).  Returns survivors."""
    if hbm_bytes is None:
        # the card's memory; without one, the JAX package's fallback
        hbm_bytes = (torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
            if torch.cuda.is_available() else 16 << 30)
    budget = int(hbm_bytes * headroom)
    alive = []
    for e in exps:
        est = estimate_state_bytes(n_params, e.overrides["zero_stage"],
                                   e.overrides["mesh"])
        e.est_state_bytes = est
        if est > budget:
            e.pruned = (f"state {est/1e9:.2f} GB > budget "
                        f"{budget/1e9:.2f} GB")
        else:
            alive.append(e)
    return alive


# --------------------------------------------------------------------------
# experiment evaluation
# --------------------------------------------------------------------------

def _apply_overrides(base_config: Dict, ov: Dict[str, Any]) -> Dict:
    import copy
    cfg = copy.deepcopy(base_config)
    cfg.setdefault("zero_optimization", {})["stage"] = ov["zero_stage"]
    cfg["train_micro_batch_size_per_device"] = ov["micro_batch"]
    cfg.pop("train_batch_size", None)
    cfg["mesh"] = dict(ov["mesh"])
    return cfg


def evaluate(exp: Experiment, model_fn: Callable[[str], Any],
             base_config: Dict, batch_fn: Callable[[int], Any],
             steps: int = 3, warmup: int = 1, device=None) -> Experiment:
    """Run one experiment: build the engine, take its first step
    (``compile_time_s``: construction and that step), one step under the
    flops counter (``flops_per_step``; on the card ``peak_bytes``, the
    allocator's peak over it), ``warmup - 1`` more, then time ``steps``
    steps with the card synchronised.  ``model_fn(remat_policy)`` builds
    the model on ``device`` (None = the card)."""
    from ..profiling import analyze_fn
    from ..runtime.engine import initialize

    cfg = _apply_overrides(base_config, exp.overrides)
    eng = None
    try:
        model = model_fn(exp.overrides["remat_policy"])
        t0 = time.perf_counter()
        eng = initialize(model=model, config=cfg, device=device)
        cuda = eng.device.type == "cuda"

        def sync(m):
            float(m["loss"])
            if cuda:
                torch.cuda.synchronize(eng.device)

        batch = batch_fn(eng.train_batch_size)
        # staged once; reused for every step (the step does not consume
        # it), so host-side batch synthesis stays out of the timed region
        staged = eng.shard_batch(batch)
        sync(eng.train_batch(staged))
        exp.compile_time_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats(eng.device)
        exp.flops_per_step = analyze_fn(eng.train_batch, staged)["flops"]
        if cuda:
            torch.cuda.synchronize(eng.device)
            exp.peak_bytes = int(torch.cuda.max_memory_allocated(eng.device))
        m = None
        for _ in range(max(warmup - 1, 0)):
            m = eng.train_batch(staged)
        if m is not None:
            sync(m)
        t0 = time.perf_counter()
        for _ in range(steps):
            m = eng.train_batch(staged)
        sync(m)
        exp.step_time_s = (time.perf_counter() - t0) / steps
    # recorded, not swallowed: the tuner loop log_dist's every FAILED
    # experiment with this error string
    except Exception as e:  # tpulint: disable=silent-except
        exp.error = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    finally:
        del eng
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return exp


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def autotune(model_fn: Callable[[str], Any],
             base_config: Dict,
             batch_fn: Callable[[int], Any],
             n_params: Optional[int] = None,
             space: Optional[List[Experiment]] = None,
             tuner: str = "model",
             budget: int = 12,
             steps: int = 3,
             hbm_bytes: Optional[int] = None,
             device=None,
             **space_kw) -> List[Experiment]:
    """Search the config space; returns experiments ranked by step time
    (fastest first), failed/pruned ones at the end.

    ``model_fn(remat_policy) -> model`` builds the model per candidate
    (remat is a model-construction choice here); ``batch_fn(n)``
    synthesizes ``n`` samples — ``n`` is the per-process share of the
    candidate's global batch.  ``budget`` caps the number of *measured*
    experiments — the tuner decides which candidates get measured
    (reference: Autotuner.tune autotuner.py + tuner hierarchy).
    ``device``: None = the card (the space of one device), ``"cpu"`` for
    a CPU run; ``hbm_bytes`` defaults to the card's memory."""
    if space is None:
        space = build_space(1, **space_kw)
    if n_params is not None:
        # marks .pruned in place; pruned entries stay in the returned
        # list (with the reason) but are never measured
        prune_by_memory(space, n_params, hbm_bytes=hbm_bytes)
    space_alive = [e for e in space if e.pruned is None]

    from .tuner import GridTuner, ModelBasedTuner, RandomTuner
    tuner_cls = {"grid": GridTuner, "random": RandomTuner,
                 "model": ModelBasedTuner}[tuner]
    run = lambda e: evaluate(e, model_fn, base_config, batch_fn,  # noqa
                             steps=steps, device=device)
    tuner_obj = tuner_cls(space_alive, run)
    measured = tuner_obj.tune(budget)

    for e in measured:
        if e.ok:
            log_dist(f"autotune {e.label()}: {e.step_time_s*1e3:.1f} ms/step")
        elif e.error:
            log_dist(f"autotune {e.label()}: FAILED ({e.error})")

    ranked = sorted([e for e in measured if e.ok],
                    key=lambda e: e.step_time_s)
    rest = [e for e in space if not e.ok and e not in ranked]
    return ranked + rest
