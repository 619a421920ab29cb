"""Config-driven model compression: quantization, pruning, layer reduction.

Counterpart of ``deepspeed_tpu/compression/compress.py``.  Compression is
a pure function of the parameter tree: ``CompressionScheduler.apply(params,
step)`` returns compressed parameters, matching leaves by a regex on
their path (``blocks/attn/wq``).  Quantization is straight-through
(quantize then dequantize in the forward; the dense master keeps
training).  Every technique is plain PyTorch on the tensors it is given;
the fake-quantization is the grouped ``ops.quant.quantize``, whose codes
and scales are the JAX package's bit for bit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..ops.quant import default_groups, dequantize, quantize
from ..utils.logging import logger


# ---- techniques ------------------------------------------------------------

def weight_quantization(w: torch.Tensor, bits: int = 8,
                        groups: int = 1) -> torch.Tensor:
    """Fake-quantize (quantize -> dequantize): the QAT forward."""
    groups = default_groups(w.numel(), max(1, w.numel() // max(1, groups)))
    return dequantize(quantize(w, bits=bits, num_groups=groups))


def activation_quantization(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    return dequantize(quantize(x, bits=bits, num_groups=1))


def sparse_pruning(w: torch.Tensor, ratio: float,
                   method: str = "l1") -> torch.Tensor:
    """Unstructured magnitude pruning: the ``ratio`` smallest |w| zeroed."""
    if ratio <= 0:
        return w
    flat = w.reshape(-1).abs()
    k = int(flat.numel() * ratio)
    if k == 0:
        return w
    thresh = torch.sort(flat).values[k - 1]
    return torch.where(w.abs() > thresh, w, torch.zeros_like(w))


def row_pruning(w: torch.Tensor, ratio: float) -> torch.Tensor:
    """Structured row pruning by row L1 norm (rows zeroed, shape kept)."""
    if ratio <= 0 or w.dim() < 2:
        return w
    norms = w.abs().sum(dim=tuple(range(1, w.dim())))
    k = int(norms.numel() * ratio)
    if k == 0:
        return w
    thresh = torch.sort(norms).values[k - 1]
    mask = (norms > thresh).to(w.dtype)
    return w * mask.reshape((-1,) + (1,) * (w.dim() - 1))


def head_pruning(w: torch.Tensor, num_heads: int,
                 ratio: float) -> torch.Tensor:
    """Zero whole attention heads by head-block norm (the output
    projection's leading dim split into heads)."""
    if ratio <= 0:
        return w
    d = w.shape[0]
    if d % num_heads:
        raise ValueError(f"leading dim {d} not divisible by {num_heads} "
                         "heads")
    blocks = w.reshape(num_heads, d // num_heads, *w.shape[1:])
    norms = blocks.abs().sum(dim=tuple(range(1, blocks.dim())))
    k = int(num_heads * ratio)
    if k == 0:
        return w
    thresh = torch.sort(norms).values[k - 1]
    mask = (norms > thresh).to(w.dtype)
    return (blocks * mask.reshape((-1,) + (1,) * (blocks.dim() - 1))
            ).reshape(w.shape)


# ---- schedule ----------------------------------------------------------------

@dataclass
class TechniqueSpec:
    """One technique applied to the leaves whose path matches
    ``pattern``."""
    pattern: str                       # regex on the param path
    method: str                        # quantize|sparse_prune|row_prune|head_prune
    schedule_offset: int = 0           # steps before it activates
    bits: int = 8
    groups: int = 1
    ratio: float = 0.0
    num_heads: int = 1

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        if self.method == "quantize":
            return weight_quantization(w, self.bits, self.groups)
        if self.method == "sparse_prune":
            return sparse_pruning(w, self.ratio)
        if self.method == "row_prune":
            return row_pruning(w, self.ratio)
        if self.method == "head_prune":
            return head_pruning(w, self.num_heads, self.ratio)
        raise ValueError(f"unknown compression method {self.method!r}")


def _specs_from_config(cc: Dict) -> List[TechniqueSpec]:
    """The ``compression_training`` block (technique -> shared_parameters
    + different_groups) as TechniqueSpecs."""
    key_map = {
        "weight_quantization": "quantize",
        "sparse_pruning": "sparse_prune",
        "row_pruning": "row_prune",
        "head_pruning": "head_prune",
    }
    specs: List[TechniqueSpec] = []
    for key, method in key_map.items():
        tech = cc.get(key)
        if not tech or not tech.get("shared_parameters", {}).get(
                "enabled", False):
            continue
        shared = tech.get("shared_parameters", {})
        offset = int(shared.get("schedule_offset", 0))
        for gname, group in (tech.get("different_groups") or {}).items():
            gp = group.get("params", {})
            modules = group.get("modules", ["*"])
            # dense_ratio is the fraction KEPT; ratio the fraction pruned
            if "dense_ratio" in gp:
                ratio = 1.0 - float(gp["dense_ratio"])
            else:
                ratio = float(gp.get("sparse_ratio", gp.get("ratio", 0.0)))
            if method != "quantize" and ratio <= 0:
                logger.warning(
                    "compression group %s/%s: no dense_ratio/ratio given "
                    "— pruning disabled for this group", key, gname)
            for mod in modules:
                pattern = ".*" if mod == "*" else mod.replace("*", ".*")
                specs.append(TechniqueSpec(
                    pattern=pattern, method=method,
                    schedule_offset=offset,
                    bits=int(gp.get("start_bits",
                                    gp.get("target_bits", 8))),
                    groups=int(gp.get("quantization_groups", 1)),
                    ratio=ratio,
                    num_heads=int(gp.get("num_heads", 1))))
    return specs


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(path), tree)


class CompressionScheduler:
    """Applies the techniques whose schedule_offset has passed."""

    def __init__(self, specs: Sequence[TechniqueSpec]):
        self.specs = list(specs)

    @classmethod
    def from_config(cls, compression_config: Dict) -> "CompressionScheduler":
        return cls(_specs_from_config(compression_config or {}))

    def active(self, step: int) -> List[TechniqueSpec]:
        return [s for s in self.specs if step >= s.schedule_offset]

    def apply(self, params: Any, step: int) -> Any:
        active = self.active(step)
        if not active:
            return params

        def leaf(name, w):
            for s in active:
                if w.dim() >= 1 and re.search(s.pattern, name):
                    w = s.apply(w)
            return w

        return _map_with_path(leaf, params)


def init_compression(params: Any, ds_config: Dict) -> CompressionScheduler:
    """The scheduler to call inside a loss function or step."""
    cc = ds_config.get("compression_training", {})
    sched = CompressionScheduler.from_config(cc)
    logger.info("compression: %d technique spec(s)", len(sched.specs))
    return sched


def redundancy_clean(params: Any, ds_config: Dict,
                     step: int = 10**9) -> Any:
    """Bake all compression into the weights for deployment."""
    return CompressionScheduler.from_config(
        ds_config.get("compression_training", {})).apply(params, step)


# ---- layer reduction + distillation ----------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def student_initialization(student_params: Any, teacher_params: Any,
                           ds_config: Dict) -> Any:
    """A depth-reduced student from chosen teacher layers: one gather on
    the stacked layer dim (``blocks[teacher_layer]``); the other leaves
    are copied whole where their shapes agree.  Config::

        {"compression_training": {"layer_reduction": {
            "enabled": true, "keep_number_layer": 6,
            "teacher_layer": [1, 3, 5, 7, 9, 11]}}}   # default: even spread
    """
    lr = (ds_config.get("compression_training", {})
          .get("layer_reduction", {}))
    if not lr.get("enabled", False):
        raise ValueError("layer_reduction.enabled must be true")
    t_blocks = teacher_params["blocks"]
    n_teacher = _leaves(t_blocks)[0].shape[0]
    n_student = _leaves(student_params["blocks"])[0].shape[0]
    keep = int(lr.get("keep_number_layer", n_student))
    layers = lr.get("teacher_layer")
    if layers is None:
        layers = np.linspace(0, n_teacher - 1, keep).round().astype(int)
    layers = np.asarray(layers, np.int64)
    if keep != n_student:
        raise ValueError(f"keep_number_layer={keep} but the student has "
                         f"{n_student} layers")
    if len(layers) != keep:
        raise ValueError(f"teacher_layer has {len(layers)} entries but "
                         f"keep_number_layer={keep}")
    if layers.min() < 0 or layers.max() >= n_teacher:
        raise ValueError(f"teacher_layer {layers.tolist()} out of range "
                         f"({n_teacher} teacher layers)")

    def gather(w):
        return w[torch.from_numpy(layers).to(w.device)]

    out = dict(student_params)
    out["blocks"] = _map_with_path(lambda _, w: gather(w), t_blocks)
    for k in student_params:
        if k != "blocks" and k in teacher_params and \
                _shapes(teacher_params[k]) == _shapes(student_params[k]):
            out[k] = teacher_params[k]
    logger.info("student initialized from teacher layers %s",
                layers.tolist())
    return out


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """Distillation soft cross entropy: KL(teacher-softened || student)
    up to the teacher-entropy constant, times T^2."""
    t = temperature
    s = torch.log_softmax(student_logits.float() / t, dim=-1)
    p = torch.softmax(teacher_logits.float() / t, dim=-1)
    return -(p * s).sum(dim=-1).mean() * (t * t)
