"""Optimizers as gradient transformations on parameter trees.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``: ``Optimizer``,
``AdamState``, ``adamw`` (:63), ``adam``, ``lion``, ``adagrad``, ``lamb``,
``sgd`` and ``build_optimizer`` (:277), in plain tensor ops.
``update(grads, state, params, step) -> (updates, new_state)`` returns
*deltas* to add to the fp32 master parameters, as in the JAX package
(:76-97); moments are fp32 unless ``moment_dtype`` says otherwise
(``adamw``, ``adam``, ``lion``: the update runs in fp32 and rounds the
new moments to that dtype, as the reference does at :93 and :132).
``step`` is the optimizer step about to be applied (a Python int, 1 for
the first update); the learning rate and the bias corrections are host
floats.

Every optimizer here is defined by its update of one leaf,
``update_leaf(g, state_leaves, p, step) -> (delta, new_state_leaves)``,
with ``state_leaves`` the leaf's entry in each field of the state; the
tree ``update`` applies it leaf by leaf.  An optimizer that needs a value
over all leaves (a global norm, a compressed all-reduce) does not fit that
form and is not expressed as one.

The 1-bit family (``onebitadam``, ``zerooneadam``, ``onebitlamb``) is not
ported: it needs the compressed DP all-reduce (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .runtime_utils import tree_leaves, tree_map, tree_unflatten

Schedule = Callable[[float], float]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update_leaf: Callable[[Any, Tuple, Any, int], Tuple[Any, Tuple]]
    # update_leaf(g, state_leaves, p, step) -> (delta, new_state_leaves)

    def update(self, grads, state, params, step: int) -> Tuple[Any, Any]:
        """(updates, new_state) for whole trees: ``update_leaf`` leaf by
        leaf; ``updates`` is shaped like ``grads``, each field of the new
        state too."""
        fields = [tree_leaves(f) for f in state]
        outs = [self.update_leaf(g, tuple(f[i] for f in fields), p, step)
                for i, (g, p) in enumerate(zip(tree_leaves(grads),
                                               tree_leaves(params)))]
        updates = tree_unflatten(grads, [d for d, _ in outs])
        return updates, type(state)(*(
            tree_unflatten(grads, [new[j] for _, new in outs])
            for j in range(len(fields))))


def _lr_fn(lr) -> Schedule:
    return lr if callable(lr) else (lambda _: float(lr))


def _zeros(params, dtype=torch.float32):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt``, correctly rounded also on the CPU: PyTorch's CPU
    kernel for fp32 is off by one ulp on ~0.6% of inputs, the card's
    (IEEE ``sqrtf``) and numpy's are not.  A host update (ZeRO-Offload's
    ``update_leaf`` on CPU tensors, ``HostAdam``) must round as the card
    does, so an fp32 CPU input goes through float64, where the square root
    rounded once more to fp32 is the correctly rounded one."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _moment_dtype(dtype) -> torch.dtype:
    """A ``moment_dtype`` as a torch dtype: a torch dtype, or its name as
    a JSON config spells it (``"bfloat16"``)."""
    out = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f"moment_dtype={dtype!r}: expected a floating "
                         "torch dtype or its name (e.g. 'bfloat16')")
    return out


# --------------------------------------------------------------------------
# Adam / AdamW
# --------------------------------------------------------------------------

class AdamState(NamedTuple):
    m: Any
    v: Any


def adamw(lr, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, adam_w_mode: bool = True,
          bias_correction: bool = True,
          moment_dtype=torch.float32) -> Optimizer:
    """AdamW (``adam_w_mode=True``, decoupled decay) or Adam with L2;
    the moments are stored in ``moment_dtype``."""
    b1, b2 = betas
    lr_fn = _lr_fn(lr)
    moment_dtype = _moment_dtype(moment_dtype)

    def init(params):
        return AdamState(m=_zeros(params, moment_dtype),
                         v=_zeros(params, moment_dtype))

    def update_leaf(g, state, p, step: int):
        m, v = (x.float() for x in state)
        lr_t = lr_fn(float(step))
        c1 = 1.0 - b1 ** step if bias_correction else 1.0
        c2 = 1.0 - b2 ** step if bias_correction else 1.0
        g32 = g.float()
        if not adam_w_mode and weight_decay:              # classic L2
            g32 = g32 + weight_decay * p.float()
        m_ = b1 * m + (1 - b1) * g32
        v_ = b2 * v + (1 - b2) * (g32 * g32)
        # the bias corrections as products by their reciprocals: what
        # both the card's and the CPU's kernels then compute alike (a
        # division by a Python number is a product by its reciprocal on
        # the card and a true division on the CPU), so a host update
        # (ZeRO-Offload) rounds as the card's
        delta = -lr_t * (m_ * (1.0 / c1)) / (sqrt(v_ * (1.0 / c2)) + eps)
        if adam_w_mode and weight_decay:                  # decoupled decay
            delta = delta - lr_t * weight_decay * p.float()
        return delta, (m_.to(moment_dtype), v_.to(moment_dtype))

    return Optimizer(init, update_leaf)


def adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **kw) -> Optimizer:
    return adamw(lr, betas, eps, weight_decay, adam_w_mode=False, **kw)


# --------------------------------------------------------------------------
# Lion
# --------------------------------------------------------------------------

class LionState(NamedTuple):
    m: Any


def lion(lr, betas=(0.9, 0.99), weight_decay: float = 0.0,
         moment_dtype=torch.float32) -> Optimizer:
    b1, b2 = betas
    lr_fn = _lr_fn(lr)
    moment_dtype = _moment_dtype(moment_dtype)

    def init(params):
        return LionState(m=_zeros(params, moment_dtype))

    def update_leaf(g, state, p, step: int):
        m = state[0].float()
        lr_t = lr_fn(float(step))
        g32 = g.float()
        delta = -lr_t * torch.sign(b1 * m + (1 - b1) * g32)
        if weight_decay:
            delta = delta - lr_t * weight_decay * p.float()
        return delta, ((b2 * m + (1 - b2) * g32).to(moment_dtype),)

    return Optimizer(init, update_leaf)


# --------------------------------------------------------------------------
# Adagrad
# --------------------------------------------------------------------------

class AdagradState(NamedTuple):
    acc: Any


def adagrad(lr, eps: float = 1e-10, weight_decay: float = 0.0,
            initial_accumulator: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return AdagradState(acc=tree_map(
            lambda p: torch.full_like(p, initial_accumulator,
                                      dtype=torch.float32), params))

    def update_leaf(g, state, p, step: int):
        (a,) = state
        lr_t = lr_fn(float(step))
        g32 = g.float()
        if weight_decay:
            g32 = g32 + weight_decay * p.float()
        a_ = a + g32 * g32
        return -lr_t * g32 / (sqrt(a_) + eps), (a_,)

    return Optimizer(init, update_leaf)


# --------------------------------------------------------------------------
# LAMB
# --------------------------------------------------------------------------

def lamb(lr, betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.0,
         min_trust: float = 0.01, max_trust: float = 10.0) -> Optimizer:
    """Per-tensor trust ratio ||p|| / ||update|| scales the step."""
    b1, b2 = betas
    lr_fn = _lr_fn(lr)

    def init(params):
        return AdamState(m=_zeros(params), v=_zeros(params))

    def update_leaf(g, state, p, step: int):
        m, v = state
        lr_t = lr_fn(float(step))
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        g32 = g.float()
        p32 = p.float()
        m_ = b1 * m + (1 - b1) * g32
        v_ = b2 * v + (1 - b2) * (g32 * g32)
        u = (m_ * (1.0 / c1)) / (sqrt(v_ * (1.0 / c2)) + eps)
        if weight_decay:
            u = u + weight_decay * p32
        w_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(u)
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            torch.clamp(w_norm / u_norm, min_trust,
                                        max_trust),
                            torch.ones_like(w_norm))
        return -lr_t * trust * u, (m_, v_)

    return Optimizer(init, update_leaf)


# --------------------------------------------------------------------------
# SGD (momentum)
# --------------------------------------------------------------------------

class SGDState(NamedTuple):
    mom: Any


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return SGDState(mom=_zeros(params))

    def update_leaf(g, state, p, step: int):
        (b,) = state
        lr_t = lr_fn(float(step))
        g32 = g.float()
        if weight_decay:
            g32 = g32 + weight_decay * p.float()
        b_ = momentum * b + g32
        d = g32 + momentum * b_ if nesterov else b_
        return -lr_t * d, (b_,)

    return Optimizer(init, update_leaf)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

def _onebit(name):
    def build(lr, **kw):
        raise NotImplementedError(
            f"optimizer {name!r} (1-bit compressed communication) is not "
            "ported yet: it needs the compressed DP all-reduce (ROADMAP "
            "Queue 1 item 6, multi-GPU training breadth)")
    return build


OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {
    "adam": adam,
    "adamw": adamw,
    "lion": lion,
    "lamb": lamb,
    "adagrad": adagrad,
    "sgd": sgd,
    "onebitadam": _onebit("onebitadam"),
    "zerooneadam": _onebit("zerooneadam"),
    "onebitlamb": _onebit("onebitlamb"),
}


def build_optimizer(name: str, lr, params_cfg: Optional[Dict] = None) -> Optimizer:
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}")
    kw = dict(params_cfg or {})
    kw.pop("lr", None)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    return OPTIMIZERS[name](lr, **kw)


__all__ = ["AdamState", "AdagradState", "LionState", "OPTIMIZERS",
           "Optimizer", "SGDState", "adagrad", "adam", "adamw",
           "build_optimizer", "lamb", "lion", "sgd"]
