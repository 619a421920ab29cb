"""Hessian eigenvalue estimation by power iteration.

Counterpart of ``deepspeed_tpu/runtime/eigenvalue.py``, used to pace MoQ's
bit reductions.  The JAX package takes exact Hessian-vector products by
forward-over-reverse (``jvp(grad(f))``); here each product is a second
backward through the retained graph of the first-order gradient
(``torch.autograd.grad(g, params, grad_outputs=v)``), so ``loss_fn`` must
be twice differentiable: the transformer's ``lm_loss_fn`` gives the
engine ``hvp_loss`` for that (a plain cross entropy; the flash kernels
have no second derivative, and it raises under them, as forward-over-
reverse through the JAX flash attention does: its Pallas kernels have no
JVP rule).

The random start vector is the JAX package's: one ``prng.normal`` draw
per leaf from ``split(rng, n_leaves)``, the leaves in JAX's order (dict
keys sorted), each cast to its leaf's dtype.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from ..utils.prng import normal, split


def _jax_order(tree) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [(((k,) + p), x) for k in sorted(tree)
                for p, x in _jax_order(tree[k])]
    return [((), tree)]


def _rebuild(paths, leaves):
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out if paths and paths[0] else leaves[0]


class Eigenvalue:
    """(reference: Eigenvalue.__init__ — verbose, max_iter, tol,
    stability, gas_boundary_resolution)."""

    def __init__(self, verbose: bool = False, max_iter: int = 100,
                 tol: float = 1e-2, stability: float = 1e-6,
                 gas_boundary_resolution: int = 1):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution

    def compute_eigenvalue(self, loss_fn: Callable[[Any], torch.Tensor],
                           params: Any, rng: torch.Tensor
                           ) -> Tuple[float, Any]:
        """Dominant Hessian eigenvalue of ``loss_fn`` at ``params`` (a
        tree of tensors): (eigenvalue, eigenvector tree)."""
        pairs = _jax_order(params)
        paths = [p for p, _ in pairs]
        leaves = [x.detach().requires_grad_(True) for _, x in pairs]
        loss = loss_fn(_rebuild(paths, leaves))
        grads = torch.autograd.grad(loss, leaves, create_graph=True,
                                    allow_unused=True)
        live = [i for i, g in enumerate(grads)
                if g is not None and g.requires_grad]

        def hvp(v: List[torch.Tensor]) -> List[torch.Tensor]:
            hv = [torch.zeros_like(x) for x in leaves]
            if live:
                out = torch.autograd.grad(
                    [grads[i] for i in live], leaves,
                    grad_outputs=[v[i] for i in live], retain_graph=True,
                    allow_unused=True)
                hv = [torch.zeros_like(x) if o is None else o.detach()
                      for x, o in zip(leaves, out)]
            return hv

        keys = split(rng, len(leaves))
        # drawn on each leaf's device (a host key would draw 124 M
        # normals of GPT-2 on the CPU)
        v = [normal(keys[i].to(x.device), tuple(x.shape)).to(x.dtype)
             for i, x in enumerate(leaves)]
        eig_prev = 0.0
        eig = 0.0
        for i in range(self.max_iter):
            n = torch.sqrt(sum((x.float() ** 2).sum() for x in v)) \
                + self.stability
            v = [(x / n).to(x.dtype) for x in v]
            hv = hvp(v)
            eig = float(sum((a.float() * b.float()).sum()
                            for a, b in zip(v, hv)))
            if i > 0 and abs(eig) > 0 and \
                    abs(eig - eig_prev) / abs(eig) < self.tol:
                break
            eig_prev = eig
            v = hv
        del grads
        return eig, _rebuild(paths, v)
