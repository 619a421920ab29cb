"""Mixture-of-Experts: top-k gating with capacity, dispatch and combine.

Counterpart of ``deepspeed_tpu/parallel/moe.py`` on one device: the
gating functions (``top_k_gating`` dense masks, ``top_k_gating_sparse``
index form, ``capacity_for``), the stacked expert FFN (``experts_init``,
``experts_apply``, ``gate_init``) and ``moe_ffn`` in its three dispatch
modes:

* ``"scatter"`` (default): each (token, choice) is written into an
  ``[E, C]`` slot buffer and gathered back, weighted, after the experts
  (``torch.bmm`` over the slots);
* ``"einsum"``: the GShard dense ``[T, E, C]`` dispatch/combine masks;
* ``"ragged"``: dropless, tokens sorted by expert and one matmul per
  expert group (the reference's ``lax.ragged_dot``).

None of these is a Pallas kernel in the reference (``ragged_dot`` and the
einsums are XLA ops), so all of it is plain torch here.  Tokens are gated
per group (one group per sequence), and a group's capacity is
``capacity_for(S, E, k, capacity_factor, min_capacity)``.  JAX's
``mode="drop"`` scatters have no torch counterpart (an out-of-range
index raises), so a dropped choice is sent to one spare slot past the
last, which is then discarded.

The gating noise (``noise_policy``) draws from the port's threefry keys
(``utils.prng``): ``"Jitter"`` multiplies the input by jax's uniforms bit
for bit, ``"RSample"`` adds jax's normals (to a few float32 ulps).

:func:`moe_serving` is the serving form (the JAX serving forward's
``moe_ffn(h[None], ...)``): one group of rows, of which only the valid
ones (not a step's padding) are gated, take slot positions and count
towards an expert's capacity; the capacity is the one the JAX engine uses
at the same call site (``tokens``, its row count there), and the slot
buffer holds ``min(capacity, rows)`` slots, which no expert can
outgrow.  Nothing in it reads a value back to the host, so a CUDA graph
can capture it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import prng


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


class GateOutput(NamedTuple):
    dispatch: torch.Tensor   # [T, E, C] float (0/1)
    combine: torch.Tensor    # [T, E, C] float (gate weights)
    aux_loss: torch.Tensor   # scalar load-balancing loss
    dropped: torch.Tensor    # scalar fraction of tokens dropped


class SparseGateOutput(NamedTuple):
    """Index-form gating: one (expert, slot, weight) triple per (token,
    choice)."""
    ids: torch.Tensor        # [T, K] expert per choice
    pos: torch.Tensor        # [T, K] slot within the expert (C = dropped)
    vals: torch.Tensor       # [T, K] f32 gate weights (0 when dropped)
    aux_loss: torch.Tensor
    dropped: torch.Tensor


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot over the last dim (a comparison: no host read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _noised(logits: torch.Tensor, rng: Optional[torch.Tensor],
            noise_policy: Optional[str]) -> torch.Tensor:
    """RSample: ``logits + normal(rng, logits.shape) / E`` (float32);
    ``rng`` [..., 2] keys for the leading dims of ``logits``."""
    if noise_policy == "RSample" and rng is not None:
        E = logits.shape[-1]
        lead = rng.shape[:-1]
        noise = prng.normal(rng.to(logits.device),
                            tuple(logits.shape[len(lead):]))
        return logits.float() + noise / E
    return logits


def _select(gates: torch.Tensor, top_k: int) -> Tuple[List, List]:
    """Iterative top-k over the last dim: (one-hot masks, indices)."""
    E = gates.shape[-1]
    remaining = gates
    sels, ids = [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        sel = _one_hot(idx, E)
        sels.append(sel)
        ids.append(idx)
        remaining = remaining * (1.0 - sel)
    return sels, ids


def _aux_loss(gates: torch.Tensor, sel0: torch.Tensor) -> torch.Tensor:
    """Switch/GShard load-balancing loss of the top-1 assignment."""
    E = gates.shape[-1]
    me = gates.mean(dim=-2)
    ce = sel0.mean(dim=-2)
    return (me * ce).sum(dim=-1) * E


def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int,
                 rng: Optional[torch.Tensor] = None,
                 noise_policy: Optional[str] = None,
                 norm_topk: bool = True) -> GateOutput:
    """logits: [..., T, E] (leading dims are groups, gated apart)."""
    logits = _noised(logits, rng, noise_policy)
    gates = torch.softmax(logits.float(), dim=-1)
    sels, _ = _select(gates, top_k)
    aux_loss = _aux_loss(gates, sels[0])
    prev = torch.zeros_like(gates[..., :1, :])
    kept_any = torch.zeros_like(gates[..., 0])
    dispatch = combine = 0.0
    for sel in sels:
        pos = torch.cumsum(sel, dim=-2) - 1.0 + prev
        keep = sel * (pos < capacity).float()
        pos_idx = (pos * keep).to(torch.int64)
        disp = keep[..., None] * _one_hot(pos_idx, capacity)
        gate_val = (gates * keep).sum(dim=-1, keepdim=True)
        dispatch = dispatch + disp
        combine = combine + disp * gate_val[..., None]
        prev = prev + sel.sum(dim=-2, keepdim=True)
        kept_any = torch.maximum(kept_any, keep.sum(dim=-1))
    if top_k > 1 and norm_topk:
        denom = combine.sum(dim=(-2, -1), keepdim=True)
        combine = combine / torch.clamp(denom, min=1e-9)
    return GateOutput(dispatch=dispatch, combine=combine, aux_loss=aux_loss,
                      dropped=1.0 - kept_any.mean(dim=-1))


def top_k_gating_sparse(logits: torch.Tensor, top_k: int, capacity: int,
                        rng: Optional[torch.Tensor] = None,
                        noise_policy: Optional[str] = None,
                        norm_topk: bool = True) -> SparseGateOutput:
    """The selection, capacity and renormalization of
    :func:`top_k_gating`, returned as indices.  logits: [..., T, E]."""
    logits = _noised(logits, rng, noise_policy)
    gates = torch.softmax(logits.float(), dim=-1)
    sels, ids = _select(gates, top_k)
    aux_loss = _aux_loss(gates, sels[0])
    prev = torch.zeros_like(gates[..., :1, :])
    kept_any = torch.zeros_like(gates[..., 0])
    pos_list, val_list = [], []
    for sel in sels:
        pos = torch.cumsum(sel, dim=-2) - 1.0 + prev
        keep = sel * (pos < capacity).float()
        pos_t = (pos * sel).sum(dim=-1)
        kept_t = keep.sum(dim=-1)
        val_list.append((gates * keep).sum(dim=-1))
        # dropped choices point at slot C (the spare slot)
        pos_list.append(torch.where(kept_t > 0, pos_t,
                                    float(capacity)).to(torch.int64))
        prev = prev + sel.sum(dim=-2, keepdim=True)
        kept_any = torch.maximum(kept_any, kept_t)
    vals = torch.stack(val_list, dim=-1)
    if top_k > 1 and norm_topk:
        vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return SparseGateOutput(
        ids=torch.stack(ids, dim=-1), pos=torch.stack(pos_list, dim=-1),
        vals=vals, aux_loss=aux_loss, dropped=1.0 - kept_any.mean(dim=-1))


def capacity_for(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float, min_capacity: int = 4) -> int:
    """(reference: _capacity sharded_moe.py)."""
    cap = int(math.ceil(tokens * top_k * capacity_factor / num_experts))
    return max(cap, min_capacity)


# --------------------------------------------------------------------------
# Expert FFN params (stacked on a leading expert dim)
# --------------------------------------------------------------------------

def experts_init(key: torch.Generator, num_experts: int, d_model: int,
                 d_ff: int, gated: bool = False, out_scale: float = None, *,
                 device=None, dtype: torch.dtype = torch.float32):
    """(params [E, ...], logical axes led by 'expert'), drawn from the
    ``torch.Generator`` ``key`` on its device (the reference takes a jax
    key)."""
    out_scale = out_scale or 1.0 / math.sqrt(d_ff)
    dev = key.device if device is None else torch.device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=key, device=dev,
                           dtype=dtype).mul_(scale)

    p = {"wi": normal((num_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
         "wo": normal((num_experts, d_ff, d_model), out_scale)}
    a = {"wi": ("expert", "embed", "mlp"), "wo": ("expert", "mlp", "embed")}
    if gated:
        p["wg"] = normal((num_experts, d_model, d_ff),
                         1.0 / math.sqrt(d_model))
        a["wg"] = ("expert", "embed", "mlp")
    return p, a


def experts_apply(p, x: torch.Tensor, activation: Callable,
                  gated: bool = False) -> torch.Tensor:
    """x: [E, C, d_model] -> [E, C, d_model]: one batched matmul per
    projection."""
    dt = x.dtype
    u = torch.bmm(x, p["wi"].to(dt))
    if gated:
        u = activation(torch.bmm(x, p["wg"].to(dt))) * u
    else:
        u = activation(u)
    return torch.bmm(u, p["wo"].to(dt))


def gate_init(key: torch.Generator, d_model: int, num_experts: int, *,
              device=None, dtype: torch.dtype = torch.float32):
    """The router's kernel [d_model, E] drawn from the ``torch.Generator``
    ``key``."""
    dev = key.device if device is None else torch.device(device)
    w = torch.randn((d_model, num_experts), generator=key, device=dev,
                    dtype=dtype).mul_(0.01)
    return {"kernel": w}, {"kernel": ("embed", None)}


def _gate_logits(xg: torch.Tensor, kernel: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
    """xg @ kernel.astype(dt), promoted as ``jnp.einsum`` promotes (a
    jittered float32 xg against a bf16 kernel runs in float32)."""
    ct = torch.promote_types(xg.dtype, dt)
    return xg.to(ct) @ kernel.to(dt).to(ct)


def _ragged_moe(expert_p, x: torch.Tensor, logits: torch.Tensor, *,
                top_k: int, activation: Callable, gated: bool,
                norm_topk: bool = True, noise_policy: Optional[str],
                rng: Optional[torch.Tensor], dt: torch.dtype
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DROPLESS grouped-GEMM MoE (``dispatch_mode="ragged"``): tokens
    sorted by assigned expert, one matmul per expert's row group (the
    group sizes are read on the host: a training path)."""
    B, S, dm = x.shape
    T = B * S
    E = logits.shape[-1]
    lf = _noised(logits.reshape(T, E), rng, noise_policy)
    gates = torch.softmax(lf.float(), dim=-1)
    sels, idxs = _select(gates, top_k)
    ids = torch.stack(idxs, dim=1)                                # [T, K]
    vals = torch.gather(gates, 1, ids)                            # [T, K]
    if top_k > 1 and norm_topk:
        vals = vals / torch.clamp(vals.sum(dim=1, keepdim=True), min=1e-9)
    aux_loss = _aux_loss(gates, sels[0])

    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    tok = order // top_k
    xs = x.reshape(T, dm)[tok].to(dt)
    sizes = torch.bincount(flat_ids, minlength=E).tolist()

    def grouped(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        parts = [a_g @ w[e].to(dt) for e, a_g in
                 enumerate(torch.split(a, sizes))]
        return torch.cat(parts) if parts else a.new_zeros((0, w.shape[-1]))

    u = grouped(xs, expert_p["wi"])
    if gated:
        u = activation(grouped(xs, expert_p["wg"])) * u
    else:
        u = activation(u)
    out = grouped(u, expert_p["wo"])
    w = vals.reshape(-1)[order].to(dt)
    y = torch.zeros((T, dm), dtype=dt, device=x.device).index_add(
        0, tok, out * w[:, None])
    return y.reshape(B, S, dm), {
        "moe_aux_loss": aux_loss,
        "moe_dropped": torch.zeros((), dtype=torch.float32,
                                   device=x.device)}


def _slot_dispatch(x: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                   E: int, C: int) -> torch.Tensor:
    """Rows of x [G, S, d] written to their (expert, slot) of a [G, E,
    C + 1, d] buffer (slot C, where dropped choices land, is the spare);
    ids/pos [G, S, K] -> the [G, E, C, d] slots, empty ones zero."""
    G, S, dm = x.shape
    K = ids.shape[-1]
    g = torch.arange(G, device=x.device)[:, None, None]
    flat = ((g * E + ids) * (C + 1) + pos).reshape(-1)
    rows = x[:, :, None, :].expand(G, S, K, dm).reshape(-1, dm)
    buf = x.new_zeros((G * E * (C + 1), dm)).index_put((flat,), rows)
    return buf.view(G, E, C + 1, dm)[:, :, :C]


def _slot_combine(eo: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                  vals: torch.Tensor, C: int) -> torch.Tensor:
    """K-way weighted gather: eo [G, E, C, d] -> [G, S, d] (a dropped
    choice reads slot C - 1 with weight 0, as the reference does)."""
    G = eo.shape[0]
    g = torch.arange(G, device=eo.device)[:, None, None]
    picked = eo[g, ids, torch.clamp(pos, max=C - 1)]            # [G,S,K,d]
    return (picked * vals[..., None].to(eo.dtype)).sum(dim=-2)


def moe_ffn(gate_p, expert_p, x: torch.Tensor, *, top_k: int,
            capacity_factor: float, min_capacity: int = 4,
            activation: Callable = _gelu, gated: bool = False,
            rng: Optional[torch.Tensor] = None,
            noise_policy: Optional[str] = None,
            dispatch_mode: str = "scatter", norm_topk: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full MoE FFN over x [B, S, d_model]: (y, metrics) with the aux
    load-balancing loss and the dropped fraction.  Tokens are gated per
    sequence (one group per sequence).  ``rng``: a threefry key
    (``utils.prng``) for the noise policies."""
    B, S, dm = x.shape
    E = expert_p["wi"].shape[0]
    cap = capacity_for(S, E, top_k, capacity_factor, min_capacity)
    if noise_policy == "Jitter" and rng is not None:
        # jitter gets its own stream (the gating noise draws from the rest)
        jitter_rng, rng = prng.split(rng)
        xg = x * prng.uniform(jitter_rng.to(x.device), x.shape,
                              minval=0.98, maxval=1.02)
    else:
        xg = x
    dt = x.dtype
    logits = _gate_logits(xg, gate_p["kernel"], dt)
    if dispatch_mode == "ragged":
        return _ragged_moe(expert_p, x, logits, top_k=top_k,
                           activation=activation, gated=gated,
                           noise_policy=noise_policy, rng=rng, dt=dt,
                           norm_topk=norm_topk)
    if dispatch_mode not in ("scatter", "einsum"):
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    rngs = prng.split(rng, B) if rng is not None else None
    gate_fn = top_k_gating_sparse if dispatch_mode == "scatter" \
        else top_k_gating
    gate = gate_fn(logits, top_k, cap, rng=rngs, noise_policy=noise_policy,
                   norm_topk=norm_topk)

    if dispatch_mode == "scatter":
        slots = _slot_dispatch(x, gate.ids, gate.pos, E, cap)   # [B,E,C,d]
        expert_in = slots.transpose(0, 1).reshape(E, B * cap, dm)
        expert_out = experts_apply(expert_p, expert_in, activation, gated)
        eo = expert_out.reshape(E, B, cap, dm).transpose(0, 1)
        y = _slot_combine(eo, gate.ids, gate.pos, gate.vals, cap)
    else:
        # [G,Tg,E,Cg] x [G,Tg,d] -> [E, G*Cg, d]
        expert_in = torch.einsum("gtec,gtd->egcd", gate.dispatch.to(dt), x)
        expert_in = expert_in.reshape(E, B * cap, dm)
        expert_out = experts_apply(expert_p, expert_in, activation, gated)
        expert_out = expert_out.reshape(E, B, cap, dm)
        y = torch.einsum("gtec,egcd->gtd", gate.combine.to(dt), expert_out)
    return y, {"moe_aux_loss": gate.aux_loss.mean(),
               "moe_dropped": gate.dropped.mean()}


def _serving_route(gate_p, x: torch.Tensor, valid: torch.Tensor, cap: int,
                   C: int, top_k: int, norm_topk: bool):
    """The serving gating: (ids, slots, weights) [R, K] of the rows x [R,
    d]; invalid rows and dropped choices get slot C (the spare)."""
    gates = torch.softmax(_gate_logits(x, gate_p["kernel"], x.dtype).float(),
                          dim=-1)
    sels, idxs = _select(gates, top_k)
    v = valid.to(torch.float32)[:, None]
    prev = torch.zeros_like(gates[:1])
    pos_list, val_list = [], []
    for sel in sels:
        sel = sel * v
        pos = torch.cumsum(sel, dim=0) - 1.0 + prev
        keep = sel * (pos < cap).float()
        kept = keep.sum(dim=-1)
        val_list.append((gates * keep).sum(dim=-1))
        pos_list.append(torch.where(kept > 0, (pos * sel).sum(dim=-1),
                                    float(C)).to(torch.int64))
        prev = prev + sel.sum(dim=0, keepdim=True)
    vals = torch.stack(val_list, dim=-1)
    if top_k > 1 and norm_topk:
        vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return (torch.stack(idxs, dim=-1), torch.stack(pos_list, dim=-1),
            vals.to(x.dtype))


def moe_serving(gate_p, expert_p, x: torch.Tensor, valid: torch.Tensor,
                tokens: int, *, top_k: int, capacity_factor: float,
                min_capacity: int = 4, activation: Callable = _gelu,
                gated: bool = False, norm_topk: bool = True) -> torch.Tensor:
    """The serving MoE FFN over the rows x [R, d] of one step, of which
    ``valid`` [R] (bool, on the device) are real.  ``tokens``: the row
    count of the JAX serving forward at this call site (its token budget
    in a step, its slot count in a burst), which sets the capacity.
    Invalid rows take no slot and no position; their output rows are
    zero.  The slot buffer holds ``min(capacity, R)`` slots: an expert
    receives at most one choice of a row, so no more than R."""
    R = x.shape[0]
    E = expert_p["wi"].shape[0]
    cap = capacity_for(tokens, E, top_k, capacity_factor, min_capacity)
    C = min(cap, R)
    ids, pos, vals = _serving_route(gate_p, x, valid, cap, C, top_k,
                                    norm_topk)
    slots = _slot_dispatch(x[None], ids[None], pos[None], E, C)[0]
    eo = experts_apply(expert_p, slots, activation, gated)       # [E, C, d]
    return _slot_combine(eo[None], ids[None], pos[None], vals[None], C)[0]
