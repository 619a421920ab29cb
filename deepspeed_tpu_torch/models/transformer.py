"""Decoder-only transformer: config, parameter tree, dense forward.

Counterpart of ``deepspeed_tpu/models/transformer.py``.  The parameter
tree has the JAX package's keys and layouts exactly — per-layer weights
stacked on a leading layer dimension under ``params["blocks"]``,
``wq [dm, H, D]``, ``wk``/``wv [dm, Hkv, D]``, ``wo [H, D, dm]``,
``mlp.wi``/``wg [dm, dff]``, ``mlp.wo [dff, dm]``, ``lm_head.kernel
[dm, vocab]`` — so weights carry over from the JAX package with a plain
tree map (:func:`params_from_numpy`).

The layer stack is a Python loop over views of the stacked weights
(the JAX package's ``lax.scan``).  :func:`forward` is the grad-enabled
forward the training loss runs; :func:`apply` is the same forward under
``torch.no_grad`` for serving.  The training half: ``lm_loss_fn`` with
``rolled_lm_targets`` and ``cross_entropy_loss``, ``_resolve_attention``
(``attention_impl``) and per-layer remat with the JAX package's six
policies (:data:`REMAT_POLICIES`).  ALiBi (``position="alibi"``) runs
through the eager attention with the per-head bias.  Not ported: MoE
(``num_experts > 1`` raises).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..platform.cuda import resolve_device
from . import layers as L


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None        # None => MHA
    d_ff: Optional[int] = None                # None => 4*d_model (or 8/3 gated)
    max_seq_len: int = 1024
    activation: str = "gelu"
    gated_mlp: bool = False                   # SwiGLU-style (llama)
    norm: str = "layernorm"                   # layernorm | rmsnorm
    position: str = "learned"                 # learned | rope | alibi
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                     # partial rotary (phi: 0.4)
    # bloom: layernorm applied to the word embeddings before the stack
    embed_norm: bool = False
    # parallel residual: x + attn(ln(x)) + mlp(ln(x)), one shared norm
    # (falcon, phi, gpt-j)
    parallel_block: bool = False
    # gpt-neox/pythia: parallel residual but TWO norms — the MLP reads
    # ln2(x) instead of the attention's ln1(x)
    parallel_separate_norms: bool = False
    tie_embeddings: bool = True
    attn_bias: bool = True
    # o-projection bias; None follows attn_bias (qwen2: q/k/v biases
    # but NO o bias)
    attn_out_bias: Optional[bool] = None
    mlp_bias: bool = True
    head_bias: bool = False                   # lm_head bias (phi)
    eps: float = 1e-5
    # training-side fields, kept so configs carry over field for field
    remat: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "xla_flash"
    scan_unroll: int = 1
    # gpt-neo: attention WITHOUT the 1/sqrt(d) scaling; None = default
    attn_scale: Optional[float] = None
    # --- MoE (not ported yet: num_experts > 1 raises) ---------------------
    num_experts: int = 1
    moe_top_k: int = 2
    moe_shared_ff: Optional[int] = None
    moe_norm_topk: bool = True
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noise_policy: Optional[str] = None
    aux_loss_coef: float = 0.01
    moe_dispatch: str = "scatter"

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.attn_out_bias is None:
            self.attn_out_bias = self.attn_bias
        if self.d_ff is None:
            if self.gated_mlp:
                # llama sizing: 2/3 * 4d, rounded up to a multiple of 256
                raw = int(8 * self.d_model / 3)
                self.d_ff = 256 * ((raw + 255) // 256)
            else:
                self.d_ff = 4 * self.d_model
        if self.d_model % self.num_heads or self.num_heads % self.num_kv_heads:
            raise ValueError("d_model % num_heads and num_heads % "
                             "num_kv_heads must be 0")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def rotary_dim(self) -> int:
        """Head dims receiving rotary embedding (even, <= head_dim)."""
        return (int(self.head_dim * self.rope_pct) // 2) * 2


def _require_supported(cfg: TransformerConfig) -> None:
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "num_experts > 1 (MoE) is not ported yet (ROADMAP Queue 1, "
            "multi-GPU training breadth: parallel/moe.py)")


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def unstack_layers(blocks, num_layers: int):
    """Per-layer weight trees: views into the stacked tensors (one
    ``unbind`` per leaf)."""
    if isinstance(blocks, dict):
        per_key = {k: unstack_layers(v, num_layers) for k, v in blocks.items()}
        return [{k: v[i] for k, v in per_key.items()}
                for i in range(num_layers)]
    return blocks.unbind(0)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init
    scales (``init_params`` there), drawn ON ``device`` from
    ``generator`` (which must live on that device) — a large model's
    random weights never pass through host memory.  The values differ
    from the JAX package's for the same seed."""
    _require_supported(cfg)
    dev = torch.device(device)
    H, D, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    dm, dff, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    out_scale = 1.0 / math.sqrt(dm) / math.sqrt(2.0 * nl)   # GPT-2 depth scaling

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return x.mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    def norm_init(*lead):
        p = {"scale": ones(*lead, dm)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(*lead, dm)
        return p

    params: Dict[str, Any] = {"embed": {"table": normal((cfg.vocab_size, dm),
                                                        0.02)}}
    if cfg.position == "learned":
        params["pos_embed"] = {"table": normal((cfg.max_seq_len, dm), 0.01)}
    if cfg.embed_norm:                      # bloom word_embeddings_layernorm
        params["ln_embed"] = norm_init()

    attn = {"wq": normal((nl, dm, H, D), 1.0 / math.sqrt(dm)),
            "wk": normal((nl, dm, Hkv, D), 1.0 / math.sqrt(dm)),
            "wv": normal((nl, dm, Hkv, D), 1.0 / math.sqrt(dm)),
            "wo": normal((nl, H, D, dm), out_scale)}
    if cfg.attn_bias:
        attn["bq"] = zeros(nl, H, D)
        attn["bk"] = zeros(nl, Hkv, D)
        attn["bv"] = zeros(nl, Hkv, D)
    if cfg.attn_out_bias:
        attn["bo"] = zeros(nl, dm)
    mlp = {"wi": normal((nl, dm, dff), 1.0 / math.sqrt(dm))}
    if cfg.gated_mlp:
        mlp["wg"] = normal((nl, dm, dff), 1.0 / math.sqrt(dm))
    mlp["wo"] = normal((nl, dff, dm), out_scale)
    if cfg.mlp_bias:
        mlp["bi"] = zeros(nl, dff)
        mlp["bo"] = zeros(nl, dm)
    blocks = {"attn": attn, "mlp": mlp, "ln1": norm_init(nl)}
    if not cfg.parallel_block or cfg.parallel_separate_norms:
        blocks["ln2"] = norm_init(nl)
    params["blocks"] = blocks
    params["ln_f"] = norm_init()
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal((dm, cfg.vocab_size),
                                              1.0 / math.sqrt(dm))}
        if cfg.head_bias:
            params["lm_head"]["bias"] = zeros(cfg.vocab_size)
    return params


# numpy dtypes torch.from_numpy rejects (ml_dtypes) -> (same-width integer
# view, torch dtype): carried bit for bit
_VIEW_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}

# dtype names of a JAX tree's static metadata -> torch dtypes
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _from_numpy(a) -> torch.Tensor:
    """A host tensor with ``a``'s exact bits (bf16 and fp8 arrays through
    a same-width integer view)."""
    a = np.ascontiguousarray(np.asarray(a))
    view = _VIEW_DTYPES.get(a.dtype.name)
    if view is None:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(view[0]).copy()).view(view[1])


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Carry a parameter tree of numpy arrays (e.g. ``np.asarray`` of each
    leaf of a JAX tree) into the port on ``device``, bit for bit (bf16
    arrays, numpy dtype ``bfloat16``, which ``torch.from_numpy`` rejects,
    go through a uint16 view).  ``dtype`` None keeps each leaf's own
    type."""
    dev = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a).to(device=dev, dtype=dtype),
                    tree)


def quant_tree_from_numpy(tree, device=None):
    """Carry a quantized tree (``quantize_model_params``'s second output)
    whose leaves are QuantizedTensor-like objects with numpy ``data``,
    ``scale``, ``zero`` and static ``bits``, ``shape``, ``dtype`` and
    ``layout`` (e.g. a JAX tree after ``jax.tree.map(np.asarray, ...)``)
    into the port's :class:`~..ops.quant.QuantizedTensor`s on ``device``;
    payloads and scales stay bitwise exact."""
    from ..ops.quant import QuantizedTensor
    dev = resolve_device(device)

    def conv(qt):
        if isinstance(qt, dict):
            return {k: conv(v) for k, v in qt.items()}
        name = np.dtype(qt.dtype).name
        if name not in _TORCH_DTYPES:
            raise ValueError(f"quantized leaf of dtype {name}: expected one "
                             f"of {sorted(_TORCH_DTYPES)}")
        return QuantizedTensor(
            _from_numpy(qt.data).to(dev), _from_numpy(qt.scale).to(dev),
            None if qt.zero is None else _from_numpy(qt.zero).to(dev),
            int(qt.bits), tuple(qt.shape), _TORCH_DTYPES[name],
            layout=qt.layout)

    return conv(tree)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _norm(cfg: TransformerConfig):
    fn = L.layernorm if cfg.norm == "layernorm" else L.rmsnorm
    return partial(fn, eps=cfg.eps)


def attn_scale(cfg: TransformerConfig) -> float:
    return (cfg.attn_scale if cfg.attn_scale is not None
            else 1.0 / (cfg.head_dim ** 0.5))


def block_apply(cfg: TransformerConfig, lp, x: torch.Tensor, cos, sin,
                mask=None, attention_fn: Optional[Callable] = None
                ) -> torch.Tensor:
    """One decoder layer.  lp: this layer's params; x: [B, S, dm].
    ``attention_fn`` None: ``causal_attention`` at ``attn_scale(cfg)``."""
    if attention_fn is None:
        attention_fn = partial(L.causal_attention, scale=attn_scale(cfg))
    norm = _norm(cfg)
    act = L.ACTIVATIONS[cfg.activation]
    ap = lp["attn"]
    dt = x.dtype
    h = norm(lp["ln1"], x)
    q = torch.einsum("bsd,dhk->bshk", h, ap["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, ap["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, ap["wv"].to(dt))
    if cfg.attn_bias:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    if cfg.position == "rope":
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    o = attention_fn(q, k, v, mask=mask)
    o = torch.einsum("bshk,hkd->bsd", o, ap["wo"].to(dt))
    if cfg.attn_out_bias:
        o = o + ap["bo"].to(dt)
    if not cfg.parallel_block:
        x = x + o
        h = norm(lp["ln2"], x)
    elif cfg.parallel_separate_norms:
        h = norm(lp["ln2"], x)   # gpt-neox: the MLP norms the original x
    mp = lp["mlp"]
    u = h @ mp["wi"].to(dt)
    if cfg.mlp_bias:
        u = u + mp["bi"].to(dt)
    u = act(h @ mp["wg"].to(dt)) * u if cfg.gated_mlp else act(u)
    d = u @ mp["wo"].to(dt)
    if cfg.mlp_bias:
        d = d + mp["bo"].to(dt)
    if cfg.parallel_block:
        return x + o + d
    return x + d


def forward(cfg: TransformerConfig, params, input_ids: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            attention_fn: Optional[Callable] = None,
            dtype=None) -> torch.Tensor:
    """Dense forward -> logits [B, S, vocab], differentiable (the JAX
    ``apply`` without PLD/LTD/MoE).  ``cfg.remat`` recomputes each layer
    in the backward (``torch.utils.checkpoint``) under
    ``cfg.remat_policy``."""
    _require_supported(cfg)
    remat = _remat(cfg)
    dt = dtype or params["embed"]["table"].dtype
    x = L.embed(params["embed"], input_ids).to(dt)
    if cfg.embed_norm:
        x = _norm(cfg)(params["ln_embed"], x)
    cos = sin = None
    if cfg.position == "learned":
        S = input_ids.shape[1]
        x = x + params["pos_embed"]["table"][:S].to(dt)
    elif cfg.position == "alibi":
        # the default eager attention gains the ALiBi bias (Model's
        # resolved attention carries it already)
        if attention_fn is None:
            attention_fn = L.make_alibi_attention(
                partial(L.causal_attention, scale=attn_scale(cfg)))
    else:
        cos, sin = L.rope_freqs(cfg.rotary_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
    for lp in unstack_layers(params["blocks"], cfg.num_layers):
        layer = partial(block_apply, cfg, lp, cos=cos, sin=sin, mask=mask,
                        attention_fn=attention_fn)
        x = remat(layer, x) if remat else layer(x)
    x = _norm(cfg)(params["ln_f"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(dt).T
    logits = x @ params["lm_head"]["kernel"].to(dt)
    if cfg.head_bias:
        logits = logits + params["lm_head"]["bias"].to(dt)
    return logits


@torch.no_grad()
def apply(cfg: TransformerConfig, params, input_ids: torch.Tensor,
          mask: Optional[torch.Tensor] = None,
          attention_fn: Optional[Callable] = None, dtype=None) -> torch.Tensor:
    """:func:`forward` without autograd (the serving path's dense forward);
    the positional order is the reference's (``mask, attention_fn,
    dtype``)."""
    return forward(cfg, params, input_ids, mask=mask,
                   attention_fn=attention_fn, dtype=dtype)


# --------------------------------------------------------------------------
# training: remat, attention choice, loss
# --------------------------------------------------------------------------

_aten = torch.ops.aten
_MM = (_aten.mm.default, _aten.addmm.default)
_BMM = (_aten.bmm.default, _aten.baddbmm.default)


def _dot(func, args) -> bool:
    """Any matrix product (``jax.checkpoint_policies.checkpoint_dots``)."""
    return func in _MM or func in _BMM


def _dot_no_batch(func, args) -> bool:
    """A matrix product without batch dimensions
    (``checkpoint_dots_with_no_batch_dims``): the projections against
    weights.  Classified by the operands, not by the op's name alone:
    ``einsum("bsd,dhk->bshk")`` lowers to a ``bmm`` of batch 1 (or, on
    some paths, a broadcast weight of batch stride 0), while attention's
    products are ``bmm`` over a real batch of B x heads."""
    if func in _MM:
        return True
    if func in _BMM:
        a, b = args[-2], args[-1]
        return a.shape[0] == 1 or a.stride(0) == 0 or b.stride(0) == 0
    return False


def _named(name: str):
    """The outputs of one of the port's named ops (the counterpart of
    ``jax.checkpoint_policies.save_only_these_names``)."""
    return lambda func, args: func.name() == name


def _either(*tests):
    return lambda func, args: any(t(func, args) for t in tests)


@torch.library.custom_op("deepspeed_tpu_torch::attn_out", mutates_args=(),
                         schema="(Tensor x) -> Tensor")
def attn_out(x):
    """Identity (a copy) that names the eager attention's output for the
    ``xla_flash`` policy, as ``checkpoint_name(o, "attn_out")`` does in the
    JAX package's XLA attention."""
    return x.clone()


attn_out.register_fake(lambda x: torch.empty_like(x))
attn_out.register_autograd(lambda ctx, g: g)


# per-layer recompute policies of the JAX package (transformer.py:119-135):
# None = one torch.utils.checkpoint per layer that saves nothing inside it
# ("nothing" is jax.checkpoint's default, "everything" nothing_saveable:
# both recompute the whole layer); otherwise the test of what a selective
# checkpoint saves (MUST_SAVE) instead of recomputing.
#   dots           every matrix product
#   dots_no_batch  the products against weights
#   flash          those, plus the flash forward's (o, lse)
#                  (deepspeed_tpu_torch::flash_fwd; the JAX policy saves
#                  flash_out, the output only)
#   xla_flash      those, plus the attention output of the eager attention
#                  (deepspeed_tpu_torch::attn_out).  The port's "xla_flash"
#                  attention is the plain causal_attention, with no custom
#                  VJP of its own: its backward recomputes the softmax that
#                  the JAX package's XLA attention keeps as attn_lse.
# No policy changes the numbers, only what is kept and what is recomputed.
REMAT_POLICIES = {
    "nothing": None,
    "everything": None,
    "dots": _dot,
    "dots_no_batch": _dot_no_batch,
    "flash": _either(_dot_no_batch,
                     _named("deepspeed_tpu_torch::flash_fwd")),
    "xla_flash": _either(_dot_no_batch,
                         _named("deepspeed_tpu_torch::attn_out")),
}


def _remat(cfg: TransformerConfig) -> Optional[Callable]:
    """None without remat; else ``run(layer, x)``, the layer under a
    checkpoint of ``cfg.remat_policy``."""
    if not cfg.remat:
        return None
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"known: {sorted(REMAT_POLICIES)}")
    saves = REMAT_POLICIES[cfg.remat_policy]
    if saves is None:
        return partial(checkpoint, use_reentrant=False)

    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if saves(func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return partial(checkpoint, use_reentrant=False, context_fn=partial(
        create_selective_checkpoint_contexts, policy))


def rolled_lm_targets(ids: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Next-token targets by rolling left with the final position masked.
    Returns (labels, target_mask fp32)."""
    labels = torch.roll(ids, -1, dims=1)
    S = ids.shape[1]
    keep = (torch.arange(S, device=ids.device) < S - 1).float()
    tgt_mask = keep[None, :].expand(ids.shape)
    if mask is not None:
        tgt_mask = tgt_mask * torch.roll(mask, -1, dims=1).float()
    return labels, tgt_mask


# rows of [*, V] logits turned to fp32 at once by the loss (bounds the fp32
# transient to ~1 GiB whatever B * S is)
_LOSS_CHUNK_ELEMS = 1 << 28


def _row_chunks(x: torch.Tensor):
    rows = max(1, _LOSS_CHUNK_ELEMS // x.shape[-1])
    return x.split(rows)


class _CrossEntropy(torch.autograd.Function):
    """sum(weights * (logsumexp(logits) - logits[label])) with the
    logsumexp in fp32.  Saves the logits in their own dtype and the fp32
    per-row LSE; the backward rebuilds softmax rows chunk by chunk, so no
    fp32 copy of the [B*S, V] logits outlives one chunk."""

    @staticmethod
    def forward(ctx, logits, labels, weights):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        lab = labels.reshape(-1, 1).long()
        lse = torch.cat([torch.logsumexp(c.float(), dim=-1)
                         for c in _row_chunks(flat)])
        tgt = flat.gather(1, lab).squeeze(1).float()
        w = weights.reshape(-1)
        ctx.save_for_backward(logits, lab, w, lse)
        return ((lse - tgt) * w).sum()

    @staticmethod
    def backward(ctx, g):
        logits, lab, w, lse = ctx.saved_tensors
        V = logits.shape[-1]
        grad = torch.empty_like(logits)
        gw = (w * g).unsqueeze(1)
        out_rows = grad.view(-1, V).split(max(1, _LOSS_CHUNK_ELEMS // V))
        start = 0
        for c, out in zip(_row_chunks(logits.reshape(-1, V)), out_rows):
            n = c.shape[0]
            p = torch.exp(c.float() - lse[start:start + n, None])
            p.mul_(gw[start:start + n])
            p.scatter_add_(1, lab[start:start + n], -gw[start:start + n])
            out.copy_(p)
            start += n
        return grad, None, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token LM loss, ``lse - target_logit`` with fp32 reductions;
    logits [B, S, V], labels [B, S].  The mean over tokens (over the
    masked-in tokens with ``mask``)."""
    if mask is not None:
        m = mask.float()
        denom = torch.clamp(m.sum(), min=1.0)
        return _CrossEntropy.apply(logits, labels, m) / denom
    n = labels.numel()
    w = torch.full(labels.shape, 1.0 / n, dtype=torch.float32,
                   device=logits.device)
    return _CrossEntropy.apply(logits, labels, w)


def lm_loss_fn(cfg: TransformerConfig,
               attention_fn: Optional[Callable] = None,
               pld: bool = False, ltd_keep: Optional[int] = None):
    """Causal-LM loss over a batch ``{input_ids, [attention_mask]}``:
    ``loss_fn(params, batch, rng) -> loss`` (``rng`` unused: the dense
    model draws no randomness)."""
    if pld or ltd_keep is not None:
        raise NotImplementedError(
            "progressive layer drop / random-LTD are not ported yet "
            "(ROADMAP Queue 1 item 7, data_pipeline)")

    def loss_fn(params, batch, rng=None):
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        logits = forward(cfg, params, ids, mask=mask,
                         attention_fn=attention_fn)
        labels, tgt_mask = rolled_lm_targets(ids, mask)
        return cross_entropy_loss(logits, labels, tgt_mask)

    return loss_fn


def _resolve_attention(cfg: TransformerConfig) -> Callable:
    """attention_impl -> callable: ``"flash"`` is the K1 kernels' wrapper;
    ``"xla"`` and ``"xla_flash"`` (an XLA memory schedule of the same
    function, ops/xla_attention.py in the JAX package) are the plain
    ``causal_attention``.  ALiBi wraps the eager attention with the
    per-head bias (the flash kernels have no bias operand)."""
    if cfg.attn_scale is not None and cfg.attention_impl in (
            "flash", "xla_flash"):
        raise ValueError(
            "attn_scale needs the eager attention (attention_impl="
            "'xla'): the flash kernels bake in 1/sqrt(d)")
    if cfg.position == "alibi":
        if cfg.attention_impl in ("flash", "xla_flash"):
            raise ValueError(
                "position='alibi' needs the eager attention "
                "(attention_impl='xla'): the flash kernels carry no "
                "additive-bias operand")
        return L.make_alibi_attention(
            partial(L.causal_attention, scale=attn_scale(cfg)))
    if cfg.attention_impl == "flash":
        from ..ops.flash_attention import flash_attention
        return flash_attention
    if cfg.attention_impl not in ("xla", "xla_flash"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    fn = partial(L.causal_attention, scale=attn_scale(cfg))
    if (cfg.attention_impl, cfg.remat, cfg.remat_policy) == (
            "xla_flash", True, "xla_flash"):
        return _named_output(fn)
    return fn


def _named_output(fn: Callable) -> Callable:
    """``fn`` with its output passed through :func:`attn_out`."""
    def attn(*args, **kw):
        return attn_out(fn(*args, **kw))
    return attn


class Model:
    """Config + parameters on one device (``device`` None = the card) +
    the LM loss, for ``deepspeed_tpu_torch.initialize(model=...)``."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Optional[Callable] = None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.config = cfg
        self.device = dev
        self.params = init_params(cfg, gen, dev, dtype)
        self._set_loss(attention_fn)

    def _set_loss(self, attention_fn: Optional[Callable]) -> None:
        if attention_fn is None:
            attention_fn = _resolve_attention(self.config)
        self.attention_fn = attention_fn
        self.loss_fn = lm_loss_fn(self.config, attention_fn)

    def apply(self, params, input_ids, **kw):
        kw.setdefault("attention_fn", self.attention_fn)
        return apply(self.config, params, input_ids, **kw)

    @classmethod
    def from_params(cls, cfg: TransformerConfig, params,
                    attention_fn: Optional[Callable] = None) -> "Model":
        """Wrap EXISTING parameters (no initializer run); the device is
        the one the parameters live on."""
        _require_supported(cfg)
        m = cls.__new__(cls)
        m.config = cfg
        m.params = params
        m.device = tree_leaves(params)[0].device
        m._set_loss(attention_fn)
        return m
