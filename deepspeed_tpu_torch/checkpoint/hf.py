"""HuggingFace checkpoint import: state dict -> the port's parameter tree.

Counterpart of ``deepspeed_tpu/checkpoint/hf.py``: ``family_of``,
``load_hf_state_dict`` and the 16 decoder converters of ``CONVERTERS``,
which map a family's HF names onto the single transformer core's tree
(``models/transformer.py``): per-layer tensors stacked on a leading
``layers`` dim, attention projections reshaped heads-major to ``[dm, H,
D]`` / ``[H, D, dm]``, MoE experts stacked on ``[layers, E, ...]``.

The converters work on torch tensors (numpy arrays are taken as host
tensors): each result keeps its source tensor's device and dtype (the
JAX package goes through fp32 numpy on the host, which for a 14 B
parameter model is 57 GB of host memory), and the converted tree is
bitwise the JAX converter's for fp32 sources.  A converter CONSUMES the
state dict: each source entry is removed as its tensor is copied into
the stacked result, so the two never both exist whole.  Pass a copy of
the dict to keep it.

The encoder importers (``load_hf_bert``, ``load_hf_distilbert``,
``load_hf_clip``) need ``models/encoder.py`` and ``clip.py``, which are
not ported: they raise, naming ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.transformer import TransformerConfig
from ..utils.logging import logger

_ENCODERS = ("the HF encoder importers (models/encoder.py, clip.py) are not "
             "ported yet (ROADMAP Queue 1 item 7, model families)")


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach()
    return torch.from_numpy(np.asarray(t))


def _take(sd: Dict[str, Any], key: str) -> torch.Tensor:
    """The entry ``key``, removed from the state dict."""
    return _tensor(sd.pop(key))


def _stack(sd: Dict[str, Any], fmt: str, n: int, transform=None,
           inner: Optional[int] = None) -> torch.Tensor:
    """Entries ``fmt.format(i)`` (``fmt.format(i, e)`` for ``inner``
    experts) transformed and stacked into one preallocated tensor, each
    source removed from the dict as it is copied."""
    out = None
    idx = [(i,) for i in range(n)] if inner is None else \
        [(i, e) for i in range(n) for e in range(inner)]
    for ix in idx:
        x = _take(sd, fmt.format(*ix))
        if transform is not None:
            x = transform(x)
        if out is None:
            lead = (n,) if inner is None else (n, inner)
            out = torch.empty(lead + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
        out[ix].copy_(x)
        del x
    return out


def _stacked(fn: Callable, n: int) -> Dict[str, torch.Tensor]:
    """Per-layer dicts of ``fn(i)`` stacked key by key."""
    outs = [fn(i) for i in range(n)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _T(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2)


def _qkv_heads(w: torch.Tensor, H: int, D: int,
               transpose: bool) -> torch.Tensor:
    """HF linear weight -> [dm, H, D].  ``transpose``: HF stores [out,
    in] (torch Linear) vs GPT-2's Conv1D [in, out]."""
    if transpose:
        w = _T(w)                     # -> [in(dm), out]
    return w.reshape(w.shape[0], H, D)


def _o_heads(w: torch.Tensor, H: int, D: int,
             transpose: bool) -> torch.Tensor:
    """HF out-proj weight -> [H, D, dm]."""
    if transpose:
        w = _T(w)                     # -> [in(H*D), dm]
    return w.reshape(H, D, w.shape[1])


# --------------------------------------------------------------------------
# GPT-2 (Conv1D layout: weights already [in, out]; fused c_attn)
# --------------------------------------------------------------------------

def _convert_gpt2(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    H, D, dm, nl = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.num_layers
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""

    def attn(i):
        w = _take(sd, f"{pre}h.{i}.attn.c_attn.weight")       # [dm, 3dm]
        b = _take(sd, f"{pre}h.{i}.attn.c_attn.bias")
        wq, wk, wv = w.chunk(3, dim=1)
        bq, bk, bv = b.chunk(3)
        return dict(
            wq=wq.reshape(dm, H, D), wk=wk.reshape(dm, H, D),
            wv=wv.reshape(dm, H, D),
            bq=bq.reshape(H, D), bk=bk.reshape(H, D), bv=bv.reshape(H, D),
            wo=_take(sd, f"{pre}h.{i}.attn.c_proj.weight").reshape(H, D, dm),
            bo=_take(sd, f"{pre}h.{i}.attn.c_proj.bias"))

    def mlp(i):
        return dict(
            wi=_take(sd, f"{pre}h.{i}.mlp.c_fc.weight"),
            bi=_take(sd, f"{pre}h.{i}.mlp.c_fc.bias"),
            wo=_take(sd, f"{pre}h.{i}.mlp.c_proj.weight"),
            bo=_take(sd, f"{pre}h.{i}.mlp.c_proj.bias"))

    def ln(i, which):
        return dict(scale=_take(sd, f"{pre}h.{i}.{which}.weight"),
                    bias=_take(sd, f"{pre}h.{i}.{which}.bias"))

    return {
        "embed": {"table": _take(sd, f"{pre}wte.weight")},
        "pos_embed": {"table": _take(sd, f"{pre}wpe.weight")},
        "blocks": {
            "attn": _stacked(attn, nl),
            "mlp": _stacked(mlp, nl),
            "ln1": _stacked(lambda i: ln(i, "ln_1"), nl),
            "ln2": _stacked(lambda i: ln(i, "ln_2"), nl),
        },
        "ln_f": {"scale": _take(sd, f"{pre}ln_f.weight"),
                 "bias": _take(sd, f"{pre}ln_f.bias")},
    }


# --------------------------------------------------------------------------
# Llama / Mistral (torch Linear layout [out, in]; separate q/k/v; RMSNorm)
# --------------------------------------------------------------------------

def _convert_llama(cfg: TransformerConfig, sd: Dict[str, Any],
                   with_mlp: bool = True) -> Dict:
    H, D, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    nl = cfg.num_layers
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    L = pre + "layers.{}."
    has_qkv_bias = L.format(0) + "self_attn.q_proj.bias" in sd
    params = {
        "embed": {"table": _take(sd, f"{pre}embed_tokens.weight")},
        "blocks": {
            "attn": {
                "wq": _stack(sd, L + "self_attn.q_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wk": _stack(sd, L + "self_attn.k_proj.weight", nl,
                             lambda w: _qkv_heads(w, Hkv, D, True)),
                "wv": _stack(sd, L + "self_attn.v_proj.weight", nl,
                             lambda w: _qkv_heads(w, Hkv, D, True)),
                "wo": _stack(sd, L + "self_attn.o_proj.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
            },
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl)},
            "ln2": {"scale": _stack(
                sd, L + "post_attention_layernorm.weight", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}norm.weight")},
    }
    # qwen2: q/k/v projection biases (no o bias) — llama layout otherwise
    if has_qkv_bias:
        attn = params["blocks"]["attn"]
        attn["bq"] = _stack(sd, L + "self_attn.q_proj.bias", nl,
                            lambda b: b.reshape(H, D))
        attn["bk"] = _stack(sd, L + "self_attn.k_proj.bias", nl,
                            lambda b: b.reshape(Hkv, D))
        attn["bv"] = _stack(sd, L + "self_attn.v_proj.bias", nl,
                            lambda b: b.reshape(Hkv, D))
    if with_mlp:
        params["blocks"]["mlp"] = {
            "wg": _stack(sd, L + "mlp.gate_proj.weight", nl, _T),
            "wi": _stack(sd, L + "mlp.up_proj.weight", nl, _T),
            "wo": _stack(sd, L + "mlp.down_proj.weight", nl, _T),
        }
    head_key = "lm_head.weight"
    if head_key in sd and not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": _T(_take(sd, head_key))}
    return params


# --------------------------------------------------------------------------
# OPT (learned positions w/ offset, LayerNorm, fused decoder naming)
# --------------------------------------------------------------------------

def _convert_opt(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    H, D, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
    pre = next((p for p in ("model.decoder.", "decoder.", "")
                if f"{p}embed_tokens.weight" in sd), "")
    L = pre + "layers.{}."

    def lin(fmt, out_heads=False):
        if out_heads:
            return _stack(sd, fmt, nl, lambda w: _o_heads(w, H, D, True))
        return _stack(sd, fmt, nl, lambda w: _qkv_heads(w, H, D, True))

    # OPT's learned positional table has a +2 offset (HF quirk)
    pos = _take(sd, f"{pre}embed_positions.weight")[2:]
    return {
        "embed": {"table": _take(sd, f"{pre}embed_tokens.weight")},
        "pos_embed": {"table": pos},
        "blocks": {
            "attn": {
                "wq": lin(L + "self_attn.q_proj.weight"),
                "wk": lin(L + "self_attn.k_proj.weight"),
                "wv": lin(L + "self_attn.v_proj.weight"),
                "wo": lin(L + "self_attn.out_proj.weight", out_heads=True),
                "bq": _stack(sd, L + "self_attn.q_proj.bias", nl,
                             lambda b: b.reshape(H, D)),
                "bk": _stack(sd, L + "self_attn.k_proj.bias", nl,
                             lambda b: b.reshape(H, D)),
                "bv": _stack(sd, L + "self_attn.v_proj.bias", nl,
                             lambda b: b.reshape(H, D)),
                "bo": _stack(sd, L + "self_attn.out_proj.bias", nl),
            },
            "mlp": {
                "wi": _stack(sd, L + "fc1.weight", nl, _T),
                "bi": _stack(sd, L + "fc1.bias", nl),
                "wo": _stack(sd, L + "fc2.weight", nl, _T),
                "bo": _stack(sd, L + "fc2.bias", nl),
            },
            "ln1": {"scale": _stack(sd, L + "self_attn_layer_norm.weight", nl),
                    "bias": _stack(sd, L + "self_attn_layer_norm.bias", nl)},
            "ln2": {"scale": _stack(sd, L + "final_layer_norm.weight", nl),
                    "bias": _stack(sd, L + "final_layer_norm.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}final_layer_norm.weight"),
                 "bias": _take(sd, f"{pre}final_layer_norm.bias")},
    }


# --------------------------------------------------------------------------
# Falcon (fused MQA query_key_value, parallel residual, single block LN)
# --------------------------------------------------------------------------

def _convert_falcon(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    H, D, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    dm, nl = cfg.d_model, cfg.num_layers
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""
    L = pre + "h.{}."

    def qkv(i):
        # fused [(H + 2*Hkv) * D, dm]: q heads then k then v
        w = _T(_take(sd, L.format(i) + "self_attention.query_key_value."
                     "weight"))
        return dict(wq=w[:, :H * D].reshape(dm, H, D),
                    wk=w[:, H * D:(H + Hkv) * D].reshape(dm, Hkv, D),
                    wv=w[:, (H + Hkv) * D:].reshape(dm, Hkv, D))

    attn = _stacked(qkv, nl)
    attn["wo"] = _stack(sd, L + "self_attention.dense.weight", nl,
                        lambda w: _o_heads(w, H, D, True))
    return {
        "embed": {"table": _take(sd, f"{pre}word_embeddings.weight")},
        "blocks": {
            "attn": attn,
            "mlp": {
                "wi": _stack(sd, L + "mlp.dense_h_to_4h.weight", nl, _T),
                "wo": _stack(sd, L + "mlp.dense_4h_to_h.weight", nl, _T),
            },
            # parallel residual: one shared input layernorm
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl),
                    "bias": _stack(sd, L + "input_layernorm.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}ln_f.weight"),
                 "bias": _take(sd, f"{pre}ln_f.bias")},
    }


# --------------------------------------------------------------------------
# Phi (partial rotary, parallel residual, biased linears + biased lm_head)
# --------------------------------------------------------------------------

def _convert_phi(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    H, D, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    L = pre + "layers.{}."
    return {
        "embed": {"table": _take(sd, f"{pre}embed_tokens.weight")},
        "blocks": {
            "attn": {
                "wq": _stack(sd, L + "self_attn.q_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wk": _stack(sd, L + "self_attn.k_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wv": _stack(sd, L + "self_attn.v_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wo": _stack(sd, L + "self_attn.dense.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
                "bq": _stack(sd, L + "self_attn.q_proj.bias", nl,
                             lambda b: b.reshape(H, D)),
                "bk": _stack(sd, L + "self_attn.k_proj.bias", nl,
                             lambda b: b.reshape(H, D)),
                "bv": _stack(sd, L + "self_attn.v_proj.bias", nl,
                             lambda b: b.reshape(H, D)),
                "bo": _stack(sd, L + "self_attn.dense.bias", nl),
            },
            "mlp": {
                "wi": _stack(sd, L + "mlp.fc1.weight", nl, _T),
                "bi": _stack(sd, L + "mlp.fc1.bias", nl),
                "wo": _stack(sd, L + "mlp.fc2.weight", nl, _T),
                "bo": _stack(sd, L + "mlp.fc2.bias", nl),
            },
            # parallel residual: one shared input layernorm
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl),
                    "bias": _stack(sd, L + "input_layernorm.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}final_layernorm.weight"),
                 "bias": _take(sd, f"{pre}final_layernorm.bias")},
        "lm_head": {"kernel": _T(_take(sd, "lm_head.weight")),
                    "bias": _take(sd, "lm_head.bias")},
    }


# --------------------------------------------------------------------------
# Mixtral (llama attention + block-sparse MoE experts)
# --------------------------------------------------------------------------

def _convert_mixtral(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    nl, E = cfg.num_layers, cfg.num_experts
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    params = _convert_llama(cfg, sd, with_mlp=False)
    L = pre + "layers.{}."
    # HF: w1 [ffn, dm] (gate), w3 [ffn, dm] (up), w2 [dm, ffn] (down)
    params["blocks"]["gate"] = {"kernel": _stack(
        sd, L + "block_sparse_moe.gate.weight", nl, _T)}
    params["blocks"]["experts"] = {
        name: _stack(sd, L + "block_sparse_moe.experts.{}." + f"{hf}.weight",
                     nl, _T, inner=E)
        for name, hf in (("wg", "w1"), ("wi", "w3"), ("wo", "w2"))}
    return params


def _convert_gptj(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """GPT-J: partial rotary + parallel residual with ONE shared
    LayerNorm.  HF GPT-J rotates INTERLEAVED (even/odd) head-dim pairs;
    this core rotates half-split pairs — the converter permutes the
    rotary columns of wq/wk (interleaved -> half), which is
    score-invariant because q and k share the permutation."""
    H, D, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
    pre = next((p for p in ("transformer.", "")
                if f"{p}wte.weight" in sd))
    L = pre + "h.{}."
    R = cfg.rotary_dim
    perm = torch.from_numpy(np.concatenate([
        np.arange(0, R, 2), np.arange(1, R, 2), np.arange(R, D)]))

    def qk(w):
        h = _qkv_heads(w, H, D, True)                      # [dm, H, D]
        return h.index_select(2, perm.to(h.device))

    return {
        "embed": {"table": _take(sd, f"{pre}wte.weight")},
        "blocks": {
            "attn": {
                "wq": _stack(sd, L + "attn.q_proj.weight", nl, qk),
                "wk": _stack(sd, L + "attn.k_proj.weight", nl, qk),
                "wv": _stack(sd, L + "attn.v_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wo": _stack(sd, L + "attn.out_proj.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
            },
            "mlp": {
                "wi": _stack(sd, L + "mlp.fc_in.weight", nl, _T),
                "bi": _stack(sd, L + "mlp.fc_in.bias", nl),
                "wo": _stack(sd, L + "mlp.fc_out.weight", nl, _T),
                "bo": _stack(sd, L + "mlp.fc_out.bias", nl),
            },
            "ln1": {"scale": _stack(sd, L + "ln_1.weight", nl),
                    "bias": _stack(sd, L + "ln_1.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}ln_f.weight"),
                 "bias": _take(sd, f"{pre}ln_f.bias")},
        "lm_head": {"kernel": _T(_take(sd, "lm_head.weight")),
                    "bias": _take(sd, "lm_head.bias")},
    }


def _fused_qkv_per_head(sd, key_w, key_b, H, D, dm):
    """A fused query_key_value stored per head ([H, 3, D, dm], q/k/v
    contiguous per head) -> wq/wk/wv [dm, H, D] and bq/bk/bv [H, D]."""
    w = _take(sd, key_w).reshape(H, 3, D, dm)
    b = _take(sd, key_b).reshape(H, 3, D)
    out = {}
    for which, (wn, bn) in enumerate((("wq", "bq"), ("wk", "bk"),
                                      ("wv", "bv"))):
        out[wn] = w[:, which].permute(2, 0, 1)             # [dm, H, D]
        out[bn] = b[:, which]                              # [H, D]
    return out


def _convert_gpt_neox(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """GPT-NeoX / Pythia: parallel residual with SEPARATE input and
    post-attention norms, partial half-split rotary, head-interleaved
    fused query_key_value."""
    H, D, dm, nl = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.num_layers
    pre = next((p for p in ("gpt_neox.", "")
                if f"{p}embed_in.weight" in sd), "gpt_neox.")
    L = pre + "layers.{}."
    qkv = _stacked(lambda i: _fused_qkv_per_head(
        sd, L.format(i) + "attention.query_key_value.weight",
        L.format(i) + "attention.query_key_value.bias", H, D, dm), nl)
    return {
        "embed": {"table": _take(sd, f"{pre}embed_in.weight")},
        "blocks": {
            "attn": {
                **qkv,
                "wo": _stack(sd, L + "attention.dense.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
                "bo": _stack(sd, L + "attention.dense.bias", nl),
            },
            "mlp": {
                "wi": _stack(sd, L + "mlp.dense_h_to_4h.weight", nl, _T),
                "bi": _stack(sd, L + "mlp.dense_h_to_4h.bias", nl),
                "wo": _stack(sd, L + "mlp.dense_4h_to_h.weight", nl, _T),
                "bo": _stack(sd, L + "mlp.dense_4h_to_h.bias", nl),
            },
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl),
                    "bias": _stack(sd, L + "input_layernorm.bias", nl)},
            "ln2": {"scale": _stack(
                        sd, L + "post_attention_layernorm.weight", nl),
                    "bias": _stack(
                        sd, L + "post_attention_layernorm.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}final_layer_norm.weight"),
                 "bias": _take(sd, f"{pre}final_layer_norm.bias")},
        "lm_head": {"kernel": _T(_take(sd, "embed_out.weight"))},
    }


def _convert_bloom(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """BLOOM: ALiBi position, word-embedding layernorm, head-interleaved
    fused query_key_value, tied embeddings."""
    H, D, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
    pre = next((p for p in ("transformer.", "")
                if f"{p}word_embeddings.weight" in sd), "transformer.")
    L = pre + "h.{}."
    qkv = _stacked(lambda i: _fused_qkv_per_head(
        sd, L.format(i) + "self_attention.query_key_value.weight",
        L.format(i) + "self_attention.query_key_value.bias", H, D,
        cfg.d_model), nl)
    return {
        "embed": {"table": _take(sd, f"{pre}word_embeddings.weight")},
        "ln_embed": {
            "scale": _take(sd, f"{pre}word_embeddings_layernorm.weight"),
            "bias": _take(sd, f"{pre}word_embeddings_layernorm.bias")},
        "blocks": {
            "attn": {
                **qkv,
                "wo": _stack(sd, L + "self_attention.dense.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
                "bo": _stack(sd, L + "self_attention.dense.bias", nl),
            },
            "mlp": {
                "wi": _stack(sd, L + "mlp.dense_h_to_4h.weight", nl, _T),
                "bi": _stack(sd, L + "mlp.dense_h_to_4h.bias", nl),
                "wo": _stack(sd, L + "mlp.dense_4h_to_h.weight", nl, _T),
                "bo": _stack(sd, L + "mlp.dense_4h_to_h.bias", nl),
            },
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl),
                    "bias": _stack(sd, L + "input_layernorm.bias", nl)},
            "ln2": {"scale": _stack(
                        sd, L + "post_attention_layernorm.weight", nl),
                    "bias": _stack(
                        sd, L + "post_attention_layernorm.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}ln_f.weight"),
                 "bias": _take(sd, f"{pre}ln_f.bias")},
    }


def _convert_phi3(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """Phi-3: llama-ish RMSNorm + gated silu, but the checkpoint fuses
    qkv_proj [(H+2Hkv)·D, dm] and gate_up_proj [2·ffn, dm]."""
    H, D, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    nl = cfg.num_layers
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    L = pre + "layers.{}."

    def qkv(i):
        w = _take(sd, L.format(i) + "self_attn.qkv_proj.weight")
        q, k, v = torch.split(w, [H * D, Hkv * D, Hkv * D])
        return {"wq": _qkv_heads(q, H, D, True),
                "wk": _qkv_heads(k, Hkv, D, True),
                "wv": _qkv_heads(v, Hkv, D, True)}

    def gate_up(i):
        g, u = _take(sd, L.format(i) + "mlp.gate_up_proj.weight").chunk(2)
        return {"wg": _T(g), "wi": _T(u)}

    gu = _stacked(gate_up, nl)
    params = {
        "embed": {"table": _take(sd, f"{pre}embed_tokens.weight")},
        "blocks": {
            "attn": {
                **_stacked(qkv, nl),
                "wo": _stack(sd, L + "self_attn.o_proj.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
            },
            "mlp": {
                "wg": gu["wg"], "wi": gu["wi"],
                "wo": _stack(sd, L + "mlp.down_proj.weight", nl, _T),
            },
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl)},
            "ln2": {"scale": _stack(
                sd, L + "post_attention_layernorm.weight", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}norm.weight")},
    }
    if "lm_head.weight" in sd and not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": _T(_take(sd, "lm_head.weight"))}
    return params


def _convert_internlm(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """InternLM: llama tensor layout with q/k/v AND o-projection
    biases."""
    nl = cfg.num_layers
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    L = pre + "layers.{}."
    has_o_bias = L.format(0) + "self_attn.o_proj.bias" in sd
    params = _convert_llama(cfg, sd)
    if has_o_bias:
        params["blocks"]["attn"]["bo"] = _stack(
            sd, L + "self_attn.o_proj.bias", nl)
    return params


def _convert_gptneo(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """GPT-Neo: learned positions, separate UNBIASED q/k/v with a biased
    out projection, and NO attention scaling (cfg.attn_scale=1); the
    alternating local-attention layers serve as dense causal
    attention."""
    H, D, nl = cfg.num_heads, cfg.head_dim, cfg.num_layers
    pre = "transformer." if any(k.startswith("transformer.")
                                for k in sd) else ""
    L = pre + "h.{}."
    return {
        "embed": {"table": _take(sd, f"{pre}wte.weight")},
        "pos_embed": {"table": _take(sd, f"{pre}wpe.weight")},
        "blocks": {
            "attn": {
                "wq": _stack(sd, L + "attn.attention.q_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wk": _stack(sd, L + "attn.attention.k_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wv": _stack(sd, L + "attn.attention.v_proj.weight", nl,
                             lambda w: _qkv_heads(w, H, D, True)),
                "wo": _stack(sd, L + "attn.attention.out_proj.weight",
                             nl, lambda w: _o_heads(w, H, D, True)),
                "bo": _stack(sd, L + "attn.attention.out_proj.bias", nl),
            },
            "mlp": {
                "wi": _stack(sd, L + "mlp.c_fc.weight", nl, _T),
                "bi": _stack(sd, L + "mlp.c_fc.bias", nl),
                "wo": _stack(sd, L + "mlp.c_proj.weight", nl, _T),
                "bo": _stack(sd, L + "mlp.c_proj.bias", nl),
            },
            "ln1": {"scale": _stack(sd, L + "ln_1.weight", nl),
                    "bias": _stack(sd, L + "ln_1.bias", nl)},
            "ln2": {"scale": _stack(sd, L + "ln_2.weight", nl),
                    "bias": _stack(sd, L + "ln_2.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, f"{pre}ln_f.weight"),
                 "bias": _take(sd, f"{pre}ln_f.bias")},
    }


def _convert_qwen2_moe(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """Qwen2-MoE: qwen2 attention (qkv biases, no o bias) + sparse experts
    with RAW top-k softmax probs (norm_topk_prob=False) + a sigmoid-gated
    dense shared expert."""
    nl, E = cfg.num_layers, cfg.num_experts
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    params = _convert_llama(cfg, sd, with_mlp=False)
    L = pre + "layers.{}."
    params["blocks"]["gate"] = {"kernel": _stack(
        sd, L + "mlp.gate.weight", nl, _T)}
    params["blocks"]["experts"] = {
        name: _stack(sd, L + "mlp.experts.{}." + f"{hf}.weight", nl, _T,
                     inner=E)
        for name, hf in (("wg", "gate_proj"), ("wi", "up_proj"),
                         ("wo", "down_proj"))}
    params["blocks"]["shared"] = {
        "wg": _stack(sd, L + "mlp.shared_expert.gate_proj.weight", nl, _T),
        "wi": _stack(sd, L + "mlp.shared_expert.up_proj.weight", nl, _T),
        "wo": _stack(sd, L + "mlp.shared_expert.down_proj.weight", nl, _T),
        "gate": _stack(sd, L + "mlp.shared_expert_gate.weight", nl, _T),
    }
    return params


def _convert_megatron(cfg: TransformerConfig, sd: Dict[str, Any]) -> Dict:
    """Megatron-LM GPT checkpoints: megatron naming
    (``language_model.…``/``transformer.layers.N``) with the fused
    query_key_value stored PER-HEAD INTERLEAVED [H·3·D, dm]."""
    H, D, dm, nl = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.num_layers
    emb = next((p for p in
                ("language_model.embedding.", "embedding.", "")
                if f"{p}word_embeddings.weight" in sd), None)
    if emb is None:
        raise KeyError("not a megatron-lm GPT state dict "
                       "(no *word_embeddings.weight)")
    lpre = next((p for p in
                 ("language_model.transformer.", "transformer.",
                  "language_model.encoder.", "encoder.")
                 if f"{p}layers.0.input_layernorm.weight" in sd),
                "transformer.")
    L = lpre + "layers.{}."
    qkv = _stacked(lambda i: _fused_qkv_per_head(
        sd, L.format(i) + "attention.query_key_value.weight",
        L.format(i) + "attention.query_key_value.bias", H, D, dm), nl)
    fl = next((k for k in (lpre + "final_layernorm.weight",
                           "final_layernorm.weight") if k in sd))
    return {
        "embed": {"table": _take(sd, f"{emb}word_embeddings.weight")},
        "pos_embed": {"table": _take(
            sd, f"{emb}position_embeddings.weight")},
        "blocks": {
            "attn": {
                **qkv,
                "wo": _stack(sd, L + "attention.dense.weight", nl,
                             lambda w: _o_heads(w, H, D, True)),
                "bo": _stack(sd, L + "attention.dense.bias", nl),
            },
            "mlp": {
                "wi": _stack(sd, L + "mlp.dense_h_to_4h.weight", nl, _T),
                "bi": _stack(sd, L + "mlp.dense_h_to_4h.bias", nl),
                "wo": _stack(sd, L + "mlp.dense_4h_to_h.weight", nl, _T),
                "bo": _stack(sd, L + "mlp.dense_4h_to_h.bias", nl),
            },
            "ln1": {"scale": _stack(sd, L + "input_layernorm.weight", nl),
                    "bias": _stack(sd, L + "input_layernorm.bias", nl)},
            "ln2": {"scale": _stack(
                        sd, L + "post_attention_layernorm.weight", nl),
                    "bias": _stack(
                        sd, L + "post_attention_layernorm.bias", nl)},
        },
        "ln_f": {"scale": _take(sd, fl),
                 "bias": _take(sd, fl.replace(".weight", ".bias"))},
    }


CONVERTERS: Dict[str, Callable] = {
    "gpt2": _convert_gpt2,
    "llama": _convert_llama,
    "mistral": _convert_llama,     # same tensor layout
    "qwen2": _convert_llama,
    "mixtral": _convert_mixtral,
    "falcon": _convert_falcon,
    "phi": _convert_phi,
    "opt": _convert_opt,
    "gptj": _convert_gptj,
    "gpt_neox": _convert_gpt_neox,
    "bloom": _convert_bloom,
    "phi3": _convert_phi3,
    "internlm": _convert_internlm,
    "gpt_neo": _convert_gptneo,
    "qwen2_moe": _convert_qwen2_moe,
    "megatron": _convert_megatron,
}


def family_of(name_or_type: str) -> str:
    s = name_or_type.lower()
    if "gpt-j" in s or "gptj" in s:      # canonical repo ids hyphenate
        return "gptj"
    if "neox" in s or "pythia" in s:
        return "gpt_neox"
    if "gpt-neo" in s or "gpt_neo" in s:
        return "gpt_neo"
    if "qwen2_moe" in s or "qwen2-moe" in s:
        return "qwen2_moe"
    if "phi3" in s or "phi-3" in s:
        return "phi3"
    for fam in ("megatron", "internlm", "mixtral", "llama", "mistral",
                "qwen2", "gpt2", "falcon", "phi", "opt", "bloom"):
        if fam in s:
            return fam
    raise ValueError(f"no HF converter for {name_or_type!r}; "
                     f"known families: {sorted(CONVERTERS)}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}[{k!r}]").items()}
    return {prefix: tree}


def load_hf_state_dict(cfg: TransformerConfig, state_dict: Dict[str, Any],
                       family: str, dtype=None,
                       reference_params: Optional[Dict] = None) -> Dict:
    """Convert an HF ``state_dict`` (consumed: see the module docstring)
    to this framework's parameter tree, each leaf on its source's device
    in its source's dtype, or cast to ``dtype`` (a torch dtype).

    ``reference_params`` (e.g. ``model.params``) enables a structural
    check: every leaf converted must match the target's tree and shape."""
    from ..models.transformer import tree_map
    n = len(state_dict)
    fam = family_of(family)
    params = CONVERTERS[fam](cfg, state_dict)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    # a transposed or sliced leaf becomes a tensor of its own
    params = tree_map(lambda x: (x if dtype is None else x.to(dtype))
                      .contiguous(), params)
    if reference_params is not None:
        ref_flat, got_flat = _flat(reference_params), _flat(params)
        missing = set(ref_flat) - set(got_flat)
        extra = set(got_flat) - set(ref_flat)
        if missing or extra:
            raise ValueError(
                f"HF conversion tree mismatch: missing={sorted(missing)} "
                f"extra={sorted(extra)}")
        for path, leaf in got_flat.items():
            want = tuple(ref_flat[path].shape)
            if tuple(leaf.shape) != want:
                raise ValueError(
                    f"shape mismatch at {path}: got {tuple(leaf.shape)}, "
                    f"model expects {want}")
    logger.info("converted %d HF tensors (%s family)", n, fam)
    return params


def load_hf_bert(cfg, state_dict: Dict[str, Any], dtype=None) -> Dict:
    raise NotImplementedError(_ENCODERS)


def load_hf_distilbert(cfg, state_dict: Dict[str, Any],
                       dtype=None) -> Dict:
    raise NotImplementedError(_ENCODERS)


def load_hf_clip(cfg, state_dict: Dict[str, Any], dtype=None) -> Dict:
    raise NotImplementedError(_ENCODERS)
