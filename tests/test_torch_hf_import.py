"""The port's HF importer (``deepspeed_tpu_torch.checkpoint.hf``) held
against the JAX package's: for all 16 decoder families of ``CONVERTERS``
the port's tree is bitwise the JAX ``load_hf_state_dict`` tree on the
same tiny random ``transformers`` state dict (megatron: a synthetic state
dict in its naming), keeps the source dtype and device, and consumes the
dict; the port's forward on the converted weights matches the
``transformers`` forward for gpt2, llama (GQA), mixtral and qwen2-moe;
the encoder importers raise, naming ROADMAP Queue 1 item 7.

Tolerances: trees bitwise.  Logits against ``transformers`` atol 2e-3 /
rtol 1e-3 (fp32, another attention and norm arithmetic), 8e-3 for the
MoE models (the routed experts are summed in another order), as the JAX
package's own tests (tests/test_hf_import.py)."""

import jax
import numpy as np
import pytest
import torch
import transformers as tf

from deepspeed_tpu.checkpoint import hf as jhf
from deepspeed_tpu_torch.checkpoint import hf as thf
from deepspeed_tpu_torch.models import Model, build_config
from deepspeed_tpu_torch.models.presets import build_model

IDS = np.random.RandomState(0).randint(1, 250, (2, 16))

FAMILIES = {
    "gpt2": (lambda: tf.GPT2LMHeadModel(tf.GPT2Config(
        vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        activation_function="gelu_new", attn_pdrop=0.0, embd_pdrop=0.0,
        resid_pdrop=0.0)),
        ("gpt2", dict(vocab_size=256, num_layers=2, d_model=64,
                      num_heads=4, max_seq_len=64))),
    "llama": (lambda: tf.LlamaForCausalLM(tf.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5)),
        ("llama-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                            num_heads=4, num_kv_heads=2, d_ff=128,
                            max_seq_len=64))),
    "mistral": (lambda: tf.MistralForCausalLM(tf.MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64)),
        ("mistral-7b", dict(vocab_size=256, num_layers=2, d_model=64,
                            num_heads=4, num_kv_heads=2, d_ff=128,
                            max_seq_len=64))),
    "qwen2": (lambda: tf.Qwen2ForCausalLM(tf.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)),
        ("qwen2-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                            num_heads=4, num_kv_heads=2, d_ff=128,
                            max_seq_len=64))),
    "mixtral": (lambda: tf.MixtralForCausalLM(tf.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rope_theta=10000.0,
        router_jitter_noise=0.0)),
        ("mixtral-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                              num_heads=4, num_kv_heads=2, d_ff=128,
                              num_experts=4, moe_top_k=2, max_seq_len=64,
                              capacity_factor=4.0,
                              eval_capacity_factor=4.0))),
    "falcon": (lambda: tf.FalconForCausalLM(tf.FalconConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_kv_heads=1,
        new_decoder_architecture=False, multi_query=True,
        parallel_attn=True, bias=False, max_position_embeddings=64,
        alibi=False)),
        ("falcon-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                             num_heads=4, num_kv_heads=1, max_seq_len=64))),
    "phi": (lambda: tf.PhiForCausalLM(tf.PhiConfig(
        vocab_size=256, hidden_size=64, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        partial_rotary_factor=0.5, max_position_embeddings=64)),
        ("phi-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                          num_heads=4, d_ff=256, rope_pct=0.5,
                          max_seq_len=64))),
    "opt": (lambda: tf.OPTForCausalLM(tf.OPTConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        ffn_dim=128, num_attention_heads=4, max_position_embeddings=64,
        word_embed_proj_dim=64)),
        ("opt-125m", dict(vocab_size=256, num_layers=2, d_model=64,
                          num_heads=4, d_ff=128, max_seq_len=64))),
    "gptj": (lambda: tf.GPTJForCausalLM(tf.GPTJConfig(
        vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        rotary_dim=8)),
        ("gptj-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                           num_heads=4, max_seq_len=64, rope_pct=0.5))),
    "gpt_neox": (lambda: tf.GPTNeoXForCausalLM(tf.GPTNeoXConfig(
        vocab_size=256, hidden_size=64, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, rotary_pct=0.25,
        use_parallel_residual=True)),
        ("gpt-neox-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                               num_heads=4, max_seq_len=64))),
    "bloom": (lambda: tf.BloomForCausalLM(tf.BloomConfig(
        vocab_size=256, hidden_size=64, n_layer=2, n_head=4)),
        ("bloom-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                            num_heads=4, max_seq_len=64))),
    "phi3": (lambda: tf.Phi3ForCausalLM(tf.Phi3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, pad_token_id=0)),
        ("phi3-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                           num_heads=4, d_ff=128, max_seq_len=64))),
    "internlm": (lambda: tf.LlamaForCausalLM(tf.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, attention_bias=True)),
        ("internlm-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                               num_heads=4, d_ff=128, max_seq_len=64))),
    "gpt_neo": (lambda: tf.GPTNeoForCausalLM(tf.GPTNeoConfig(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        max_position_embeddings=64, intermediate_size=256,
        attention_types=[[["global", "local"], 1]], window_size=256)),
        ("gpt-neo-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                              num_heads=4, max_seq_len=64))),
    "qwen2_moe": (lambda: tf.Qwen2MoeForCausalLM(tf.Qwen2MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=96, shared_expert_intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
        decoder_sparse_step=1, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-6)),
        ("qwen2-moe-tiny", dict(vocab_size=256, num_layers=2, d_model=64,
                                num_heads=4, num_kv_heads=2, d_ff=96,
                                moe_shared_ff=160, max_seq_len=64,
                                num_experts=4, moe_top_k=2,
                                capacity_factor=4.0,
                                eval_capacity_factor=4.0,
                                rope_theta=10000.0))),
}


def _megatron_state_dict():
    """A megatron-lm GPT state dict (per-head interleaved fused QKV) of
    random numpy arrays."""
    r = np.random.RandomState(5)
    H, D, dm, ff, V, S = 4, 16, 64, 256, 256, 64
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    sd = {"language_model.embedding.word_embeddings.weight": f(V, dm),
          "language_model.embedding.position_embeddings.weight": f(S, dm),
          "language_model.transformer.final_layernorm.weight": f(dm),
          "language_model.transformer.final_layernorm.bias": f(dm)}
    for i in range(2):
        Lp = f"language_model.transformer.layers.{i}."
        sd[Lp + "attention.query_key_value.weight"] = f(3 * H * D, dm)
        sd[Lp + "attention.query_key_value.bias"] = f(3 * H * D)
        sd[Lp + "attention.dense.weight"] = f(dm, H * D)
        sd[Lp + "attention.dense.bias"] = f(dm)
        sd[Lp + "mlp.dense_h_to_4h.weight"] = f(ff, dm)
        sd[Lp + "mlp.dense_h_to_4h.bias"] = f(ff)
        sd[Lp + "mlp.dense_4h_to_h.weight"] = f(dm, ff)
        sd[Lp + "mlp.dense_4h_to_h.bias"] = f(dm)
        for nm in ("input_layernorm", "post_attention_layernorm"):
            sd[Lp + nm + ".weight"] = f(dm)
            sd[Lp + nm + ".bias"] = f(dm)
    return sd


def _case(family):
    """(state dict, port config, port model of the config)."""
    if family == "megatron":
        preset, over = "megatron-gpt2-345m", dict(
            vocab_size=256, num_layers=2, d_model=64, num_heads=4,
            max_seq_len=64)
        sd, hf = _megatron_state_dict(), None
    else:
        make, (preset, over) = FAMILIES[family]
        torch.manual_seed(0)
        hf = make().eval()
        sd = hf.state_dict()
    model = build_model(preset, device="cpu", **over)
    return sd, model, hf


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}[{k!r}]").items()}
    return {prefix: tree}


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["megatron"])
def test_tree_is_bitwise_the_jax_converters(family):
    sd, model, _ = _case(family)
    cfg = model.config
    jcfg = jhf.TransformerConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    ref = jhf.load_hf_state_dict(jcfg, dict(sd), family=family)
    mine = dict(sd)
    n = len(mine)
    got = thf.load_hf_state_dict(cfg, mine, family=family,
                                 reference_params=model.params)
    assert len(mine) < n                     # the dict was consumed
    rf = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
          jax.tree_util.tree_flatten_with_path(ref)[0]}
    gf = _flat(got)
    assert sorted(gf) == sorted(rf)
    for k, v in gf.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), rf[k], err_msg=k)


def test_dtype_and_device_are_the_sources():
    """A bf16 state dict converts to a bf16 tree (bitwise the fp32
    conversion rounded), without an fp32 detour; ``dtype=`` casts."""
    sd, model, _ = _case("qwen2_moe")
    bf = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    ref = _flat(thf.load_hf_state_dict(model.config, dict(sd),
                                       family="qwen2_moe"))
    got = _flat(thf.load_hf_state_dict(model.config, dict(bf),
                                       family="qwen2_moe"))
    for k, v in got.items():
        assert v.dtype == torch.bfloat16 and v.device.type == "cpu"
        assert torch.equal(v, ref[k].to(torch.bfloat16)), k
    cast = _flat(thf.load_hf_state_dict(model.config, dict(bf),
                                        family="qwen2_moe",
                                        dtype=torch.float32))
    assert all(v.dtype == torch.float32 for v in cast.values())
    bad = dict(model.params)
    bad["blocks"] = dict(bad["blocks"])
    bad["blocks"].pop("shared")
    with pytest.raises(ValueError, match="extra"):
        thf.load_hf_state_dict(model.config, dict(sd), family="qwen2_moe",
                               reference_params=bad)


@pytest.mark.parametrize("family,atol", [("gpt2", 2e-3), ("llama", 2e-3),
                                         ("mixtral", 8e-3),
                                         ("qwen2_moe", 8e-3)])
def test_logits_match_transformers(family, atol):
    sd, model, hf = _case(family)
    params = thf.load_hf_state_dict(model.config, dict(sd), family=family,
                                    reference_params=model.params)
    m = Model.from_params(model.config, params)
    with torch.no_grad():
        ref = hf(torch.tensor(IDS)).logits.float().numpy()
    got = m.apply(params, torch.from_numpy(IDS)).numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-3)


def test_family_of_and_encoders():
    for name in ("mixtral-8x7b", "tiiuae/falcon-7b", "microsoft/phi-2",
                 "meta-llama/Llama-3-8B", "Qwen/Qwen1.5-MoE-A2.7B",
                 "qwen2_moe", "EleutherAI/gpt-j-6b", "gpt2"):
        try:
            want = jhf.family_of(name)
        except ValueError:
            with pytest.raises(ValueError):
                thf.family_of(name)
            continue
        assert thf.family_of(name) == want
    assert sorted(thf.CONVERTERS) == sorted(jhf.CONVERTERS)
    cfg = build_config("gpt2")
    for fn in (thf.load_hf_bert, thf.load_hf_distilbert, thf.load_hf_clip):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            fn(cfg, {})
