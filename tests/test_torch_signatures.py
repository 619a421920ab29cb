"""The port's public signatures hold the reference's positional order.

A caller written against the JAX package passes arguments by position:
``eng.step(rng)``, ``InferenceEngine(model, config, topology)``,
``apply(cfg, params, ids, mask, attention_fn, dtype)``.  The port's
positional parameters must be the reference's, by name and in order (the
port may stop early: the reference's later parameters are features the
port does not take), and each keyword-only parameter of the port must be
one of the reference's.  Then ``eng.step(rng)`` on a tiny CPU engine
returns ``{uid: token}``, the token the JAX engine's ``step(rng)`` gives
on the same weights and prompt.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import model as jax_inference_model
from deepspeed_tpu.inference.engine import \
    InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import transformer as jax_transformer
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference import model as port_inference_model
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.models import transformer as port_transformer
from deepspeed_tpu_torch.utils import prng
from deepspeed_tpu.checkpoint import engine as jax_ckpt
from deepspeed_tpu.checkpoint import hf as jax_hf
from deepspeed_tpu.parallel import moe as jax_moe
from deepspeed_tpu.runtime.engine import Engine as JaxTrainEngine
from deepspeed_tpu_torch.checkpoint import engine as port_ckpt
from deepspeed_tpu_torch.checkpoint import hf as port_hf
from deepspeed_tpu_torch.parallel import moe as port_moe
from deepspeed_tpu_torch.runtime.engine import Engine as PortTrainEngine
from deepspeed_tpu.ops import aio as jax_aio
from deepspeed_tpu.runtime import param_stream as jax_param_stream
from deepspeed_tpu.runtime import swap_tensor as jax_swap
from deepspeed_tpu.runtime import zero_infinity as jax_zi
from deepspeed_tpu_torch.ops import aio as port_aio
from deepspeed_tpu_torch.runtime import param_stream as port_param_stream
from deepspeed_tpu_torch.runtime import swap_tensor as port_swap
from deepspeed_tpu_torch.runtime import zero_infinity as port_zi
from deepspeed_tpu.inference import failures as jax_failures
from deepspeed_tpu.ops import quant as jax_quant
from deepspeed_tpu_torch.inference import failures as port_failures
from deepspeed_tpu_torch.ops import quant as port_quant
from deepspeed_tpu import compression as jax_compression
from deepspeed_tpu import linear as jax_linear
from deepspeed_tpu import profiling as jax_profiling
from deepspeed_tpu.runtime import data_analyzer as jax_analyzer
from deepspeed_tpu.runtime import data_pipeline as jax_pipeline
from deepspeed_tpu.runtime import eigenvalue as jax_eigen
from deepspeed_tpu.runtime import hybrid_engine as jax_hybrid
from deepspeed_tpu.runtime import indexed_dataset as jax_indexed
from deepspeed_tpu.runtime import quantize as jax_moq
from deepspeed_tpu.compression import compress as jax_compress
from deepspeed_tpu_torch import compression as port_compression
from deepspeed_tpu_torch import linear as port_linear
from deepspeed_tpu_torch import profiling as port_profiling
from deepspeed_tpu_torch.compression import compress as port_compress
from deepspeed_tpu_torch.runtime import data_analyzer as port_analyzer
from deepspeed_tpu_torch.runtime import data_pipeline as port_pipeline
from deepspeed_tpu_torch.runtime import eigenvalue as port_eigen
from deepspeed_tpu_torch.runtime import hybrid_engine as port_hybrid
from deepspeed_tpu_torch.runtime import indexed_dataset as port_indexed
from deepspeed_tpu_torch.runtime import quantize as port_moq
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)

PAIRS = {
    "InferenceEngine.__init__": (InferenceEngine.__init__,
                                 JaxInferenceEngine.__init__),
    "InferenceEngine.step": (InferenceEngine.step, JaxInferenceEngine.step),
    **{f"InferenceEngine.{m}": (getattr(InferenceEngine, m),
                                getattr(JaxInferenceEngine, m))
       for m in ("put", "health", "health_state", "snapshot",
                 "snapshot_requests", "migrate_out", "handoff_out",
                 "export_tier_chain", "load_snapshot", "restore", "drain")},
    "models.transformer.apply": (port_transformer.apply,
                                 jax_transformer.apply),
    "models.transformer.Model.__init__": (port_transformer.Model.__init__,
                                          jax_transformer.Model.__init__),
    "models.transformer.Model.from_params": (
        port_transformer.Model.from_params,
        jax_transformer.Model.from_params),
    "inference.model.ragged_forward": (port_inference_model.ragged_forward,
                                       jax_inference_model.ragged_forward),
    "models.transformer.block_apply": (port_transformer.block_apply,
                                       jax_transformer.block_apply),
    "models.transformer._shared_expert": (port_transformer._shared_expert,
                                          jax_transformer._shared_expert),
    "models.transformer.lm_loss_fn": (port_transformer.lm_loss_fn,
                                      jax_transformer.lm_loss_fn),
    **{f"checkpoint.engine.{f}": (getattr(port_ckpt, f),
                                  getattr(jax_ckpt, f))
       for f in ("save_tree", "load_tree", "load_tree_host",
                 "save_checkpoint", "save_checkpoint_async",
                 "load_checkpoint", "consolidate")},
    "checkpoint.engine.AsyncCheckpointSaver.submit": (
        port_ckpt.AsyncCheckpointSaver.submit,
        jax_ckpt.AsyncCheckpointSaver.submit),
    **{f"checkpoint.hf.{f}": (getattr(port_hf, f), getattr(jax_hf, f))
       for f in ("load_hf_state_dict", "family_of", "load_hf_bert",
                 "load_hf_distilbert", "load_hf_clip")},
    **{f"parallel.moe.{f}": (getattr(port_moe, f), getattr(jax_moe, f))
       for f in ("top_k_gating", "top_k_gating_sparse", "capacity_for",
                 "experts_init", "experts_apply", "gate_init",
                 "_ragged_moe", "moe_ffn")},
    **{f"runtime.Engine.{m}": (getattr(PortTrainEngine, m),
                               getattr(JaxTrainEngine, m))
       for m in ("save_checkpoint", "load_checkpoint", "wait_checkpoint",
                 "train_batch")},
    # offload on one card: the I/O stack and the NVMe optimizer
    "ops.aio.AsyncIOHandle.__init__": (port_aio.AsyncIOHandle.__init__,
                                       jax_aio.AsyncIOHandle.__init__),
    **{f"runtime.swap_tensor.{c}.__init__": (
        getattr(port_swap, c).__init__, getattr(jax_swap, c).__init__)
       for c in ("TensorSwapper", "OptimizerSwapper")},
    "runtime.zero_infinity.HostAdam.update": (port_zi.HostAdam.update,
                                              jax_zi.HostAdam.update),
    **{f"runtime.zero_infinity.NVMeOptimizer.{m}": (
        getattr(port_zi.NVMeOptimizer, m), getattr(jax_zi.NVMeOptimizer, m))
       for m in ("__init__", "initialize", "step", "restore")},
    "runtime.param_stream.StreamedInfinityTrainer.__init__": (
        port_param_stream.StreamedInfinityTrainer.__init__,
        jax_param_stream.StreamedInfinityTrainer.__init__),
    "inference.failures.FailurePolicy.run": (
        port_failures.FailurePolicy.run, jax_failures.FailurePolicy.run),
    "ops.quant.quantize": (port_quant.quantize, jax_quant.quantize),
    # the RLHF and data-efficiency slice (item 7's training side)
    "InferenceEngine.refresh_params": (InferenceEngine.refresh_params,
                                       JaxInferenceEngine.refresh_params),
    "ops.quant.fp_quantize": (port_quant.fp_quantize, jax_quant.fp_quantize),
    **{f"runtime.hybrid_engine.HybridEngine.{m}": (
        getattr(port_hybrid.HybridEngine, m),
        getattr(jax_hybrid.HybridEngine, m)) for m in ("__init__",
                                                      "generate")},
    "runtime.hybrid_engine.fuse_lora_tree": (port_hybrid.fuse_lora_tree,
                                             jax_hybrid.fuse_lora_tree),
    **{f"runtime.eigenvalue.Eigenvalue.{m}": (
        getattr(port_eigen.Eigenvalue, m), getattr(jax_eigen.Eigenvalue, m))
       for m in ("__init__", "compute_eigenvalue")},
    **{f"runtime.quantize.Quantizer.{m}": (
        getattr(port_moq.Quantizer, m), getattr(jax_moq.Quantizer, m))
       for m in ("__init__", "quantize")},
    **{f"runtime.data_pipeline.{f}": (getattr(port_pipeline, f),
                                      getattr(jax_pipeline, f))
       for f in ("random_ltd_select", "random_ltd_scatter",
                 "truncate_to_difficulty")},
    **{f"runtime.data_pipeline.{c}.__init__": (
        getattr(port_pipeline, c).__init__, getattr(jax_pipeline, c).__init__)
       for c in ("CurriculumDataSampler", "RandomLTDScheduler")},
    "runtime.data_analyzer.DataAnalyzer.__init__": (
        port_analyzer.DataAnalyzer.__init__,
        jax_analyzer.DataAnalyzer.__init__),
    "runtime.indexed_dataset.MMapIndexedDataset.batch": (
        port_indexed.MMapIndexedDataset.batch,
        jax_indexed.MMapIndexedDataset.batch),
    **{f"linear.{f}": (getattr(port_linear, f), getattr(jax_linear, f))
       for f in ("init_optimized_linear", "apply_optimized_linear",
                 "merge_lora")},
    **{f"compression.{f}": (getattr(port_compression, f),
                            getattr(jax_compression, f))
       for f in ("weight_quantization", "head_pruning", "sparse_pruning")},
    **{f"compression.compress.{f}": (getattr(port_compress, f),
                                     getattr(jax_compress, f))
       for f in ("student_initialization", "kd_loss")},
    "profiling.FlopsProfiler.profile": (port_profiling.FlopsProfiler.profile,
                                        jax_profiling.FlopsProfiler.profile),
}

# the positional parameters each port signature must have at least
MUST_HAVE = {
    "InferenceEngine.__init__": ["self", "model", "config", "topology"],
    "InferenceEngine.step": ["self", "rng", "sampling"],
    # the serving seam a router and a gateway call (the whole signature)
    "InferenceEngine.put": ["self", "uid", "tokens", "priority",
                            "deadline_ms", "slo_class"],
    "InferenceEngine.health": ["self"],
    "InferenceEngine.health_state": ["self"],
    "InferenceEngine.snapshot": ["self"],
    "InferenceEngine.snapshot_requests": ["self", "uids"],
    "InferenceEngine.migrate_out": ["self", "uids"],
    "InferenceEngine.handoff_out": ["self", "uids"],
    "InferenceEngine.export_tier_chain": ["self", "digests"],
    "InferenceEngine.load_snapshot": ["self", "snap", "merge"],
    "InferenceEngine.restore": ["model", "snap", "config", "topology",
                                "quant_tree"],
    "InferenceEngine.drain": ["self", "deadline_ms", "sampling", "rng"],
    "models.transformer.apply": ["cfg", "params", "input_ids", "mask",
                                 "attention_fn", "dtype"],
    "models.transformer.Model.__init__": ["self", "cfg", "seed",
                                          "attention_fn"],
    "models.transformer.Model.from_params": ["cfg", "params", "param_axes",
                                             "attention_fn"],
    "inference.model.ragged_forward": ["cfg", "params", "kv", "batch",
                                       "block_size", "max_blocks_per_seq"],
    "models.transformer.block_apply": ["cfg", "lp", "x", "cos", "sin",
                                       "mask", "attention_fn", "rng"],
    "models.transformer._shared_expert": ["sp", "h", "act", "gated"],
    "models.transformer.lm_loss_fn": ["cfg", "attention_fn", "pld",
                                      "ltd_keep"],
    "checkpoint.engine.save_tree": ["tree", "ckpt_dir", "extra_meta"],
    "checkpoint.engine.load_tree": ["template", "shardings", "ckpt_dir",
                                    "strict"],
    "checkpoint.engine.load_tree_host": ["template", "ckpt_dir", "strict"],
    "checkpoint.engine.save_checkpoint": ["engine", "save_dir", "tag",
                                          "client_state"],
    "checkpoint.engine.save_checkpoint_async": ["engine", "saver",
                                                "save_dir", "tag",
                                                "client_state"],
    "checkpoint.engine.load_checkpoint": ["engine", "load_dir", "tag"],
    "checkpoint.engine.consolidate": ["ckpt_dir", "prefix"],
    "checkpoint.engine.AsyncCheckpointSaver.submit": [
        "self", "host_state", "ckpt_dir", "extra", "save_dir", "tag"],
    "checkpoint.hf.load_hf_state_dict": ["cfg", "state_dict", "family",
                                         "dtype", "reference_params"],
    "checkpoint.hf.family_of": ["name_or_type"],
    "checkpoint.hf.load_hf_bert": ["cfg", "state_dict", "dtype"],
    "checkpoint.hf.load_hf_distilbert": ["cfg", "state_dict", "dtype"],
    "checkpoint.hf.load_hf_clip": ["cfg", "state_dict", "dtype"],
    "parallel.moe.top_k_gating": ["logits", "top_k", "capacity", "rng",
                                  "noise_policy", "norm_topk"],
    "parallel.moe.top_k_gating_sparse": ["logits", "top_k", "capacity",
                                         "rng", "noise_policy",
                                         "norm_topk"],
    "parallel.moe.capacity_for": ["tokens", "num_experts", "top_k",
                                  "capacity_factor", "min_capacity"],
    "parallel.moe.experts_init": ["key", "num_experts", "d_model", "d_ff",
                                  "gated", "out_scale"],
    "parallel.moe.experts_apply": ["p", "x", "activation", "gated"],
    "parallel.moe.gate_init": ["key", "d_model", "num_experts"],
    "parallel.moe._ragged_moe": ["expert_p", "x", "logits"],
    "parallel.moe.moe_ffn": ["gate_p", "expert_p", "x"],
    "runtime.Engine.save_checkpoint": ["self", "save_dir", "tag",
                                       "client_state"],
    "runtime.Engine.load_checkpoint": ["self", "load_dir", "tag"],
    "runtime.Engine.wait_checkpoint": ["self"],
    "runtime.Engine.train_batch": ["self", "batch", "rng"],
    "ops.aio.AsyncIOHandle.__init__": [
        "self", "block_size", "queue_depth", "thread_count", "single_submit",
        "overlap_events", "use_odirect", "backend"],
    "runtime.swap_tensor.TensorSwapper.__init__": ["self", "swap_dir",
                                                   "aio"],
    "runtime.swap_tensor.OptimizerSwapper.__init__": [
        "self", "swap_dir", "num_groups", "aio", "aio_config"],
    "runtime.zero_infinity.HostAdam.update": ["self", "p", "m", "v", "g",
                                              "lr", "step"],
    "runtime.zero_infinity.NVMeOptimizer.__init__": [
        "self", "nvme_path", "opt_type", "opt_params", "buffer_size",
        "aio_config"],
    "runtime.zero_infinity.NVMeOptimizer.initialize": ["self", "params",
                                                       "shardings"],
    "runtime.zero_infinity.NVMeOptimizer.step": [
        "self", "grad_leaves", "lr", "step_num", "consume"],
    "runtime.zero_infinity.NVMeOptimizer.restore": ["self", "master", "m",
                                                    "v"],
    "runtime.param_stream.StreamedInfinityTrainer.__init__": [
        "self", "engine", "model", "params"],
    "inference.failures.FailurePolicy.run": ["self", "fn", "uids", "cold"],
    "ops.quant.quantize": ["x", "bits", "num_groups", "symmetric",
                           "stochastic", "rng"],
    "InferenceEngine.refresh_params": ["self", "params"],
    "ops.quant.fp_quantize": ["x", "fmt", "num_groups"],
    "runtime.hybrid_engine.HybridEngine.__init__": [
        "self", "model", "config", "inference_config", "lora_config"],
    "runtime.hybrid_engine.HybridEngine.generate": ["self", "prompts",
                                                    "sampling", "rng"],
    "runtime.hybrid_engine.fuse_lora_tree": ["params", "lora_config"],
    "runtime.eigenvalue.Eigenvalue.__init__": [
        "self", "verbose", "max_iter", "tol", "stability",
        "gas_boundary_resolution"],
    "runtime.eigenvalue.Eigenvalue.compute_eigenvalue": [
        "self", "loss_fn", "params", "rng"],
    "runtime.quantize.Quantizer.__init__": [
        "self", "q_start_bits", "q_target_bits", "q_period", "q_groups",
        "use_quantizer_kernel"],
    "runtime.quantize.Quantizer.quantize": ["self", "params", "step"],
    "runtime.data_pipeline.random_ltd_select": ["x", "keep", "rng"],
    "runtime.data_pipeline.random_ltd_scatter": ["full", "processed",
                                                 "idx"],
    "runtime.data_pipeline.truncate_to_difficulty": [
        "batch", "difficulty", "seq_keys", "pad_to"],
    "runtime.data_pipeline.CurriculumDataSampler.__init__": [
        "self", "metric_values", "scheduler", "batch_size", "seed"],
    "runtime.data_pipeline.RandomLTDScheduler.__init__": [
        "self", "total_layers", "start_tokens", "max_tokens",
        "schedule_steps", "step_size"],
    "runtime.data_analyzer.DataAnalyzer.__init__": [
        "self", "dataset", "metric_functions", "save_path", "num_workers",
        "worker_id", "batch_size"],
    "runtime.indexed_dataset.MMapIndexedDataset.batch": [
        "self", "indices", "seq_len", "pad_id"],
    "linear.init_optimized_linear": ["rng", "in_dim", "out_dim", "lora",
                                     "quant", "dtype", "base_weight"],
    "linear.apply_optimized_linear": ["params", "x", "lora"],
    "linear.merge_lora": ["params", "lora"],
    "compression.weight_quantization": ["w", "bits", "groups"],
    "compression.head_pruning": ["w", "num_heads", "ratio"],
    "compression.sparse_pruning": ["w", "ratio", "method"],
    "compression.compress.student_initialization": [
        "student_params", "teacher_params", "ds_config"],
    "compression.compress.kd_loss": ["student_logits", "teacher_logits",
                                     "temperature"],
    "profiling.FlopsProfiler.profile": ["self", "fn"],
}

# keyword-only parameters the reference has no counterpart of: where the
# port builds its weights (jax places them on its default device)
PORT_ONLY_KEYWORDS = {
    "models.transformer.Model.__init__": {"device", "dtype"},
    "parallel.moe.experts_init": {"device", "dtype"},
    "parallel.moe.gate_init": {"device", "dtype"},
    # read the groups into pinned memory (the streamed layers, on the card)
    "runtime.swap_tensor.OptimizerSwapper.__init__": {"pin"},
    "runtime.hybrid_engine.HybridEngine.__init__": {"device"},
    "linear.init_optimized_linear": {"device"},
}


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in _POSITIONAL]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_positional_order_is_the_reference_order(name):
    port, ref = PAIRS[name]
    got, want = _positional(port), _positional(ref)
    assert got == want[:len(got)], (name, got, want)
    assert got[:len(MUST_HAVE[name])] == MUST_HAVE[name]
    kw_only = [p.name for p in inspect.signature(port).parameters.values()
               if p.kind == inspect.Parameter.KEYWORD_ONLY]
    assert set(kw_only) <= (set(inspect.signature(ref).parameters)
                            | PORT_ONLY_KEYWORDS.get(name, set())), kw_only


def _models():
    jm = jax_inference.tiny_model()
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)


def test_step_takes_rng_first():
    """``eng.step(PRNGKey(0))`` (the reference's first positional) runs a
    step and returns ``{uid: token}``, equal to the JAX engine's
    ``step(jax.random.PRNGKey(0))`` on the same prompt; sampling by
    keyword after it works too."""
    jm, port = _models()
    prompt = [int(x) for x in np.random.RandomState(3).randint(1, 128, 9)]
    jeng = jax_inference.make_fp32_engine(jm, attn_impl="xla",
                                          pipeline_depth=1, **ENGINE)
    jeng.put(1, prompt)
    ref = jeng.step(jax.random.PRNGKey(0))
    eng = InferenceEngine(port, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32))
    eng.put(1, prompt)
    out = eng.step(prng.PRNGKey(0))
    assert isinstance(out, dict) and list(out) == [1]
    assert isinstance(out[1], int) and out == {1: int(ref[1])}
    eng.put(1, [out[1]])
    nxt = eng.step(prng.PRNGKey(0), sampling=SamplingParams())
    assert list(nxt) == [1] and 0 <= nxt[1] < port.config.vocab_size


def test_topology_is_the_third_positional():
    """One device takes ``topology=None`` (or a one-device
    ``MeshTopology``, which means no topology, as in the reference);
    anything but a ``MeshTopology`` is refused loudly, and
    ``quant_tree`` is keyword-only."""
    from deepspeed_tpu_torch.comm import MeshTopology
    _, port = _models()
    icfg = InferenceConfig(**ENGINE, kv_dtype=torch.float32,
                           param_dtype=torch.float32)
    InferenceEngine(port, icfg, None)
    assert InferenceEngine(port, icfg, MeshTopology.build()).topology \
        is None
    with pytest.raises(TypeError, match="topology"):
        InferenceEngine(port, icfg, object())
    with pytest.raises(TypeError):
        InferenceEngine(port, icfg, None, None)


def test_model_positionals_are_the_reference_ones():
    """``Model(cfg, seed, attention_fn)`` takes the attention by position
    (it raised in ``torch.device`` before), and
    ``Model.from_params(cfg, params, param_axes)`` takes the axes tree
    third and keeps it for a sharded engine (the loss still runs)."""
    from deepspeed_tpu_torch.models import build_config
    from deepspeed_tpu_torch.models.layers import causal_attention
    # attention_impl "xla": from_params resolves the same causal_attention
    # that Model is handed by position ("xla_flash" would resolve to
    # fused_attention, the same function in another summation order)
    cfg = build_config("llama-tiny", vocab_size=64, num_layers=1,
                       d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                       max_seq_len=16, attention_impl="xla")
    m = Model(cfg, 0, causal_attention, device="cpu")
    ids = torch.randint(0, 64, (2, 8))
    loss = m.loss_fn(m.params, {"input_ids": ids})
    m2 = Model.from_params(cfg, m.params, {"x": 1})
    assert torch.equal(m2.loss_fn(m2.params, {"input_ids": ids}), loss)
    assert m2.param_axes == {"x": 1}


@pytest.mark.parametrize("pkg", [jax_failures, port_failures],
                         ids=["jax", "port"])
def test_failure_policy_run_takes_cold_third(pkg):
    """``run(fn, uids, True)`` runs unguarded, inline on the caller's
    thread, in both packages (the port's third positional was
    ``guarded``, the opposite sense); ``run(fn, uids)`` runs under the
    deadline, on the watchdog's worker; ``cold=True`` by keyword works."""
    import threading
    policy = pkg.FailurePolicy(
        pkg.FailureConfig(dispatch_timeout_ms=10_000.0), {})
    here = threading.current_thread

    def where():
        return here()

    main = here()
    assert policy.run(where, (1,), True) is main
    assert policy.run(where, (1,), cold=True) is main
    assert policy.run(where, (1,)) is not main
    assert policy.run(where, (1,), False) is not main


def test_nvme_initialize_takes_shardings_none(tmp_path):
    """``initialize(params, None)`` (the reference's call) partitions the
    leaves as the reference does; a sharding tree raises naming ROADMAP
    Queue 1 item 6 (per-process fragments)."""
    import jax.numpy as jnp
    rs = np.random.RandomState(0)
    tree = {"a": rs.randn(64, 33).astype(np.float32),
            "b": {"c": rs.randn(100).astype(np.float32)}}
    ref = jax_zi.NVMeOptimizer(str(tmp_path / "j"), "adamw", {"lr": 1e-3},
                               buffer_size=4096)
    ref.initialize(jax.tree.map(jnp.asarray, tree), None)
    port = port_zi.NVMeOptimizer(str(tmp_path / "t"), "adamw", {"lr": 1e-3},
                                 buffer_size=4096)
    port.initialize(jax.tree.map(torch.from_numpy, tree), None)
    assert port.groups == ref.groups
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        port_zi.NVMeOptimizer(str(tmp_path / "s"), "adamw", {"lr": 1e-3}) \
            .initialize(jax.tree.map(torch.from_numpy, tree), {"a": 1})


def test_quantize_takes_rng_sixth():
    """``quantize(x, 8, None, True, False, None)`` (the reference's six
    positionals) gives the reference's codes and scales bitwise;
    stochastic rounding still raises, naming item 6."""
    x = np.random.RandomState(1).randn(16, 64).astype(np.float32)
    ref = jax_quant.quantize(jax.numpy.asarray(x), 8, None, True, False,
                             None)
    got = port_quant.quantize(torch.from_numpy(x), 8, None, True, False,
                              None)
    assert np.array_equal(got.data.numpy(), np.asarray(ref.data))
    assert np.array_equal(got.scale.numpy(), np.asarray(ref.scale))
    with pytest.raises(NotImplementedError, match="item 6"):
        port_quant.quantize(torch.from_numpy(x), 8, None, True, True, None)
