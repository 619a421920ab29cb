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
from deepspeed_tpu.inference.engine import \
    InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import transformer as jax_transformer
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.models import transformer as port_transformer
from deepspeed_tpu_torch.utils import prng

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)

PAIRS = {
    "InferenceEngine.__init__": (InferenceEngine.__init__,
                                 JaxInferenceEngine.__init__),
    "InferenceEngine.step": (InferenceEngine.step, JaxInferenceEngine.step),
    "models.transformer.apply": (port_transformer.apply,
                                 jax_transformer.apply),
}

# the positional parameters each port signature must have at least
MUST_HAVE = {
    "InferenceEngine.__init__": ["self", "model", "config", "topology"],
    "InferenceEngine.step": ["self", "rng", "sampling"],
    "models.transformer.apply": ["cfg", "params", "input_ids", "mask",
                                 "attention_fn", "dtype"],
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
    assert set(kw_only) <= set(inspect.signature(ref).parameters), kw_only


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
    """One device takes ``topology=None``; anything else is refused
    loudly, and ``quant_tree`` is keyword-only."""
    _, port = _models()
    icfg = InferenceConfig(**ENGINE, kv_dtype=torch.float32,
                           param_dtype=torch.float32)
    InferenceEngine(port, icfg, None)
    with pytest.raises(NotImplementedError, match="topology"):
        InferenceEngine(port, icfg, object())
    with pytest.raises(TypeError):
        InferenceEngine(port, icfg, None, None)
