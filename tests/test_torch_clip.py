"""The port's CLIP (``models/clip.py``) and ``checkpoint/hf.py:load_hf_clip``
held against a ``transformers`` ``CLIPModel`` built from its config
classes (tests/test_hf_import.py's config) and against the JAX package on
the same weights: the converted tree bitwise the JAX converter's (the
dict consumed, the patch kernel OIHW -> HWIO), ``encode_image``,
``encode_text`` (pooled at the highest token id) and ``similarity``.

Tolerances: against HF atol 2e-3 / rtol 1e-3 for the tower outputs and
5e-3 for the logits (fp32, another attention and norm arithmetic:
tests/test_hf_import.py's); against JAX a whole model 1e-4 max|JAX| (the
same ops in another summation order); trees bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as tf

from deepspeed_tpu.checkpoint import hf as jhf
from deepspeed_tpu.models import clip as jc
from deepspeed_tpu_torch.checkpoint import hf as thf
from deepspeed_tpu_torch.models import clip as tc
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)


def _cfg(mod):
    tower = dict(width=64, num_layers=2, num_heads=4, d_ff=128)
    return mod.CLIPConfig(
        embed_dim=48, image_size=32, patch_size=8, vocab_size=256,
        max_text_len=32, vision=mod.CLIPTowerConfig(**tower),
        text=mod.CLIPTowerConfig(**tower))


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{pre}/{k}").items()}
    return {pre: tree}


@pytest.fixture(scope="module")
def models():
    hf = tf.CLIPModel(tf.CLIPConfig(
        text_config=tf.CLIPTextConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=32, hidden_act="quick_gelu",
            attention_dropout=0.0,
            # encode_text pools at the highest token id (the original
            # CLIP's EOT convention); HF's eos pooling set to agree
            eos_token_id=255).to_dict(),
        vision_config=tf.CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=32, patch_size=8,
            hidden_act="quick_gelu", attention_dropout=0.0).to_dict(),
        projection_dim=48)).eval()
    sd = hf.state_dict()
    jp = jhf.load_hf_clip(_cfg(jc), {k: v.numpy() for k, v in sd.items()})
    mine = dict(sd)
    tp = thf.load_hf_clip(_cfg(tc), mine)
    # every entry but the text model's position_ids buffer, if the
    # transformers version keeps it in the state dict
    assert all(k.endswith("position_ids") for k in mine)
    jf, tfl = _flat(jp), _flat(tp)
    assert sorted(jf) == sorted(tfl)
    for k in jf:
        np.testing.assert_array_equal(tfl[k].numpy(), np.asarray(jf[k]),
                                      err_msg=k)
    assert tp["visual"]["patch_embed"]["kernel"].shape == (8, 8, 3, 64)
    return (hf, jc.CLIP.from_params(_cfg(jc), jax.tree.map(jnp.asarray, jp)),
            tc.CLIP.from_params(_cfg(tc), tp))


def _inputs():
    r = np.random.RandomState(0)
    imgs = r.randn(2, 32, 32, 3).astype(np.float32)
    ids = r.randint(1, 250, (3, 10)).astype(np.int64)
    ids[:, -1] = 255                       # EOT = highest id
    ids[1, 4] = 255                        # a row whose EOT is mid-sequence
    return imgs, ids


def test_towers_match_hf_and_jax(models):
    hf, jm, tm = models
    imgs, ids = _inputs()
    with torch.no_grad():
        img_ref = hf.get_image_features(torch.from_numpy(
            np.transpose(imgs, (0, 3, 1, 2))))
        txt_ref = hf.get_text_features(torch.from_numpy(ids))
    if not isinstance(img_ref, torch.Tensor):       # newer transformers
        img_ref, txt_ref = img_ref.pooler_output, txt_ref.pooler_output
    ti = tm.encode_image(torch.from_numpy(imgs))
    tt = tm.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(ti.numpy(), img_ref.numpy(), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(tt.numpy(), txt_ref.numpy(), atol=2e-3,
                               rtol=1e-3)
    _close(ti.numpy(), jm.encode_image(jnp.asarray(imgs)))
    _close(tt.numpy(), jm.encode_text(jnp.asarray(ids)))


def test_similarity_matches_hf_and_jax(models):
    hf, jm, tm = models
    imgs, ids = _inputs()
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(
            np.transpose(imgs, (0, 3, 1, 2))))
    lpi, lpt = tm.similarity(torch.from_numpy(imgs), torch.from_numpy(ids))
    jlpi, jlpt = jm.similarity(jnp.asarray(imgs), jnp.asarray(ids))
    assert lpi.shape == (2, 3) and torch.equal(lpt, lpi.T)
    np.testing.assert_allclose(lpi.numpy(), out.logits_per_image.numpy(),
                               atol=5e-3, rtol=1e-3)
    _close(lpi.numpy(), jlpi)
    _close(lpt.numpy(), jlpt)


def test_random_clip_runs_in_bf16():
    """A fresh model from a generator, every leaf (logit_scale too) in
    bf16, as the JAX wrapper casts it."""
    m = tc.CLIP(_cfg(tc), seed=1, dtype=torch.bfloat16, device="cpu")
    assert all(x.dtype == torch.bfloat16 for x in _flat(m.params).values())
    imgs, ids = _inputs()
    lpi, _ = m.similarity(torch.from_numpy(imgs).to(torch.bfloat16),
                          torch.from_numpy(ids))
    assert lpi.dtype == torch.bfloat16 and bool(torch.isfinite(lpi).all())
