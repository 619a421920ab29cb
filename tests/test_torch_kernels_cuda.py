"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a CUDA device every test here skips (a
CUDA kernel has no interpret mode).

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX, where tests/conftest.py (which imports JAX) cannot
load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

import importlib

from deepspeed_tpu_torch.ops.flash_attention import (FlashAttentionFunction,
                                                     flash_dkv,
                                                     flash_dkv_plain,
                                                     flash_dq, flash_dq_plain,
                                                     flash_fwd,
                                                     flash_fwd_plain,
                                                     kernel_head_dim)
from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 24, 64, 256])
@pytest.mark.parametrize("H, Hkv, D", [(32, 8, 128), (12, 12, 64),
                                       (8, 1, 64)],
                         ids=["llama3-8b", "gpt2", "mqa"])
def test_paged_attention_kernel_matches_plain(cuda_device, H, Hkv, D, bs):
    """bf16: a prefill chunk, a decode token whose table aliases the
    chunk's first blocks, a position-0 token and a decode token at an
    8192-token context; atol = rtol = 2e-2 (the bar of
    tests/test_paged_attention.py)."""
    rng = np.random.RandomState(bs)
    nb = -(-8192 // bs)                      # blocks of the longest row
    nblocks = nb + 16
    tables = np.full((5, nblocks), -1, np.int32)
    chunk_blocks = -(-96 // bs)
    tables[0, :chunk_blocks] = rng.permutation(nblocks)[:chunk_blocks]
    tables[1, :1] = tables[0, :1]                   # aliased prefix
    tables[1, 1:-(-120 // bs)] = nblocks - 1
    tables[2, 0] = tables[0, 0]
    tables[3, :nb] = rng.randint(0, nblocks, nb)     # long context
    toks = ([(0, p) for p in range(32, 96)] + [(1, 119), (2, 0),
                                                (3, 8191)])
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(bs)
    kv = torch.randn(nblocks + 1, bs, 2, Hkv, D, device=dev,
                     dtype=torch.bfloat16, generator=gen)
    q = torch.randn(len(toks), H, D, device=dev, dtype=torch.bfloat16,
                    generator=gen)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    args = (kv, q, as_t([s for s, _ in toks]), as_t([p for _, p in toks]),
            as_t(tables), bs, nb, D ** -0.5)
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    kv = torch.zeros(3, 16, 2, 2, 128, device=cuda_device,
                     dtype=torch.bfloat16)
    q = torch.zeros(2, 4, 128, device=cuda_device, dtype=torch.bfloat16)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=cuda_device)  # noqa: E731
    ok = (kv, q, i32(2), i32(2), i32(2, 2), 16, 2, 0.1)
    paged_attention(*ok)
    with pytest.raises(ValueError, match="bf16"):
        paged_attention(kv.float(), q.float(), *ok[2:])
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(kv[..., :32].contiguous(), q[..., :32].contiguous(),
                        *ok[2:])
    with pytest.raises(ValueError, match="rep"):
        paged_attention(kv[:, :, :, :1].contiguous(),
                        torch.zeros(2, 16, 128, device=cuda_device,
                                    dtype=torch.bfloat16), *ok[2:])
    with pytest.raises(ValueError, match="int32"):
        paged_attention(kv, q, i32(2).long(), *ok[3:])
    torch.cuda.synchronize()


def _flash_case(dev, B, H, Hkv, S, D, seed, dtype=torch.bfloat16):
    """Inputs one step wider than ``dtype`` (fp32, or fp64 for fp32) and
    their roundings to ``dtype`` (q, k, v, dO)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.float64 if dtype == torch.float32 else torch.float32
    xw = [torch.randn(shape, device=dev, generator=gen).to(wide)
          for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                        (B, H, S, D))]
    return xw, [x.to(dtype) for x in xw]


def _assert_within_noise(name, got, ref, ref_wide):
    """|kernel - plain| <= 2 x |plain - plain one step wider|: the kernel
    must be at least as close to the wider result as the plain version in
    its own dtype is (the noise floor of that dtype, chip_smoke.py's
    bar)."""
    assert torch.isfinite(got).all(), f"{name}: non-finite values"
    noise = float((ref.double() - ref_wide.double()).abs().max())
    err = float((got.double() - ref.double()).abs().max())
    assert err <= 2.0 * noise, f"{name}: max|d| {err} > 2 x noise {noise}"


def _check_flash_kernels(dev, B, H, Hkv, S, D, causal, dtype):
    """fwd, dq and dkv on the card against their plain versions on the
    same inputs in ``dtype``, within the noise floor of ``dtype``; each
    wrapper launches its kernel once."""
    xw, (q, k, v, do) = _flash_case(dev, B, H, Hkv, S, D, S + D, dtype)
    scale = D ** -0.5
    wrappers = (flash_fwd, flash_dq, flash_dkv)
    variant = (str(dtype).removeprefix("torch."), kernel_head_dim(D))
    before = [(w.launches, w.variant_launches.get(variant, 0))
              for w in wrappers]
    o, lse = flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale, causal)
    o_w, lse_w = flash_fwd_plain(*xw[:3], scale, causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    _assert_within_noise("o", o, o_ref, o_w)
    _assert_within_noise("lse", lse, lse_ref, lse_w)
    delta = (do.float() * o_ref.float()).sum(-1)
    delta_w = (xw[3] * o_w).sum(-1)
    args = (q, k, v, do, lse_ref, delta, scale, causal)
    args_w = (*xw, lse_w, delta_w, scale, causal)
    dq = flash_dq(*args)
    dk, dv = flash_dkv(*args)
    torch.cuda.synchronize()
    _assert_within_noise("dq", dq, flash_dq_plain(*args),
                         flash_dq_plain(*args_w))
    for name, got, ref, ref_w in zip(("dk", "dv"), (dk, dv),
                                     flash_dkv_plain(*args),
                                     flash_dkv_plain(*args_w)):
        _assert_within_noise(name, got, ref, ref_w)
    assert [(w.launches, w.variant_launches.get(variant, 0))
            for w in wrappers] == [(n + 1, m + 1) for n, m in before]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B, H, Hkv, S, D", [
    (2, 4, 4, 256, 64), (1, 4, 2, 256, 128), (1, 8, 2, 192, 64),
    (2, 4, 1, 100, 128), (1, 2, 2, 64, 64)],
    ids=["mha", "gqa2-d128", "gqa4", "mqa-s100", "one-tile"])
def test_flash_kernels_match_plain(cuda_device, B, H, Hkv, S, D, causal):
    """fwd, dq and dkv against their plain versions on the same bf16
    inputs, within the bf16 noise floor; S=100 and 192 exercise the
    zero-filled ragged tile."""
    _check_flash_kernels(cuda_device, B, H, Hkv, S, D, causal, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [32, 48, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.bfloat16],
                         ids=["fp16", "fp32", "bf16"])
def test_flash_kernels_every_dtype_and_head_dim(cuda_device, dtype, D,
                                                causal):
    """Every instantiated head dim (32, 64, 80, 96, 128, 256) and one that
    is zero-padded to the next (48 -> 64), in each dtype, on a GQA batch
    with a ragged last tile, within the noise floor of the dtype (fp16 and
    bf16 against fp32, fp32 against fp64)."""
    _check_flash_kernels(cuda_device, 2, 4, 2, 160, D, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [1024, 1000], ids=["tiled", "ragged"])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_sm90_fwd_and_dkv_match_plain_and_dkv_is_deterministic(
        cuda_device, dtype, D, rep, S, causal):
    """The wgmma / TMA forward and dk/dv (every head dim they run: 32, 64,
    80, 96, 128) against their plain versions on the same inputs, within
    2x the noise floor of the dtype: GQA rep 1, 2 and 4; S a multiple of
    the 128-row tiles and S ragged (1000: TMA's zero fill, masked); causal
    and full.  B 3 x 8 KV heads gives the persistent forward more (q
    tile, head) items than the card has SMs, so blocks take several.  dk
    and dv are bitwise equal on a second run (no atomics)."""
    B, Hkv = 3, 8
    H = Hkv * rep
    xw, (q, k, v, do) = _flash_case(cuda_device, B, H, Hkv, S, D,
                                    S + D + rep, dtype)
    scale = D ** -0.5
    before = (flash_fwd.launches, flash_dkv.launches)
    o, lse = flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale, causal)
    o_w, lse_w = flash_fwd_plain(*xw[:3], scale, causal)
    torch.cuda.synchronize()
    _assert_within_noise("o", o, o_ref, o_w)
    _assert_within_noise("lse", lse, lse_ref, lse_w)
    delta = (do.float() * o_ref.float()).sum(-1)
    delta_w = (xw[3] * o_w).sum(-1)
    args = (q, k, v, do, lse_ref, delta, scale, causal)
    dk, dv = flash_dkv(*args)
    dk2, dv2 = flash_dkv(*args)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dkv.launches) == (before[0] + 1,
                                                        before[1] + 2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    for name, got, ref, ref_w in zip(
            ("dk", "dv"), (dk, dv), flash_dkv_plain(*args),
            flash_dkv_plain(*xw, lse_w, delta_w, scale, causal)):
        _assert_within_noise(name, got, ref, ref_w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [1024, 1000], ids=["tiled", "ragged"])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_sm90_dq_matches_plain_and_is_deterministic(cuda_device, dtype, D,
                                                    rep, S, causal):
    """The wgmma / TMA dq (every head dim it runs: 32, 64, 80, 96, 128)
    against its plain version on the same inputs, within 2x the noise
    floor of the dtype, with the parametrisation of the forward and dk/dv
    above: GQA rep 1, 2, 4; S tiled and ragged (TMA's zero fill, masked;
    lse and delta rows past S); causal and full; more work items than
    SMs.  dq is bitwise equal on a second run (no atomics)."""
    B, Hkv = 3, 8
    H = Hkv * rep
    xw, (q, k, v, do) = _flash_case(cuda_device, B, H, Hkv, S, D,
                                    S + D + rep, dtype)
    scale = D ** -0.5
    o_ref, lse = flash_fwd_plain(q, k, v, scale, causal)
    o_w, lse_w = flash_fwd_plain(*xw[:3], scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    delta_w = (xw[3] * o_w).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal)
    before = flash_dq.launches
    dq = flash_dq(*args)
    dq2 = flash_dq(*args)
    torch.cuda.synchronize()
    assert flash_dq.launches == before + 2
    assert dq.dtype == dtype and dq.shape == q.shape
    assert torch.equal(dq, dq2)
    _assert_within_noise("dq", dq, flash_dq_plain(*args),
                         flash_dq_plain(*xw, lse_w, delta_w, scale, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128, 256])
def test_fp32_dkv_matches_plain_and_is_deterministic(cuda_device, D,
                                                     causal):
    """The register-blocked fp32 dk/dv at every head dim (two cp.async
    stages at D <= 128, one at D 256) on a GQA batch with a ragged last
    tile and many streamed query tiles: within 2x the fp32 noise floor
    (against fp64), and bitwise equal on a second run (no atomics)."""
    B, H, Hkv, S = 2, 8, 2, 1000
    xw, (q, k, v, do) = _flash_case(cuda_device, B, H, Hkv, S, D, S + D,
                                    torch.float32)
    scale = D ** -0.5
    o_ref, lse = flash_fwd_plain(q, k, v, scale, causal)
    o_w, lse_w = flash_fwd_plain(*xw[:3], scale, causal)
    delta = (do * o_ref).sum(-1)
    delta_w = (xw[3] * o_w).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal)
    before = flash_dkv.launches
    dk, dv = flash_dkv(*args)
    dk2, dv2 = flash_dkv(*args)
    torch.cuda.synchronize()
    assert flash_dkv.launches == before + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    for name, got, ref, ref_w in zip(
            ("dk", "dv"), (dk, dv), flash_dkv_plain(*args),
            flash_dkv_plain(*xw, lse_w, delta_w, scale, causal)):
        _assert_within_noise(name, got, ref, ref_w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128, 256])
def test_fp32_fwd_and_dq_match_plain_and_are_deterministic(cuda_device, D,
                                                           causal):
    """The register-blocked fp32 forward and dq at every head dim (query
    tiles resident, K/V streamed through two cp.async stages, one for dq
    at D 256) on the dk/dv test's GQA batch (a ragged last tile, many
    streamed key tiles): o, lse and dq within 2x the fp32 noise floor
    (against fp64), each bitwise equal on a second run (no atomics)."""
    B, H, Hkv, S = 2, 8, 2, 1000
    xw, (q, k, v, do) = _flash_case(cuda_device, B, H, Hkv, S, D, S + D,
                                    torch.float32)
    scale = D ** -0.5
    before = (flash_fwd.launches, flash_dq.launches)
    o, lse = flash_fwd(q, k, v, scale, causal)
    o2, lse2 = flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale, causal)
    o_w, lse_w = flash_fwd_plain(*xw[:3], scale, causal)
    delta = (do * o_ref).sum(-1)
    delta_w = (xw[3] * o_w).sum(-1)
    args = (q, k, v, do, lse_ref, delta, scale, causal)
    dq = flash_dq(*args)
    dq2 = flash_dq(*args)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dq.launches) == (before[0] + 2,
                                                       before[1] + 2)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dq, dq2)
    _assert_within_noise("o", o, o_ref, o_w)
    _assert_within_noise("lse", lse, lse_ref, lse_w)
    _assert_within_noise("dq", dq, flash_dq_plain(*args),
                         flash_dq_plain(*xw, lse_w, delta_w, scale, causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32],
                         ids=["fp16", "fp32"])
def test_flash_cuda_tensors_never_reach_a_plain_version(cuda_device,
                                                        monkeypatch, dtype):
    """An fp16 or fp32 tensor on the card launches the kernels, through the
    wrappers and through autograd: the plain versions are never called."""
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain"):
        monkeypatch.setattr(fa, name, refuse)
    _, (q, k, v, do) = _flash_case(cuda_device, 1, 4, 2, 128, 80, 5, dtype)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))
    o.backward(do.transpose(1, 2))
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    assert q.grad.dtype == dtype and torch.isfinite(q.grad).all()


@pytest.mark.cuda
def test_flash_autograd_runs_the_kernels(cuda_device):
    """The autograd Function's backward on the card goes through dq and
    dkv and matches the plain backward's arithmetic on the same inputs."""
    _, (q, k, v, do) = _flash_case(cuda_device, 2, 8, 2, 256, 64, 3)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    before = flash_dkv.launches
    o = FlashAttentionFunction.apply(q, k, v, 0.125, True)
    o.backward(do)
    torch.cuda.synchronize()
    assert flash_dkv.launches == before + 1
    _, lse = flash_fwd_plain(q.detach(), k.detach(), v.detach(), 0.125,
                             True)
    delta = (do.float() * o.detach().float()).sum(-1)
    args = (q.detach(), k.detach(), v.detach(), do, lse, delta, 0.125, True)
    torch.testing.assert_close(q.grad.float(), flash_dq_plain(*args).float(),
                               atol=3e-2, rtol=3e-2)
    dk, dv = flash_dkv_plain(*args)
    torch.testing.assert_close(k.grad.float(), dk.float(), atol=3e-2,
                               rtol=3e-2)
    torch.testing.assert_close(v.grad.float(), dv.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("policy, fwd_per_layer",
                         [("flash", 1), ("dots_no_batch", 2), ("nothing", 2)])
def test_remat_policy_flash_saves_the_forward_on_the_card(cuda_device, policy,
                                                          fwd_per_layer):
    """A phi-style model in fp16 (head dim 80) trains one step on the card
    with the flash kernels under remat: the "flash" policy saves the
    forward op's (o, lse), so the backward launches no second forward; the
    other policies replay it."""
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime.runtime_utils import (tree_leaves,
                                                           tree_unflatten)
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    m = build_model("phi-tiny", num_layers=2, d_model=320, num_heads=4,
                    vocab_size=512, device=cuda_device, dtype=torch.float16,
                    remat=True, remat_policy=policy, attention_impl="flash")
    leaves = [x.detach().requires_grad_() for x in tree_leaves(m.params)]
    ids = torch.randint(0, 512, (2, 256), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(0))
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    loss = m.loss_fn(tree_unflatten(m.params, leaves), {"input_ids": ids})
    grads = torch.autograd.grad(loss * 1024.0, leaves)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches - before[0],
            fa.flash_dq.launches - before[1],
            fa.flash_dkv.launches - before[2]) == (2 * fwd_per_layer, 2, 2)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    z = lambda *s, dt=torch.bfloat16: torch.zeros(  # noqa: E731
        *s, device=cuda_device, dtype=dt)
    q, k = z(1, 4, 128, 64), z(1, 2, 128, 64)
    flash_fwd(q, k, k, 0.1)
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        flash_fwd(q.double(), k.double(), k.double(), 0.1)
    with pytest.raises(ValueError, match="is torch.float16, q is"):
        flash_fwd(q, k.half(), k, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(z(1, 4, 128, 320), z(1, 2, 128, 320), z(1, 2, 128, 320),
                  0.1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(z(1, 128, 4, 64).transpose(1, 2), k, k, 0.1)
    with pytest.raises(ValueError, match="multiple"):
        flash_fwd(z(1, 3, 128, 64), k, k, 0.1)
    with pytest.raises(ValueError, match="fp32"):
        flash_dq(q, k, k, q, z(1, 4, 128), z(1, 4, 128, dt=torch.float32),
                 0.1)
    torch.cuda.synchronize()


# --- the mixed-input GEMM (K3) ----------------------------------------------

# Llama-3-8B's projections (K, N, contract_dims): mlp wi/wg, mlp wo, wq,
# wk/wv, and the attention output [32, 128] -> 4096 with one scale per head
LLAMA3_8B_PROJECTIONS = {"wi": ((4096,), 14336), "mlp_wo": ((14336,), 4096),
                         "wq": ((4096,), 4096), "wk": ((4096,), 1024),
                         "attn_wo": ((32, 128), 4096)}


def _mixed_case(dev, kdims, N, M, bits, seed):
    """(x fp32, x bf16, QuantizedTensor) on the card."""
    from deepspeed_tpu_torch.ops.quant import (_quantize_leading,
                                               quantize_rowwise4)
    gen = torch.Generator(device=dev).manual_seed(seed)
    K = int(np.prod(kdims))
    w = torch.randn(*kdims, N, device=dev, generator=gen).to(torch.bfloat16)
    x32 = torch.randn(M, K, device=dev, generator=gen)
    qt = (_quantize_leading(w, 1) if bits == 8
          else quantize_rowwise4(w, contract_dims=len(kdims)))
    return x32, x32.to(torch.bfloat16), qt


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [1, 8, 16, 64, 65, 77, 300, 1024])
@pytest.mark.parametrize("proj", sorted(LLAMA3_8B_PROJECTIONS))
def test_mixed_gemm_kernels_match_plain(cuda_device, proj, M, bits):
    """K3 at Llama-3-8B's projection shapes against the plain version on
    the same bf16 inputs, within 2x the bf16 noise floor (the plain
    version in bf16 against x @ dequant(w) in fp32 on the unrounded x).
    M spans both designs, the threshold between them and the prefill
    design's 128- and 256-row tiles (ragged at M 300)."""
    from deepspeed_tpu_torch.ops import mixed_gemm as mg
    from deepspeed_tpu_torch.ops.quant import dequantize
    torch.backends.cuda.matmul.allow_tf32 = False
    kdims, N = LLAMA3_8B_PROJECTIONS[proj]
    x32, x, qt = _mixed_case(cuda_device, kdims, N, M, bits, M + bits)
    counter = mg.mixed_matmul_2d if bits == 8 else mg.mixed4_matmul_2d
    before = counter.launches
    got = mg.mixed_matmul(x, qt, contract_dims=len(kdims))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    plain = mg.mixed4_matmul_2d_plain if bits == 4 else \
        mg.mixed_matmul_2d_plain
    K = int(np.prod(kdims))
    s = qt.scale.reshape(-1)
    s = s[:, None].expand(s.numel(), K // s.numel()).reshape(K)
    data = qt.data.reshape(-1, N)
    ref = plain(x, data, s)
    ref32 = x32 @ dequantize(qt, torch.float32).reshape(K, N)
    _assert_within_noise(f"{proj} M={M} int{bits}", got, ref, ref32)
    # fp32 out: the same sums, not rounded
    got32 = mg.mixed_matmul(x, qt, contract_dims=len(kdims),
                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_within_noise(f"{proj} M={M} int{bits} fp32", got32,
                         plain(x, data, s, out_dtype=torch.float32), ref32)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_mixed_gemm_kernel_ragged_tiles(cuda_device, bits):
    """N and M that do not fill a tile (N % 64 != 0, M % 16 != 0)."""
    from deepspeed_tpu_torch.ops import mixed_gemm as mg
    x32, x, qt = _mixed_case(cuda_device, (128,), 48, 5, bits, 1)
    got = mg.mixed_matmul(x, qt)
    plain = mg.mixed4_matmul_2d_plain if bits == 4 else \
        mg.mixed_matmul_2d_plain
    ref = plain(x, qt.data.reshape(-1, 48), qt.scale.reshape(-1))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_mixed_gemm_prefill_ragged_tiles(cuda_device, bits):
    """The prefill design where M, N and (int8) K do not fill a tile:
    M 77, N 48, K 96 (a last stage of 32 code rows) or 128 (int4)."""
    from deepspeed_tpu_torch.ops import mixed_gemm as mg
    K = 96 if bits == 8 else 128
    x32, x, qt = _mixed_case(cuda_device, (K,), 48, 77, bits, 2)
    assert mg.design_for(77) == "prefill"
    got = mg.mixed_matmul(x, qt)
    plain = mg.mixed4_matmul_2d_plain if bits == 4 else \
        mg.mixed_matmul_2d_plain
    ref = plain(x, qt.data.reshape(-1, 48), qt.scale.reshape(-1))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


def _one_hot_case(dev, bits, seed, N=256):
    """(data, fp32 scales) whose every code row holds every code: int8
    [256, N] with code (k + n) mod 256, int4 [256, N] bytes (k + n) mod 256
    (both nibbles take all 16 values), K 256 or 512; scales spread over
    2^-20..2^20 with mantissas that bf16 rounds."""
    K = 256 if bits == 8 else 512
    k = np.arange(256)[:, None]
    n = np.arange(N)[None, :]
    data = torch.from_numpy(((k + n) % 256).astype(np.uint8).view(np.int8))
    rng = np.random.RandomState(seed)
    scale = (rng.uniform(1.0, 2.0, K) * 2.0 ** rng.randint(-20, 21, K))
    return (data.to(dev), torch.from_numpy(scale.astype(np.float32)).to(dev),
            K)


@pytest.mark.cuda
@pytest.mark.parametrize("M, N", [(8, 256), (32, 256), (128, 256),
                                  (300, 16384)],
                         ids=["decode8", "decode32", "prefill128",
                              "prefill256"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_mixed_gemm_dequantizes_every_code_bitwise(cuda_device, bits, M, N):
    """x of one-hot rows, fp32 out: each output row is one dequantized
    weight row whatever the order of the sums, so every int8 code (every
    int4 code in both nibbles) at every contraction row and a spread of
    scales must equal the plain version bit for bit, in both designs (the
    prefill design at 128- and 256-row tiles)."""
    from deepspeed_tpu_torch.ops import mixed_gemm as mg
    data, scale, K = _one_hot_case(cuda_device, bits, M + bits, N)
    if M > 128:
        sms = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        assert mg.prefill_rows(M, N, sms) == 256
    kern = mg.mixed_matmul_2d if bits == 8 else mg.mixed4_matmul_2d
    plain = mg.mixed_matmul_2d_plain if bits == 8 else \
        mg.mixed4_matmul_2d_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    for k0 in range(0, K, M):
        rows = torch.arange(k0, min(k0 + M, K), device=cuda_device)
        x = torch.zeros(M, K, device=cuda_device, dtype=torch.bfloat16)
        x[torch.arange(len(rows), device=cuda_device), rows] = 1
        before = dict(kern.design_launches)
        got = kern(x, data, scale, out_dtype=torch.float32)
        ref = plain(x, data, scale, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert kern.design_launches[mg.design_for(M)] == \
            before[mg.design_for(M)] + 1
        bad = (got != ref).nonzero()
        assert bad.numel() == 0, (
            f"int{bits} {mg.design_for(M)}: {bad.shape[0]} outputs differ, "
            f"first at {bad[0].tolist()}: {got[tuple(bad[0])].item()} vs "
            f"{ref[tuple(bad[0])].item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_mixed_gemm_decode_split_is_deterministic(cuda_device, bits, M):
    """The decode design sums its split-K partials in a fixed order: a
    second call gives the same bits (wk and mlp wo, split > 1)."""
    from deepspeed_tpu_torch.ops import mixed_gemm as mg
    for kdims, N in (((4096,), 1024), ((14336,), 4096)):
        _, x, qt = _mixed_case(cuda_device, kdims, N, M, bits, M)
        assert mg.design_for(M) == "decode"
        assert mg.decode_split(M, kdims[0], N, bits == 4,
                               torch.cuda.get_device_properties(
                                   cuda_device).multi_processor_count) > 1
        first = mg.mixed_matmul(x, qt, out_dtype=torch.float32)
        second = mg.mixed_matmul(x, qt, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_mixed_gemm_kernels_reject_what_they_do_not_take(cuda_device):
    from deepspeed_tpu_torch.ops import mixed_gemm as mg
    dev = cuda_device
    x = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    d = torch.zeros(64, 64, device=dev, dtype=torch.int8)
    s = torch.ones(64, device=dev)
    mg.mixed_matmul_2d(x, d, s)
    with pytest.raises(ValueError, match="multiple of 32"):
        mg.mixed_matmul_2d(x[:, :48].contiguous(), d[:48].contiguous(), s[:48])
    with pytest.raises(ValueError, match="multiple of 16"):
        mg.mixed_matmul_2d(x, d[:, :24].contiguous(), s)
    with pytest.raises(ValueError, match="multiple of 64"):
        mg.mixed4_matmul_2d(x[:, :32].contiguous(), d[:16].contiguous(),
                            s[:32])
    with pytest.raises(ValueError, match="int8 data"):
        mg.mixed_matmul_2d(x, d.to(torch.uint8), s)
    with pytest.raises(ValueError, match="fp32 scale"):
        mg.mixed_matmul_2d(x, d, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        mg.mixed_matmul_2d(x, d.t(), s)
    with pytest.raises(ValueError, match="on cpu"):
        mg.mixed_matmul_2d(x, d.cpu(), s)
    torch.cuda.synchronize()


# --- the quantized-KV variant of paged attention (K2) ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("code", ["int8", "fp8"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("H, Hkv, D", [(32, 8, 128), (12, 12, 64),
                                       (8, 1, 64)],
                         ids=["llama3-8b", "gpt2", "mqa"])
def test_paged_attention_quantized_kernel_matches_plain(cuda_device, H, Hkv,
                                                        D, bs, code):
    """int8 / fp8 codes + fp32 scales (quantized by the serving path's
    _quantize_kv): a prefill chunk, an aliased decode token, a position-0
    token and a long-context decode token; atol = rtol = 2e-2."""
    from deepspeed_tpu_torch.inference.model import _quantize_kv
    qdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[code]
    rng = np.random.RandomState(bs + 1)
    nb = -(-4096 // bs)
    nblocks = nb + 16
    tables = np.full((5, nblocks), -1, np.int32)
    chunk_blocks = -(-96 // bs)
    tables[0, :chunk_blocks] = rng.permutation(nblocks)[:chunk_blocks]
    tables[1, :1] = tables[0, :1]
    tables[1, 1:-(-120 // bs)] = nblocks - 1
    tables[2, 0] = tables[0, 0]
    tables[3, :nb] = rng.randint(0, nblocks, nb)
    toks = ([(0, p) for p in range(32, 96)] + [(1, 119), (2, 0),
                                                (3, 4095)])
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(bs)
    kv = torch.randn(nblocks + 1, bs, 2, Hkv, D, device=dev, generator=gen)
    codes, scales = _quantize_kv(kv, qdt)
    q = torch.randn(len(toks), H, D, device=dev, dtype=torch.bfloat16,
                    generator=gen)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    args = ((codes, scales), q, as_t([s for s, _ in toks]),
            as_t([p for _, p in toks]), as_t(tables), bs, nb, D ** -0.5)
    counter = f"{code}_launches"
    before = (getattr(paged_attention, counter), paged_attention.launches)
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert (getattr(paged_attention, counter), paged_attention.launches) \
        == (before[0] + 1, before[1])
    ref = paged_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_paged_attention_quantized_rejects_what_it_does_not_take(cuda_device):
    dev = cuda_device
    codes = torch.zeros(3, 16, 2, 2, 128, device=dev, dtype=torch.int8)
    scales = torch.ones(3, 16, 2, 2, device=dev)
    q = torch.zeros(2, 4, 128, device=dev, dtype=torch.bfloat16)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa: E731
    rest = (i32(2), i32(2), i32(2, 2), 16, 2, 0.1)
    paged_attention((codes, scales), q, *rest)
    with pytest.raises(ValueError, match="int8 or float8"):
        paged_attention((codes.view(torch.uint8), scales), q, *rest)
    with pytest.raises(ValueError, match="scales"):
        paged_attention((codes, scales[..., :1].contiguous()), q, *rest)
    with pytest.raises(ValueError, match="bf16 q"):
        paged_attention((codes, scales), q.float(), *rest)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention((codes[..., :32].contiguous(), scales),
                        q[..., :32].contiguous(), *rest)
    torch.cuda.synchronize()


# --- the ALiBi variant of paged attention (K2) --------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("code", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("H, Hkv, D", [(32, 32, 128), (32, 8, 128),
                                       (8, 1, 64)],
                         ids=["bloom-7b1-rep1", "rep4", "rep8"])
def test_paged_attention_alibi_kernel_matches_plain(cuda_device, H, Hkv, D,
                                                    bs, code):
    """ALiBi slopes (the model's, from alibi_slopes(H)) with a bf16, int8
    or fp8 cache: a prefill chunk, an aliased decode token, a position-0
    token and a decode token at position 2047, where the bias reaches
    ~1.7e3 on the first head; atol = rtol = 2e-2.  The launch bumps the
    cache type's counter and ``alibi_launches``."""
    from deepspeed_tpu_torch.inference.model import _quantize_kv
    from deepspeed_tpu_torch.models.layers import alibi_slopes
    rng = np.random.RandomState(bs + H + Hkv)
    nb = -(-2048 // bs)
    nblocks = nb + 16
    tables = np.full((5, nblocks), -1, np.int32)
    chunk_blocks = -(-96 // bs)
    tables[0, :chunk_blocks] = rng.permutation(nblocks)[:chunk_blocks]
    tables[1, :1] = tables[0, :1]
    tables[1, 1:-(-120 // bs)] = nblocks - 1
    tables[2, 0] = tables[0, 0]
    tables[3, :nb] = rng.randint(0, nblocks, nb)
    toks = ([(0, p) for p in range(32, 96)] + [(1, 119), (2, 0),
                                                (3, 2047)])
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(bs + H)
    kv = torch.randn(nblocks + 1, bs, 2, Hkv, D, device=dev, generator=gen)
    if code == "bf16":
        kv = kv.to(torch.bfloat16)
    else:
        kv = _quantize_kv(kv, {"int8": torch.int8,
                               "fp8": torch.float8_e4m3fn}[code])
    q = torch.randn(len(toks), H, D, device=dev, dtype=torch.bfloat16,
                    generator=gen)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    args = (kv, q, as_t([s for s, _ in toks]), as_t([p for _, p in toks]),
            as_t(tables), bs, nb, D ** -0.5, alibi_slopes(H, device=dev))
    counter = "launches" if code == "bf16" else f"{code}_launches"
    before = (getattr(paged_attention, counter),
              paged_attention.alibi_launches)
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert (getattr(paged_attention, counter),
            paged_attention.alibi_launches) == (before[0] + 1, before[1] + 1)
    ref = paged_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    # the bias changed the result: the same launch without slopes differs
    plain = paged_attention_plain(*args[:-1])
    assert float((plain.float() - ref.float()).abs().max()) > 0.1


@pytest.mark.cuda
def test_paged_attention_rejects_bad_slopes(cuda_device):
    """Slopes of the wrong dtype, element count or device, or not
    contiguous, raise before any launch; a bf16 and a quantized cache
    check them alike."""
    dev = cuda_device
    kv = torch.zeros(3, 16, 2, 2, 128, device=dev, dtype=torch.bfloat16)
    codes = torch.zeros(3, 16, 2, 2, 128, device=dev, dtype=torch.int8)
    scales = torch.ones(3, 16, 2, 2, device=dev)
    q = torch.zeros(2, 4, 128, device=dev, dtype=torch.bfloat16)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa: E731
    rest = (i32(2), i32(2), i32(2, 2), 16, 2, 0.1)
    good = torch.ones(2, 2, device=dev)                # [Hkv, rep]
    for cache in (kv, (codes, scales)):
        paged_attention(cache, q, *rest, good)
        with pytest.raises(ValueError, match="slopes"):
            paged_attention(cache, q, *rest, good.double())
        with pytest.raises(ValueError, match="slopes"):
            paged_attention(cache, q, *rest, torch.ones(3, device=dev))
        with pytest.raises(ValueError, match="slopes"):
            paged_attention(cache, q, *rest, good.cpu())
        with pytest.raises(ValueError, match="slopes"):
            paged_attention(cache, q, *rest, torch.ones(2, 4, device=dev)[:, ::2])
    torch.cuda.synchronize()
