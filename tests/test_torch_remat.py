"""The port's six remat policies (``models/transformer.py``
``REMAT_POLICIES``, the JAX package's ``transformer.py:119-135``): each
gives a loss and gradients bitwise equal to no remat on the CPU; the
selective ones (``dots``, ``dots_no_batch``, ``flash``, ``xla_flash``)
save what their JAX counterparts save (``xla_flash``: the forward op of
``ops/xla_attention.py``); and the flash forward runs no more often than
in the JAX program.

The JAX gradient of ``phi-tiny`` with ``attention_impl="flash"`` holds 3
``pallas_call``s without remat (fwd, dq, dkv) and 4 under every policy,
``flash`` included: the policy saves ``flash_out``, the output, but not
the LSE, so the backward replays ``_fwd``.  The port's ``flash`` policy
saves both outputs of the forward op (``deepspeed_tpu_torch::flash_fwd``:
``o`` and ``lse``), so its backward launches no second forward: one per
layer, as the comment at ``deepspeed_tpu/ops/flash_attention.py:374-377``
meant; every other policy replays it, two per layer, as JAX does.

Bitwise comparisons run under ``torch.use_deterministic_algorithms``: the
CPU's embedding backward otherwise accumulates in an order that changes
from run to run."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.models import Model, build_model
from deepspeed_tpu_torch.models.transformer import REMAT_POLICIES
from deepspeed_tpu_torch.runtime.runtime_utils import (tree_leaves,
                                                       tree_unflatten)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

POLICIES = ("nothing", "everything", "dots", "dots_no_batch", "flash",
            "xla_flash")
LAYERS = 2
# phi-tiny cut to 2 layers of d_model 160 (2 heads of 80, phi-2's head dim)
TINY = dict(num_layers=LAYERS, vocab_size=256, d_model=160, num_heads=2)
SEQ = 64


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture
def counted_fwd(monkeypatch):
    """Count the flash forwards the autograd seam runs (the CPU path
    counts no launches): the forward op calls the module's ``flash_fwd``."""
    calls = [0]
    inner = fa.flash_fwd

    def counting(*args, **kw):
        calls[0] += 1
        return inner(*args, **kw)

    monkeypatch.setattr(fa, "flash_fwd", counting)
    return calls


class _CountDots(TorchDispatchMode):
    """Matrix products run (``n``) and every op run (``ops``)."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.n += 1
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _base(attention_impl):
    return build_model("phi-tiny", seed=0, device="cpu",
                       attention_impl=attention_impl, **TINY)


def _loss_and_grads(base, **cfg):
    m = Model.from_params(dataclasses.replace(base.config, **cfg),
                          base.params)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(m.params)]
    ids = torch.randint(0, 256, (2, SEQ),
                        generator=torch.Generator().manual_seed(0))
    loss = m.loss_fn(tree_unflatten(m.params, leaves), {"input_ids": ids})
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_six_policies():
    assert sorted(REMAT_POLICIES) == sorted(POLICIES)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("attention_impl", ["flash", "xla_flash"])
def test_policy_is_bitwise_no_remat(deterministic, attention_impl, policy):
    """No policy changes the numbers: loss and every gradient bitwise equal
    to remat=False (with the flash kernels' plain versions, and with
    ``fused_attention`` under ``xla_flash``)."""
    base = _base(attention_impl)
    ref_loss, ref_grads = _loss_and_grads(base)
    loss, grads = _loss_and_grads(base, remat=True, remat_policy=policy)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)


def _jax_forward_pallas_calls(policy):
    """``pallas_call``s in the JAX gradient's jaxpr on phi-tiny (flash
    attention): (all of them, the forward ones, which emit an LSE whose
    trailing dim is 1)."""
    m = jax_build_model("phi-tiny", seed=0, attention_impl="flash",
                        remat=policy is not None,
                        remat_policy=policy or "nothing", **TINY)
    jp = jax.make_jaxpr(jax.grad(m.loss_fn))(
        m.params, {"input_ids": jnp.zeros((2, SEQ), jnp.int32)},
        jax.random.PRNGKey(0))
    calls = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                calls.append(eqn)
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)

    walk(jp.jaxpr)
    fwd = [e for e in calls if any(v.aval.shape[-1] == 1 for v in e.outvars)]
    return len(calls), len(fwd)


@pytest.mark.parametrize("policy", [None, *POLICIES])
def test_flash_forwards_no_more_than_jax(counted_fwd, policy):
    """Flash forwards per layer per step: the port runs no more than the
    JAX program (whose scanned layer body holds each kernel once), and
    under ``flash`` exactly one, because it saves ``(o, lse)``."""
    n_jax, fwd_jax = _jax_forward_pallas_calls(policy)
    assert (n_jax, fwd_jax) == ((3, 1) if policy is None else (4, 2))
    cfg = {} if policy is None else dict(remat=True, remat_policy=policy)
    _loss_and_grads(_base("flash"), **cfg)
    per_layer = counted_fwd[0] / LAYERS
    assert per_layer <= fwd_jax
    assert per_layer == (1 if policy in (None, "flash") else 2)


@pytest.mark.parametrize("policy, replayed", [
    (None, 0), ("nothing", 5), ("everything", 5), ("dots", 0),
    ("dots_no_batch", 0), ("flash", 0), ("xla_flash", 0)])
def test_selective_policies_save_the_products(policy, replayed):
    """Matrix products (mm/addmm/bmm) run in one loss-and-gradient pass
    with the flash attention: each layer of phi-tiny has six against
    weights (q, k, v, the attention projection, the MLP's two).  The
    whole-layer checkpoints replay five of them in the backward (the
    recomputation stops once it has rebuilt what the backward needs, and
    the MLP's last product feeds only the residual sum); the selective
    policies replay none."""
    cfg = {} if policy is None else dict(remat=True, remat_policy=policy)
    base = _base("flash")
    with _CountDots() as ref:
        _loss_and_grads(base)
    with _CountDots() as got:
        _loss_and_grads(base, **cfg)
    assert got.n - ref.n == replayed * LAYERS


def test_xla_flash_saves_the_attention_output():
    """Under ``xla_flash`` the attention is ``fused_attention``, whose
    forward is one op (``deepspeed_tpu_torch::xla_attention_fwd``, its
    products inside it): the policy saves that op's (o, lse), as the JAX
    policy saves attn_out and attn_lse, so neither it nor a product is
    replayed; ``dots`` saves the products but replays the forward op."""
    base = _base("xla_flash")
    fwd = torch.ops.deepspeed_tpu_torch.xla_attention_fwd.default
    counts = {}
    for policy in ("xla_flash", "dots", None):
        cfg = {} if policy is None else dict(remat=True, remat_policy=policy)
        with _CountDots() as c:
            _loss_and_grads(base, **cfg)
        counts[policy] = (c.n, c.ops.get(fwd, 0))
    assert counts["xla_flash"] == counts[None]
    assert counts[None][1] == LAYERS
    assert counts["dots"] == (counts[None][0], 2 * LAYERS)
