"""The port's ZeRO-Infinity storage and host optimizer
(``runtime/swap_tensor.py``, ``runtime/zero_infinity.py``) against the
JAX package's (``deepspeed_tpu/runtime/swap_tensor.py``,
``zero_infinity.py``) on the same numpy inputs.

``HostAdam`` runs the same IEEE-rounded fp32 operations in the same order
as the numpy mirror: the trajectories are held bitwise.  The NVMe
optimizer's swap groups at a given ``buffer_size`` are the reference's,
and three NVMe steps give bitwise the reference's masters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import zero_infinity as jzi
from deepspeed_tpu.runtime.swap_tensor import \
    OptimizerSwapper as JaxOptimizerSwapper
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.runtime import zero_infinity as tzi
from deepspeed_tpu_torch.runtime.swap_tensor import (OptimizerSwapper,
                                                     TensorSpec,
                                                     TensorSwapper, spec_of,
                                                     tree_bytes)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

OPTIMIZERS = [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.01}),
    ("adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("adagrad", {"lr": 1e-2, "weight_decay": 0.05}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True,
             "weight_decay": 0.01}),
]


@pytest.mark.parametrize("kind,params", OPTIMIZERS)
def test_host_adam_matches_the_numpy_mirror_bitwise(kind, params):
    r = np.random.RandomState(0)
    p0 = r.randn(1000).astype(np.float32)
    grads = [r.randn(1000).astype(np.float32) for _ in range(6)]
    ref, port = jzi.HostAdam(kind, dict(params)), tzi.HostAdam(kind,
                                                              dict(params))
    jp, jm, jv = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    tp, tm, tv = (torch.from_numpy(p0.copy()), torch.zeros(1000),
                  torch.zeros(1000))
    for i, g in enumerate(grads):
        ref.update(jp, jm, jv, g, params["lr"], i + 1)
        # the port takes the grad as a tensor or as a numpy array
        port.update(tp, tm, tv, torch.from_numpy(g) if i % 2 else g,
                    params["lr"], i + 1)
    for a, b in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=kind)


def test_host_adam_refuses_what_the_reference_refuses():
    with pytest.raises(ConfigError, match="supports"):
        tzi.HostAdam("lamb", {})
    with pytest.raises(ConfigError, match="nvme_path"):
        tzi.NVMeOptimizer("", "adamw", {})


def test_tensor_swapper_round_trip(tmp_path):
    sw = TensorSwapper(str(tmp_path))
    x = torch.randn(33, 7)
    sw.swap_out("a/b['c']", x)
    assert sw.swap_in("a/b['c']").equal(x)
    bf = torch.randn(5, 9).to(torch.bfloat16)
    sw.swap_out("bf", bf, async_op=True)
    sw.wait()
    got = sw.swap_in("bf")
    assert got.dtype == torch.bfloat16 and got.equal(bf)
    out = torch.empty(33, 7)
    sw.swap_in("a/b['c']", out=out)
    assert out.equal(x)
    sw.remove("bf")
    sw.remove("bf")                      # removing twice is harmless
    assert spec_of(np.zeros((2, 3), np.float32)).shape == (2, 3)


def test_optimizer_swapper_groups_and_prefetch(tmp_path):
    """Group round trips through the two alternating pools, a prefetch
    consumed by read_group, and the reference's keys (``g<n>`` + keystr),
    so the JAX swapper reads the port's files."""
    sw = OptimizerSwapper(str(tmp_path), 3)
    trees = [{"w": torch.randn(4, 5) + g, "b": [torch.randn(3), torch.ones(2)]}
             for g in range(3)]
    for g, t in enumerate(trees):
        sw.write_group(g, t)
    tpl = {"w": TensorSpec((4, 5), torch.float32),
           "b": [TensorSpec((3,), torch.float32),
                 TensorSpec((2,), torch.float32)]}
    assert tree_bytes(tpl) == 4 * 25
    sw.prefetch_group(1, tpl)
    sw.prefetch_group(2, tpl)
    for g in (1, 2, 0):
        got = sw.read_group(g, tpl)
        assert got["w"].equal(trees[g]["w"])
        assert all(a.equal(b) for a, b in zip(got["b"], trees[g]["b"]))
    assert sw._keys(0, tpl) == ["g0['b'][0]", "g0['b'][1]", "g0['w']"]
    ref = JaxOptimizerSwapper(str(tmp_path), 3)
    for key in sw._keys(2, tpl):        # the JAX swapper's metadata
        ref._swapper(2)._meta[key] = sw._swapper(2)._meta[key].shape, \
            np.float32
    got = ref.read_group(2, {"w": jax.ShapeDtypeStruct((4, 5), np.float32),
                             "b": [jax.ShapeDtypeStruct((3,), np.float32),
                                   jax.ShapeDtypeStruct((2,), np.float32)]})
    np.testing.assert_array_equal(got["w"], trees[2]["w"].numpy())


def _tree(seed):
    r = np.random.RandomState(seed)
    return {"embed": {"table": r.randn(64, 32).astype(np.float32)},
            "blocks": {"attn": {"wq": r.randn(2, 32, 4, 8).astype(
                np.float32), "wo": r.randn(2, 4, 8, 32).astype(np.float32)},
                "ln1": {"scale": r.randn(2, 32).astype(np.float32)}},
            "ln_f": {"scale": r.randn(32).astype(np.float32),
                     "bias": r.randn(32).astype(np.float32)}}


@pytest.mark.parametrize("buffer_size", [1, 4096, 10_000, 1 << 30])
def test_swap_groups_are_the_references(tmp_path, buffer_size):
    tree = _tree(0)
    ref = jzi.NVMeOptimizer(str(tmp_path / "j"), "adamw", {"lr": 1e-3},
                            buffer_size=buffer_size)
    ref.initialize(jax.tree.map(jnp.asarray, tree))
    port = tzi.NVMeOptimizer(str(tmp_path / "t"), "adamw", {"lr": 1e-3},
                             buffer_size=buffer_size)
    port.initialize(jax.tree.map(torch.from_numpy, tree))
    assert port.groups == ref.groups
    assert port._group_bytes == ref._group_bytes


@pytest.mark.parametrize("span", [None, 100])
def test_nvme_steps_are_the_references_bitwise(tmp_path, monkeypatch, span):
    """Three steps with the double-buffered prefetch (several groups),
    ``consume`` on the last: the masters, moments and the consumed leaves
    are bitwise the JAX NVMe optimizer's (``span``: each leaf updated in
    spans of that many elements)."""
    if span is not None:
        monkeypatch.setattr(tzi, "HOST_CHUNK", span)
    tree = _tree(1)
    kw = dict(buffer_size=9000)
    ref = jzi.NVMeOptimizer(str(tmp_path / "j"), "adamw",
                            {"lr": 1e-2, "weight_decay": 0.01}, **kw)
    ref.initialize(jax.tree.map(jnp.asarray, tree))
    port = tzi.NVMeOptimizer(str(tmp_path / "t"), "adamw",
                             {"lr": 1e-2, "weight_decay": 0.01}, **kw)
    port.initialize(jax.tree.map(torch.from_numpy, tree))
    assert len(port.groups) > 2
    for step in range(1, 4):
        g = _tree(10 + step)
        jl = jax.tree_util.tree_leaves(g)
        tl = port.flatten(jax.tree.map(torch.from_numpy, g))
        new_j = ref.step(jl, 1e-2, step)
        if step < 3:
            new_t = port.step(tl, 1e-2, step)
        else:
            got = {}
            assert port.step(tl, 1e-2, step,
                             consume=lambda i, p: got.setdefault(
                                 i, p.clone())) is None
            new_t = [got[i] for i in range(len(tl))]
        for a, b in zip(new_t, new_j):
            np.testing.assert_array_equal(a.numpy(), b)
    for tp, jp in zip(port.state_trees(), ref.state_trees()):
        for a, b in zip(port.flatten(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port.bytes_read > 0 and port.bytes_written > 0


def test_lazy_leaves_read_only_when_touched(tmp_path):
    """``state_trees(lazy=True)``: LazyNVMeLeaf leaves with their shape
    and dtype, each read (one leaf of one column) when materialized."""
    tree = jax.tree.map(torch.from_numpy, _tree(2))
    opt = tzi.NVMeOptimizer(str(tmp_path), "adamw", {"lr": 1e-2},
                            buffer_size=5000)
    opt.initialize(tree)
    reads = []
    orig = opt._read_leaf

    def counting(g, col, j):
        reads.append((g, col, j))
        return orig(g, col, j)

    opt._read_leaf = counting
    master, m, v = opt.state_trees(lazy=True)
    leaf = master["blocks"]["attn"]["wq"]
    assert isinstance(leaf, tzi.LazyNVMeLeaf) and reads == []
    assert leaf.shape == (2, 32, 4, 8) and leaf.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(leaf),
                                  tree["blocks"]["attn"]["wq"].numpy())
    assert len(reads) == 1 and reads[0][1] == 0
    np.testing.assert_array_equal(np.asarray(v["ln_f"]["bias"]),
                                  np.zeros(32, np.float32))
    assert reads[-1][1] == 2 and len(reads) == 2
    assert np.asarray(m["embed"]["table"], np.float64).dtype == np.float64
    full = opt.master_tree()
    np.testing.assert_array_equal(full["embed"]["table"].numpy(),
                                  tree["embed"]["table"].numpy())
