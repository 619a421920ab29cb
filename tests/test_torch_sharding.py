"""The port's mesh layout and logical-axis sharding rules
(``deepspeed_tpu_torch/comm/mesh.py``, ``parallel/sharding.py``) held
against the JAX package's on the virtual 8-device CPU mesh, in one
process: the specs equal entry for entry, and the slice a rank cuts is
the shard JAX places on the device of the same index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from deepspeed_tpu.comm import mesh as jmesh
from deepspeed_tpu.config.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu.models.transformer import Model as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.parallel import sharding as jshd
from deepspeed_tpu_torch.comm import mesh as pmesh
from deepspeed_tpu_torch.config.config import MeshConfig
from deepspeed_tpu_torch.models import Model, TransformerConfig
from deepspeed_tpu_torch.models.transformer import param_axes, param_shapes
from deepspeed_tpu_torch.parallel import sharding as pshd
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

MESHES = [dict(tensor=2), dict(tensor=2, fsdp=2), dict(tensor=4, fsdp=2),
          dict(data=2, fsdp=2, tensor=2), dict(fsdp=8), dict(tensor=8),
          dict(pipe=2, expert=2, tensor=2)]

CONFIGS = {
    "llama-gqa": dict(vocab_size=256, d_model=64, num_layers=2, num_heads=8,
                      num_kv_heads=4, d_ff=192, max_seq_len=128,
                      gated_mlp=True, norm="rmsnorm", tie_embeddings=False),
    "gpt2-tied": dict(vocab_size=250, d_model=96, num_layers=2, num_heads=6,
                      num_kv_heads=6, d_ff=384, max_seq_len=128,
                      position="learned", attn_bias=True, mlp_bias=True),
    "bloom-alibi": dict(vocab_size=256, d_model=64, num_layers=3,
                        num_heads=4, num_kv_heads=4, d_ff=256,
                        max_seq_len=128, position="alibi", embed_norm=True,
                        attn_bias=True, head_bias=True,
                        tie_embeddings=False, attention_impl="xla"),
    "moe": dict(vocab_size=256, d_model=64, num_layers=2, num_heads=4,
                num_kv_heads=2, d_ff=128, max_seq_len=64, num_experts=4,
                moe_shared_ff=64, gated_mlp=True),
}


def _topos(mesh):
    n = int(np.prod(list(mesh.values())))
    jt = jmesh.MeshTopology.build(JaxMeshConfig(**mesh),
                                  devices=jax.devices()[:n])
    pt = pmesh.MeshTopology.build(MeshConfig(**mesh), devices=list(range(n)))
    return jt, pt


@pytest.fixture(scope="module")
def jax_models():
    return {k: JaxModel(JaxConfig(**kw), seed=0) for k, kw in CONFIGS.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_axes_and_shapes_are_the_jax_trees(jax_models, name):
    jm = jax_models[name]
    cfg = TransformerConfig(**CONFIGS[name])
    assert param_axes(cfg) == jm.param_axes
    assert param_shapes(cfg) == jax.tree.map(lambda x: tuple(x.shape),
                                             jm.params)
    # a model's axes: its own, or inferred (every dim None) from_params
    assert Model(cfg, device="cpu").param_axes == jm.param_axes
    m = Model.from_params(cfg, Model(cfg, device="cpu").params)
    assert m.param_axes == jax.tree.map(
        lambda x: (None,) * x.ndim, jm.params)
    assert m.param_axes == jshd.infer_logical_axes(jm.params)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_mesh_sizes_and_layout_equal_jax(mesh, devices):
    jt, pt = _topos(mesh)
    assert pt.axis_sizes == jt.axis_sizes
    for prop in ("dp_world_size", "device_count", "pp_size", "tp_size",
                 "sp_size", "ep_size"):
        assert getattr(pt, prop) == getattr(jt, prop), prop
    assert pt.active_axes() == jt.active_axes()
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    assert pt.mesh.tolist() == np.vectorize(lambda d: ids[d.id])(
        jt.mesh.devices).tolist()
    for extra in (False, True):
        assert tuple(pt.batch_spec(extra)) == tuple(jt.batch_spec(extra))
    assert tuple(pt.replicated) == tuple(jt.replicated.spec) == ()
    assert tuple(pt.sharding("tensor", None)) == tuple(
        jt.sharding("tensor", None).spec)
    # a rank's coordinates are its place in the row-major mesh
    for r in range(pt.device_count):
        c = pt.coords(r)
        assert pt.mesh[tuple(c[a] for a in pmesh.AXIS_ORDER)] == r


def test_mesh_inference_and_errors_match_jax(devices):
    for cfg, n in ((dict(fsdp=4), 8), (dict(tensor=2, data=-1), 8),
                   (dict(data=1, seq=2), 2)):
        jt = jmesh.MeshTopology.build(JaxMeshConfig(**cfg),
                                      devices=jax.devices()[:n])
        pt = pmesh.MeshTopology.build(MeshConfig(**cfg),
                                      devices=list(range(n)))
        assert pt.axis_sizes == jt.axis_sizes
    for cfg, n in ((dict(data=3, fsdp=4), 8), (dict(data=-1, fsdp=-1), 8),
                   (dict(tensor=3), 8)):
        with pytest.raises(ValueError) as je:
            jmesh.MeshTopology.build(JaxMeshConfig(**cfg),
                                     devices=jax.devices()[:n])
        with pytest.raises(ValueError) as pe:
            pmesh.MeshTopology.build(MeshConfig(**cfg),
                                     devices=list(range(n)))
        assert str(pe.value) == str(je.value)
    # one device, no process group: every axis 1, no group
    one = pmesh.MeshTopology.build(MeshConfig())
    assert one.device_count == 1 and one.group("tensor") is None
    assert one.axis_rank("tensor") == 0


def test_split_outer_and_hybrid_arrangement():
    for shape, k in (((1, 2, 2, 1, 1, 2), 2), ((2, 4, 1, 1, 1, 2), 4),
                     ((1, 8, 1, 1, 1, 1), 8), ((1, 1, 3, 1, 1, 2), 3)):
        assert pmesh._split_outer(shape, k) == jmesh._split_outer(shape, k)
    with pytest.raises(ValueError) as je:
        jmesh._split_outer((1, 1, 1, 1, 1, 4), 3)
    with pytest.raises(ValueError) as pe:
        pmesh._split_outer((1, 1, 1, 1, 1, 4), 3)
    assert str(pe.value) == str(je.value)
    # ranks numbered node by node: each node's ranks are one contiguous
    # block of the inner axes (data=2 x tensor=4 over nodes of 4 and 2)
    for per_node in (4, 2):
        arr = pmesh._arrange_devices(list(range(8)), (1, 2, 1, 1, 1, 4),
                                     per_node)
        assert arr.reshape(2, 4).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError):     # 4 nodes cannot split (3, 3)
        pmesh._arrange_devices(list(range(9)), (1, 1, 1, 1, 3, 3), 2)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_specs_equal_jax_spec_for_spec(jax_models, mesh, devices):
    jt, pt = _topos(mesh)
    for name, jm in jax_models.items():
        shapes = jax.tree.map(lambda x: tuple(x.shape), jm.params)
        axes = param_axes(TransformerConfig(**CONFIGS[name]))
        js = jshd.tree_specs(jm.param_axes, jt, shapes=shapes)
        ps = pshd.tree_specs(axes, pt, shapes=shapes)
        jl = jax.tree.leaves(js, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        pl = jax.tree.leaves(ps, is_leaf=lambda x: isinstance(
            x, pmesh.PartitionSpec))
        assert [tuple(s) for s in pl] == [tuple(s) for s in jl], name
        # without shapes (no divisibility check) too
        assert [tuple(s) for s in jax.tree.leaves(
            pshd.tree_specs(axes, pt), is_leaf=lambda x: isinstance(
                x, pmesh.PartitionSpec))] == [tuple(s) for s in jax.tree.leaves(
                    jshd.tree_specs(jm.param_axes, jt), is_leaf=lambda x:
                    isinstance(x, jax.sharding.PartitionSpec))], name
        # the fsdp layer and the engine's generic memory shards
        for (p, j), shp in zip(zip(pl, jl), jax.tree.leaves(
                shapes, is_leaf=lambda x: isinstance(x, tuple))):
            for ms in (0, 1 << 10, 1 << 14):
                for axis in ("fsdp", "tensor"):
                    a = pshd.add_fsdp_to_spec(p, shp, pt, min_size=ms,
                                              axis=axis)
                    b = jshd.add_fsdp_to_spec(j, shp, jt, min_size=ms,
                                              axis=axis)
                    assert tuple(a) == tuple(b), (name, shp, ms, axis)
                    g = pshd.add_fsdp_to_spec(
                        pmesh.PartitionSpec(), shp, pt, min_size=ms,
                        axis=axis)
                    h = jshd.add_fsdp_to_spec(
                        jax.sharding.PartitionSpec(), shp, jt, min_size=ms,
                        axis=axis)
                    assert tuple(g) == tuple(h)


@pytest.mark.parametrize("mesh", [dict(tensor=2, fsdp=2),
                                  dict(tensor=4, fsdp=2),
                                  dict(data=2, fsdp=2, tensor=2)],
                         ids=["t2f2", "t4f2", "d2f2t2"])
def test_rank_slices_are_the_jax_shards(jax_models, mesh, devices):
    """The slice rank r cuts (``named``) is the shard JAX places on device
    r of the same mesh, for every leaf's spec with fsdp layered on."""
    jt, pt = _topos(mesh)
    jm = jax_models["llama-gqa"]
    shapes = jax.tree.map(lambda x: tuple(x.shape), jm.params)
    js = jshd.tree_specs(jm.param_axes, jt, shapes=shapes)
    leaves = jax.tree.leaves(jm.params)
    specs = jax.tree.leaves(js, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    for x, js_ in zip(leaves, specs):
        js_ = jshd.add_fsdp_to_spec(js_, x.shape, jt, min_size=16)
        ps_ = pmesh.PartitionSpec(*js_)
        placed = jax.device_put(x, NamedSharding(jt.mesh, js_))
        full = np.asarray(x)
        assert pshd.local_shape(full.shape, ps_, pt) == \
            placed.addressable_shards[0].data.shape
        for sh in placed.addressable_shards:
            r = ids[sh.device.id]
            np.testing.assert_array_equal(
                pshd.local_slice(full, ps_, pt, rank=r), np.asarray(sh.data))
    # tree_named: the cut functions over a spec tree
    cuts = pshd.tree_named(pt, pshd.tree_specs(
        jm.param_axes, pt, shapes=shapes))
    wq = np.asarray(jm.params["blocks"]["attn"]["wq"])
    assert cuts["blocks"]["attn"]["wq"](wq).shape == (
        2, 64, 8 // pt.tp_size, 8)


def test_infer_logical_axes_on_torch_and_numpy_trees(jax_models):
    jm = jax_models["gpt2-tied"]
    np_tree = jax.tree.map(np.asarray, jm.params)
    assert pshd.infer_logical_axes(np_tree) == \
        jshd.infer_logical_axes(jm.params)
    m = Model(TransformerConfig(**CONFIGS["gpt2-tied"]), device="cpu")
    assert pshd.infer_logical_axes(m.params) == \
        jshd.infer_logical_axes(jm.params)
    assert pshd.DEFAULT_RULES == {k: tuple(v) for k, v in
                                  jshd.DEFAULT_RULES.items()}
    assert jnp.float32   # the JAX package's trees above are fp32
