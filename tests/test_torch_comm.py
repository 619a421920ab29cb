"""The port's ``comm/`` (``deepspeed_tpu_torch/comm``) on four gloo ranks,
held against the JAX package's collectives under ``shard_map`` on the
virtual CPU mesh: JAX shard r is rank r's tensor.

Data movement (gathers, all-to-all, broadcast, the ring gather) is
bitwise; reductions agree within one ulp of the summands' magnitude; the
port's ``psum``-strategy tiles are bitwise its serial path and the ring
is exact but not bitwise, as ``tests/test_comm_overlap.py`` holds the
JAX ones.  The ranks are spawned once for the module
(``tests/torch_ranks.py``, which imports no JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.comm import comms_logging as jlog
from deepspeed_tpu.comm import overlap as jov
from deepspeed_tpu.comm.mesh import MeshTopology as JaxTopology
from deepspeed_tpu.compat import shard_map
from deepspeed_tpu.config.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu_torch.comm import comms_logging as plog
from deepspeed_tpu_torch.comm import overlap as pov
from deepspeed_tpu_torch.comm import init_distributed, get_rank, \
    get_world_size
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tests.torch_ranks import rank_pool

N = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = rank_pool(N, tmp_path_factory.mktemp("comm_store"))
    yield p
    p.close()


def _per_rank(body, xs, n=N):
    """``body`` on each device's shard of the stacked ``xs`` under
    ``shard_map``; each device's output, in device order."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    f = jax.jit(shard_map(lambda v: body(v[0])[None], mesh=mesh,
                          in_specs=P("x"), out_specs=P("x"),
                          check_vma=False))
    return list(np.asarray(f(np.stack(xs))))


def _per_rank2(body, xs, ws, n=N):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    f = jax.jit(shard_map(lambda a, b: body(a[0], b[0])[None], mesh=mesh,
                          in_specs=(P("x"), P("x")), out_specs=P("x"),
                          check_vma=False))
    return list(np.asarray(f(np.stack(xs), np.stack(ws))))


def _inputs(shape, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(N)]


def _sum_bound(xs):
    """One ulp of each element's summand magnitude sum."""
    return np.spacing(np.abs(np.stack(xs)).sum(0))


COLLECTIVES = {
    "all_reduce": ({}, lambda v: jax.lax.psum(v, "x"), "ulp"),
    "all_reduce_mean": ({"op": "mean"}, lambda v: jax.lax.psum(v, "x") / N,
                        "ulp"),
    "all_gather": ({}, lambda v: jax.lax.all_gather(v, "x", axis=0,
                                                    tiled=True), "bitwise"),
    "reduce_scatter": ({}, lambda v: jax.lax.psum_scatter(
        v, "x", scatter_dimension=0, tiled=True), "ulp"),
    "all_to_all": ({"split_dim": 0, "concat_dim": 1},
                   lambda v: jax.lax.all_to_all(v, "x", split_axis=0,
                                                concat_axis=1, tiled=True),
                   "bitwise"),
    "broadcast": ({"src": 2}, lambda v: jax.lax.psum(jnp.where(
        jax.lax.axis_index("x") == 2, v, jnp.zeros_like(v)), "x"),
        "bitwise"),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_match_jax(pool, name, devices):
    kwargs, body, how = COLLECTIVES[name]
    xs = _inputs((8, 6), seed=1)
    op = "all_reduce" if name.startswith("all_reduce") else name
    port = pool.run("collective", op, kwargs, per_rank=xs)
    ref = _per_rank(body, xs)
    bound = _sum_bound(xs)
    bounds = np.split(bound, N) if name == "reduce_scatter" else [bound] * N
    for p, r, b in zip(port, ref, bounds):
        assert p.shape == r.shape and p.dtype == r.dtype
        if how == "bitwise":
            np.testing.assert_array_equal(p, r)
        else:
            assert np.all(np.abs(p - r) <= b), np.abs(p - r).max()


LAX = {
    "lax_psum": ((), {}, lambda v: jax.lax.psum(v, "x"), "ulp"),
    "lax_pmean": ((), {}, lambda v: jax.lax.pmean(v, "x"), "ulp"),
    "lax_all_gather": ((), {"axis": 1}, lambda v: jax.lax.all_gather(
        v, "x", axis=1, tiled=True), "bitwise"),
    "lax_reduce_scatter": ((), {"scatter_dimension": 0},
                           lambda v: jax.lax.psum_scatter(
                               v, "x", scatter_dimension=0, tiled=True),
                           "ulp"),
    "lax_all_to_all": ((1, 0), {}, lambda v: jax.lax.all_to_all(
        v, "x", split_axis=1, concat_axis=0, tiled=True), "bitwise"),
    "lax_ppermute": (([(0, 1), (1, 2), (2, 3), (3, 0)],), {},
                     lambda v: jax.lax.ppermute(
                         v, "x", [(0, 1), (1, 2), (2, 3), (3, 0)]),
                     "bitwise"),
    "ring_all_gather": ((), {"axis": 1}, lambda v: jax.lax.all_gather(
        v, "x", axis=1, tiled=True), "bitwise"),
}


@pytest.mark.parametrize("name", sorted(LAX))
def test_rank_local_collectives_match_jax(pool, name, devices):
    args, kwargs, body, how = LAX[name]
    xs = _inputs((8, 12), seed=2)
    port = pool.run("overlap", name, kwargs, per_rank=[
        (x,) + args for x in xs])
    ref = _per_rank(body, xs)
    bound = _sum_bound(xs)
    bounds = (np.split(bound, N) if name == "lax_reduce_scatter"
              else [bound] * N)
    for p, r, b in zip(port, ref, bounds):
        assert p.shape == r.shape
        if how == "bitwise":
            np.testing.assert_array_equal(p, r)
        else:
            assert np.all(np.abs(p - r) <= b), np.abs(p - r).max()


@pytest.mark.parametrize("split,concat,shape", [(0, 1, (4, 6)),
                                                (1, 0, (6, 4))])
def test_untiled_all_to_all_matches_jax(pool, split, concat, shape, devices):
    """``tiled=False``: the split axis has one entry a rank, and the
    received entries stack along a new ``concat`` axis, bitwise."""
    xs = _inputs(shape, seed=7)
    port = pool.run("overlap", "lax_all_to_all", {"tiled": False},
                    per_rank=[(x, split, concat) for x in xs])
    ref = _per_rank(lambda v: jax.lax.all_to_all(
        v, "x", split, concat, tiled=False), xs)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)


def test_ring_reductions_exact_not_bitwise(pool, devices):
    """The ring rung: the same summands in a ring rotation's order —
    within rounding of the psum and of the JAX ring."""
    xs = _inputs((8, 12), seed=3)
    for fn, jfn, jref in (
            ("ring_reduce_scatter", lambda v: jov.ring_reduce_scatter(
                v, "x"), lambda v: jax.lax.psum_scatter(
                    v, "x", scatter_dimension=0, tiled=True)),
            ("ring_all_reduce", lambda v: jov.ring_all_reduce(v, "x"),
             lambda v: jax.lax.psum(v, "x"))):
        port = pool.run("overlap", fn, {}, per_rank=[(x,) for x in xs])
        for p, r, q in zip(port, _per_rank(jfn, xs), _per_rank(jref, xs)):
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(p, q, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlapped_matmul_allreduce_tiles_bitwise_serial(pool, dtype,
                                                          devices):
    """psum tiles bitwise the serial exact path at any tile count; the
    ring close to it; both close to the JAX package's."""
    rng = np.random.RandomState(4)
    xs = [rng.randn(48, 16).astype(np.float32) for _ in range(N)]
    ws = [rng.randn(16, 32).astype(np.float32) for _ in range(N)]
    out = pool.run("matmul_allreduce", dtype, (1, 2, 4, 6),
                   per_rank=list(zip(xs, ws)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = _per_rank2(lambda a, b: jov.overlapped_matmul_allreduce(
        a.astype(jdt), b.astype(jdt), "x", tiles=4).astype(jnp.float32),
        xs, ws)
    tol = 1e-5 if dtype == "float32" else 0.05
    for rank_out, r in zip(out, ref):
        serial = rank_out["serial"]
        for t, got in rank_out["psum"].items():
            np.testing.assert_array_equal(got, serial, err_msg=f"tiles {t}")
        for t, got in rank_out["ring"].items():
            np.testing.assert_allclose(got, serial, rtol=tol, atol=tol)
        np.testing.assert_allclose(serial, r, rtol=tol, atol=tol * 10)
    # every rank holds the same sum
    for rank_out in out[1:]:
        np.testing.assert_array_equal(rank_out["serial"], out[0]["serial"])


def test_overlapped_gather_all_reduce_reduce_scatter_bitwise(pool,
                                                             devices):
    rng = np.random.RandomState(5)
    xs = [rng.randn(24, 16).astype(np.float32) for _ in range(N)]
    ws = [rng.randn(16, 8).astype(np.float32) for _ in range(N)]
    out = pool.run("overlapped_family",
                   per_rank=[(xs[0], x, w) for x, w in zip(xs, ws)])
    jag = _per_rank2(lambda a, b: jov.overlapped_matmul_allgather(
        a, b, "x", tiles=4), [xs[0]] * N, ws)
    jar = _per_rank(lambda v: jax.lax.psum(v, "x"), xs)
    jrs = _per_rank(lambda v: jax.lax.psum_scatter(
        v, "x", scatter_dimension=1, tiled=True), xs)
    for r, o in enumerate(out):
        for t in (1, 2, 4, 5):
            np.testing.assert_array_equal(o["ag"][t], o["ag_serial"])
            np.testing.assert_array_equal(o["ar"][t], o["ar_serial"])
            np.testing.assert_array_equal(o["rs"][t], o["rs_serial"])
        np.testing.assert_allclose(o["ag_serial"], jag[r], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["ar_serial"], jar[r], rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(o["rs_serial"], jrs[r], rtol=1e-6,
                                   atol=1e-5)
        assert o["quant"].startswith("quant_bits=8: the quantized wire is "
                                     "not ported yet (ROADMAP Queue 1 "
                                     "item 6, the quantized collectives")


def test_mesh_groups_on_four_ranks(pool, devices):
    """Rank r stands where JAX device r stands (tensor innermost); each
    axis's group is the rank's line along it."""
    facts = pool.run("mesh_facts", {"tensor": 2, "fsdp": 2})
    jt = JaxTopology.build(JaxMeshConfig(tensor=2, fsdp=2),
                           devices=jax.devices()[:N])
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    jranks = np.vectorize(lambda d: ids[d.id])(jt.mesh.devices)
    for r, f in enumerate(facts):
        assert f["mesh"] == jranks.tolist()
        assert f["sizes"] == jt.axis_sizes
        where = np.argwhere(jranks == r)[0]
        assert [f["coords"][a] for a in jt.mesh.axis_names] == list(where)
    assert [f["lines"]["tensor"] for f in facts] == \
        [(0, 1), (0, 1), (2, 3), (2, 3)]
    assert [f["lines"]["fsdp"] for f in facts] == \
        [(0, 2), (1, 3), (0, 2), (1, 3)]
    assert [f["lines"]["data"] for f in facts] == [(r,) for r in range(N)]


def test_comms_logger_and_counters(pool):
    xs = _inputs((16,), seed=6)
    out = pool.run("logged_collectives", per_rank=xs)
    for o in out:
        assert o["table"]["all_reduce"] == {64: 2}
        assert o["table"]["all_gather"] == {64: 1}
        assert o["keys"] == 2 and o["calls"] == 2


def test_bench_sweep_and_overlap_leg(pool):
    out = pool.run("bench_small")
    recs, leg = out[0]
    assert [op for op, _, _ in recs] == [op for op in (
        "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
        "broadcast") for _ in range(2)]
    assert {n for _, _, n in recs} == {N}
    assert leg["devices"] == N and leg["comm_serial_ms"] > 0
    assert set(leg) >= {"comm_overlapped_ms", "comm_ring_ms",
                        "comm_overlap_speedup", "wire_bytes_exact"}
    assert leg["wire_bytes_exact"] == jov.wire_bytes(
        "all_reduce", 32 * 32, 4, N)
    # the rank-ordered sum all-gathers the partials: (N-1) x the payload
    assert leg["wire_bytes_sent"] == (N - 1) * 32 * 32 * 4


def test_accounting_functions_equal_jax():
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "broadcast", "psum"):
        for n in (1, 2, 4, 8):
            for q in (None, 4, 8):
                assert pov.wire_bytes(op, 1000, 2, n, q) == \
                    jov.wire_bytes(op, 1000, 2, n, q)
            assert plog.calc_bw_log(op, 1 << 20, 1e-3, n) == \
                jlog.calc_bw_log(op, 1 << 20, 1e-3, n)
    for rows in (0, 1, 7, 12, 48, 97):
        for tiles in (1, 2, 4, 6, 16):
            assert pov._resolve_tiles(rows, tiles) == \
                jov._resolve_tiles(rows, tiles)
    for shape in ((8, 12), (7, 5, 16), (4,), (12, 12, 3)):
        for sd in range(len(shape)):
            for tiles in (1, 2, 3, 4):
                assert pov._rs_tile_dim(shape, sd, tiles) == \
                    jov._rs_tile_dim(shape, sd, tiles)
    assert plog.convert_size(3 << 20) == jlog.convert_size(3 << 20)


def test_init_distributed_alone_is_a_no_op():
    """One process with no coordinator: nothing to join, as the JAX
    package's on one host."""
    init_distributed()
    assert get_world_size() == 1 and get_rank() == 0


def test_init_distributed_joins_again_after_destroy(tmp_path):
    """A group torn down with ``destroy_process_group`` can be joined
    again: ``init_distributed`` asks torch whether a group is up."""
    import torch.distributed as dist
    for i in range(2):
        init_distributed(f"file://{tmp_path}/store{i}", 1, 0, backend="gloo")
        assert dist.is_initialized() and get_world_size() == 1
        init_distributed(f"file://{tmp_path}/other{i}", 1, 0,
                         backend="gloo")          # up already: a no-op
        dist.destroy_process_group()
    assert not dist.is_initialized()
