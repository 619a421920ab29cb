"""Cases for spawned gloo ranks of the port's multi-process tests, without
JAX.

:func:`rank_pool` starts a ``deepspeed_tpu_torch.comm.ranks.RankPool`` of
``world`` processes (spawned once, one thread each, joined through a
``file://`` store) whose cases are the functions of this module:
``pool.run(case, *args)`` calls ``case(*args)`` on every rank and returns
each rank's result in rank order.  The ranks import this module, never a
test module, so no rank imports JAX.
"""

import os

import numpy as np
import torch

from deepspeed_tpu_torch.comm.ranks import RankPool

# one pool's ranks run their cases for at most this long (seconds)
CASE_TIMEOUT = 240


def rank_pool(world: int, store_dir, device: str = "cpu") -> RankPool:
    """``world`` gloo ranks running this module's cases (by the name this
    module was imported under, which the ranks import it by)."""
    store = os.path.join(str(store_dir), f"store{world}")
    return RankPool(world, __name__, init_method="file://" + store,
                    device=device, threads=1, timeout=CASE_TIMEOUT)


# --------------------------------------------------------------------------
# cases: comm/
# --------------------------------------------------------------------------

def _topology(mesh: dict):
    from deepspeed_tpu_torch.comm import MeshTopology
    from deepspeed_tpu_torch.config.config import MeshConfig
    return MeshTopology.build(MeshConfig(**mesh))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tensor_topology():
    import torch.distributed as dist
    return _topology({"data": 1, "tensor": dist.get_world_size()})


def collective(op: str, kwargs: dict, x):
    """One ``Collectives`` op on this rank's ``x`` over a ``data`` axis of
    the world."""
    from deepspeed_tpu_torch.comm import Collectives
    import torch.distributed as dist
    topo = _topology({"data": dist.get_world_size()})
    return getattr(Collectives(topo), op)(_t(x), **kwargs).numpy()


def overlap(fn: str, kwargs: dict, args: tuple):
    """``fn(x, "tensor", *rest, **kwargs)`` — a ring of ``comm.overlap``
    or a ``lax_*`` of ``comm.collectives`` — on this rank's ``args = (x,
    *rest)``, with the world as the tensor axis."""
    from deepspeed_tpu_torch.comm import collectives, overlap as ov
    f = getattr(ov, fn, None) or getattr(collectives, fn)
    return f(_t(args[0]), "tensor", *args[1:], topology=_tensor_topology(),
             **kwargs).numpy()


def matmul_allreduce(dtype: str, tiles, xw):
    """The row-parallel matmul + all-reduce: serial (the product, then
    the exact psum), then psum and ring tiles at each tile count."""
    from deepspeed_tpu_torch.comm import overlap as ov
    from deepspeed_tpu_torch.comm.collectives import exact_psum
    topo = _tensor_topology()
    dt = _DTYPES[dtype]
    x, w = (_t(a).to(dt) for a in xw)
    serial = exact_psum((x @ w).to(dt), topo.group("tensor"),
                        topo.tp_size)
    out = {"serial": serial.float().numpy(), "psum": {}, "ring": {}}
    for t in tiles:
        for strat in ("psum", "ring"):
            out[strat][t] = ov.overlapped_matmul_allreduce(
                x, w, "tensor", tiles=t, strategy=strat,
                topology=topo).float().numpy()
    return out


def overlapped_family(xwv):
    """The gather, all-reduce and reduce-scatter of ``comm.overlap`` at
    several tile counts beside their serial paths, and the quantized
    wire's refusal."""
    from deepspeed_tpu_torch.comm import overlap as ov
    from deepspeed_tpu_torch.comm.collectives import (exact_psum,
                                                      exact_reduce_scatter,
                                                      gather_dim)
    topo = _tensor_topology()
    g, n = topo.group("tensor"), topo.tp_size
    x0, x, w = (_t(a) for a in xwv)
    out = {"ag_serial": gather_dim(x0 @ w, 1, g, n).numpy(),
           "ar_serial": exact_psum(x, g, n).numpy(),
           "rs_serial": exact_reduce_scatter(x, 1, g, n).numpy(),
           "ag": {}, "ar": {}, "rs": {}}
    for t in (1, 2, 4, 5):
        out["ag"][t] = ov.overlapped_matmul_allgather(
            x0, w, "tensor", tiles=t, topology=topo).numpy()
        out["ar"][t] = ov.overlapped_all_reduce(
            x, "tensor", tiles=t, topology=topo).numpy()
        out["rs"][t] = ov.overlapped_reduce_scatter(
            x, "tensor", scatter_dim=1, tiles=t, topology=topo).numpy()
    try:
        ov.overlapped_all_reduce(x, "tensor", quant_bits=8, topology=topo)
        out["quant"] = "no error"
    except NotImplementedError as e:
        out["quant"] = str(e)
    return out


def mesh_facts(mesh: dict):
    """This rank's coordinates, group lines and the topology's sizes."""
    from deepspeed_tpu_torch.comm.mesh import AXIS_ORDER
    topo = _topology(mesh)
    return {"coords": topo.coords(), "sizes": dict(topo.axis_sizes),
            "lines": {a: topo.group_ranks(a) for a in AXIS_ORDER},
            "mesh": topo.mesh.tolist()}


# --------------------------------------------------------------------------
# cases: tensor-parallel serving
# --------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _engine(spec: dict, device: str = "cpu"):
    from deepspeed_tpu_torch.inference import InferenceConfig, \
        InferenceEngine
    from deepspeed_tpu_torch.models import Model, TransformerConfig
    from deepspeed_tpu_torch.models.transformer import params_from_numpy
    cfg = TransformerConfig(**spec["cfg"])
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    params = params_from_numpy(spec["params"], device=dev)
    model = Model.from_params(cfg, params, param_axes=spec.get("axes"))
    icfg = dict(spec["icfg"])
    for k in ("param_dtype", "kv_dtype"):
        if k in icfg:
            icfg[k] = _DTYPES[icfg[k]]
    topo = _topology(spec["mesh"]) if spec.get("mesh") else None
    return InferenceEngine(model, InferenceConfig(**icfg), topology=topo)


def serve(spec: dict, device: str = "cpu"):
    """Build the engine of ``spec`` (config, numpy weights, logical axes,
    inference config, mesh), take the first prefill step's logits when
    asked, then generate ``spec["prompts"]`` greedily.  Returns the
    tokens, the cache's per-rank shape and the logits."""
    from deepspeed_tpu_torch.inference import SamplingParams
    from deepspeed_tpu_torch.inference.model import ragged_forward
    eng = _engine(spec, device)
    out = {"kv_shape": tuple(eng.state.kv[0].shape if isinstance(
        eng.state.kv, tuple) else eng.state.kv.shape),
        "comm": eng._serving_comm is not None}
    if spec.get("logits"):
        uid, prompt = next(iter(spec["prompts"].items()))
        eng.put(uid, list(prompt))
        batch = eng.state.build_batch(eng._schedule(), eng.icfg.token_budget)
        # padded to the engine's token bucket, as a step is: its rows cut
        # into the comm plan's tiles
        batch = batch._replace(n_tokens=eng.token_bucket(batch.n_tokens))
        logits, _ = ragged_forward(
            eng.cfg, eng.params, eng.state.kv, batch,
            eng.icfg.kv_block_size, eng.max_blocks_per_seq, quant=eng._quant,
            mixed_gemm=eng._mixed_gemm_active, shard_mesh=eng._shard,
            comm=eng._serving_comm)
        out["logits"] = logits[0].float().cpu().numpy()
        return out
    toks = eng.generate({u: list(p) for u, p in spec["prompts"].items()},
                        SamplingParams(temperature=0.0,
                                       max_new_tokens=spec.get("new", 8)))
    out["tokens"] = {u: list(t) for u, t in toks.items()}
    return out


def logged_collectives(x):
    """Two profiled all-reduces and an all-gather: the comms logger's
    table and the Collectives counters."""
    from deepspeed_tpu_torch.comm import Collectives, comms_logger
    import torch.distributed as dist
    topo = _topology({"data": dist.get_world_size()})
    comms_logger.configure(enabled=True, prof_all=True)
    comms_logger.reset()
    col = Collectives(topo)
    for _ in range(2):
        col.all_reduce(_t(x))
    col.all_gather(_t(x))
    col.barrier()
    comms_logger.configure(enabled=False)
    table = comms_logger.log_all(print_log=False)
    m = col.metrics
    return {"table": {op: {size: rec["count"] for size, rec in v.items()}
                      for op, v in table.items()},
            "keys": m.counter("training_comm_collective_compiles_total")
            .value(),
            "calls": m.counter("training_comm_collective_calls_total")
            .value(op="all_reduce")}


def bench_small():
    """A tiny collective sweep and overlap leg on the CPU ranks."""
    from deepspeed_tpu_torch.comm import bench
    recs = bench.sweep(list(bench.OPS), 10, 11, trials=2, warmups=1,
                       dtype="float32", print_table=False, device="cpu")
    leg = bench.overlap_bench(rows=32, k=64, nmodel=32, tiles=4, trials=2,
                              warmups=1, device="cpu")
    return [(r["op"], r["bytes"], r["devices"]) for r in recs], leg


# --------------------------------------------------------------------------
# cases: K2-TP on the card (each rank's head group)
# --------------------------------------------------------------------------

def _k2_batch(H, Hkv, D, bs, nblk, seed, dev):
    """Two prefill chunks and decode rows at several contexts, one decode
    row's table aliasing the first chunk's leading blocks."""
    r = np.random.RandomState(seed)
    free = list(r.permutation(nblk))
    seqs = [(0, 128), (64, 96)] + [(c - 1, 1) for c in
                                   (1, 2, 63, 65, 200, 511, 777, 1000)]
    tables = np.full((len(seqs) + 1, nblk), -1, np.int32)
    slot, pos = [], []
    for s, (start, n) in enumerate(seqs):
        k = -(-(start + n) // bs)
        tables[s, :k] = [free.pop() for _ in range(k)]
        slot += [s] * n
        pos += list(range(start, start + n))
    tables[len(seqs) - 1, :2] = tables[0, :2]
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = torch.randn((nblk + 1, bs, 2, Hkv, D), generator=g, device=dev,
                     dtype=torch.bfloat16)
    q = torch.randn((len(pos), H, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    return kv, q, t(slot), t(pos), t(tables)


def k2_tp(seed: int, kv_quant):
    """Llama-3-8B's attention heads (32 over 8, D 128) under tensor=2: this
    rank runs K2 on its 16 query heads over its 4 KV heads (an int8
    cache's codes and scales cut with them), against the plain version on
    the same slice; the noise floor is the plain version in bf16 against
    it in fp32.  The ranks' outputs gathered over gloo are the full
    heads' kernel output within twice the tolerance (each is within it
    of its fp32 plain version)."""
    import importlib

    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.collectives import gather_dim
    from deepspeed_tpu_torch.inference.model import _quantize_kv
    # the module (the package's attribute of that name is the function)
    pam = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    topo = _tensor_topology()
    tp, r = topo.tp_size, topo.axis_rank("tensor")
    dev = torch.device("cuda", torch.cuda.current_device())
    H, Hkv, D, bs, nblk = 32, 8, 128, 64, 64
    kv, q, slot, pos, tables = _k2_batch(H, Hkv, D, bs, nblk, seed, dev)
    if kv_quant:
        kv = _quantize_kv(kv, torch.int8)            # (codes, scales)
    hq, hk = H // tp, Hkv // tp

    def heads(x, lo, n, dim):
        return x.narrow(dim, lo, n).contiguous()

    if kv_quant:
        kv_r = (heads(kv[0], r * hk, hk, 3), heads(kv[1], r * hk, hk, 3))
    else:
        kv_r = heads(kv, r * hk, hk, 3)
    q_r = heads(q, r * hq, hq, 1)
    args = (slot, pos, tables, bs, 1024 // bs, D ** -0.5)
    count = pam.paged_attention
    before = count.launches + count.int8_launches
    out = pam.paged_attention(kv_r, q_r, *args)
    launched = count.launches + count.int8_launches - before
    ref = pam.paged_attention_plain(kv_r, q_r, *args)
    wide_kv = (kv_r if kv_quant else kv_r.float())
    wide = pam.paged_attention_plain(wide_kv, q_r.float(), *args)
    noise = float((ref.double() - wide.double()).abs().max())
    err = float((out.double() - wide.double()).abs().max())
    full = pam.paged_attention(kv, q, *args)
    gathered = gather_dim(out, 1, topo.group("tensor"), tp)
    torch.cuda.synchronize()
    assert dist.get_backend() == "gloo"
    return dict(err=err, noise=noise, launched=launched,
                finite=bool(torch.isfinite(out).all()),
                gathered_err=float((gathered.double() - full.double())
                                   .abs().max()),
                shape=tuple(out.shape))
