"""The aux subsystems of the port held against the JAX package:
``runtime_utils.partition_balanced``, the elasticity plans (v0.1, v0.2)
and fingerprint, the autotuner's space, memory model, pruning and three
tuners (on a synthetic run function), ``autotune(device="cpu")`` on a tiny
GPT-2, the launcher's SSH/PDSH/Slurm/local commands (the module name
swapped), a two-rank gloo group joined through
``init_distributed_from_env``, the elastic restart loop, the training
engine with an ``elasticity`` block, and ``env_report``.

Tolerance: every plan, space, ranking and command equal; the engine's
first step with and without the elasticity block bitwise, and against the
JAX engine at the trajectory tests' 1e-5."""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import deepspeed_tpu_torch as tds
from deepspeed_tpu import elasticity as jel
from deepspeed_tpu.autotuning import autotuner as jat
from deepspeed_tpu.autotuning import tuner as jtu
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.launcher import runner as jrun
from deepspeed_tpu.runtime import runtime_utils as jru
from deepspeed_tpu_torch import elasticity as pel
from deepspeed_tpu_torch.autotuning import autotuner as pat
from deepspeed_tpu_torch.autotuning import tuner as ptu
from deepspeed_tpu_torch.launcher import runner as prun
from deepspeed_tpu_torch.runtime import runtime_utils as pru
from tests.test_torch_train import jax_engine, tiny_models
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("parts", [1, 3, 7, 40])
def test_partition_balanced_matches_jax(seed, parts):
    r = np.random.RandomState(seed)
    w = list(r.randint(1, 100, 5 + 6 * seed).astype(float))
    assert pru.partition_balanced(w, parts) == jru.partition_balanced(w,
                                                                      parts)
    with pytest.raises(ValueError):
        pru.partition_balanced(w, 0)


def test_see_memory_usage_without_a_card():
    """The JAX package reports the devices that have memory stats; the
    CPU has none, and no card means none here."""
    assert pru.see_memory_usage("x", force=True) == {}


ELASTIC = {
    "v01": {"enabled": True, "max_train_batch_size": 100,
            "micro_batch_sizes": [2, 4], "min_devices": 1,
            "max_devices": 8, "version": 0.1},
    "v02": {"enabled": True, "max_train_batch_size": 100,
            "micro_batch_sizes": [2, 4], "min_devices": 1,
            "max_devices": 8, "version": 0.2},
    "v02-mp": {"enabled": True, "max_train_batch_size": 2000,
               "micro_batch_sizes": [2, 4, 6], "min_devices": 8,
               "max_devices": 64, "version": 0.2, "model_parallel_size": 2,
               "devices_per_node": 8, "prefer_larger_batch": False},
}


@pytest.mark.parametrize("case", sorted(ELASTIC))
def test_elastic_plans_match_jax(case):
    cfg = {"elasticity": ELASTIC[case]}
    want = jel.compute_elastic_config(cfg)
    assert pel.compute_elastic_config(cfg) == want
    for world in want[1][:3]:
        assert pel.compute_elastic_config(cfg, world_size=world) == \
            jel.compute_elastic_config(cfg, world_size=world)
    bad = max(want[1]) + 1
    for mod in (jel, pel):
        with pytest.raises(mod.ElasticityError):
            mod.compute_elastic_config(cfg, world_size=bad)
    assert pel.get_candidate_batch_sizes([2, 3], 5) == \
        jel.get_candidate_batch_sizes([2, 3], 5)
    assert pel.get_valid_devices(24, [2, 4], 1, 16) == \
        jel.get_valid_devices(24, [2, 4], 1, 16)


def test_elastic_fingerprint_matches_jax():
    c1 = {"elasticity": {"enabled": True, "max_train_batch_size": 64}}
    fp = pel.elasticity_fingerprint(c1)
    assert fp == jel.elasticity_fingerprint(c1)
    pel.ensure_immutable(c1, fp)
    c2 = copy.deepcopy(c1)
    c2["elasticity"]["max_train_batch_size"] = 128
    with pytest.raises(pel.ElasticityError):
        pel.ensure_immutable(c2, fp)
    with pytest.raises(pel.ElasticityError):
        pel.compute_elastic_config({"elasticity": {"enabled": False}})


MESHES = [{"data": 8, "fsdp": 1, "tensor": 1},
          {"data": 1, "fsdp": 8, "tensor": 1},
          {"data": 2, "fsdp": 2, "tensor": 2}]


def _overrides(space):
    return [(e.label(), e.overrides) for e in space]


@pytest.mark.parametrize("n", [1, 4, 8])
def test_space_and_memory_model_match_jax(n):
    assert pat.mesh_factorizations(n) == jat.mesh_factorizations(n)
    assert pat.mesh_factorizations(n, max_tensor=2) == \
        jat.mesh_factorizations(n, max_tensor=2)
    assert _overrides(pat.build_space(n)) == _overrides(jat.build_space(n))
    for stage in range(4):
        for mesh in MESHES:
            assert pat.estimate_state_bytes(10**9, stage, mesh) == \
                jat.estimate_state_bytes(10**9, stage, mesh)
    a, b = pat.build_space(n), jat.build_space(n)
    alive_p = pat.prune_by_memory(a, 10**9, hbm_bytes=24 << 30)
    alive_j = jat.prune_by_memory(b, 10**9, hbm_bytes=24 << 30)
    assert _overrides(alive_p) == _overrides(alive_j)
    assert [(e.pruned, e.est_state_bytes) for e in a] == \
        [(e.pruned, e.est_state_bytes) for e in b]


def test_one_card_space_is_micro_batch_by_remat():
    space = pat.build_space(1)
    assert {e.overrides["zero_stage"] for e in space} == {0}
    assert len(space) == 4 * len(pat.REMAT_CHOICES)
    from deepspeed_tpu_torch.models.transformer import REMAT_POLICIES
    assert set(pat.REMAT_CHOICES) <= set(REMAT_POLICIES)


def _fake_run(times):
    def run(e):
        t = times.get(e.label())
        if t is None:
            e.error = "boom"
        else:
            e.step_time_s = t
        return e
    return run


TUNERS = {"grid": (jtu.GridTuner, ptu.GridTuner, {}),
          "random": (jtu.RandomTuner, ptu.RandomTuner, {"seed": 1}),
          "model": (jtu.ModelBasedTuner, ptu.ModelBasedTuner, {"seed": 0})}


@pytest.mark.parametrize("name", sorted(TUNERS))
@pytest.mark.parametrize("budget", [3, 6])
def test_tuners_match_jax(name, budget):
    """Each tuner measures the same experiments in the same order on a
    synthetic run function (a step time that favours large micro-batches,
    one label failing)."""
    jcls, pcls, kw = TUNERS[name]

    def space(mod):
        return mod.build_space(8, stages=(0, 1), micro_batches=(1, 2, 4, 8),
                               remat_policies=("nothing", "dots_no_batch"),
                               meshes=MESHES[:2])

    times = {e.label(): 10.0 / e.overrides["micro_batch"]
             + 0.1 * e.overrides["zero_stage"] for e in space(jat)}
    times.pop(space(jat)[3].label())
    want = jcls(space(jat), _fake_run(times), **kw).tune(budget)
    got = pcls(space(pat), _fake_run(times), **kw).tune(budget)
    assert [(e.label(), e.step_time_s, e.error) for e in got] == \
        [(e.label(), e.step_time_s, e.error) for e in want]


def test_autotune_on_the_cpu_ranks_every_experiment():
    """A real search on a tiny GPT-2: micro-batches {1, 2} x remat
    {nothing, everything}, the model tuner, budget 4, 2 timed steps."""
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime import param_count

    def model_fn(remat_policy):
        return build_model("gpt2", device="cpu", num_layers=2, d_model=32,
                           num_heads=2, vocab_size=64, max_seq_len=16,
                           attention_impl="xla",
                           remat=remat_policy != "nothing",
                           remat_policy=remat_policy)

    def batch_fn(bs):
        return {"input_ids": np.random.RandomState(0).randint(0, 64,
                                                              (bs, 16))}

    base = {"optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "steps_per_print": 10_000}
    ranked = pat.autotune(
        model_fn, base, batch_fn,
        n_params=param_count(model_fn("nothing").params),
        tuner="model", budget=4, steps=2, device="cpu",
        micro_batches=(1, 2), remat_policies=("nothing", "everything"))
    assert len(ranked) == 4 and all(e.ok for e in ranked), \
        [e.error or e.pruned for e in ranked]
    ts = [e.step_time_s for e in ranked]
    assert ts == sorted(ts)
    assert all(e.compile_time_s is not None and e.flops_per_step > 0
               and e.peak_bytes is None for e in ranked)
    # the flop count grows with the micro-batch, not with remat
    flops = {(e.overrides["micro_batch"], e.overrides["remat_policy"]):
             e.flops_per_step for e in ranked}
    assert flops[2, "nothing"] > flops[1, "nothing"]


def _runner_args(mod, *extra):
    return mod.build_parser().parse_args(
        ["--master_port", "12345", *extra, "train.py", "--lr", "0.1"])


def _swap(cmds):
    return [(h, [c.replace("deepspeed_tpu.launcher.launch",
                           "deepspeed_tpu_torch.launcher.launch")
                 for c in cmd]) for h, cmd in cmds]


@pytest.mark.parametrize("name", ["local", "ssh", "pdsh", "slurm"])
def test_runner_commands_match_jax(name):
    hostfile = "h0 slots=2\nh1 slots=2\n# a comment\nh2"
    got, want = [], []
    for mod, out in ((prun, got), (jrun, want)):
        hosts = mod.parse_hostfile(hostfile)
        hosts = mod.parse_inclusion_exclusion(hosts, exclude="h2")
        r = mod.RUNNERS[name](_runner_args(mod, "--master_addr", "h0"),
                              hosts)
        r.add_export("NCCL_DEBUG", "WARN")
        out.extend(r.launch_cmds())
    assert got == _swap(want)
    assert any("deepspeed_tpu_torch.launcher.launch" in " ".join(c)
               for _, c in got)
    assert prun.parse_inclusion_exclusion(
        prun.parse_hostfile(hostfile), include="h[0-1]:0") == \
        jrun.parse_inclusion_exclusion(jrun.parse_hostfile(hostfile),
                                       include="h[0-1]:0")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_group_through_the_env(tmp_path):
    """Two processes with the runner's DSPD_* environment join one group
    (backend unset: gloo for CPU tensors) and all-reduce."""
    code = ("import torch, torch.distributed as dist\n"
            "from deepspeed_tpu_torch.launcher.launch import "
            "init_distributed_from_env\n"
            "init_distributed_from_env()\n"
            "x = torch.tensor([float(dist.get_rank() + 1)])\n"
            "dist.all_reduce(x)\n"
            "print('RESULT', dist.get_rank(), dist.get_world_size(), "
            "dist.get_backend_config(), float(x[0]), flush=True)\n"
            "dist.destroy_process_group()\n")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=str(REPO), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=str(REPO),
                 DSPD_COORDINATOR=f"127.0.0.1:{port}",
                 DSPD_NUM_PROCESSES="2", DSPD_PROCESS_ID=str(rank)))
        for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (out, err) in enumerate(outs):
        assert f"RESULT {rank} 2 cpu:gloo" in out and out.strip().endswith(
            " 3.0"), err


def _run_runner(*args):
    return subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", *args],
        capture_output=True, text=True, timeout=180, cwd=str(REPO))


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    """--elastic_training relaunches a crashed worker group; the script
    resumes from its 'latest' checkpoint: no gap, no redo."""
    ckpt, log = tmp_path / "latest", tmp_path / "steps.log"
    script = tmp_path / "train.py"
    script.write_text(f"""
import os, sys
ckpt, log = {str(ckpt)!r}, {str(log)!r}
start = int(open(ckpt).read()) if os.path.exists(ckpt) else 0
for step in range(start + 1, 7):
    with open(log, "a") as f:
        f.write(f"{{step}}\\n")
    with open(ckpt, "w") as f:
        f.write(str(step))
    if step == 3 and not os.path.exists(ckpt + ".crashed"):
        open(ckpt + ".crashed", "w").write("1")
        sys.exit(17)                      # a simulated node failure
print("DONE", flush=True)
""")
    out = _run_runner("--elastic_training", "--max_elastic_restarts", "3",
                      str(script))
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "DONE" in out.stdout
    assert [int(x) for x in log.read_text().split()] == [1, 2, 3, 4, 5, 6]


def test_elastic_budget_exhausted(tmp_path):
    script = tmp_path / "always_fail.py"
    script.write_text("import sys; sys.exit(9)")
    out = _run_runner("--elastic_training", "--max_elastic_restarts", "2",
                      str(script))
    assert out.returncode == 9
    assert out.stderr.count("restart") >= 2


def test_engine_takes_the_elasticity_block_as_jax_does():
    """The engine accepts ``elasticity`` and reads none of it: the first
    step bitwise the step without the block, and the JAX engine's (with
    the block) at 1e-5."""
    jm, tm = tiny_models("gpt2")
    _, tm2 = tiny_models("gpt2")
    base = {"train_batch_size": 2, "steps_per_print": 1000,
            "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
            "mesh": {"data": 1}}
    cfg = dict(base, elasticity={"enabled": True, "max_train_batch_size": 8,
                                 "micro_batch_sizes": [2]})
    batch = {"input_ids": np.random.RandomState(0).randint(0, 256, (2, 32))}
    with_block = tds.initialize(model=tm, config=dict(cfg), device="cpu")
    without = tds.initialize(model=tm2, config=dict(base), device="cpu")
    assert with_block.config.elasticity.enabled
    a = with_block.train_batch(dict(batch))
    b = without.train_batch(dict(batch))
    assert float(a["loss"]) == float(b["loss"])
    assert float(a["grad_norm"]) == float(b["grad_norm"])
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    j = jax_engine(jm, cfg, topo).train_batch(dict(batch))
    np.testing.assert_allclose(float(a["loss"]), float(j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(a["grad_norm"]), float(j["grad_norm"]),
                               rtol=1e-5)


def test_env_report_runs_without_a_card(capsys):
    from deepspeed_tpu_torch.env_report import main
    assert main() == 0
    out = capsys.readouterr().out
    for row in ("python", "torch", "devices", "nvcc toolchain", "triton",
                "paged_attention", "mixed_gemm", "async_io"):
        assert f"\n{row}." in out, row
