"""The port (``deepspeed_tpu_torch``) stands alone: it imports neither JAX
nor any module of the JAX package (``deepspeed_tpu`` — mind the shared
name prefix), and no entry point quietly runs on the CPU when it was not
asked to."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deepspeed_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "deepspeed_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch."))


def test_fresh_interpreter_imports_no_jax():
    mods = _modules()
    assert "deepspeed_tpu_torch.inference.engine" in mods
    for sub in ("checkpoint.engine", "checkpoint.hf", "parallel.moe",
                "ops.aio", "runtime.swap_tensor", "runtime.zero_infinity",
                "runtime.param_stream", "telemetry.tracer", "telemetry.flight",
                "telemetry.anomaly", "telemetry.slo", "telemetry.device",
                "telemetry.profiler", "monitor.monitor", "serving.placement",
                "serving.replica", "serving.fleet_telemetry",
                "serving.router", "serving.autoscaler", "gateway.protocol",
                "gateway.sloclass", "gateway.server", "gateway.__main__",
                "linear.optimized_linear", "compression.compress",
                "profiling.flops_profiler", "runtime.hybrid_engine",
                "runtime.data_pipeline", "runtime.indexed_dataset",
                "runtime.data_analyzer", "runtime.eigenvalue",
                "runtime.quantize", "runtime.progressive_layer_drop",
                "ops.xla_attention", "ops.spatial", "ops.sparse_attention",
                "ops.evoformer", "models.diffusion", "models.encoder",
                "models.clip", "elasticity", "elasticity.elasticity",
                "env_report", "autotuning", "autotuning.autotuner",
                "autotuning.tuner", "launcher", "launcher.runner",
                "launcher.launch", "comm", "comm.mesh", "comm.collectives",
                "comm.overlap", "comm.bench", "comm.comms_logging",
                "comm.ranks", "parallel.sharding"):
        assert f"deepspeed_tpu_torch.{sub}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_ast_scan_finds_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_raise_without_a_card(monkeypatch):
    """``device=None`` means the card; with no card it raises."""
    from deepspeed_tpu_torch.inference.ragged.state import KVCacheConfig
    from deepspeed_tpu_torch.models import build_model, params_from_numpy
    from deepspeed_tpu_torch.platform.cuda import (NoCudaDeviceError,
                                                   default_device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        default_device()
    with pytest.raises(NoCudaDeviceError):
        build_model("llama-tiny", num_layers=1)
    with pytest.raises(NoCudaDeviceError):
        build_model("llama-tiny", num_layers=1, device="cuda")
    with pytest.raises(NoCudaDeviceError):
        params_from_numpy({"w": [1.0]})
    with pytest.raises(NoCudaDeviceError):
        KVCacheConfig(num_layers=1, num_kv_heads=1, head_dim=8).kv_zeros()
    # asked for explicitly, the CPU works
    assert build_model("llama-tiny", num_layers=1, d_model=32, num_heads=4,
                       num_kv_heads=2, d_ff=64, vocab_size=64,
                       device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result here (no CUDA),
    and alone in a directory without the package."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((REPO, REPO / "chip_smoke.py"))
    for cwd, script in runs:
        r = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
