"""A capture window armed through the gateway, in a fresh process.

The gateway runs its engine on a worker thread, so a ``POST
/debug/capture`` window opens its ``torch.profiler`` session there.
Each case runs a new Python process, so that no session has run in it
before the ones the library opens itself: a gateway user's process,
with nothing primed by the caller.  The ``cuda`` case needs the card
(the window's device track holds its kernels) and skips without one;
the CPU case runs anywhere.  This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gateway_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a tiny engine behind the gateway (argv: flight dir, device): one
# request warms the graphs, the ops plane arms a window, a second
# request runs through it
_SCRIPT = r'''
import json, sys, threading
import torch
from deepspeed_tpu_torch.gateway import GatewayConfig, spawn_gateway
from deepspeed_tpu_torch.inference import InferenceConfig, InferenceEngine
from deepspeed_tpu_torch.inference.failures import FailureConfig
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.telemetry import profiler
from tools.loadgen import http_completion, http_post
from tools.tracemerge import merge_capture, validate_merged_trace

opened = []
begin = profiler.ProfilerCapture.begin


def begin_where(self, *a, **k):
    if self.armed:
        opened.append(threading.current_thread().name)
    return begin(self, *a, **k)


profiler.ProfilerCapture.begin = begin_where
device = sys.argv[2]
model = build_model("llama-tiny", seed=5, device=device,
                    dtype=torch.bfloat16 if device == "cuda"
                    else torch.float32,
                    vocab_size=512, num_layers=2, d_model=512, num_heads=8,
                    num_kv_heads=2, d_ff=1024, max_seq_len=512)
eng = InferenceEngine(model, InferenceConfig(
    token_budget=64, max_seqs=4, kv_block_size=16, num_kv_blocks=64,
    trace=True, failure=FailureConfig(flight_dir=sys.argv[1])))
h = spawn_gateway(eng, GatewayConfig(ops="on", ops_token="t",
                                     install_signals=False))
prompt = list(range(3, 23))
warm = http_completion(h.host, h.port, {"prompt": prompt, "max_tokens": 16})
code, _, body = http_post(h.host, h.port, "/debug/capture",
                          headers={"x-ops-token": "t"})
cdir = json.loads(body)["capture"]
again = http_completion(h.host, h.port, {"prompt": prompt[::-1],
                                         "max_tokens": 16})
h.stop()
merged = json.load(open(merge_capture(cdir)))
meta = json.load(open(cdir + "/meta.json"))
print(json.dumps({
    "primed": bool(profiler._PRIMED), "opened_on": opened,
    "codes": [warm["code"], code, again["code"]], "cdir": cdir,
    "captures": eng.capture_dirs, "profiler": meta["profiler"],
    "problems": validate_merged_trace(merged),
    "kernels": sorted({ev["name"] for ev in merged["traceEvents"]
                       if ev.get("pid", 0) >= 10_000
                       and ev.get("cat") == "kernel"})}))
'''


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_capture_armed_through_the_gateway(tmp_path, device):
    """The window opens on the gateway's engine thread, in a process
    whose only earlier profiler session is the library's own priming on
    the main thread: Kineto reports no session begun off its client's
    thread, the merged capture validates, and on the card its device
    track lists paged attention."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device track of a capture)")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path), device], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT,
             **({"OMP_NUM_THREADS": "1"} if device == "cpu" else {})},
        capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "must run in same thread" not in res.stderr, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["primed"] and out["codes"] == [200, 200, 200]
    assert out["opened_on"] and "MainThread" not in out["opened_on"]
    assert out["captures"] == [out["cdir"]] and out["profiler"]
    assert out["problems"] == []
    if device == "cuda":
        assert any("paged_attention_kernel" in k for k in out["kernels"]), \
            out["kernels"]
