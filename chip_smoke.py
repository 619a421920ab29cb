#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one card.

    python3 chip_smoke.py              # every phase, one H100
    python3 chip_smoke.py --phases device,build,kernel   # a shorter run

Phases, in order; any failure exits non-zero (nothing is caught and
passed over):

1. device  — the card's name, count, capability, nvidia-smi power limit.
2. build   — every kernel of the serving path, built from this checkout's
             sources with nvcc for sm_90a into build/kernels/.
3. kernel  — each kernel against its plain PyTorch version on the card,
             in bf16, at Llama-3-8B and GPT-2 widths on a mixed
             prefill/decode batch with an aliased block table, plus the
             serving path's decode shape; times (CUDA events) and bounds.
4. serve   — Llama-3-8B at full width (random bf16 weights from a seed)
             through InferenceEngine.generate with the pipeline at depth 2
             and the prefix cache on; launch counts, a first-forward check
             against the dense plain forward, TTFT and token rates.

The line before the last is the card's name and power limit as nvidia-smi
reports them; the line before that, the per-kernel JSON; the last line,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# the bar of tests/test_paged_attention.py for bf16 kernel-vs-reference
KERNEL_ATOL = KERNEL_RTOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def mixed_batch(torch, H, Hkv, D, bs, num_blocks, seed, device):
    """Two 512-token prefill chunks (positions 0..511 and 256..767) plus
    decode tokens at contexts 1..2048; one decode sequence's table aliases
    the first prefill sequence's leading blocks (a prefix-cache hit)."""
    import numpy as np
    r = np.random.RandomState(seed)
    free = list(r.permutation(num_blocks))
    decode_ctx = [1, 2, 63, 64, 65, 200, 511, 777, 1024, 1500, 2047, 2048]
    seqs = [(0, 512), (256, 512)] + [(c - 1, 1) for c in decode_ctx]
    max_seqs = len(seqs) + 1
    tables = np.full((max_seqs, num_blocks), -1, np.int32)
    tok_slot, tok_pos = [], []
    for s, (start, n) in enumerate(seqs):
        nblk = -(-(start + n) // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        tok_slot += [s] * n
        tok_pos += list(range(start, start + n))
    # the 1024-context decode row reads sequence 0's first 4 blocks
    alias = seqs.index((1023, 1))
    tables[alias, :4] = tables[0, :4]
    kv = torch.randn((num_blocks + 1, bs, 2, Hkv, D), generator=torch.Generator(
        device=device).manual_seed(seed), device=device, dtype=torch.bfloat16)
    T = len(tok_pos)
    q = torch.randn((T, H, D), generator=torch.Generator(
        device=device).manual_seed(seed + 1), device=device,
        dtype=torch.bfloat16)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return dict(kv=kv, q=q, seq_slot=as_t(tok_slot), positions=as_t(tok_pos),
                block_tables=as_t(tables), block_size=bs,
                max_blocks_per_seq=2048 // bs, scale=1.0 / D ** 0.5,
                tables_np=tables, slots_np=np.asarray(tok_slot),
                pos_np=np.asarray(tok_pos))


def decode_batch(torch, H, Hkv, D, bs, num_blocks, seed, device):
    """The serving path's decode shape: 8 sequences, one token each, at
    contexts 513..544 (the 8B main path after its 512-token prompts)."""
    import numpy as np
    r = np.random.RandomState(seed)
    free = list(r.permutation(num_blocks))
    ctx = [513 + 4 * i for i in range(8)]
    tables = np.full((9, num_blocks), -1, np.int32)
    for s, c in enumerate(ctx):
        nblk = -(-c // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
    kv = torch.randn((num_blocks + 1, bs, 2, Hkv, D), generator=torch.Generator(
        device=device).manual_seed(seed), device=device, dtype=torch.bfloat16)
    q = torch.randn((8, H, D), generator=torch.Generator(
        device=device).manual_seed(seed + 1), device=device,
        dtype=torch.bfloat16)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return dict(kv=kv, q=q, seq_slot=as_t(range(8)),
                positions=as_t([c - 1 for c in ctx]),
                block_tables=as_t(tables), block_size=bs,
                max_blocks_per_seq=16, scale=1.0 / D ** 0.5, tables_np=tables,
                slots_np=np.arange(8), pos_np=np.asarray([c - 1 for c in ctx]))


def attention_bound(case, H, Hkv, D):
    """Least time on the card: the larger of (bytes each input/output moves
    once) / 3.35 TB/s and (flops) / 989 TFLOP/s.  KV bytes count each
    distinct (block, offset) row this batch's tokens read, once."""
    bs = case["block_size"]
    flops = 4 * H * D * int((case["pos_np"] + 1).sum())
    last = {}                     # slot -> deepest position its tokens read
    for s, p in zip(case["slots_np"].tolist(), case["pos_np"].tolist()):
        last[s] = max(last.get(s, -1), p)
    rows = {(int(case["tables_np"][s, key // bs]), key % bs)
            for s, p in last.items() for key in range(p + 1)}
    T = len(case["pos_np"])
    nbytes = (len(rows) * 2 * Hkv * D * 2          # K and V rows, bf16
              + 2 * T * H * D * 2                  # q in, out
              + T * 4 * 2                          # seq_slot, positions
              + len(set(case["slots_np"].tolist()))
              * case["max_blocks_per_seq"] * 4)    # table rows read
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations", nbytes, flops)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel_case(torch, pa, name, case, H, Hkv, D, iters):
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention_plain)
    args = (case["kv"], case["q"], case["seq_slot"], case["positions"],
            case["block_tables"], case["block_size"],
            case["max_blocks_per_seq"], case["scale"])
    out = pa(*args)
    torch.cuda.synchronize()
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    diff = (out.float() - ref.float()).abs()
    max_err = float(diff.max())
    bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
    kernel_ms = time_ms(torch, lambda: pa(*args), iters)
    plain_ms = time_ms(torch, lambda: paged_attention_plain(*args),
                       max(2, iters // 10), warmup=1)
    bound_ms, bound_by, nbytes, flops = attention_bound(case, H, Hkv, D)
    T = case["q"].shape[0]
    log(f"[kernel] {name}: T={T} H={H} Hkv={Hkv} D={D} "
        f"bs={case['block_size']} max|d|={max_err:.3e} "
        f"(atol=rtol={KERNEL_ATOL}) kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
        f"{nbytes} B, {flops} flop) library_ms: n/a")
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with the plain version on "
            f"{int(bad.sum())} elements (max |d| {max_err})")
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 4 helpers
# ---------------------------------------------------------------------------

# first-forward check.  The kernel path and the dense plain forward both
# run in bf16 and round at different places in each of 32 layers (the
# dense path rounds attention scores and probabilities to bf16, the kernel
# keeps them in fp32; summation orders differ), so the bar is the bf16
# noise floor measured in the same run: the distance NOISE of the dense
# bf16 forward from the dense forward in fp32 (same weights, no TF32).  If
# the kernel path is at least as exact as the dense bf16 path, both lie
# within NOISE of the fp32 logits and within 2 * NOISE of each other.
NOISE_FACTOR = 2.0


def first_forward_check(torch, model, prompts):
    from deepspeed_tpu_torch.inference.model import ragged_forward
    from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                            StateManager)
    from deepspeed_tpu_torch.models import apply
    cfg = model.config
    sm = StateManager(KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                    cfg.head_dim, block_size=64,
                                    num_blocks=64, dtype=torch.bfloat16,
                                    device=model.device), max_seqs=2)
    batch = sm.build_batch([(0, prompts[0]), (1, prompts[1])], 1024)
    logits, _ = ragged_forward(cfg, model.params, sm.kv, batch, 64, 8)
    got = logits[[sm.slot(0), sm.slot(1)]]
    del sm
    ids = torch.as_tensor([prompts[0], prompts[1]], device=model.device)
    ref = apply(cfg, model.params, ids)[:, -1].float()
    ref32 = apply(cfg, model.params, ids, dtype=torch.float32)[:, -1]
    noise = float((ref - ref32).abs().max())
    tol = NOISE_FACTOR * noise
    max_err = float((got - ref).abs().max())
    err32 = float((got - ref32).abs().max())
    top2 = ref.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    agree = got.argmax(-1) == top2.indices[:, 0]
    must = margin > tol
    log(f"[serve] first forward, kernel path vs dense apply (both bf16): "
        f"max|d|={max_err:.4f}; bf16 noise floor (dense bf16 vs dense fp32)"
        f"={noise:.4f} -> tol={tol:.4f}; kernel path vs dense fp32: "
        f"max|d|={err32:.4f}; |ref|max={float(ref.abs().max()):.3f}; top1 "
        f"agree={agree.tolist()} margins="
        f"{[round(float(m), 4) for m in margin]}")
    if max_err > tol:
        raise AssertionError(f"first-forward logits disagree: max|d| "
                             f"{max_err} > {tol}")
    if bool((must & ~agree).any()):
        raise AssertionError("first-forward top-1 disagrees where the "
                             "reference margin exceeds the tolerance")


def serve(torch, pa, seed):
    import numpy as np

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.models.transformer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model("llama3-8b", seed=seed, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = model.config
    n_params = sum(x.numel() for x in tree_leaves(model.params))
    log(f"[serve] llama3-8b: {n_params / 1e9:.3f} B params, bf16, random "
        f"init on the card in {time.perf_counter() - t0:.2f} s")
    r = np.random.RandomState(seed)
    prompts = [list(map(int, r.randint(0, cfg.vocab_size, 512)))
               for _ in range(8)]
    prompts[2][:256] = prompts[0][:256]   # 4 shared blocks: a prefix hit
    first_forward_check(torch, model, prompts)

    icfg = InferenceConfig(token_budget=1024, max_seqs=8, kv_block_size=64,
                           num_kv_blocks=512)
    sp = SamplingParams(max_new_tokens=32)
    eng = InferenceEngine(model, icfg)
    pa.launches = 0
    t0 = time.perf_counter()
    out = eng.generate(dict(enumerate(prompts)), sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    steps = int(eng.timings["steps"])
    log(f"[serve] generate: 8 x 512-token prompts, 32 new tokens each, "
        f"{steps} steps in {wall:.3f} s; paged_attention launches="
        f"{launches} ({cfg.num_layers} layers x {steps} steps = "
        f"{cfg.num_layers * steps})")
    for uid, toks in out.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {uid}: bad output {toks}")
    if launches != cfg.num_layers * steps or launches == 0:
        raise AssertionError("the serving path did not run the kernel in "
                             "every layer of every step")
    tm = eng.timings
    log(f"[serve] prefix cache: hits={int(tm['prefix_hits'])} cached_tokens="
        f"{int(tm['cached_tokens'])} of prompt_tokens="
        f"{int(tm['prompt_tokens'])}")
    if tm["prefix_hits"] < 1:
        raise AssertionError("no prefix-cache hit on the shared prompts")
    ttft = sorted(eng.ttft_ms[u] for u in out)
    # a repeat of prompt 0: its blocks rest in the cached-free pool, so
    # query() reports the hit (full cover -> a copy-on-write block)
    eng.put(100, prompts[0])
    eng.step(sp)
    q = eng.query(100)
    log(f"[serve] query(repeat of prompt 0) -> status={q['status']} "
        f"cached_tokens={q['cached_tokens']}")
    if q["cached_tokens"] <= 0:
        raise AssertionError("query() shows no prefix hit")
    eng.flush(100)
    del eng

    # rates: prefill alone (1 new token) vs the full run, fresh engines
    def run(n_new, profiler=None):
        e = InferenceEngine(model, icfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if profiler is not None:
            profiler.start()
        e.generate(dict(enumerate(prompts)), SamplingParams(
            max_new_tokens=n_new))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if profiler is not None:
            profiler.stop()
        computed = e.timings["prompt_tokens"] - e.timings["cached_tokens"]
        tm = dict(e.timings)
        del e
        return dt, computed, tm

    t_pre, computed, _ = run(1)
    t_all, _, tm = run(32)
    prefill_tps = computed / t_pre
    decode_tps = 8 * 31 / max(t_all - t_pre, 1e-9)
    log(f"[serve] TTFT p50={statistics.median(ttft):.1f} ms "
        f"(min {ttft[0]:.1f}, max {ttft[-1]:.1f}); prefill "
        f"{prefill_tps:.0f} tok/s ({computed} prompt tokens in "
        f"{t_pre:.3f} s); decode {decode_tps:.0f} tok/s (8 x 31 tokens in "
        f"{t_all - t_pre:.3f} s); max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n = max(tm["steps"], 1)
    log(f"[serve] host phases per step over {int(tm['steps'])} steps "
        f"(ms): schedule {tm['schedule_ms'] / n:.3f}, stage "
        f"{tm['stage_ms'] / n:.3f}, enqueue {tm['device_ms'] / n:.3f}, "
        f"wait {tm['wait_ms'] / n:.3f}, readback {tm['readback_ms'] / n:.3f}")
    device_profile(torch, lambda prof: run(32, prof), t_all)
    return launches


def device_profile(torch, run, wall_unprofiled):
    """The kernels that take the device time, over one more full run under
    torch.profiler, and the device busy share: that device time over the
    same run's wall time WITHOUT the profiler (``wall_unprofiled``; the
    profiler slows the host several times over)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    wall, _, _ = run(prof)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            rows.append((us, e.count, e.key))
    total_us = sum(r[0] for r in rows)
    if total_us <= 0:
        log("[serve] device busy share: not measured (the profiler "
            "recorded no device time)")
        return
    log(f"[serve] device time {total_us / 1e3:.1f} ms; busy share "
        f"{100 * total_us / 1e6 / wall_unprofiled:.1f}% of the unprofiled "
        f"{wall_unprofiled * 1e3:.1f} ms wall ({wall * 1e3:.1f} ms under the "
        f"profiler); top kernels by device time:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"[serve]   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="device,build,kernel,serve")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "deepspeed_tpu_torch").is_dir():
        print("chip_smoke: deepspeed_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import importlib

    from deepspeed_tpu_torch.ops import build_all
    from deepspeed_tpu_torch.platform.cuda import device_report
    pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    pa = pa_mod.paged_attention
    t_start = time.perf_counter()

    # 1. device
    rep = device_report()
    log(f"[device] {rep['name']} count={rep['count']} capability="
        f"{rep['capability']} torch={rep['torch']} cuda={rep['cuda']} "
        f"nvidia-smi: {rep['nvidia_smi']}")
    if not rep["sm90"]:
        raise SystemExit("chip_smoke: the kernels are built for sm_90a; "
                         f"this card is {rep['capability']}")

    # 2. build
    if "build" in phases:
        builders = [pa_mod.BUILDER]
        build_all(builders, force=True)
        for b in builders:
            log(f"[build] {b.name}: {' '.join(b.command)}")
            log(f"[build] {b.name}: {b.build_seconds:.2f} s; nvcc output:")
            for line in b.build_log.strip().splitlines():
                log(f"[build]   {line.strip()}")

    # 3. kernels vs plain
    kern = None
    if "kernel" in phases:
        dev = torch.device("cuda")
        cases = [("llama3-8b mixed", (32, 8, 128, 64, 512, 20)),
                 ("gpt2 mixed", (12, 12, 64, 64, 512, 20)),
                 ("llama3-8b decode", (32, 8, 128, 64, 512, 100))]
        for name, (H, Hkv, D, bs, nblk, iters) in cases:
            make = decode_batch if "decode" in name else mixed_batch
            case = make(torch, H, Hkv, D, bs, nblk, args.seed, dev)
            res = check_kernel_case(torch, pa, name, case, H, Hkv, D, iters)
            if kern is None:
                kern = res
            del case
            torch.cuda.empty_cache()

    # 4. the serving path
    launches = None
    if "serve" in phases:
        launches = serve(torch, pa, args.seed)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if kern is not None:
        print(json.dumps({"kernels": [dict(
            name="paged_attention", route="cuda",
            source="deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
            replaces="deepspeed_tpu/ops/paged_attention.py:48",
            launches=launches, library_ms=None, **kern)]}), flush=True)
    print(rep["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
