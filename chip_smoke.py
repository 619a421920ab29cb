#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one card.

    python3 chip_smoke.py              # every phase, one H100
    python3 chip_smoke.py --phases device,build,kernel   # a shorter run
    python3 chip_smoke.py --phases device,build,kernel,train
    python3 chip_smoke.py --phases device,build,kernel,serve-quant
    python3 chip_smoke.py --phases device,build,kernel,serve-alibi
    python3 chip_smoke.py --phases device,build,kernel,serve-mqa
    python3 chip_smoke.py --phases device,build,kernel,train-fp16

Phases, in order; any failure exits non-zero (nothing is caught and
passed over):

1. device  — the card's name, count, capability, nvidia-smi power limit.
2. build   — every kernel of the port (paged attention with its int8/fp8
             cache variant; flash attention forward, dq and dkv in bf16,
             fp16 and fp32; the int8/int4 mixed-input GEMM), built from
             this checkout's sources with nvcc for sm_90a into
             build/kernels/, one nvcc per source, all started together;
             each library's own build seconds and nvcc -Xptxas -v output.
3. kernel  — each kernel against its plain PyTorch version on the card,
             within NOISE_FACTOR x the noise floor of its dtype: paged
             attention (bf16) at Llama-3-8B and GPT-2 widths on a
             mixed prefill/decode batch with an aliased block table plus
             the serving path's decode shape, and with int8 and fp8
             caches on the 8B batches; its ALiBi variant at BLOOM-7b1
             width (mixed and decode batches; bf16, int8 and fp8 caches)
             and on a GQA batch with slopes; at every other head dim and
             GQA ratio a preset serves (phi-2's 80, phi3-mini's 96,
             gptj-6b's 256, falcon-7b's 71 heads over 1 KV head), mixed
             and decode; each K2 line names the designs and plan items
             that ran (chunk tiles, split decode tiles), its device ms
             (calls queued behind a sleep kernel), bound, plain ms and host
             us a call, and a second call's bits equal to the first's;
             flash fwd/dq/dkv (causal) in
             bf16 at the GPT-2 training shape, the llama-0.7B training leg
             of bench.py and Llama-3-8B widths, in fp16 at phi-2's training
             width and the GPT-2 shape, in bf16 and fp16 at gptj-6b (head
             dim 256), phi3-mini (96) and a tiny width (32), in fp32 at the
             GPT-2 shape (micro-batch 8) and phi-2's width; the int8 and
             int4 mixed-input GEMM at
             Llama-3-8B's five projection shapes (wi, mlp wo, wq, wk, attn
             wo) at M = 8 (decode) and 1024 (a prefill budget), each line
             naming the design that ran (decode: split-K on mma.sync;
             prefill: wgmma), its GB/s and share of the byte bound (M 8) or
             TFLOP/s and ratio to a dense bf16 torch.matmul of the same
             shape (M 1024, context only), the host microseconds a call,
             and a second call's bits equal to the first's.  Times (CUDA
             events; K3's with its calls queued behind a sleep kernel, as
             a decode call's host time exceeds its kernel time), bounds,
             and for flash attention the time of PyTorch's
             scaled_dot_product_attention as a yardstick.  Each flash line names the
             design that ran (wgmma: fwd, dq and dkv at D <= 128 in
             bf16/fp16; wmma: D 256; fp32-rb: the fp32 dk/dv; fp32-rbq:
             the fp32 fwd and dq), its TFLOP/s, its ratio to SDPA, the host
             microseconds per call (tensor maps included) and its
             library's build seconds; dq and dkv must be bitwise equal on
             a second run.
4. train   — GPT-2-small at full width and depth (bf16, ZeRO-1, AdamW,
             clip 1.0, micro-batch 32, seq 1024, attention_impl="flash":
             bench.py's training configuration) through
             deepspeed_tpu_torch.initialize on synthetic_lm_data batches
             through PrefetchingLoader: 2 + 10 steps with 12 launches of
             each flash kernel per step, a first-step parity check of
             loss and grad norm against the plain attention, tokens/s,
             MFU, peak memory, host time per step and the device profile.
4b. train-fp32 — the same model in fp32 (K1's fp32 kernels), micro-batch
             8, 2 + 3 steps, 12 launches of each flash kernel per step and
             a first-step parity check against the plain attention within
             2x the fp32 noise floor (fp32 against fp64).
5. serve   — Llama-3-8B at full width (random bf16 weights from a seed)
             through InferenceEngine.generate with the pipeline at depth 2
             and the prefix cache on; launch counts, a first-forward check
             against the dense plain forward, TTFT and token rates.
6. serve-quant — the same model and traffic served quantized: (a) int8
             weights and embeddings with an int8 cache (bench.py's
             llama8b_serving_bench configuration without decode bursts),
             (b) int4 weights with an fp8 cache; launch counts of the
             mixed-input GEMM (by design) and the quantized paged
             attention, a first-forward check against the plain path on
             the same quantized weights and cache, TTFT, token rates,
             resident bytes, the device profile (K3's two kernels as two
             kinds) and K3's device ms a decode and a prefill step.
7. serve-alibi — BLOOM-7b1 at full width and depth (ALiBi, random bf16
             weights from a seed), run after the Llama model is freed,
             at phase 5's traffic and engine: a first-forward check
             against the dense forward with the ALiBi bias, a greedy run
             (every layer of every step launches the ALiBi kernel), TTFT
             and token rates, a seeded sampled run (temperature 0.8,
             top-k 50, top-p 0.95, rng=PRNGKey(seed)) at pipeline depth 2
             and 1 that must agree token for token, with the keys,
             Gumbel noise and tokens of the first step and of the first
             step that samples every slot held against the CPU, the
             sampler's cost per step, and a short int8-cache run.
7b. serve-mqa — falcon-7b at full width and depth (32 layers, d_model
             4544, 71 query heads of 64 over 1 KV head, parallel block;
             random bf16 weights from a seed), run after BLOOM is freed,
             at phase 5's traffic and engine: the first-forward check
             against the dense forward, paged-attention launches = layers x
             steps (K2's chunk tiles and split single-token tiles at rep
             71), TTFT, token rates and the device profile.
8. train-fp16 — phi-2 at full width and depth (2.78 B params, 32 layers,
             32 heads of 80) in fp16 with the dynamic loss scaler, run
             after falcon is freed: ZeRO-1, AdamW lr 3e-4, clip 1.0, seq
             2048, micro-batch 4, remat_policy="flash", attention_impl=
             "flash", on synthetic_lm_data through PrefetchingLoader, 2 + 5
             steps: the reckoned and the measured peak memory, 32 launches
             of each flash kernel per step, all of the fp16 D 80 variant
             (the remat policy saves the
             forward's outputs: no replay), the loss scale and skipped
             steps, a first-step parity check against the plain attention
             within 2x the fp16 noise floor, tokens/s, MFU and the device
             profile.

Every phase prints its wall time ("[time] phase ...").

The line before the last is the card's name and power limit as nvidia-smi
reports them; the line before that, the per-kernel JSON (a flash variant's
``launches`` is the sum over the training phases that ran of what its
count read, by dtype and the head dim the kernel ran at; null when no
training phase ran; K3 has an entry per weight type and design, timed at
wi, with the launches of that design in phase 6; K2's entries name the
designs their timed batch ran, ``design``, and paged_attention_mqa, timed
on the falcon-7b mixed batch, carries serve-mqa's launches); the last line,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
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


def free_engines(torch) -> None:
    """Give back the card memory of engines the caller dropped.  An engine
    and its state reference each other (the state's release hook is a
    bound method), so ``del`` leaves the KV cache to the cycle collector:
    at BLOOM-7b1's 16 GB cache, three dropped engines fill the card."""
    gc.collect()
    torch.cuda.empty_cache()


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


def attention_bound(case, H, Hkv, D, kv_bytes=2):
    """Least time on the card: the larger of (bytes each input/output moves
    once) / 3.35 TB/s and (flops) / 989 TFLOP/s.  KV bytes count each
    distinct (block, offset) row this batch's tokens read, once, at
    ``kv_bytes`` per element (2 for bf16; 1 for int8/fp8 codes, plus one
    fp32 scale per K/V row)."""
    bs = case["block_size"]
    flops = 4 * H * D * int((case["pos_np"] + 1).sum())
    last = {}                     # slot -> deepest position its tokens read
    for s, p in zip(case["slots_np"].tolist(), case["pos_np"].tolist()):
        last[s] = max(last.get(s, -1), p)
    rows = {(int(case["tables_np"][s, key // bs]), key % bs)
            for s, p in last.items() for key in range(p + 1)}
    T = len(case["pos_np"])
    scale_bytes = 0 if kv_bytes == 2 else 4
    nbytes = (len(rows) * 2 * Hkv * (D * kv_bytes + scale_bytes)  # K, V
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


# cycles of the sleep kernel a queued call waits behind (~0.1 ms at the
# H100's ~2 GHz: more than any wrapper's host time a call)
SLEEP_CYCLES_PER_CALL = 200_000


def device_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Device ms a call of ``fn``, with the calls queued behind a sleep
    kernel that outlasts their enqueue, so that they run back to back
    however slow the host is (CUDA events around the calls alone time
    the host when it is slower than the kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# K2 cases: (name, (H, Hkv, D, bs, blocks, iterations), ALiBi).  Llama-3-8B,
# GPT-2 and BLOOM-7b1 widths (BLOOM: MHA, 32 heads of 128); a GQA batch
# with slopes; every other head dim and GQA ratio a preset serves: phi-2
# (32 heads of 80), phi3-mini (32 of 96), gptj-6b (16 of 256) and falcon-7b
# (71 heads over 1 KV head, D 64), each on the mixed and the decode batch.
# The quantized caches run on the 8B and BLOOM mixed batches and the 8B
# decode batch
K2_CASES = [("llama3-8b mixed", (32, 8, 128, 64, 512, 20), False),
            ("gpt2 mixed", (12, 12, 64, 64, 512, 20), False),
            ("llama3-8b decode", (32, 8, 128, 64, 512, 100), False),
            ("bloom-7b1 mixed", (32, 32, 128, 64, 512, 10), True),
            ("bloom-7b1 decode", (32, 32, 128, 64, 512, 100), True),
            ("gqa rep4 mixed", (32, 8, 128, 64, 512, 10), True),
            ("phi-2 mixed", (32, 32, 80, 64, 512, 10), False),
            ("phi-2 decode", (32, 32, 80, 64, 512, 100), False),
            ("phi3-mini mixed", (32, 32, 96, 64, 512, 10), False),
            ("phi3-mini decode", (32, 32, 96, 64, 512, 100), False),
            ("gptj-6b mixed", (16, 16, 256, 64, 512, 10), False),
            ("gptj-6b decode", (16, 16, 256, 64, 512, 100), False),
            ("falcon-7b mixed", (71, 1, 64, 64, 512, 20), False),
            ("falcon-7b decode", (71, 1, 64, 64, 512, 100), False)]


def k2_plan(torch, case, H, Hkv):
    """The designs and work items K2's plan gives this batch (the plan
    kernel's PyTorch twin, on the host copies of the batch): (design
    label, items by design, split items)."""
    from deepspeed_tpu_torch.ops import paged_attention as _  # noqa: F401
    pam = sys.modules["deepspeed_tpu_torch.ops.paged_attention"]
    rep = H // Hkv
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if torch.cuda.is_available() else 132)
    items = pam.plan_plain(case["slots_np"], case["pos_np"], rep,
                           case["block_size"], case["max_blocks_per_seq"],
                           pam.items_target(Hkv, sms))
    by = pam.designs_of(items, rep)
    label = "+".join(d for d in pam.DESIGNS if by[d])
    return label, by, int((items[:, 6] > 1).sum())


def k2_report(torch, pa, name, args, case, H, Hkv, D, iters, kv_bytes=2):
    """Times and plan of one K2 case whose output was already checked:
    kernel ms (calls queued behind a sleep kernel: a decode call's host
    time exceeds its kernel time), plain ms, host us a call, the bound
    and the designs the plan gave; raises if a second call's bits differ
    from the first's."""
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention_plain)
    out = pa(*args)
    again = pa(*args)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: a second call gave other bits")
    # the calls share one plan, as a step's layers do; the plan kernel
    # alone is timed beside them
    kernel_ms = device_ms(torch, lambda: pa(*args), iters)
    pam = sys.modules["deepspeed_tpu_torch.ops.paged_attention"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_args = (args[2], args[3], H // Hkv, args[5], args[6],
                 pam.items_target(Hkv, sms))
    buf = pam.launch_plan(*plan_args)
    plan_ms = device_ms(torch, lambda: pam.launch_plan(*plan_args, buf),
                        iters)
    host_us = host_us_per_call(torch, lambda: pa(*args))
    plain_ms = time_ms(torch, lambda: paged_attention_plain(*args),
                       max(2, iters // 10), warmup=1)
    bound_ms, bound_by, nbytes, flops = attention_bound(case, H, Hkv, D,
                                                        kv_bytes)
    design, by, splits = k2_plan(torch, case, H, Hkv)
    text = (f"design={design} (plan items: {by['chunk']} chunk, "
            f"{by['decode']} decode, {splits} of them split) "
            f"kernel_ms={kernel_ms:.4f} (plan reused, as by a step's "
            f"layers; the plan kernel alone {plan_ms * 1e3:.1f} us) "
            f"plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}: {nbytes} B, {flops} flop; "
            f"{bound_ms / kernel_ms:.1%} of the bound) host "
            f"{host_us:.1f} us/call; bitwise equal on a second call; "
            f"library_ms: n/a")
    return text, dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None, design=design,
                      plan_ms=plan_ms)


def check_kernel_case(torch, pa, name, case, H, Hkv, D, iters, slopes=None):
    """One bf16 case of paged attention (with ALiBi ``slopes`` if given)
    against its plain version on the same inputs."""
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention_plain)
    args = (case["kv"], case["q"], case["seq_slot"], case["positions"],
            case["block_tables"], case["block_size"],
            case["max_blocks_per_seq"], case["scale"], slopes)
    out = pa(*args)
    torch.cuda.synchronize()
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    diff = (out.float() - ref.float()).abs()
    max_err = float(diff.max())
    bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with the plain version on "
            f"{int(bad.sum())} elements (max |d| {max_err})")
    del out, ref, diff, bad
    text, res = k2_report(torch, pa, name, args, case, H, Hkv, D, iters)
    T = case["q"].shape[0]
    log(f"[kernel] {name}{' alibi' if slopes is not None else ''}: T={T} "
        f"H={H} Hkv={Hkv} D={D} bs={case['block_size']} max|d|={max_err:.3e} "
        f"(atol=rtol={KERNEL_ATOL}) {text}")
    return dict(max_abs_err=max_err, **res)


# flash attention cases: (name, dtype, (B, H, Hkv, S, D, timing
# iterations)).  bf16: GPT-2 is the training phase's shape (micro-batch 32,
# 12 heads of 64, seq 1024); llama-0.7B is bench.py's long-context training
# leg (:586-593); Llama-3-8B its serving width at S=4096.  fp16: phi-2's
# training width (phase 8: micro-batch 4, 32 heads of 80, seq 2048) and the
# GPT-2 shape.  bf16 and fp16 at the other head dims of the presets:
# gptj-6b (16 heads of 256), phi3-mini (32 of 96, S=4096) and the *-tiny
# models' 32 (8 heads).  fp32: the GPT-2 shape at phase 4b's micro-batch 8
# and phi-2's width at B=1.
FLASH_CASES = [
    ("gpt2 train", "bfloat16", (32, 12, 12, 1024, 64, 20)),
    ("llama-0.7B train", "bfloat16", (2, 16, 8, 2048, 128, 20)),
    ("llama3-8b", "bfloat16", (1, 32, 8, 4096, 128, 10)),
    ("phi-2 train", "float16", (4, 32, 32, 2048, 80, 10)),
    ("gpt2 train", "float16", (32, 12, 12, 1024, 64, 10)),
    *((name, dt, shape) for name, shape in (
        ("gptj-6b", (1, 16, 16, 2048, 256, 10)),
        ("phi3-mini", (1, 32, 32, 4096, 96, 10)),
        ("tiny", (4, 8, 8, 512, 32, 20)))
      for dt in ("bfloat16", "float16")),
    ("gpt2 train", "float32", (8, 12, 12, 1024, 64, 5)),
    ("phi-2 train", "float32", (1, 32, 32, 2048, 80, 5)),
]

# the case each kernel entry of the JSON line reports: (dtype, head dim) ->
# the first case of that variant
FLASH_VARIANTS = {}
for _name, _dt, _shape in FLASH_CASES:
    FLASH_VARIANTS.setdefault((_dt, _shape[4]), _name)

# kernel vs plain tolerance: the kernel must land within NOISE_FACTOR x
# the noise floor of its dtype, the distance of the plain version run in
# that dtype (inputs rounded to it) from the plain version one step wider
# (fp32 for bf16/fp16, fp64 for fp32) on the unrounded inputs, per output
NOISE_FACTOR = 2.0

# the peak rate of each operand type on one H100 SXM (NVIDIA data sheet;
# dense): tensor cores for bf16/fp16, the CUDA cores for fp32
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": 67e12}
ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def flash_bound(B, H, Hkv, S, D, products, in_qk, in_f32, out_qk,
                out_f32, dtype="bfloat16"):
    """(bound ms, bound_by, bytes, flops) of one flash kernel: ``products``
    causal matrix products of B*H*S*S/2*D multiply-adds at the peak of
    ``dtype``; bytes count each [B,H|Hkv,S,D] operand ("q" or "k" in the
    specs) at the element size of ``dtype`` and each [B,H,S] fp32 row
    vector once."""
    flops = products * 2 * B * H * (S * S // 2) * D
    q_el, kv_el, vec = B * H * S * D, B * Hkv * S * D, B * H * S

    def n(spec):
        return sum({"q": q_el, "k": kv_el}[k] for k in spec)

    nbytes = (ELEM_BYTES[dtype] * (n(in_qk) + n(out_qk))
              + 4 * vec * (in_f32 + out_f32))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations", nbytes, flops)


def _within_noise(torch, name, got, ref, ref_wide):
    """|got - ref| <= NOISE_FACTOR x |ref - ref_wide| (max over elements,
    in fp64): ``ref`` is the plain version in the kernel's dtype,
    ``ref_wide`` the plain version one step wider."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    noise = float((ref.double() - ref_wide.double()).abs().max())
    err = float((got.double() - ref.double()).abs().max())
    tol = NOISE_FACTOR * noise
    if err > tol:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version: max|d| {err} > {tol} "
                             f"({NOISE_FACTOR} x noise {noise})")
    return err, tol


def flash_design(kname, dtype, D):
    """Which kernel design a flash variant runs (the entry points' dispatch
    by head dim): "wgmma" (csrc/flash_attention_sm90.cuh: fwd, dq and dkv
    at D <= 128), "wmma" (csrc/flash_attention.cuh: D 256), "fp32-rb" (the
    register-blocked fp32 dk/dv, keys resident) or "fp32-rbq" (the
    register-blocked fp32 fwd and dq, queries resident; both in
    csrc/flash_attention_fp32.cu)."""
    if dtype == "float32":
        return "fp32-rb" if kname == "flash_dkv" else "fp32-rbq"
    return "wgmma" if D != 256 else "wmma"


def host_us_per_call(torch, fn, calls: int = 20) -> float:
    """Host microseconds per call of ``fn`` (a kernel wrapper: checks,
    tensor-map encoding, the launch), with the card still busy on earlier
    calls; synchronised after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def check_flash_case(torch, fa, name, B, H, Hkv, S, D, iters,
                     dtype="bfloat16", device="cuda"):
    """fwd, dq, dkv (causal) against their plain versions on the same
    inputs in ``dtype``; times of kernels, plain versions and SDPA fwd /
    bwd."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    wide = torch.float64 if dt == torch.float32 else torch.float32
    gen = torch.Generator(device=device).manual_seed(S + D)
    f32 = [torch.randn(shape, device=device, generator=gen)
           for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                         (B, H, S, D))]
    q, k, v, do = (x.to(dt) for x in f32)
    xw = [x.to(wide) for x in f32]
    del f32
    scale = D ** -0.5
    res = {}
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, scale, True)
    o_w, lse_w = fa.flash_fwd_plain(*xw[:3], scale, True)
    errs = {"o": _within_noise(torch, f"{name} fwd o", o, o_ref, o_w),
            "lse": _within_noise(torch, f"{name} fwd lse", lse, lse_ref,
                                 lse_w)}
    res["flash_fwd"] = max(e for e, _ in errs.values())
    delta = (do.float() * o_ref.float()).sum(-1)
    delta_w = (xw[3] * o_w).sum(-1)
    del o, lse, o_w
    args = (q, k, v, do, lse_ref, delta, scale, True)
    args_w = (*xw, lse_w, delta_w, scale, True)
    dq = fa.flash_dq(*args)
    dq2 = fa.flash_dq(*args)
    torch.cuda.synchronize()
    if not torch.equal(dq, dq2):
        raise AssertionError(f"{name} dq: two runs on equal inputs differ")
    del dq2
    errs["dq"] = _within_noise(torch, f"{name} dq", dq,
                               fa.flash_dq_plain(*args),
                               fa.flash_dq_plain(*args_w))
    res["flash_dq"] = errs["dq"][0]
    del dq
    dk, dv = fa.flash_dkv(*args)
    dk2, dv2 = fa.flash_dkv(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{name} dkv: two runs on equal inputs differ")
    del dk2, dv2
    ref, ref_w = fa.flash_dkv_plain(*args), fa.flash_dkv_plain(*args_w)
    errs["dk"] = _within_noise(torch, f"{name} dk", dk, ref[0], ref_w[0])
    errs["dv"] = _within_noise(torch, f"{name} dv", dv, ref[1], ref_w[1])
    res["flash_dkv"] = max(errs["dk"][0], errs["dv"][0])
    del dk, dv, ref, ref_w, xw, args_w, delta_w
    torch.cuda.empty_cache()

    plain_iters = 3
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, scale),
             "flash_dq": lambda: fa.flash_dq(*args),
             "flash_dkv": lambda: fa.flash_dkv(*args)}
    t = {kname: time_ms(torch, fn, iters) for kname, fn in calls.items()}
    host_us = {kname: host_us_per_call(torch, fn)
               for kname, fn in calls.items()}
    tp = {"flash_fwd": time_ms(
              torch, lambda: fa.flash_fwd_plain(q, k, v, scale, True),
              plain_iters, warmup=1),
          "flash_dq": time_ms(torch, lambda: fa.flash_dq_plain(*args),
                              plain_iters, warmup=1),
          "flash_dkv": time_ms(torch, lambda: fa.flash_dkv_plain(*args),
                               plain_iters, warmup=1)}
    # the library yardstick (timed here only; the port never calls it):
    # SDPA forward, and its backward against dq + dkv together
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
        a, b, c, is_causal=True, scale=scale, enable_gqa=True)
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v), iters)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = sdpa(qg, kg, vg)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters)
    del out, qg, kg, vg
    lib = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd, "flash_dkv": lib_bwd}
    bounds = {
        "flash_fwd": flash_bound(B, H, Hkv, S, D, 2, "qkk", 0, "q", 1,
                                 dtype),
        "flash_dq": flash_bound(B, H, Hkv, S, D, 3, "qkkq", 2, "q", 0,
                                dtype),
        "flash_dkv": flash_bound(B, H, Hkv, S, D, 4, "qkkq", 2, "kk", 0,
                                 dtype)}
    out = {}
    build_s = fa._KERNEL_DTYPES[dt][1].build_seconds
    for kname in ("flash_fwd", "flash_dq", "flash_dkv"):
        bound_ms, bound_by, nbytes, flops = bounds[kname]
        out[kname] = dict(max_abs_err=res[kname], ms=t[kname],
                          plain_ms=tp[kname], bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib[kname])
        ratio = (t[kname] / lib_fwd if kname == "flash_fwd"
                 else (t["flash_dq"] + t["flash_dkv"]) / lib_bwd)
        log(f"[kernel] {name} {kname} {dtype}: B={B} H={H} Hkv={Hkv} S={S} "
            f"D={D} design={flash_design(kname, dtype, D)} "
            f"max|d|={res[kname]:.3e} kernel_ms={t[kname]:.4f} "
            f"plain_ms={tp[kname]:.4f} bound_ms={bound_ms:.4f} ({bound_by}: "
            f"{nbytes} B, {flops} flop; {flops / t[kname] / 1e9:.1f} "
            f"TFLOP/s achieved) library_ms={lib[kname]:.4f} "
            f"({'SDPA fwd' if kname == 'flash_fwd' else 'SDPA bwd, dq+dkv'}"
            f"; {'kernel' if kname == 'flash_fwd' else 'dq+dkv'}/SDPA "
            f"{ratio:.2f}x) host_us={host_us[kname]:.1f} per call "
            f"(wrapper, tensor maps, launch) library_build_s={build_s:.2f}")
    log(f"[kernel] {name} {dtype} tolerances (kernel vs {dtype} plain, "
        f"{NOISE_FACTOR} x the {dtype} noise floor against "
        f"{str(wide)[6:]}): " + ", ".join(
            f"{k} {e:.3e} <= {tol:.3e}" for k, (e, tol) in errs.items()))
    return out


def check_quant_kv_case(torch, pa, name, case, code, H, Hkv, D, iters,
                        slopes=None):
    """The int8 / fp8 cache variant of paged attention: the case's cache
    quantized by the serving path's _quantize_kv, kernel vs the plain
    version (bf16 q) within NOISE_FACTOR x the bf16 noise floor (the
    plain version with q and the dequantized rows in fp32)."""
    from deepspeed_tpu_torch.inference.model import _quantize_kv
    from deepspeed_tpu_torch.ops.paged_attention import (
        paged_attention_plain)
    qdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[code]
    kv = _quantize_kv(case["kv"], qdt)
    rest = (case["seq_slot"], case["positions"], case["block_tables"],
            case["block_size"], case["max_blocks_per_seq"], case["scale"],
            slopes)
    q = case["q"]
    out = pa(kv, q, *rest)
    torch.cuda.synchronize()
    ref = paged_attention_plain(kv, q, *rest)
    ref32 = paged_attention_plain(kv, q.float(), *rest)
    err, tol = _within_noise(torch, f"{name} {code}", out, ref, ref32)
    del out, ref, ref32
    text, res = k2_report(torch, pa, f"{name} {code}", (kv, q, *rest), case,
                          H, Hkv, D, iters, kv_bytes=1)
    log(f"[kernel] {name} {code} cache{' alibi' if slopes is not None else ''}"
        f": T={q.shape[0]} H={H} Hkv={Hkv} "
        f"D={D} max|d|={err:.3e} <= {tol:.3e} ({NOISE_FACTOR} x the bf16 "
        f"noise floor) {text}")
    return dict(max_abs_err=err, **res)


# mixed-input GEMM cases: Llama-3-8B's projections (contraction dims, N) —
# mlp wi (and wg), mlp wo, wq, wk (and wv), the attention output [32, 128]
# -> 4096 with one scale per head — at a decode step (M = 8) and a full
# prefill budget (M = 1024)
MIXED_PROJECTIONS = [("wi", (4096,), 14336), ("mlp wo", (14336,), 4096),
                     ("wq", (4096,), 4096), ("wk", (4096,), 1024),
                     ("attn wo", (32, 128), 4096)]
MIXED_M = (8, 1024)
# the kernel of each K3 design (csrc/mixed_gemm.cu), as the profiler names it
MIXED_KERNELS = {"decode": "mixed_gemm_decode_kernel",
                 "prefill": "mixed_gemm_prefill_kernel"}


def mixed_bound(M, K, N, bits):
    """(bound ms, bound_by, bytes, flops): the codes at bits/8 bytes per
    weight, one fp32 scale per contraction row, bf16 x in and out once."""
    nbytes = K * N * bits // 8 + 4 * K + 2 * M * K + 2 * M * N
    flops = 2 * M * K * N
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations", nbytes, flops)


def check_mixed_case(torch, mg, name, kdims, N, M, bits, iters,
                     device="cuda"):
    """The int8 / int4 mixed-input GEMM at one projection shape: kernel vs
    the plain version on the same bf16 x and quantized weight, within
    NOISE_FACTOR x the bf16 noise floor (x @ dequant(w) in fp32 on the
    unrounded x), and bitwise equal on a second call; times of the kernel,
    the plain version and a dense bf16 torch.matmul of the same shape
    (context: no single PyTorch call computes this function; kernel and
    matmul by ``device_ms``), the host microseconds a call, and the design
    that ran."""
    from deepspeed_tpu_torch.ops.quant import (_quantize_leading,
                                               dequantize, quantize_rowwise4)
    gen = torch.Generator(device=device).manual_seed(M + N + bits)
    K = math.prod(kdims)
    w = torch.randn(*kdims, N, device=device, generator=gen)
    qt = (_quantize_leading(w.to(torch.bfloat16), 1) if bits == 8 else
          quantize_rowwise4(w.to(torch.bfloat16), contract_dims=len(kdims)))
    del w
    x32 = torch.randn(M, K, device=device, generator=gen)
    x = x32.to(torch.bfloat16)
    s = qt.scale.reshape(-1)
    s = s[:, None].expand(s.numel(), K // s.numel()).reshape(K).contiguous()
    data = qt.data.reshape(-1, N)
    kern = mg.mixed_matmul_2d if bits == 8 else mg.mixed4_matmul_2d
    plain = mg.mixed_matmul_2d_plain if bits == 8 else \
        mg.mixed4_matmul_2d_plain
    design = mg.design_for(M)
    out = mg.mixed_matmul(x, qt, contract_dims=len(kdims)).reshape(M, N)
    again = kern(x, data, s)
    torch.cuda.synchronize()
    tag = f"{name} int{bits} M={M}"
    if not torch.equal(out, again):
        raise AssertionError(f"{tag}: a second call gave other bits")
    ref = plain(x, data, s)
    ref32 = x32 @ dequantize(qt, torch.float32).reshape(K, N)
    err, tol = _within_noise(torch, tag, out, ref, ref32)
    del ref32
    kernel_ms = device_ms(torch, lambda: kern(x, data, s), iters)
    host_us = host_us_per_call(torch, lambda: kern(x, data, s))
    plain_ms = time_ms(torch, lambda: plain(x, data, s), max(2, iters // 10),
                       warmup=1)
    wd = dequantize(qt, torch.bfloat16).reshape(K, N)
    dense_ms = device_ms(torch, lambda: x @ wd, iters)
    del wd
    bound_ms, bound_by, nbytes, flops = mixed_bound(M, K, N, bits)
    if bound_by == "bytes":
        rate = (f"{nbytes / kernel_ms / 1e6:.1f} GB/s, {bound_ms / kernel_ms:.1%}"
                f" of the byte bound (half the bound "
                f"{'reached' if kernel_ms <= 2 * bound_ms else 'missed'})")
    else:
        rate = (f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, "
                f"{kernel_ms / dense_ms:.2f}x the dense bf16 torch.matmul")
    log(f"[kernel] mixed gemm int{bits} {name} M={M} K={K} N={N} "
        f"design={design}: max|d|={err:.3e} <= {tol:.3e} ({NOISE_FACTOR} x "
        f"the bf16 noise floor), bitwise equal on a second call; "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}: {nbytes} B, {flops} flop; "
        f"{rate}) host {host_us:.1f} us/call; dense bf16 torch.matmul "
        f"{dense_ms:.4f} ms (context); library_ms: n/a (no single PyTorch "
        f"call)")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                design=design, dense_bf16_matmul_ms=dense_ms)


# ---------------------------------------------------------------------------
# phase 4 helpers
# ---------------------------------------------------------------------------

# the training runs (phases 4, 4b and 8), each through
# deepspeed_tpu_torch.initialize -> train_batch with attention_impl="flash"
# on synthetic_lm_data batches through PrefetchingLoader; ZeRO-1, AdamW lr
# 3e-4, clip 1.0.
#   train       bench.py's headline training configuration (:145-168):
#               GPT-2-small, seq 1024, micro-batch 32, bf16, no remat
#   train-fp32  the same model with neither bf16 nor fp16 enabled (fp32:
#               K1's fp32 kernels), micro-batch 8
#   train-fp16  phi-2 at full width and depth (32 layers, 32 heads of 80)
#               in fp16, its published precision, with the dynamic loss
#               scaler; seq 2048, micro-batch 4, remat with the "flash"
#               policy (the products against weights and the flash
#               forward's outputs saved, the rest of each layer recomputed)
TRAIN_RUNS = {
    "train": dict(preset="gpt2", precision="bf16", seq=1024, micro=32,
                  warmup=2, steps=10, remat=False, policy="nothing"),
    "train-fp32": dict(preset="gpt2", precision="fp32", seq=1024, micro=8,
                       warmup=2, steps=3, remat=False, policy="nothing"),
    "train-fp16": dict(preset="phi-2", precision="fp16", seq=2048, micro=4,
                       warmup=2, steps=5, remat=True, policy="flash"),
}
PARITY_MICRO = 4

# first-step parity, flash kernels vs the plain attention (both in the
# run's precision): the bar is PARITY_FACTOR x the noise floor measured in
# the same run, the distance of the plain-attention step from the same
# step one precision wider (bf16/fp16 against fp32, fp32 against fp64;
# same weights and batch).  Each is one scalar, which can land close to its
# wider value by chance, so the floor never goes below PARITY_FLOOR of the
# precision, relative: for bf16 2^-12, 1/16 of one bf16 rounding step
# (2^-8); for fp16 2^-16, as far below as fp16 keeps more bits (11 to
# bf16's 8, and one more step of margin): 1/32 of one fp16 rounding step
# (2^-11); for fp32 2^-20, 16 fp32 rounding steps (2^-24) of the scalar:
# the step's loss and norm are sums of ~10^4 token losses and ~10^8 squared
# gradients, whose fp32 rounding is that large or larger.  The floors only
# guard against a noise reading near 0; the kernels' own precision is held
# case by case in phase 3.
PARITY_FACTOR = 2.0
PARITY_FLOOR = {"bf16": 2.0 ** -12, "fp16": 2.0 ** -16, "fp32": 2.0 ** -20}


def train_config(micro, precision="bf16", optimizer="adamw",
                 scale_power=None):
    cfg = {"train_micro_batch_size_per_device": micro,
           "optimizer": {"type": optimizer, "params": {"lr": 3e-4}},
           "bf16": {"enabled": precision == "bf16"},
           "fp16": {"enabled": precision == "fp16"},
           "zero_optimization": {"stage": 1},
           "mesh": {"data": -1},
           "gradient_clipping": 1.0,
           "steps_per_print": 10_000}
    if scale_power is not None:
        cfg["fp16"]["initial_scale_power"] = scale_power
    return cfg


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def flash_counts(fa):
    return (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches, fa.flash_attention.fallbacks)


def reckon_peak(cfg, n_params, largest_leaf, micro, seq):
    """The fp16 remat-"flash" step's card memory from the shapes, in bytes,
    at its two peaks: the start of the backward and the update."""
    B, S, dm, dff = micro, seq, cfg.d_model, cfg.d_ff
    weights = 2 * n_params            # the model's fp16 parameters
    state = 4 * n_params + 8 * n_params   # fp32 master, AdamW m and v
    # saved per layer under "flash": the layer input, q, k, v, the flash
    # output, the attention projection and the MLP output ([B, S, dm]
    # each), the MLP's first product ([B, S, dff]), all fp16, and the lse
    acts = cfg.num_layers * (2 * B * S * (7 * dm + dff)
                             + 4 * B * S * cfg.num_heads)
    logits = 2 * 2 * B * S * cfg.vocab_size   # fp16 logits and their grad
    backward = weights + state + 2 * n_params + acts + logits
    # the update: fp32 grads of every leaf, and for the leaf being updated
    # its new m and v and ~3 fp32 temporaries
    update = weights + state + 4 * n_params + 5 * 4 * largest_leaf
    return backward, update, acts


def train(torch, fa, seed, run="train", device=None, **overrides):
    """One training run of TRAIN_RUNS through the port's public entry
    points; returns the flash kernels' launch counts over its timed run,
    by variant: kernel name -> {(dtype name, head dim): launches}.
    ``device`` and ``overrides`` (model-config fields) exist for a CPU
    rehearsal at a tiny size; the chip run passes neither."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.models.transformer import tree_leaves
    from deepspeed_tpu_torch.runtime import (DataLoader, PrefetchingLoader,
                                             param_count, synthetic_lm_data)

    spec = TRAIN_RUNS[run]
    prec = spec["precision"]
    warmup, steps = spec["warmup"], spec["steps"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = overrides.pop("max_seq_len", spec["seq"])
    micro = overrides.pop("micro", spec["micro"])
    t0 = time.perf_counter()
    model = build_model(
        spec["preset"], seed=seed, device=device, max_seq_len=seq,
        remat=spec["remat"], remat_policy=spec["policy"],
        attention_impl="flash",
        dtype=torch.float16 if prec == "fp16" else torch.float32,
        **overrides)
    cfg = model.config
    n_params = param_count(model.params)
    if prec == "fp16":
        largest = max(x.numel() for x in tree_leaves(model.params))
        bwd, upd, acts = reckon_peak(cfg, n_params, largest, micro, seq)
        log(f"[{run}] reckoned peak memory: {max(bwd, upd) / 2**30:.2f} GiB "
            f"(start of the backward {bwd / 2**30:.2f} GiB, of which saved "
            f"activations {acts / 2**30:.2f}; update {upd / 2**30:.2f} GiB)")
    engine = ds.initialize(model=model, config=train_config(micro, prec),
                           device=device)
    tbs = engine.train_batch_size
    data = synthetic_lm_data(cfg.vocab_size, tbs * (warmup + steps + 1), seq,
                             seed=seed)
    it = iter(PrefetchingLoader(DataLoader(data, tbs), engine))
    remat = (f"remat_policy={spec['policy']!r}" if spec["remat"]
             else "no remat")
    log(f"[{run}] {spec['preset']}: {n_params / 1e6:.2f} M params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads of {cfg.head_dim}, vocab {cfg.vocab_size}, seq {seq}; "
        f"{prec}{' (dynamic loss scale)' if prec == 'fp16' else ''}, ZeRO-1, "
        f"AdamW lr 3e-4, clip 1.0, micro-batch {micro}, {remat}, "
        f"attention_impl=flash; set up in {time.perf_counter() - t0:.2f} s")

    # the main path: counts to 0 just before, read just after
    fa.reset_launches()
    fa.flash_attention.fallbacks = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, host_ms, per_step, batches = [], [], [], []
    for step in range(warmup + steps):
        if step == warmup:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        before = flash_counts(fa)
        batch = next(it)
        batches.append(batch)
        th = time.perf_counter()
        metrics.append(engine.train_batch(batch))
        host_ms.append((time.perf_counter() - th) * 1e3)
        per_step.append(tuple(b - a for a, b in zip(before, flash_counts(fa))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = flash_counts(fa)
    variants = {k: dict(getattr(fa, k).variant_launches) for k in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()

    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    applied = [not m["overflow"] for m in metrics]
    log(f"[{run}] losses {[round(x, 4) for x in losses]}")
    log(f"[{run}] grad norms {[round(x, 4) for x in gnorms]}")
    if prec == "fp16":
        log(f"[{run}] loss scale per step {[m['loss_scale'] for m in metrics]}"
            f"; skipped (overflow) per step "
            f"{[int(m['overflow']) for m in metrics]}; engine: "
            f"{engine.state.skipped} skipped, {engine.state.step} applied")
        if not any(applied):
            raise AssertionError("no fp16 step was applied")
    log(f"[{run}] flash launches over {len(metrics)} steps: fwd={counts[0]} "
        f"dq={counts[1]} dkv={counts[2]}; routed to causal_attention: "
        f"{counts[3]}; per step {sorted(set(per_step))}; by (dtype, head "
        f"dim) {variants}")
    if not all(map(math.isfinite, losses + [
            g for g, ok in zip(gnorms, applied) if ok])):
        raise AssertionError("non-finite loss or grad norm")
    want = (cfg.num_layers, cfg.num_layers, cfg.num_layers, 0)
    if any(p != want for p in per_step):
        raise AssertionError(f"a step did not launch each flash kernel once "
                             f"per layer (want {want} per step, got "
                             f"{per_step})")
    variant = ({"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}[prec],
               fa.kernel_head_dim(cfg.head_dim))
    if any(v != {variant: n} for v, n in zip(variants.values(), counts)):
        raise AssertionError(f"the flash launches were not all of the "
                             f"{variant} variant: {variants}")

    toks = tbs * (seq - 1) * steps
    tok_s = toks / wall
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * cfg.d_model * (
        seq - 1)                                  # bench.py:207-211
    peak_flops = PEAK_FLOPS["float32" if prec == "fp32" else "bfloat16"]
    mfu = tok_s * flops_per_token / peak_flops
    smi = nvidia_smi_line()
    log(f"[{run}] {steps} steps in {wall:.3f} s "
        f"({wall / steps * 1e3:.1f} ms/step): {tok_s:.0f} tokens/s, "
        f"MFU {100 * mfu:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({flops_per_token / 1e6:.1f} MFLOP/token); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; host time in train_batch "
        f"{statistics.mean(host_ms[warmup:]):.1f} ms/step (first "
        f"step {host_ms[0]:.1f} ms) [{smi}]")

    def one_step(prof):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof.start()
        engine.train_batch(next(it))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        prof.stop()
        return dt

    device_profile(torch, one_step, wall / steps, tag=run)
    del engine, it
    free_engines(torch)

    if run == "train":
        parity(torch, model, data, seed, device)
    else:
        k = applied.index(True)       # skipped steps leave the weights
        parity_step(torch, model, run, batches[k], metrics[k], k, device)
    del model, batches
    free_engines(torch)
    return variants


def parity_step(torch, model, run, batch, met, k, device):
    """The first applied step of a run (step ``k``: the steps before it
    were skipped and left the weights as they were) against the plain
    causal_attention on the same weights, batch and loss scale, with the
    plain attention one precision wider as the noise-floor reference: an
    engine for fp32 (the reference engines run SGD: the first step's loss
    and grad norm do not depend on the optimizer, and SGD holds one buffer
    in place of Adam's two), the loss and the norm of its gradient
    computed directly in fp64 (the engine computes in at most fp32)."""
    import dataclasses

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Model
    from deepspeed_tpu_torch.runtime.runtime_utils import (tree_leaves,
                                                           tree_unflatten)

    spec = TRAIN_RUNS[run]
    prec, micro = spec["precision"], batch["input_ids"].shape[0]
    got = (float(met["loss"]), float(met["grad_norm"]))
    power = int(round(math.log2(met["loss_scale"]))) if prec == "fp16" \
        else None

    def engine_step(precision, policy):
        m = Model.from_params(dataclasses.replace(
            model.config, attention_impl="xla", remat=spec["remat"],
            remat_policy=policy), model.params)
        eng = ds.initialize(model=m, config=train_config(
            micro, precision, "sgd", power), device=device)
        out = eng.train_batch(batch)
        res = (float(out["loss"]), float(out["grad_norm"]))
        del eng, out
        free_engines(torch)
        return res

    def fp64_step():
        m = Model.from_params(dataclasses.replace(
            model.config, attention_impl="xla", remat=True,
            remat_policy="nothing"), model.params)
        leaves = [x.detach().double().requires_grad_()
                  for x in tree_leaves(model.params)]
        loss = m.loss_fn(tree_unflatten(model.params, leaves),
                         {"input_ids": batch["input_ids"]})
        grads = torch.autograd.grad(loss, leaves)
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        res = (float(loss.detach()), float(norm))
        del leaves, loss, grads
        free_engines(torch)
        return res

    ref = engine_step(prec, spec["policy"])
    if prec == "fp16":
        # fp32 without the training run's activations saved: the whole
        # layer is recomputed (no policy changes the numbers)
        wide, wide_name = engine_step("fp32", "nothing"), "fp32"
    else:
        wide, wide_name = fp64_step(), "fp64"
    floor = PARITY_FLOOR[prec]
    for i, what in enumerate(("loss", "grad_norm")):
        noise = abs(ref[i] - wide[i])
        tol = PARITY_FACTOR * max(noise, floor * abs(wide[i]))
        log(f"[{run}] parity (micro-batch {micro}, step {k}, the first "
            f"applied{f', loss scale 2^{power}' if power is not None else ''}"
            f") {what}: flash {got[i]:.7f} vs plain {ref[i]:.7f} (|d| "
            f"{abs(got[i] - ref[i]):.3e}); {wide_name} plain {wide[i]:.7f}: "
            f"noise {noise:.3e}, tol {tol:.3e}")
        if not math.isfinite(got[i]) or abs(got[i] - ref[i]) > tol:
            raise AssertionError(f"{run}: first-step {what} with the flash "
                                 f"kernels disagrees with the plain attention")


def parity(torch, model, data, seed, device):
    """First step at micro-batch PARITY_MICRO from the same weights and
    batch: flash kernels (bf16) vs the plain causal_attention (bf16), with
    the plain attention in fp32 as the noise-floor reference."""
    import dataclasses

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Model

    batch = {"input_ids": data["input_ids"][:PARITY_MICRO]}
    res = {}
    for tag, impl, bf16 in (("flash", "flash", True), ("plain", "xla", True),
                            ("fp32", "xla", False)):
        m = Model.from_params(dataclasses.replace(
            model.config, attention_impl=impl), model.params)
        eng = ds.initialize(model=m, config=train_config(
            PARITY_MICRO, "bf16" if bf16 else "fp32"), device=device)
        met = eng.train_batch(dict(batch))
        res[tag] = (float(met["loss"]), float(met["grad_norm"]))
        del eng
        torch.cuda.empty_cache()
    for i, what in enumerate(("loss", "grad_norm")):
        got, ref, ref32 = res["flash"][i], res["plain"][i], res["fp32"][i]
        noise = abs(ref - ref32)
        tol = PARITY_FACTOR * max(noise, PARITY_FLOOR["bf16"] * abs(ref32))
        log(f"[train] parity (micro-batch {PARITY_MICRO}, first step) "
            f"{what}: flash {got:.6f} vs plain {ref:.6f} (|d| "
            f"{abs(got - ref):.3e}); fp32 plain {ref32:.6f}: noise "
            f"{noise:.3e}, tol {tol:.3e}")
        if not math.isfinite(got) or abs(got - ref) > tol:
            raise AssertionError(f"first-step {what} with the flash kernels "
                                 f"disagrees with the plain attention")


def nvidia_smi_line() -> str:
    from deepspeed_tpu_torch.platform.cuda import nvidia_smi_power
    return nvidia_smi_power() or "nvidia-smi: not available"


# ---------------------------------------------------------------------------
# phase 5 helpers
# ---------------------------------------------------------------------------

# first-forward check.  The kernel path and the dense plain forward both
# run in bf16 and round at different places in each of 32 layers (the
# dense path rounds attention scores and probabilities to bf16, the kernel
# keeps them in fp32; summation orders differ), so the bar is the bf16
# noise floor measured in the same run: the distance NOISE of the dense
# bf16 forward from the dense forward in fp32 (same weights, no TF32).  If
# the kernel path is at least as exact as the dense bf16 path, both lie
# within NOISE of the fp32 logits and within NOISE_FACTOR * NOISE of each
# other.


def first_forward_check(torch, model, prompts, tag="serve"):
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
    log(f"[{tag}] first forward, kernel path vs dense apply (both bf16): "
        f"max|d|={max_err:.4f}; bf16 noise floor (dense bf16 vs dense fp32)"
        f"={noise:.4f} -> tol={tol:.4f}; kernel path vs dense fp32: "
        f"max|d|={err32:.4f}; |ref|max={float(ref.abs().max()):.3f}; top1 "
        f"agree={agree.tolist()} margins="
        f"{[round(float(m), 4) for m in margin]}")
    if not bool(torch.isfinite(got).all()) or max_err > tol:
        raise AssertionError(f"{tag}: first-forward logits disagree: max|d| "
                             f"{max_err} > {tol}")
    if bool((must & ~agree).any()):
        raise AssertionError(f"{tag}: first-forward top-1 disagrees where "
                             "the reference margin exceeds the tolerance")


def serving_model(torch, name, seed, tag="serve", device=None, **overrides):
    """A preset (Llama-3-8B, BLOOM-7b1) at full width and depth, random
    bf16 weights from ``seed`` drawn on the card, and the serving traffic:
    8 prompts of 512 random tokens, prompt 2 sharing prompt 0's first 256
    (4 blocks).  ``device`` and ``overrides`` (model-config fields) exist
    for a CPU rehearsal at a tiny size; the chip run passes neither."""
    import numpy as np

    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.models.transformer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = build_model(name, seed=seed, dtype=torch.bfloat16, device=device,
                        **overrides)
    torch.cuda.synchronize()
    cfg = model.config
    n_params = sum(x.numel() for x in tree_leaves(model.params))
    log(f"[{tag}] {name}: {n_params / 1e9:.3f} B params, bf16 "
        f"({tree_bytes(model.params) / 1e9:.2f} GB), {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} KV) "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"position {cfg.position}; random init on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    r = np.random.RandomState(seed)
    prompts = [list(map(int, r.randint(0, cfg.vocab_size, 512)))
               for _ in range(8)]
    prompts[2][:256] = prompts[0][:256]   # 4 shared blocks: a prefix hit
    return model, prompts


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter or quantized tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if hasattr(tree, "tensors"):                  # a QuantizedTensor
        return sum(t.numel() * t.element_size() for t in tree.tensors())
    if isinstance(tree, tuple):                   # a quantized KV cache
        return sum(tree_bytes(t) for t in tree)
    return tree.numel() * tree.element_size()


# phase 5's engine: token budget 1024, 8 sequence slots, 512 KV blocks of 64
SERVE_ENGINE = dict(token_budget=1024, max_seqs=8, kv_block_size=64,
                    num_kv_blocks=512)
SERVE_NEW_TOKENS = 32


def serve(torch, pa, model, prompts, tag="serve"):
    """Greedy bf16 serving at phase 5's traffic; returns the bf16-cache
    paged-attention launches (for an ALiBi model, every one of them must
    carry the slopes) and the rates."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)

    cfg = model.config
    alibi = cfg.position == "alibi"
    torch.cuda.reset_peak_memory_stats()
    first_forward_check(torch, model, prompts, tag)

    icfg = InferenceConfig(**SERVE_ENGINE)
    sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    eng = InferenceEngine(model, icfg)
    log(f"[{tag}] KV cache {tree_bytes(eng.state.kv) / 1e9:.3f} GB")
    # the main path: counts to 0 just before, read just after
    pa.launches = pa.alibi_launches = 0
    t0 = time.perf_counter()
    out = eng.generate(dict(enumerate(prompts)), sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, alibi_launches = pa.launches, pa.alibi_launches
    steps = int(eng.timings["steps"])
    log(f"[{tag}] generate: 8 x 512-token prompts, 32 new tokens each, "
        f"{steps} steps in {wall:.3f} s; paged_attention launches="
        f"{launches}, with ALiBi slopes={alibi_launches} ({cfg.num_layers} "
        f"layers x {steps} steps = {cfg.num_layers * steps})")
    check_tokens(out, cfg, SERVE_NEW_TOKENS, tag)
    if launches != cfg.num_layers * steps or launches == 0 \
            or alibi_launches != (launches if alibi else 0):
        raise AssertionError(f"{tag}: the serving path did not run the "
                             "kernel (with ALiBi where the model has it) in "
                             "every layer of every step")
    ttft = sorted(eng.ttft_ms[u] for u in out)
    check_prefix_and_cow(eng, prompts, sp, tag)
    del eng
    free_engines(torch)
    rates = serve_rates(torch, lambda: InferenceEngine(model, icfg), prompts,
                        ttft, tag)
    return dict(launches=launches, alibi_launches=alibi_launches, **rates)


def check_tokens(out, cfg, n_new, tag):
    for uid, toks in out.items():
        if len(toks) != n_new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag} request {uid}: bad output {toks}")


def check_prefix_and_cow(eng, prompts, sp, tag):
    """The shared prompts hit the prefix cache; a repeat of prompt 0 (its
    blocks rest in the cached-free pool) is a full-cover hit that query()
    reports, served through a copy-on-write block."""
    tm = eng.timings
    log(f"[{tag}] prefix cache: hits={int(tm['prefix_hits'])} cached_tokens="
        f"{int(tm['cached_tokens'])} of prompt_tokens="
        f"{int(tm['prompt_tokens'])}")
    if tm["prefix_hits"] < 1:
        raise AssertionError(f"{tag}: no prefix-cache hit on the shared "
                             "prompts")
    eng.put(100, prompts[0])
    eng.step(sampling=sp)
    q = eng.query(100)
    log(f"[{tag}] query(repeat of prompt 0) -> status={q['status']} "
        f"cached_tokens={q['cached_tokens']}")
    if q["cached_tokens"] <= 0:
        raise AssertionError(f"{tag}: query() shows no prefix hit")
    eng.flush(100)


def serve_rates(torch, make_engine, prompts, ttft, tag):
    """Prefill alone (1 new token) vs the full 32-token run on fresh
    engines from ``make_engine()``; TTFT (from the main run), token rates,
    peak memory, host phases per step and the device profile."""
    from deepspeed_tpu_torch.inference import SamplingParams

    def run(n_new, profiler=None):
        e = make_engine()
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
        free_engines(torch)
        return dt, computed, tm

    t_pre, computed, _ = run(1)
    t_all, _, tm = run(SERVE_NEW_TOKENS)
    n_dec = len(prompts) * (SERVE_NEW_TOKENS - 1)
    rates = dict(ttft_p50_ms=statistics.median(ttft),
                 prefill_tok_s=computed / t_pre,
                 decode_tok_s=n_dec / max(t_all - t_pre, 1e-9),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[{tag}] TTFT p50={rates['ttft_p50_ms']:.1f} ms "
        f"(min {ttft[0]:.1f}, max {ttft[-1]:.1f}); prefill "
        f"{rates['prefill_tok_s']:.0f} tok/s ({computed} prompt tokens in "
        f"{t_pre:.3f} s); decode {rates['decode_tok_s']:.0f} tok/s "
        f"({len(prompts)} x {SERVE_NEW_TOKENS - 1} tokens in "
        f"{t_all - t_pre:.3f} s); max_memory_allocated="
        f"{rates['peak_gib']:.2f} GiB")
    n = max(tm["steps"], 1)
    log(f"[{tag}] host phases per step over {int(tm['steps'])} steps "
        f"(ms): schedule {tm['schedule_ms'] / n:.3f}, stage "
        f"{tm['stage_ms'] / n:.3f}, enqueue {tm['device_ms'] / n:.3f}, "
        f"wait {tm['wait_ms'] / n:.3f}, readback {tm['readback_ms'] / n:.3f}")
    rates["device_ms_by_kind"] = device_profile(
        torch, lambda prof: run(SERVE_NEW_TOKENS, prof)[0], t_all, tag=tag)
    return rates


# ---------------------------------------------------------------------------
# phase 6 helpers
# ---------------------------------------------------------------------------

# the quantized serving runs: (a) bench.py's llama8b_serving_bench
# configuration (:752-758) without decode bursts, (b) the packed-int4
# weights with an fp8 cache
QUANT_RUNS = [("a", dict(weight_quant="int8", quantize_embeddings=True,
                         kv_quant="int8")),
              ("b", dict(weight_quant="int4", kv_quant="fp8"))]
# projections per layer that take the mixed-input GEMM: wq wk wv wo, and
# the MLP's wi wg wo
PROJECTIONS_PER_LAYER = 7


class plain_kernels:
    """Route the serving forward's kernels to their plain versions for the
    duration of a ``with`` block (the first-forward reference on the
    card): paged attention and the int8/int4 GEMMs."""

    def __enter__(self):
        import deepspeed_tpu_torch.inference.model as im
        import deepspeed_tpu_torch.ops.mixed_gemm as mg
        from deepspeed_tpu_torch.ops.paged_attention import (
            paged_attention_plain)
        self.saved = (im.paged_attention, mg.mixed_matmul_2d,
                      mg.mixed4_matmul_2d)
        im.paged_attention = paged_attention_plain
        mg.mixed_matmul_2d = mg.mixed_matmul_2d_plain
        mg.mixed4_matmul_2d = mg.mixed4_matmul_2d_plain
        return self

    def __exit__(self, *exc):
        import deepspeed_tpu_torch.inference.model as im
        import deepspeed_tpu_torch.ops.mixed_gemm as mg
        (im.paged_attention, mg.mixed_matmul_2d,
         mg.mixed4_matmul_2d) = self.saved
        return False


def quant_first_forward_check(torch, eng, prompts, tag):
    """First forward of two prompts with the engine's quantized weights and
    a fresh quantized cache: the kernel path vs the plain path on the same
    weights and cache (both bf16), within NOISE_FACTOR x the bf16 noise
    floor — the distance of the plain path from the same quantized model
    run in fp32 (dense weights and dequantized rows in fp32, no bf16
    rounding of x or of the dequantized weights)."""
    from deepspeed_tpu_torch.inference.model import ragged_forward
    from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                            StateManager)
    from deepspeed_tpu_torch.models.transformer import tree_map
    from deepspeed_tpu_torch.ops.quant import QuantizedTensor
    cfg = eng.cfg

    def forward(params, quant, mixed):
        sm = StateManager(KVCacheConfig(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, block_size=64,
            num_blocks=32, dtype=torch.bfloat16, quant=eng.icfg.kv_quant,
            device=eng.device), max_seqs=2)
        batch = sm.build_batch([(0, prompts[0]), (1, prompts[1])], 1024)
        logits, _ = ragged_forward(cfg, params, sm.kv, batch, 64, 8,
                                   quant=quant, mixed_gemm=mixed)
        out = logits[[sm.slot(0), sm.slot(1)]]
        del sm
        return out

    def retype(tree):
        if isinstance(tree, dict):
            return {k: retype(v) for k, v in tree.items()}
        return QuantizedTensor(tree.data, tree.scale, tree.zero, tree.bits,
                               tree.shape, torch.float32, layout=tree.layout)

    got = forward(eng.params, eng._quant, True)
    with plain_kernels():
        ref = forward(eng.params, eng._quant, True)
        ref32 = forward(tree_map(lambda t: t.float(), eng.params),
                        retype(eng._quant), False)
    torch.cuda.empty_cache()
    noise = float((ref - ref32).abs().max())
    tol = NOISE_FACTOR * noise
    max_err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    agree = got.argmax(-1) == top2.indices[:, 0]
    log(f"[{tag}] first forward, kernel path vs plain path (same quantized "
        f"weights and cache, both bf16): max|d|={max_err:.4f}; bf16 noise "
        f"floor (plain bf16 vs plain fp32)={noise:.4f} -> tol={tol:.4f}; "
        f"kernel path vs fp32: max|d|={float((got - ref32).abs().max()):.4f};"
        f" top1 agree={agree.tolist()} margins="
        f"{[round(float(m), 4) for m in margin]}")
    if not bool(torch.isfinite(got).all()) or max_err > tol:
        raise AssertionError(f"{tag}: first-forward logits disagree: max|d| "
                             f"{max_err} > {tol}")
    if bool(((margin > tol) & ~agree).any()):
        raise AssertionError(f"{tag}: first-forward top-1 disagrees where "
                             "the reference margin exceeds the tolerance")
    return max_err, tol


def serve_quant(torch, pa, mg, model, prompts, tag, over):
    """One quantized serving run of Llama-3-8B (full width and depth) at
    phase 5's traffic; returns the kernels' launch counts and the rates."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.models import Model

    cfg = model.config
    tag = f"serve-quant {tag}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    icfg = InferenceConfig(**SERVE_ENGINE, **over)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(model, icfg)       # quantizes on the card
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    dense_bytes, quant_bytes = tree_bytes(eng.params), tree_bytes(eng._quant)
    log(f"[{tag}] {over}: quantized on the card in {t_quant:.2f} s; "
        f"resident weights {(dense_bytes + quant_bytes) / 1e9:.3f} GB "
        f"(dense remainder {dense_bytes / 1e9:.3f} GB + quantized "
        f"{quant_bytes / 1e9:.3f} GB) vs the bf16 model's "
        f"{tree_bytes(model.params) / 1e9:.3f} GB; KV cache "
        f"{tree_bytes(eng.state.kv) / 1e9:.3f} GB; mixed gemm active="
        f"{eng._mixed_gemm_active}")
    if not eng._mixed_gemm_active:
        raise AssertionError(f"{tag}: the mixed-input GEMM is not active")
    ffwd = quant_first_forward_check(torch, eng, prompts, tag)

    int8 = over["weight_quant"] == "int8"
    k3, k3_other = ((mg.mixed_matmul_2d, mg.mixed4_matmul_2d) if int8
                    else (mg.mixed4_matmul_2d, mg.mixed_matmul_2d))
    kv_attr = f"{over['kv_quant']}_launches"
    sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    # the main path: counts to 0 just before, read just after
    mg.mixed_matmul_2d.launches = mg.mixed4_matmul_2d.launches = 0
    for fn in (mg.mixed_matmul_2d, mg.mixed4_matmul_2d):
        fn.design_launches = dict.fromkeys(MIXED_KERNELS, 0)
    pa.launches = pa.int8_launches = pa.fp8_launches = 0
    t0 = time.perf_counter()
    out = eng.generate(dict(enumerate(prompts)), sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k3=k3.launches, k3_other=k3_other.launches,
                    kv=getattr(pa, kv_attr),
                    other_pa=pa.launches + pa.int8_launches
                    + pa.fp8_launches - getattr(pa, kv_attr),
                    **k3.design_launches)
    steps = int(eng.timings["steps"])
    L = cfg.num_layers
    log(f"[{tag}] generate: 8 x 512-token prompts, {SERVE_NEW_TOKENS} new "
        f"tokens each, {steps} steps in {wall:.3f} s; mixed gemm int"
        f"{8 if int8 else 4} launches={launches['k3']} "
        f"({PROJECTIONS_PER_LAYER} x {L} layers x {steps} steps = "
        f"{PROJECTIONS_PER_LAYER * L * steps}: decode design "
        f"{launches['decode']}, prefill design {launches['prefill']}); "
        f"paged_attention "
        f"{over['kv_quant']} cache launches={launches['kv']} ({L} x {steps} = "
        f"{L * steps}); other variants: {launches['k3_other']} GEMM, "
        f"{launches['other_pa']} attention")
    check_tokens(out, cfg, SERVE_NEW_TOKENS, tag)
    if launches["k3"] != PROJECTIONS_PER_LAYER * L * steps or steps == 0 \
            or launches["kv"] != L * steps or launches["k3_other"] \
            or launches["other_pa"]:
        raise AssertionError(f"{tag}: the serving path did not run the "
                             f"run's kernels in every projection and layer "
                             f"of every step: {launches}")
    ttft = sorted(eng.ttft_ms[u] for u in out)
    check_prefix_and_cow(eng, prompts, sp, tag)
    # the rate runs reuse this quantized tree through quant_tree=
    dense = Model.from_params(cfg, eng.params)
    quant = eng._quant
    del eng
    free_engines(torch)
    rates = serve_rates(
        torch, lambda: InferenceEngine(dense, icfg, quant_tree=quant),
        prompts, ttft, tag)
    del dense, quant
    torch.cuda.empty_cache()
    # K3's device time a step of each kind (the profiled run repeats the
    # main run's schedule on a fresh engine: the same steps)
    by_kind = rates.pop("device_ms_by_kind") or {}
    if "mixed gemm other" in by_kind:
        raise AssertionError(f"{tag}: the profile shows a K3 kernel that is "
                             f"neither design's: {by_kind}")
    per_step = {}
    for design in MIXED_KERNELS:
        n = launches[design] / (PROJECTIONS_PER_LAYER * L)
        per_step[design] = (by_kind.get(f"mixed gemm {design}", 0.0) / n
                            if n else None)
    log(f"[{tag}] K3 device time a step: decode "
        + (f"{per_step['decode']:.3f} ms" if per_step["decode"] is not None
           else "n/a")
        + f" ({launches['decode'] // (PROJECTIONS_PER_LAYER * L)} steps), "
        f"prefill "
        + (f"{per_step['prefill']:.3f} ms" if per_step["prefill"] is not None
           else "n/a")
        + f" ({launches['prefill'] // (PROJECTIONS_PER_LAYER * L)} steps)")
    rates["k3_ms_per_step"] = per_step
    return dict(launches=launches, first_forward=ffwd,
                weight_bytes=dense_bytes + quant_bytes, **rates)


# ---------------------------------------------------------------------------
# phase 7 helpers
# ---------------------------------------------------------------------------

# phase 7's sampled run: BLOOM is served by sampling (temperature, top-k,
# top-p) with a seeded key
ALIBI_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
# the allowed card-vs-CPU difference of a sampled token: a row whose two
# best perturbed scores (logit + Gumbel noise) lie this close, where the
# card's and the host's float32 filters may round the logits apart
SAMPLE_TIE = 1e-4
ALIBI_INT8_NEW_TOKENS = 8


class capture_first_step:
    """Record sampled steps of the engine's serving loop inside a ``with``
    block: the first one (``recs["first"]``) and the first in which every
    slot samples (``recs["full"]``, a decode step): its base key, the
    batch's uids, context lengths and logits index, and the sampler's
    logits, per-row keys and tokens (all still on the card)."""

    def __enter__(self):
        import deepspeed_tpu_torch.inference.engine as em
        self.em, self.real, self.recs = em, em.pipelined_ragged_step, {}

        def step(cfg, params, quant, kv, batch, prev, rng, sample_fn, *a,
                 **kw):
            # every slot samples (host ints: no read from the card)
            full = batch.n_seqs == batch.logits_idx.shape[0]
            tag = ("first" if "first" not in self.recs else
                   "full" if full and "full" not in self.recs else None)
            if tag is None or rng is None:
                return self.real(cfg, params, quant, kv, batch, prev, rng,
                                 sample_fn, *a, **kw)

            def sample(logits, keys):
                toks = sample_fn(logits, keys)
                self.recs[tag] = dict(
                    rng=rng.clone(), uids=batch.seq_uids.clone(),
                    ctx=batch.context_lens.clone(),
                    idx=batch.logits_idx.clone(), logits=logits.clone(),
                    keys=keys.clone(), toks=toks.clone())
                return toks
            return self.real(cfg, params, quant, kv, batch, prev, rng, sample,
                             *a, **kw)

        em.pipelined_ragged_step = step
        return self

    def __exit__(self, *exc):
        self.em.pipelined_ragged_step = self.real
        return False


def check_first_step_on_cpu(torch, rec, sp, tag):
    """A sampled step's per-row keys, Gumbel noise and tokens, computed on
    the card, against the same functions on the CPU on the card's logits:
    keys and noise bit for bit; tokens equal, except a row whose two best
    perturbed scores lie within SAMPLE_TIE (logged).  Random BLOOM weights
    put the top logit tens of units above the rest, so the noise rarely
    decides a token; the tokens are compared again on the logits / 64
    (an exact scaling), where it does."""
    import numpy as np

    from deepspeed_tpu_torch.inference.sampler import (_filter, row_keys,
                                                       sample_rows)
    from deepspeed_tpu_torch.utils.prng import gumbel, key_to_numpy
    cpu = {k: v.cpu() for k, v in rec.items()}
    keys_cpu = row_keys(cpu["rng"], cpu["uids"], cpu["ctx"])
    same_keys = np.array_equal(key_to_numpy(keys_cpu),
                               key_to_numpy(cpu["keys"]))
    V = cpu["logits"].shape[-1]
    noise_card = gumbel(rec["keys"], (V,)).cpu()
    noise_cpu = gumbel(keys_cpu, (V,))
    noise_bits = int((noise_card.view(torch.int32)
                      != noise_cpu.view(torch.int32)).sum())
    log(f"[{tag}]: per-row keys card vs CPU bitwise equal={same_keys}; "
        f"Gumbel noise [{cpu['keys'].shape[0]}, {V}] words that differ="
        f"{noise_bits}")
    if not same_keys or noise_bits:
        raise AssertionError(f"{tag}: the card's keys or Gumbel noise differ "
                             "from the CPU's")
    valid = cpu["idx"] >= 0
    for label, div in (("logits", 1.0), ("logits / 64", 64.0)):
        toks_card = (cpu["toks"] if div == 1.0 else
                     sample_rows(rec["logits"] / div, sp, rec["keys"]).cpu())
        logits = cpu["logits"] / div
        toks_cpu = sample_rows(logits, sp, keys_cpu)
        top2 = (noise_cpu + _filter(logits, sp)).topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = valid & (toks_cpu != toks_card)
        not_argmax = valid & (toks_cpu != logits.argmax(-1))
        log(f"[{tag}] {label}: {int(valid.sum())} rows sampled; tokens "
            f"card={toks_card[valid].tolist()} cpu={toks_cpu[valid].tolist()}"
            f" ({int(not_argmax.sum())} rows not the argmax); rows that "
            f"differ={differ.nonzero().flatten().tolist()} (top-2 perturbed "
            f"gaps {[round(float(g), 6) for g in gap[differ]]})")
        if bool((differ & (gap >= SAMPLE_TIE)).any()):
            raise AssertionError(f"{tag}: a sampled token differs from the "
                                 f"CPU's where the top-2 gap is >= "
                                 f"{SAMPLE_TIE}")


def sampler_cost(torch, rec, sp, tag):
    """Device ms (CUDA events over 20 calls) and host ms per call of the
    step's key fold and sampler at the first step's shapes."""
    from deepspeed_tpu_torch.inference.sampler import row_keys, sample_rows
    res = {}
    for what, fn in (("row_keys", lambda: row_keys(rec["rng"], rec["uids"],
                                                   rec["ctx"])),
                     ("sample_rows", lambda: sample_rows(
                         rec["logits"], sp, rec["keys"]))):
        dev_ms = time_ms(torch, fn, 20)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = (time.perf_counter() - t) / 20 * 1e3
        torch.cuda.synchronize()
        res[what] = (dev_ms, host_ms)
    S, V = rec["logits"].shape
    log(f"[{tag}] sampler cost per step at [{S}, {V}] ({sp.temperature=}, "
        f"{sp.top_k=}, {sp.top_p=}): " + "; ".join(
            f"{k} {d:.3f} ms on the card, {h:.3f} ms to enqueue"
            for k, (d, h) in res.items()))
    return res


def serve_alibi(torch, pa, seed, device=None, **overrides):
    """Phase 7: BLOOM-7b1 served greedy (bf16 cache), seeded-sampled at
    pipeline depths 2 and 1, and with an int8 cache.  ``device`` and
    ``overrides`` as in :func:`serving_model`."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.utils.prng import PRNGKey
    tag = "serve-alibi"
    model, prompts = serving_model(torch, "bloom-7b1", seed, tag, device,
                                   **overrides)
    cfg = model.config
    res = serve(torch, pa, model, prompts, tag)
    L = cfg.num_layers

    # seeded sampling: the same stream at depth 2 and depth 1
    sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS, **ALIBI_SAMPLING)
    streams = {}
    for depth in (2, 1):
        eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE,
                                                     pipeline_depth=depth))
        with capture_first_step() as cap:
            t0 = time.perf_counter()
            streams[depth] = eng.generate(dict(enumerate(prompts)), sp,
                                          rng=PRNGKey(seed))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = int(eng.timings["steps"])
        log(f"[{tag}] sampled generate {ALIBI_SAMPLING}, rng=PRNGKey({seed}),"
            f" pipeline depth {depth}: {steps} steps in {wall:.3f} s; "
            f"request 0 -> {streams[depth][0][:12]}...")
        check_tokens(streams[depth], cfg, SERVE_NEW_TOKENS, tag)
        del eng
        free_engines(torch)
        if depth == 2:
            for which in ("first", "full"):
                check_first_step_on_cpu(torch, cap.recs[which], sp,
                                        f"{tag} {which} sampled step")
            res["sampler"] = sampler_cost(torch, cap.recs["full"], sp, tag)
        del cap
    same = streams[2] == streams[1]
    log(f"[{tag}] sampled streams at depth 2 and depth 1 identical={same}")
    if not same:
        raise AssertionError(f"{tag}: the seeded stream depends on the "
                             "pipeline depth")

    # the ALiBi kernel on the int8 cache, in every layer of every step
    eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE,
                                                 kv_quant="int8"))
    pa.launches = pa.int8_launches = pa.fp8_launches = 0
    pa.alibi_launches = 0
    out = eng.generate(dict(enumerate(prompts)), SamplingParams(
        max_new_tokens=ALIBI_INT8_NEW_TOKENS))
    torch.cuda.synchronize()
    steps = int(eng.timings["steps"])
    res["int8_launches"] = pa.int8_launches
    log(f"[{tag}] int8 cache ({tree_bytes(eng.state.kv) / 1e9:.3f} GB): "
        f"{ALIBI_INT8_NEW_TOKENS} new tokens, {steps} steps; int8 launches="
        f"{pa.int8_launches}, with ALiBi={pa.alibi_launches} ({L} x {steps} "
        f"= {L * steps}); other variants {pa.launches + pa.fp8_launches}")
    check_tokens(out, cfg, ALIBI_INT8_NEW_TOKENS, tag)
    if not (pa.alibi_launches == pa.int8_launches == L * steps) or steps == 0 \
            or pa.launches or pa.fp8_launches:
        raise AssertionError(f"{tag}: the int8-cache run did not launch the "
                             "ALiBi kernel on the int8 cache in every layer "
                             "of every step")
    del eng, model
    free_engines(torch)
    return res


def device_profile(torch, run, wall_unprofiled, tag="serve"):
    """The kernels that take the device time, over one more full run under
    torch.profiler (``run(prof)`` returns its wall seconds), and the
    device busy share: that device time over the same run's wall time
    WITHOUT the profiler (``wall_unprofiled``; the profiler slows the host
    several times over).  Returns the device ms by kind (KERNEL_GROUPS),
    empty when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    wall = run(prof)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            rows.append((us, e.count, e.key))
    total_us = sum(r[0] for r in rows)
    if total_us <= 0:
        log(f"[{tag}] device busy share: not measured (the profiler "
            "recorded no device time)")
        return {}
    log(f"[{tag}] device time {total_us / 1e3:.1f} ms; busy share "
        f"{100 * total_us / 1e6 / wall_unprofiled:.1f}% of the unprofiled "
        f"{wall_unprofiled * 1e3:.1f} ms wall ({wall * 1e3:.1f} ms under the "
        f"profiler); top kernels by device time:")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"[{tag}]   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    groups, paged = {}, []
    for us, count, key in rows:
        name = next((g for g, subs in KERNEL_GROUPS
                     if any(s in key for s in subs)), "other")
        groups[name] = groups.get(name, 0.0) + us
        if name == "paged attention":
            paged.append(f"{key[:80]} {count}x {us / 1e3:.2f} ms")
    log(f"[{tag}] device time by kind: " + ", ".join(
        f"{g} {us / 1e3:.2f} ms ({100 * us / total_us:.1f}%)"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])))
    if paged:
        log(f"[{tag}] paged attention's kernels: " + "; ".join(paged))
    return {g: us / 1e3 for g, us in groups.items()}


# kernel-name substrings -> kind, first match wins (a cast is a copy
# kernel inside an elementwise template, so copies come before elementwise;
# the port's two K3 kernels come before the library GEMMs' "gemm", and any
# other name with "mixed_gemm" in it would show as "mixed gemm other")
KERNEL_GROUPS = [("flash attention", ("flash_fwd", "flash_dq", "flash_dkv",
                                      "flash90::", "fwd32_kernel",
                                      "dq32_kernel", "dkv32_kernel")),
                 ("paged attention", ("paged_attention",)),
                 *[(f"mixed gemm {d}", (k,)) for d, k in MIXED_KERNELS.items()],
                 ("mixed gemm other", ("mixed_gemm",)),
                 ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("copies and casts", ("copy",)),
                 ("reductions", ("reduce",)),
                 ("elementwise", ("elementwise",))]


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="device,build,kernel,train,train-fp32,serve,"
                            "serve-quant,serve-alibi,serve-mqa,train-fp16")
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

    from deepspeed_tpu_torch.ops import BUILDERS, build_all
    from deepspeed_tpu_torch.platform.cuda import device_report
    pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    mg = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")
    pa = pa_mod.paged_attention
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[time] phase {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # 1. device
    rep = device_report()
    log(f"[device] {rep['name']} count={rep['count']} capability="
        f"{rep['capability']} torch={rep['torch']} cuda={rep['cuda']} "
        f"nvidia-smi: {rep['nvidia_smi']}")
    if not rep["sm90"]:
        raise SystemExit("chip_smoke: the kernels are built for sm_90a; "
                         f"this card is {rep['capability']}")
    phase_done("device")

    # 2. build
    if "build" in phases:
        build_all(BUILDERS, force=True)
        for b in BUILDERS:
            log(f"[build] {b.name}: {' '.join(b.command)}")
            log(f"[build] {b.name}: {b.build_seconds:.2f} s; nvcc output:")
            for line in b.build_log.strip().splitlines():
                log(f"[build]   {line.strip()}")
        phase_done("build")

    # 3. kernels vs plain
    kern = None
    qkv_kern, mixed_kern, alibi_kern, flash_kern = {}, {}, {}, {}
    mqa_kern = {}
    if "kernel" in phases:
        from deepspeed_tpu_torch.models.layers import alibi_slopes
        dev = torch.device("cuda")
        for name, (H, Hkv, D, bs, nblk, iters), alibi in K2_CASES:
            make = decode_batch if "decode" in name else mixed_batch
            case = make(torch, H, Hkv, D, bs, nblk, args.seed, dev)
            slopes = alibi_slopes(H, device=dev) if alibi else None
            res = check_kernel_case(torch, pa, name, case, H, Hkv, D, iters,
                                    slopes)
            if alibi:
                alibi_kern.setdefault("bf16", res)
            elif name.startswith("falcon-7b"):
                mqa_kern.setdefault("bf16", res)
            elif kern is None:
                kern = res
            if name in ("llama3-8b mixed", "llama3-8b decode",
                        "bloom-7b1 mixed"):     # the quantized caches
                for code in ("int8", "fp8"):
                    res = check_quant_kv_case(torch, pa, name, case, code, H,
                                              Hkv, D, iters, slopes)
                    (alibi_kern if alibi else qkv_kern).setdefault(code, res)
            del case
            torch.cuda.empty_cache()
        for name, dt, (B, H, Hkv, S, D, iters) in FLASH_CASES:
            res = check_flash_case(torch, fa, name, B, H, Hkv, S, D, iters,
                                   dt)
            if FLASH_VARIANTS.get((dt, D)) == name:
                flash_kern[dt, D] = res
            torch.cuda.empty_cache()
        for bits in (8, 4):
            for name, kdims, N in MIXED_PROJECTIONS:
                for M in MIXED_M:
                    res = check_mixed_case(torch, mg, name, kdims, N, M, bits,
                                           iters=50 if M <= 8 else 10)
                    if name == "wi":          # a decode and a prefill step
                        mixed_kern[bits, res.pop("design")] = res
                    torch.cuda.empty_cache()
        phase_done("kernel")

    # 4. and 4b. the training path, bf16 and fp32 (GPT-2-small); 8. fp16
    # (phi-2) runs last.  flash_runs: each training run's flash launches by
    # kernel and variant, as its counts read
    flash_runs = []
    for run in ("train", "train-fp32"):
        if run in phases:
            flash_runs.append(train(torch, fa, args.seed, run))
            phase_done(run)

    # 5. and 6. the serving paths, bf16 and quantized, on one model
    launches = None
    quant_runs = {}
    if phases & {"serve", "serve-quant"}:
        model, prompts = serving_model(torch, "llama3-8b", args.seed)
        if "serve" in phases:
            launches = serve(torch, pa, model, prompts)["launches"]
        if "serve-quant" in phases:
            for tag, over in QUANT_RUNS:
                quant_runs[tag] = serve_quant(torch, pa, mg, model, prompts,
                                              tag, over)
        del model
        torch.cuda.empty_cache()
        phase_done("serve, serve-quant")

    # 7. BLOOM-7b1 with ALiBi, after the Llama model is freed
    alibi_run = {}
    if "serve-alibi" in phases:
        alibi_run = serve_alibi(torch, pa, args.seed)
        phase_done("serve-alibi")

    # 7b. falcon-7b (71 query heads over 1 KV head), after BLOOM is freed
    mqa_launches = None
    if "serve-mqa" in phases:
        model, prompts = serving_model(torch, "falcon-7b", args.seed,
                                       tag="serve-mqa")
        mqa_launches = serve(torch, pa, model, prompts,
                             tag="serve-mqa")["launches"]
        del model
        free_engines(torch)
        phase_done("serve-mqa")

    # 8. phi-2 in fp16 with the dynamic loss scaler, after falcon is freed
    if "train-fp16" in phases:
        flash_runs.append(train(torch, fa, args.seed, "train-fp16"))
        phase_done("train-fp16")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if kern is not None:
        pa_src = "deepspeed_tpu_torch/ops/csrc/paged_attention.cu"
        pa_replaces = "deepspeed_tpu/ops/paged_attention.py:48"
        replaces = {"flash_fwd": "deepspeed_tpu/ops/flash_attention.py:76",
                    "flash_dq": "deepspeed_tpu/ops/flash_attention.py:173",
                    "flash_dkv": "deepspeed_tpu/ops/flash_attention.py:212"}

        def flash_name(k, dt, d):
            # bf16 at D 64 keeps the name of the slice that ported it
            if (dt, d) == ("bfloat16", 64):
                return k
            tag = {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}
            return f"{k}_{tag[dt]}_d{d}"

        def flash_entry(k, dt, d):
            # what the training runs' counts read (null: none ran)
            launches = (sum(r[k].get((dt, d), 0) for r in flash_runs)
                        if flash_runs else None)
            # the file that holds the kernel the variant ran
            src = {"wgmma": "flash_attention_sm90.cuh",
                   "wmma": "flash_attention.cuh"}.get(
                       flash_design(k, dt, d), "flash_attention_fp32.cu")
            return dict(name=flash_name(k, dt, d), route="cuda",
                        source=f"deepspeed_tpu_torch/ops/csrc/{src}",
                        replaces=replaces[k], launches=launches,
                        **flash_kern[dt, d][k])

        def quant_launches(run, key):
            return quant_runs[run]["launches"][key] if run in quant_runs \
                else None

        entries = [dict(name="paged_attention", route="cuda", source=pa_src,
                        replaces=pa_replaces, launches=launches, **kern)]
        entries += [dict(name=f"paged_attention_{code}kv", route="cuda",
                         source=pa_src, replaces=pa_replaces,
                         launches=quant_launches(run, "kv"),
                         **qkv_kern[code])
                    for code, run in (("int8", "a"), ("fp8", "b"))]
        entries += [flash_entry(k, dt, d) for dt, d in FLASH_VARIANTS
                    for k in FLASH_KERNELS]
        # K3: one entry per (bits, design); the prefill design keeps the
        # name of the slice that ported it
        entries += [dict(name=f"mixed_matmul_int{bits}"
                         + ("" if design == "prefill" else f"_{design}"),
                         route="cuda",
                         source="deepspeed_tpu_torch/ops/csrc/mixed_gemm.cu",
                         replaces=f"deepspeed_tpu/ops/mixed_gemm.py:{line}",
                         launches=quant_launches(run, design),
                         **mixed_kern[bits, design])
                    for bits, line, run in ((8, 49, "a"), (4, 125, "b"))
                    for design in ("decode", "prefill")]
        entries += [dict(name=name, route="cuda", source=pa_src,
                         replaces=pa_replaces,
                         launches=alibi_run.get(key), **alibi_kern[code])
                    for name, code, key in (
                        ("paged_attention_alibi", "bf16", "alibi_launches"),
                        ("paged_attention_alibi_int8kv", "int8",
                         "int8_launches"))]
        entries += [dict(name="paged_attention_mqa", route="cuda",
                         source=pa_src, replaces=pa_replaces,
                         launches=mqa_launches, **mqa_kern["bf16"])]
        print(json.dumps({"kernels": entries}), flush=True)
    print(rep["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
