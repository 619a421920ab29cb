#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one card.

    python3 chip_smoke.py              # every phase, one H100
    python3 chip_smoke.py --phases device,build,kernel   # a shorter run
    python3 chip_smoke.py --phases device,build,kernel,train
    python3 chip_smoke.py --phases device,build,kernel,serve-quant
    python3 chip_smoke.py --phases device,build,kernel,serve-alibi
    python3 chip_smoke.py --phases device,build,kernel,serve-mqa
    python3 chip_smoke.py --phases device,build,kernel,serve-burst
    python3 chip_smoke.py --phases device,build,kernel,serve-spec
    python3 chip_smoke.py --phases device,build,kernel,serve-failover
    python3 chip_smoke.py --phases device,build,kernel,train-fp16
    python3 chip_smoke.py --phases device,build,kernel,train-ckpt,serve-moe,train-moe
    python3 chip_smoke.py --phases device,build,kernel,train-offload,train-nvme

Phases, in order; any failure exits non-zero (nothing is caught and
passed over):

1. device  — the card's name, count, capability, nvidia-smi power limit;
             the host's MemTotal, MemAvailable, RLIMIT_MEMLOCK, CPU count
             and torch threads; the NVMe phase directory's (build/) mount
             point, filesystem and free bytes.
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
             design that ran (wgmma: fwd, dq and dkv at every D, in
             bf16/fp16; fp32-rb: the fp32 dk/dv; fp32-rbq: the fp32 fwd
             and dq), its TFLOP/s, its ratio to SDPA, the host
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
4c. train-ckpt — checkpoints of phase 4's GPT-2 training (its
             configuration, bench.py:145-168): engine A takes 2 steps,
             save_checkpoint, 2 more; engine B (other random weights)
             load_checkpoint and the same 2 steps: the restored state
             bitwise the saved one, B's losses and final master and
             moments bitwise A's (if not: the same two steps again from
             the checkpoint, the run-to-run spread, and the ops PyTorch
             names as non-deterministic); then checkpoint.async_save: A
             takes a step while the worker writes, wait_checkpoint, a
             fresh engine loads the checkpoint bitwise A's state at the
             save, and consolidate equals its master.  Prints the
             checkpoint's bytes, save and load seconds and GB/s, the
             async save's blocking ms against its write's wall; the
             checkpoints live in a temporary directory under build/.
   Serving (phases 5-7d) runs every step and every burst as a replay
             of a CUDA graph the engine captured (InferenceEngine's graph
             cache): each measured run follows a warm-up run on the same
             engine that captures its graphs (then the prefix cache,
             timings and TTFTs are reset), checks that it captured nothing
             and replayed a graph for every step and burst, and prints
             the captures, replays, capture ms and the host's enqueue ms
             a decode step and a prefill step.
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
6c. serve-burst — the same model in bench.py's llama8b_serving_bench
             configuration (:744-758, decode_burst=8): int8 weights and
             embeddings, an int8 cache, phase 5's prompts prefilled by
             step() and decoded by 4 decode_burst() calls of 8 iterations
             (each one graph); K3 launches = 7 x layers x (prefill steps
             + burst iterations), paged attention only in the prefill
             steps, the first burst's tokens against a step() loop from
             the same state (equal but at near-ties of the teacher-forced
             logits), decode tok/s against phase 6 (a).
6d. serve-failover — failure domains and the serving seam on phase 5's
             model, traffic and engine (phase 5 runs with it: its streams
             are the reference of (b)-(d), under the near-tie rule, which
             teacher-forces every token after a divergence): (a) a poison
             request (an injected crash on every batch holding uid 2)
             quarantined by bisection, status failed, the 7 others
             finish as the same step() driver's fault-free round; (b)
             real watchdog expiries: a sleep queued on the
             engine's stream before a warm decode step's readback, then
             before the next dispatched step, kills the engine (two
             abandoned workers) and InferenceEngine.restore of its
             snapshot finishes every stream (recovery wall time
             printed); (c) migrate_out on engine A into
             load_snapshot(merge=True) on engine B after 8 decode steps;
             (d) a drain cut short by its deadline, its shed requests
             restored on B; (e) a device-side assert inside the guarded
             readback of a GPT-2 engine in a child process (the CUDA
             context is lost): classified fatal, the child's snapshot
             restored here against an uninterrupted run; (f) the default
             watchdog's cost: phase 5's enqueue ms and decode tok/s with
             dispatch_timeout_ms=None and with the default "auto", in
             turns (off, auto, off, auto) on fresh engines.  K2
             launches = layers x (dispatched steps + captures) in every
             scenario, retried steps included.
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
7c. serve-spec — GPT-2 at full width and depth (random bf16 weights)
             in bench.py's spec_decode_serving_bench (:1111-1187): 8
             prompts of 64 tokens (4-6 token motifs repeated), 96 greedy
             new tokens, budget 256, 256 blocks of 64, depth 1, drafts of
             at most 4, speculation off then on: identical streams, fewer
             steps with it on, paged-attention launches = layers x steps,
             the acceptance rate and tok/s both ways; each mode also runs
             with dispatch_timeout_ms=None, for the default watchdog's
             cost at depth 1 (tok/s and wait ms a step).
7d. serve-moe — qwen2-moe-a2.7b at full width and depth (24 layers, 60
             experts top-4 with raw top-k weights, a shared expert of
             5632, 16 heads of 128, vocab 151936): random bf16 weights
             from a seed drawn on the card, renamed to the
             Qwen2MoeForCausalLM state dict and imported back through
             checkpoint.hf.load_hf_state_dict (bitwise the drawn tree),
             then phase 5's traffic and engine (every measured step a
             replay, paged-attention launches = layers x steps, the
             first-forward check against the dense forward at a
             capacity that drops nothing, a prefix hit and a COW repeat,
             TTFT, token rates, the device profile), then an eager
             prefill and decode step's device ms by MoE part (gating,
             dispatch/combine, expert bmm, shared expert, attention,
             dense GEMMs, other) and the resident bytes.
8b. train-moe — qwen2-moe-a2.7b at its published widths with depth cut
             to 2 layers (1.76 B params), bf16, seq 1024, micro-batch 4,
             1 + 3 steps: finite loss, aux/moe_aux_loss in the metrics,
             one launch of each flash kernel per layer per step at D 128,
             a first-step parity check against the plain attention,
             tokens/s, MFU (active parameters), peak memory and the
             device profile.
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
9. train-offload — ZeRO-Offload (offload_optimizer cpu, pinned) of
             gptj-6b at full width and depth (6.05 B params; the host's
             MemAvailable is below what Llama-3-8B's 96.4 GB of pinned
             state needs, see OFFLOAD_RUN), bf16, seq 2048, micro-batch 2,
             remat "flash", 1 + 3 steps: finite loss and norm, one launch
             of each flash kernel per layer a step (D 256), the master and
             moments pinned CPU tensors, peak device memory under 80 GB;
             each step split into device forward/backward, grad D2H, host
             update and H2D with GB/s; tokens/s, MFU, pinned bytes, peak
             RSS; one more step whose device forward/backward runs under
             torch.profiler: device ms by kind, each flash kernel's ms and
             the device's idle ms against the unprofiled forward/backward;
             a 2-layer cut trained 2 steps with and without offload:
             losses bitwise, masters within 2 x lr x steps (rms lr / 10).
10. train-nvme — ZeRO-Infinity on gptj-6b cut to 4 layers (1.22 B
             params), bf16, seq 2048, micro-batch 1, its stores in a
             temporary directory in /dev/shm (the machine's only disk, 9p,
             takes 45 GiB of writes a machine: NVME_RUN): (a) a 2 GB file
             through the aio pool on the disk and on the store's
             filesystem, with each backend and O_DIRECT on and off (bytes
             equal, GB/s with the filesystem's name); (b) offload_optimizer nvme and
             (c) plus offload_param nvme with model= (per-layer
             streaming), 1 + 2 steps each: seconds of each sweep and NVMe
             bytes a step; losses within 2x the bf16 floor of the
             device-resident engine's and consolidated masters within the
             stated bound; (c)'s peak device memory under its reckoning
             and its host residency under two swap groups and a grad
             group; the flash forward twice per layer a step (the sweep,
             then the recompute), dq and dkv once; (c)'s checkpoint loaded
             (written to the disk) loaded by a fresh streamed engine:
             master, moments and the next step's loss bitwise.

Every phase prints its wall time ("[time] phase ...").

The line before the last is the card's name and power limit as nvidia-smi
reports them; the line before that, the per-kernel JSON (a flash variant's
``launches`` is the sum over the training phases that ran of what its
count read, by dtype and the head dim the kernel ran at; null when no
training phase ran; K3 has an entry per weight type and design, timed at
wi, with the launches of that design in phase 6; K2's entries name the
designs their timed batch ran, ``design``, and paged_attention_mqa, timed
on the falcon-7b mixed batch, carries serve-mqa's launches;
paged_attention's ``failover_launches`` are K2's launches in
serve-failover's scenarios (a)-(d), its ``moe_launches`` those of
serve-moe's measured run; the flash entries' launches include
train-ckpt's, train-moe's, train-offload's and train-nvme (c)'s); the last
line,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
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
# (71 heads over 1 KV head, D 64), each on the mixed and the decode batch;
# serve-moe's qwen2-moe-a2.7b (16 heads of 128 over 16, no slopes: the plan
# splits its work items by the head count, so it may route unlike BLOOM's).
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
            ("falcon-7b decode", (71, 1, 64, 64, 512, 100), False),
            ("qwen2-moe-a2.7b mixed", (16, 16, 128, 64, 512, 20), False),
            ("qwen2-moe-a2.7b decode", (16, 16, 128, 64, 512, 100), False)]


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
# 12 heads of 64, seq 1024); qwen2-moe train-moe's (micro-batch 4, 16 heads
# of 128, seq 1024), ahead of the other D 128 cases so that the JSON line's
# entry for the variant reports the shape its launches ran at, and
# train-offload's gptj-6b (micro-batch 2, 16 heads of 256, seq 2048) ahead
# of the gptj-6b case for the same reason (train-nvme runs the latter, at
# micro-batch 1); Llama-3-8B's training shape (micro-batch 2, seq 2048);
# llama-0.7B is
# bench.py's long-context training
# leg (:586-593); Llama-3-8B its serving width at S=4096.  fp16: phi-2's
# training width (phase 8: micro-batch 4, 32 heads of 80, seq 2048) and the
# GPT-2 shape.  bf16 and fp16 at the other head dims of the presets:
# gptj-6b (16 heads of 256), phi3-mini (32 of 96, S=4096) and the *-tiny
# models' 32 (8 heads).  fp32: the GPT-2 shape at phase 4b's micro-batch 8
# and phi-2's width at B=1.
FLASH_CASES = [
    ("gpt2 train", "bfloat16", (32, 12, 12, 1024, 64, 20)),
    ("qwen2-moe train", "bfloat16", (4, 16, 16, 1024, 128, 20)),
    ("llama-0.7B train", "bfloat16", (2, 16, 8, 2048, 128, 20)),
    ("llama3-8b", "bfloat16", (1, 32, 8, 4096, 128, 10)),
    ("llama3-8b train", "bfloat16", (2, 32, 8, 2048, 128, 10)),
    ("gptj-6b train", "bfloat16", (2, 16, 16, 2048, 256, 10)),
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
    by kernel and dtype): "wgmma" (csrc/flash_attention_sm90.cuh: bf16 and
    fp16 fwd, dq and dkv at every D), "fp32-rb" (the register-blocked fp32
    dk/dv, keys resident) or "fp32-rbq" (the register-blocked fp32 fwd and
    dq, queries resident; both in csrc/flash_attention_fp32.cu)."""
    if dtype == "float32":
        return "fp32-rb" if kname == "flash_dkv" else "fp32-rbq"
    return "wgmma"


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
#   train-moe   qwen2-moe-a2.7b at its published widths (60 experts top-4,
#               a shared expert of 5632, 16 heads of 128, vocab 151936)
#               with depth cut to 2 layers (1.76 B params, ~28 GB of
#               fp32 master and AdamW moments); bf16, seq 1024,
#               micro-batch 4
TRAIN_RUNS = {
    "train": dict(preset="gpt2", precision="bf16", seq=1024, micro=32,
                  warmup=2, steps=10, remat=False, policy="nothing"),
    "train-fp32": dict(preset="gpt2", precision="fp32", seq=1024, micro=8,
                       warmup=2, steps=3, remat=False, policy="nothing"),
    "train-fp16": dict(preset="phi-2", precision="fp16", seq=2048, micro=4,
                       warmup=2, steps=5, remat=True, policy="flash"),
    "train-moe": dict(preset="qwen2-moe-a2.7b", precision="bf16", seq=1024,
                      micro=4, warmup=1, steps=3, remat=False,
                      policy="nothing", model=dict(num_layers=2)),
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
        **{**spec.get("model", {}), **overrides})
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
    if cfg.num_experts > 1:
        aux = [float(m["aux/moe_aux_loss"]) for m in metrics]
        drop = [float(m["aux/moe_dropped"]) for m in metrics]
        log(f"[{run}] aux/moe_aux_loss per step {[round(x, 5) for x in aux]}"
            f"; aux/moe_dropped {[round(x, 5) for x in drop]}")
        if not all(map(math.isfinite, aux)):
            raise AssertionError("non-finite MoE aux loss")
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
    # an MoE token runs top_k of E experts: count the active parameters
    active = n_params - (param_count(model.params["blocks"]["experts"])
                         * (1 - cfg.moe_top_k / cfg.num_experts)
                         if cfg.num_experts > 1 else 0)
    flops_per_token = 6 * active + 12 * cfg.num_layers * cfg.d_model * (
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
    fp32 engine for bf16 and fp16 (the reference engines run SGD: the
    first step's loss and grad norm do not depend on the optimizer, and
    SGD holds one buffer in place of Adam's two); for fp32 the loss and
    the norm of its gradient computed directly in fp64 (the engine
    computes in at most fp32)."""
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
        loss = loss[0] if isinstance(loss, tuple) else loss
        grads = torch.autograd.grad(loss, leaves)
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        res = (float(loss.detach()), float(norm))
        del leaves, loss, grads
        free_engines(torch)
        return res

    ref = engine_step(prec, spec["policy"])
    if prec in ("fp16", "bf16"):
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
    if cfg.num_experts > 1:
        # capacity >= T on both paths: no choice is dropped, so the
        # serving MoE (capacity from the step's budget) and the dense
        # forward's (per-sequence groups) compute the same function
        cf = cfg.num_experts / cfg.moe_top_k
        cfg = dataclasses.replace(cfg, capacity_factor=cf,
                                  eval_capacity_factor=cf)
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
    return tol


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
    carry the slopes), the rates, the streams and the first forward's
    bf16 noise tolerance (serve-failover's reference)."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)

    cfg = model.config
    alibi = cfg.position == "alibi"
    torch.cuda.reset_peak_memory_stats()
    tol = first_forward_check(torch, model, prompts, tag)

    icfg = InferenceConfig(**SERVE_ENGINE)
    sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    eng = InferenceEngine(model, icfg)
    log(f"[{tag}] KV cache {tree_bytes(eng.state.kv) / 1e9:.3f} GB")
    warm_graphs(torch, eng, prompts, (SERVE_NEW_TOKENS,), tag)
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
    check_replayed(eng.timings, tag)
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
    return dict(launches=launches, alibi_launches=alibi_launches, streams=out,
                tol=tol, ttft=ttft, **rates)


def fresh_run(eng) -> None:
    """Leave a warmed engine as a fresh one would run: no prefix-cache
    entries, zeroed timings and TTFTs (its graphs stay captured)."""
    eng.state.reset_prefix_cache()
    eng.reset_timings()
    eng.ttft_ms.clear()


def warm_graphs(torch, eng, prompts, new_tokens, tag):
    """Run the traffic once per ``new_tokens`` count, capturing every
    graph the measured runs replay (no capture may land in a measured
    window), then leave the engine as fresh."""
    from deepspeed_tpu_torch.inference import SamplingParams
    t0 = time.perf_counter()
    captured = capture_ms = replays = 0
    for n in new_tokens:
        fresh_run(eng)
        eng.generate(dict(enumerate(prompts)), SamplingParams(
            max_new_tokens=n))
        tm = eng.timings
        captured += tm["compiles"]
        capture_ms += tm["compile_ms"]
        replays += tm["graph_replays"]
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up: {len(new_tokens)} run(s) in "
        f"{time.perf_counter() - t0:.3f} s captured {int(captured)} CUDA "
        f"graphs in {capture_ms:.1f} ms (warm-up included), "
        f"{int(replays)} replays; graphs held "
        f"{len(eng._graphs)} step + {len(eng._burst_graphs)} burst")
    fresh_run(eng)


def check_replayed(tm, tag, captures_ok=False):
    """Every step and burst of a run replayed a graph, captured before
    the run (a measured run) or in it (``captures_ok``)."""
    log(f"[{tag}] graphs: {int(tm['compiles'])} captured in this run "
        f"({tm['compile_ms']:.1f} ms), {int(tm['graph_replays'])} replays "
        f"for {int(tm['steps'])} steps and {int(tm['bursts'])} bursts; "
        + enqueue_line(tm))
    if (tm["compiles"] and not captures_ok) \
            or tm["graph_replays"] != tm["steps"] + tm["bursts"]:
        raise AssertionError(f"{tag}: a step or burst of the run did not "
                             f"replay a graph (warmed: {not captures_ok}): "
                             f"{tm}")


def enqueue_line(tm) -> str:
    """The host's enqueue ms a decode step and a prefill step."""
    dec = tm["decode_steps"]
    pre = tm["steps"] - dec
    return (f"enqueue a decode step "
            + (f"{tm['decode_device_ms'] / dec:.3f} ms ({int(dec)} steps)"
               if dec else "n/a")
            + ", a prefill step "
            + (f"{(tm['device_ms'] - tm['decode_device_ms']) / pre:.3f} ms "
               f"({int(pre)} steps)" if pre else "n/a"))


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


def serve_rates(torch, make_engine, prompts, ttft, tag, profile=True):
    """Prefill alone (1 new token) vs the full 32-token run on fresh
    engines from ``make_engine()``; TTFT (from the main run), token rates,
    peak memory, host phases per step and (``profile``) the device
    profile."""
    from deepspeed_tpu_torch.inference import SamplingParams

    e = make_engine()
    warm_graphs(torch, e, prompts, (1, SERVE_NEW_TOKENS), tag)

    def run(n_new, profiler=None):
        fresh_run(e)
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
        check_replayed(tm, f"{tag} rates, {n_new} new")
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
        f"wait {tm['wait_ms'] / n:.3f}, readback {tm['readback_ms'] / n:.3f}"
        f"; {enqueue_line(tm)}")
    rates["enqueue_ms"] = dict(
        decode=tm["decode_device_ms"] / max(tm["decode_steps"], 1),
        prefill=(tm["device_ms"] - tm["decode_device_ms"])
        / max(tm["steps"] - tm["decode_steps"], 1))
    rates["wait_ms"] = tm["wait_ms"] / n
    if profile:
        rates["device_ms_by_kind"] = device_profile(
            torch, lambda prof: run(SERVE_NEW_TOKENS, prof)[0], t_all,
            tag=tag)
    del e
    free_engines(torch)
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
    warm_graphs(torch, eng, prompts, (SERVE_NEW_TOKENS,), tag)
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
    check_replayed(eng.timings, tag)
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
# serve-burst and serve-spec helpers
# ---------------------------------------------------------------------------

# bench.py's llama8b_serving_bench engine (:752-758): int8 weights and
# embeddings, an int8 cache, decode bursts of 8
BURST_ENGINE = dict(token_budget=1024, max_seqs=8, kv_block_size=64,
                    num_kv_blocks=128, kv_quant="int8", weight_quant="int8",
                    quantize_embeddings=True, decode_burst=8)
BURST_ROUNDS = 4            # bench.py's decode_rounds


def serve_burst(torch, pa, mg, model, prompts, decode_ref=None):
    """serve-burst: Llama-3-8B int8 (weights, embeddings, cache) prefills
    phase 5's 8 prompts by step() and decodes through decode_burst() (8
    iterations a burst, one CUDA graph), after a warm-up pass and a
    stepwise pass from the same state.  Checks: tokens in range; the
    measured pass replays warmed graphs only; K3 launches = 7 x layers x
    (prefill steps + burst iterations), paged attention = layers x
    prefill steps (none inside a burst); the first burst's tokens equal a
    step() loop's from the same state, except after a near-tie
    (:func:`check_near_ties`: the burst's attention is plain torch over a
    dense snapshot, the step's is K2).
    ``decode_ref``: phase 6 (a)'s decode tok/s, for the log."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    tag = "serve-burst"
    cfg = model.config
    L = cfg.num_layers
    torch.cuda.empty_cache()
    eng = InferenceEngine(model, InferenceConfig(**BURST_ENGINE))
    log(f"[{tag}] {BURST_ENGINE}: resident weights "
        f"{(tree_bytes(eng.params) + tree_bytes(eng._quant)) / 1e9:.3f} GB, "
        f"KV cache {tree_bytes(eng.state.kv) / 1e9:.3f} GB")
    _, tol = quant_first_forward_check(torch, eng, prompts, tag)
    sp = SamplingParams(max_new_tokens=1 << 30)
    uids = range(len(prompts))

    def prefill():
        for uid in uids:
            eng.put(uid, list(prompts[uid]))
        first, steps = {}, 0
        while len(first) < len(prompts):
            first.update(eng.step(sampling=sp))
            steps += 1
        return first, steps

    def bursts(first, rounds):
        last = dict(first)
        out = []
        for _ in range(rounds):
            for uid in uids:
                eng.put(uid, [last[uid]])
            got = eng.decode_burst(sampling=sp)
            out.append(got)
            last = {u: t[-1] for u, t in got.items()}
        return out

    def finish():
        for uid in uids:
            eng.flush(uid)
        torch.cuda.synchronize()
        fresh_run(eng)

    t0 = time.perf_counter()
    first, _ = prefill()
    bursts(first, 2)
    finish()
    log(f"[{tag}] warm-up pass in {time.perf_counter() - t0:.3f} s: graphs "
        f"{len(eng._graphs)} step + {len(eng._burst_graphs)} burst")
    # the stepwise reference: 8 step() iterations from the prefill state
    first, _ = prefill()
    stepwise = {u: [] for u in uids}
    cur = dict(first)
    for _ in range(BURST_ENGINE["decode_burst"]):
        for uid in uids:
            eng.put(uid, [cur[uid]])
        cur = eng.step(sampling=sp)
        for uid, t in cur.items():
            stepwise[uid].append(t)
    finish()

    # the main path: counts to 0 just before, read just after
    mg.mixed_matmul_2d.launches = mg.mixed4_matmul_2d.launches = 0
    mg.mixed_matmul_2d.design_launches = dict.fromkeys(MIXED_KERNELS, 0)
    pa.launches = pa.int8_launches = pa.fp8_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first_m, pre_steps = prefill()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rounds = bursts(first_m, BURST_ROUNDS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k3, k2 = mg.mixed_matmul_2d.launches, pa.int8_launches
    other = (mg.mixed4_matmul_2d.launches + pa.launches + pa.fp8_launches)
    tm = dict(eng.timings)
    iters = int(tm["burst_iterations"])
    produced = sum(len(t) for r in rounds for t in r.values())
    decode_tok_s = produced / (t2 - t1)
    log(f"[{tag}] prefill: {pre_steps} steps in {t1 - t0:.3f} s; decode: "
        f"{BURST_ROUNDS} bursts x {BURST_ENGINE['decode_burst']} "
        f"iterations, {produced} tokens in {t2 - t1:.3f} s = "
        f"{decode_tok_s:.1f} tok/s ({decode_tok_s / 8:.1f} a sequence; "
        + (f"phase 6 (a), stepwise: {decode_ref:.1f} tok/s" if decode_ref
           else "phase 6 (a) not run") + ")")
    log(f"[{tag}] launches: mixed gemm int8 {k3} (7 x {L} x ({pre_steps} "
        f"prefill steps + {iters} burst iterations) = "
        f"{7 * L * (pre_steps + iters)}; decode design "
        f"{mg.mixed_matmul_2d.design_launches['decode']}, prefill design "
        f"{mg.mixed_matmul_2d.design_launches['prefill']}); paged attention "
        f"int8 {k2} ({L} x {pre_steps} prefill steps = {L * pre_steps}); "
        f"other variants {other}")
    check_replayed(tm, tag)
    for r in rounds:
        check_tokens(r, cfg, BURST_ENGINE["decode_burst"], tag)
    if k3 != 7 * L * (pre_steps + iters) or k2 != L * pre_steps or other \
            or iters != BURST_ROUNDS * BURST_ENGINE["decode_burst"]:
        raise AssertionError(f"{tag}: the launch counts do not match "
                             "prefill steps + burst iterations")
    # the first burst against the stepwise loop from the same state
    burst0 = rounds[0]
    if first_m != first:
        raise AssertionError(f"{tag}: the prefill's first tokens differ "
                             "between two passes")
    same = sum(a == b for u in uids for a, b in zip(burst0[u], stepwise[u]))
    log(f"[{tag}] first burst vs a step() loop from the same state: "
        f"{same} of {8 * len(prompts)} tokens equal")
    check_near_ties(torch, eng, {u: list(prompts[u]) + [first_m[u]]
                                 for u in uids}, burst0, stepwise, tol,
                    f"{tag} first burst vs step() loop")
    finish()

    def profiled_bursts(prof):
        """The same pass again, the bursts under the profiler."""
        first, _ = prefill()
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof.start()
        bursts(first, BURST_ROUNDS)
        torch.cuda.synchronize()
        prof.stop()
        finish()
        return time.perf_counter() - t

    device_profile(torch, profiled_bursts, t2 - t1, tag=f"{tag} bursts")
    del eng
    free_engines(torch)
    return dict(decode_tok_s=decode_tok_s, k3=k3, k2=k2,
                prefill_steps=pre_steps, burst_iterations=iters)


def check_near_ties(torch, eng, contexts, got, want, tol, tag):
    """Streams ``got`` and ``want`` ({uid: tokens}) continue the same
    ``contexts``.  Where one diverges, the two tokens at the first
    divergence must both lie within ``tol`` (the bf16 noise tolerance)
    of the best logit of the teacher-forced forward there: a near-tie,
    where two bf16 paths that sum in other orders may pick either.
    Every later token of ``got`` is held to the same rule against its
    own context (the context, then ``got``'s tokens before it), so a
    stream that resumes wrongly after a near-tie fails.  The forwards
    run on a fresh cache with the engine's weights: one ragged prefill
    of each context and the common tokens, then one decode step a
    token, feeding ``got``'s tokens."""
    from deepspeed_tpu_torch.inference.model import ragged_forward
    from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                            StateManager)
    diverged = {u: next(j for j, (a, b) in enumerate(zip(got[u], want[u]))
                        if a != b)
                for u in got if got[u] != want[u]}
    same = len(got) - len(diverged)
    log(f"[{tag}]: {same} of {len(got)} streams identical")
    if not diverged:
        return same
    cfg = eng.cfg
    bs = eng.icfg.kv_block_size
    nblk = sum(-(-(len(contexts[u]) + len(got[u])) // bs) for u in diverged)
    sm = StateManager(KVCacheConfig(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, block_size=bs,
        num_blocks=nblk, dtype=eng.icfg.kv_dtype,
        quant=eng.icfg.kv_quant or "none", device=eng.device),
        max_seqs=len(diverged))

    def forward(sched):
        batch = sm.build_batch(sched, sum(len(t) for _, t in sched))
        ctx = max(sm.seqs[u].seen_tokens for u, _ in sched)
        logits, _ = ragged_forward(cfg, eng.params, sm.kv, batch, bs,
                                   -(-ctx // bs), quant=eng._quant,
                                   mixed_gemm=eng._mixed_gemm_active)
        return {u: logits[sm.slot(u)] for u, _ in sched}

    def gap(row, t):
        return float(row.max()) - float(row[t])

    first, later = {}, {}
    rows = forward([(u, contexts[u] + got[u][:j])
                    for u, j in diverged.items()])
    for u, j in diverged.items():
        first[u] = (j, [round(gap(rows[u], t[j]), 4)
                        for t in (got[u], want[u])])
        later[u] = 0.0
    k = 1
    while True:
        sched = [(u, [got[u][j + k - 1]]) for u, j in diverged.items()
                 if j + k < len(got[u])]
        if not sched:
            break
        for u, row in forward(sched).items():
            later[u] = max(later[u], gap(row, got[u][diverged[u] + k]))
        k += 1
    del sm
    later = {u: round(g, 4) for u, g in later.items()}
    log(f"[{tag}] first divergences (uid: index, how far each stream's "
        f"token lies below the best teacher-forced logit; tol {tol:.4f}): "
        f"{first}; the largest gap of a later token of each: {later}")
    if any(max(g) > tol for _, g in first.values()):
        raise AssertionError(f"{tag}: the streams diverge where the logits "
                             "are not a near-tie")
    if any(g > tol for g in later.values()):
        raise AssertionError(f"{tag}: a token after a divergence is not "
                             "the teacher-forced forward's (near-)best")
    return same


# ---------------------------------------------------------------------------
# serve-failover helpers
# ---------------------------------------------------------------------------

# scenario (e): GPT-2 at full width in a child process, its engine and
# traffic, and the step at which the child's guarded readback raises a
# device-side assert (a sticky CUDA error: the child's context is gone)
FATAL_ENGINE = dict(token_budget=256, max_seqs=8, kv_block_size=64,
                    num_kv_blocks=256)
FATAL_PROMPT_LEN = 64
FATAL_NEW_TOKENS = 24
FATAL_AT_STEP = 6
# scenario (b): the watchdog deadline is this many times the slowest warm
# step of a rehearsal, and each queued sleep lasts this many deadlines
EXPIRY_DEADLINE_FACTOR = 3
EXPIRY_SLEEP_FACTOR = 4


def step_loop(eng, done, n_new, on_step=None, on_dead=None):
    """The step() API's serving loop on the requests of ``done`` ({uid:
    tokens so far}): feed each sampled token back, flush a request at
    ``n_new`` tokens, drop the ones the engine closed.  ``on_step(eng,
    i)`` runs before step i; ``on_dead(eng)`` maps an EngineDeadError to
    the engine restored from its snapshot.  Returns the engine that
    finished."""
    from deepspeed_tpu_torch.inference import SamplingParams
    from deepspeed_tpu_torch.inference.failures import EngineDeadError
    sp = SamplingParams(max_new_tokens=1 << 30)
    active = {u for u, t in done.items() if len(t) < n_new}
    i = 0
    while active:
        i += 1
        if i > 2000:
            raise AssertionError(f"step loop wedged with {sorted(active)}")
        if on_step is not None:
            on_step(eng, i)
        try:
            out = eng.step(sampling=sp)
        except EngineDeadError:
            if on_dead is None:
                raise
            eng = on_dead(eng)
            continue
        active -= eng._drain_reaped()
        for u, t in out.items():
            if u not in active:
                continue
            done[u].append(t)
            if len(done[u]) >= n_new:
                active.discard(u)
                eng.flush(u)
            else:
                eng.put(u, [t])
    return eng


def pool_whole(eng, tag):
    """Every block of the engine's pool is free again."""
    al = eng.state.allocator
    al.assert_invariants()
    if al.free_blocks != al.total_blocks:
        raise AssertionError(f"{tag}: {al.total_blocks - al.free_blocks} "
                             "KV blocks still held")


def check_failover_launches(torch, pa, engines, L, tag):
    """K2 launched layers x (dispatched steps + captures) over the
    scenario's engines: every replay, retried steps included, and each
    capture's eager warm-up.  Every step of each engine replayed a graph
    (captures allowed: new buckets, restored and destination engines);
    returns the launches."""
    torch.cuda.synchronize()
    steps = caps = retraces = 0
    for i, e in enumerate(engines):
        tm = dict(e.timings)
        check_replayed(tm, f"{tag}, engine {i}", captures_ok=True)
        steps += int(tm["steps"])
        caps += int(tm["compiles"])
        retraces += int(tm["compile_retraces"])
    want = L * (steps + caps)
    log(f"[{tag}] paged_attention launches={pa.launches} ({L} layers x "
        f"({steps} dispatched steps + {caps} captures) = {want}); "
        f"retraces {retraces}")
    if pa.launches != want:
        raise AssertionError(f"{tag}: K2 launches do not match the steps")
    return pa.launches


def failover_poison(torch, pa, model, prompts, tol):
    """(a) A poison request: every batch holding uid 2 crashes (an
    injected fault), the bisection quarantine isolates it (status
    ``failed``) and the 7 others finish as the same engine's fault-free
    round of the same driver (its warm-up), or diverge at near-ties
    (bisected batches run the GEMMs at other M).
    Driven through step(): at pipeline depth 2 a failing batch also
    holds the decodes whose previous step is still in flight, and those
    close ``failed`` (their stream cannot be replayed), as in the JAX
    engine.  Returns (K2 launches, the summary line)."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    tag = "serve-failover (a) poison"
    cfg = model.config
    n = len(prompts)
    eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE))
    for rnd in ("warm-up", "poison"):
        fresh_run(eng)
        if rnd == "poison":
            keys = set(eng._graphs)
            pa.launches = 0
            eng.failures.inject("crash", uid=2, n=1 << 20)
        done = {u: [] for u in range(n)}
        for u in range(n):
            eng.put(u, list(prompts[u]))
        t0 = time.perf_counter()
        step_loop(eng, done, SERVE_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rnd == "warm-up":
            ref = done
    tm = eng.timings
    log(f"[{tag}] step loop in {wall:.3f} s: uid 2 -> "
        f"{eng.query(2)['status']}, requests_failed="
        f"{int(tm['requests_failed'])}, step_retries="
        f"{int(tm['step_retries'])}, {int(tm['steps'])} steps; new graphs "
        f"for the bisected batches: {sorted(set(eng._graphs) - keys)}")
    launches = check_failover_launches(torch, pa, [eng], cfg.num_layers, tag)
    innocents = [u for u in range(n) if u != 2]
    if eng.query(2)["status"] != "failed" or done[2] \
            or tm["requests_failed"] != 1 or tm["step_retries"] < 2:
        raise AssertionError(f"{tag}: uid 2 was not quarantined alone")
    if any(eng.query(u)["status"] != "finished" for u in innocents):
        raise AssertionError(f"{tag}: an innocent request did not finish")
    check_tokens({u: done[u] for u in innocents}, cfg, SERVE_NEW_TOKENS, tag)
    pool_whole(eng, tag)
    same = check_near_ties(torch, eng, {u: prompts[u] for u in innocents},
                           {u: done[u] for u in innocents},
                           {u: ref[u] for u in innocents}, tol,
                           f"{tag} vs its fault-free round")
    summary = (f"(a) poison: uid 2 failed alone after {int(tm['step_retries'])}"
               f" failed steps, the 7 others finished ({same} identical to "
               f"the fault-free round, the rest near-ties), "
               f"{int(tm['compiles'])} "
               f"captures, pool whole, K2 launches {launches}")
    del eng
    free_engines(torch)
    return launches, summary


def sleep_cycles_per_ms(torch):
    """Cycles of ``torch.cuda._sleep`` a millisecond, measured."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = 50_000_000
    start.record()
    torch.cuda._sleep(n)
    end.record()
    torch.cuda.synchronize()
    return n / start.elapsed_time(end)


def failover_expiry(torch, pa, model, prompts, ref, tol):
    """(b) Real watchdog expiries on the card: a sleep queued on the
    engine's stream holds a warm decode step's token event past the
    deadline (the worker is abandoned in the event wait, the cache is
    zeroed in place, every sequence re-queued), then the same before
    the next dispatched step: two expiries in a row, the engine dies,
    and ``InferenceEngine.restore`` of its snapshot finishes every
    stream (near-tie rule against phase 5).  Two rehearsals first, with
    the expiry raised instead (the same recovery path): the first
    captures every graph the measured run replays (so its steps are
    guarded), the second times the warm steps the deadline is set
    from.  Returns (K2 launches, the summary line)."""
    import dataclasses

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.inference.failures import (
        DispatchTimeoutError, FailureConfig)
    tag = "serve-failover (b) expiry"
    cfg = model.config
    L = cfg.num_layers
    n = len(prompts)
    eng = InferenceEngine(model, InferenceConfig(
        **SERVE_ENGINE, failure=FailureConfig(dispatch_timeout_ms=None)))
    at = {}

    def raise_once(e, i, walls=None):
        if walls is not None:
            walls.append((time.perf_counter(), int(e.timings["compiles"])))
        if "K" not in at and all(done[u] for u in range(n)):
            at["K"] = i + 2          # a decode step, all 8 rows
        if i == at.get("K"):
            fetch = e._fetch_tokens

            def expire(st):
                e._fetch_tokens = fetch
                raise DispatchTimeoutError("rehearsed expiry")
            e._fetch_tokens = expire

    walls = []
    for rehearsal in (0, 1):
        fresh_run(eng)
        done = {u: [] for u in range(n)}
        for u in range(n):
            eng.put(u, list(prompts[u]))
        step_loop(eng, done, SERVE_NEW_TOKENS, on_step=lambda e, i: raise_once(
            e, i, walls if rehearsal else None))
        if eng.timings["step_retries"] != 1:
            raise AssertionError(f"{tag}: the rehearsal took no retry")
    torch.cuda.synchronize()
    K = at["K"]
    warm = [(b[0] - a[0]) * 1e3 for a, b in zip(walls, walls[1:])
            if b[1] == a[1]]
    deadline = EXPIRY_DEADLINE_FACTOR * max(warm)
    sleep_ms = EXPIRY_SLEEP_FACTOR * deadline
    cycles = int(sleep_ms * sleep_cycles_per_ms(torch))
    log(f"[{tag}] rehearsals: expiry at step {K} (all 8 rows decoding), "
        f"{len(warm)} warm steps of {min(warm):.2f}-{max(warm):.2f} ms -> "
        f"deadline {deadline:.1f} ms, sleeps of {sleep_ms:.1f} ms")
    eng.fcfg = eng.failures.cfg = dataclasses.replace(
        eng.fcfg, dispatch_timeout_ms=deadline)
    fresh_run(eng)
    pa.launches = 0
    sleeps = []

    def sleep_before(e, i):
        if (i == K and not sleeps) or (len(sleeps) == 1 and i > K
                                       and e._backoff_rounds == 0):
            with torch.cuda.stream(e._stream):
                torch.cuda._sleep(cycles)
            sleeps.append(i)

    restored = []
    t_dead = {}

    def on_dead(dead):
        t_dead["dead"] = time.perf_counter()
        h = dead.health()
        new = InferenceEngine.restore(model, dead.snapshot(),
                                      InferenceConfig(**SERVE_ENGINE))
        t_dead["restored"] = time.perf_counter()
        log(f"[{tag}] engine dead after sleeps before steps {sleeps}: "
            f"health {h['state']}, consecutive_timeouts "
            f"{h['consecutive_timeouts']}, step_retries {h['step_retries']},"
            f" abandoned workers {dead.failures.watchdog.abandoned}; "
            f"restore (a new engine, its own graphs) in "
            f"{(t_dead['restored'] - t_dead['dead']) * 1e3:.1f} ms")
        restored.append(new)
        return new

    done = {u: [] for u in range(n)}
    for u in range(n):
        eng.put(u, list(prompts[u]))
    t0 = time.perf_counter()
    last = step_loop(eng, done, SERVE_NEW_TOKENS, on_step=sleep_before,
                     on_dead=on_dead)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if not restored or last is not restored[0] or len(sleeps) != 2 \
            or eng.failures.watchdog.abandoned != 2 \
            or eng.health()["state"] != "dead":
        raise AssertionError(f"{tag}: expected two expiries, then a dead "
                             f"engine and a restore (sleeps {sleeps}, "
                             f"abandoned {eng.failures.watchdog.abandoned})")
    log(f"[{tag}] recovery: the death to every stream complete "
        f"{(t1 - t_dead['dead']) * 1e3:.1f} ms; the whole run "
        f"{(t1 - t0) * 1e3:.1f} ms; abandoned workers "
        f"{eng.failures.watchdog.abandoned}")
    launches = check_failover_launches(torch, pa, [eng, last], L, tag)
    check_tokens(done, cfg, SERVE_NEW_TOKENS, tag)
    pool_whole(last, tag)
    same = check_near_ties(torch, last, dict(enumerate(prompts)), done,
                           {u: ref[u] for u in range(n)}, tol,
                           f"{tag} vs phase 5")
    summary = (f"(b) expiry: deadline {deadline:.1f} ms, two expiries then "
               f"dead, {eng.failures.watchdog.abandoned} abandoned workers, "
               f"restore {(t_dead['restored'] - t_dead['dead']) * 1e3:.1f} "
               f"ms, death to every stream complete "
               f"{(t1 - t_dead['dead']) * 1e3:.1f} ms, {same} of {n} streams "
               f"identical to phase 5, K2 launches {launches}")
    del eng, last, restored
    free_engines(torch)
    return launches, summary


def failover_migrate_drain(torch, pa, model, prompts, ref, tol):
    """(c) Engines A and B serve half the traffic each; after 8 decode
    steps ``B.load_snapshot(A.migrate_out(...), merge=True)`` moves A's
    open requests (``migrated`` on A; B writes no new cache tensor) and
    every stream completes.  (d) ``A.drain`` over the whole traffic after
    one prefill step, cut short by a deadline of 1.5 times that step's
    wall (warm: A ran its key in (c)); its ``shed_uids`` restore
    on B and finish; ``completed_uids`` and ``shed_uids`` partition the
    requests open at the start.  Both against phase 5 (near-tie rule).
    Returns {"c": (K2 launches, summary line), "d": (...)}."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    cfg = model.config
    L = cfg.num_layers
    n = len(prompts)
    icfg = InferenceConfig(**SERVE_ENGINE)
    A, B = InferenceEngine(model, icfg), InferenceEngine(model, icfg)
    sp = SamplingParams(max_new_tokens=1 << 30)
    res = {}

    # (c) migration
    tag = "serve-failover (c) migration"
    pa.launches = 0
    done = {u: [] for u in range(n)}
    half = n // 2
    for u in range(n):
        (A if u < half else B).put(u, list(prompts[u]))

    def one(eng):
        for u, t in eng.step(sampling=sp).items():
            done[u].append(t)
            eng.put(u, [t])
    decodes = 0
    t0 = time.perf_counter()
    while decodes < 8:
        one(A)
        one(B)
        if all(done[u] for u in range(n)):
            decodes += 1
    moved = [u for u in range(half) if A.query(u)["status"] == "running"]
    kv_ptr = B.state.kv.data_ptr()
    t1 = time.perf_counter()
    part = A.migrate_out(moved)
    B.load_snapshot(part, merge=True)
    t2 = time.perf_counter()
    step_loop(B, done, SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"[{tag}] after {decodes} decode steps on A and B ({t1 - t0:.3f} "
        f"s): migrate_out({moved}) + load_snapshot(merge=True) in "
        f"{(t2 - t1) * 1e3:.2f} ms; B finished every stream in "
        f"{t3 - t2:.3f} s; statuses on A "
        f"{[A.query(u)['status'] for u in moved]}")
    if [r["uid"] for r in part["requests"]] != moved or len(moved) != half \
            or any(A.query(u)["status"] != "migrated" for u in moved) \
            or B.state.kv.data_ptr() != kv_ptr:
        raise AssertionError(f"{tag}: the open requests did not move")
    k2 = check_failover_launches(torch, pa, [A, B], L, tag)
    check_tokens(done, cfg, SERVE_NEW_TOKENS, tag)
    pool_whole(A, tag)
    pool_whole(B, tag)
    same = check_near_ties(torch, B, dict(enumerate(prompts)), done,
                           {u: ref[u] for u in range(n)}, tol,
                           f"{tag} vs phase 5")
    res["c"] = (k2, f"(c) migration: uids {moved} moved A -> B in "
                    f"{(t2 - t1) * 1e3:.2f} ms (migrated on A, B's cache "
                    f"kept), every stream finished ({same} identical to "
                    f"phase 5), both pools whole, K2 launches {k2}")

    # (d) drain
    tag = "serve-failover (d) drain"
    fresh_run(A)
    fresh_run(B)
    pa.launches = 0
    done = {u: [] for u in range(n)}
    for u in range(n):
        A.put(u, list(prompts[u]))
    t0 = time.perf_counter()
    one(A)
    torch.cuda.synchronize()
    deadline = 1.5 * (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    snap = A.drain(deadline_ms=deadline)
    t1 = time.perf_counter()
    shed, completed = snap["shed_uids"], snap["completed_uids"]
    unstarted = [r["uid"] for r in snap["requests"] if not r["generated"]]
    log(f"[{tag}] drain(deadline_ms={deadline:.1f}) in {(t1 - t0) * 1e3:.1f}"
        f" ms, {int(A.timings['steps'])} steps on A: shed {shed}, completed "
        f"{completed}, never reached a first token {unstarted}; health "
        f"{A.health()['state']}")
    if set(shed) | set(completed) != set(range(n)) \
            or set(shed) & set(completed) or not unstarted:
        raise AssertionError(f"{tag}: the drain was not cut short, or its "
                             "split is not a partition of the open requests")
    recs = {r["uid"]: r for r in snap["requests"]}
    B.load_snapshot({"version": snap["version"],
                     "requests": [recs[u] for u in shed]}, merge=True)
    step_loop(B, done, SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    log(f"[{tag}] B finished the shed requests in "
        f"{time.perf_counter() - t1:.3f} s")
    k2 = check_failover_launches(torch, pa, [A, B], L, tag)
    check_tokens(done, cfg, SERVE_NEW_TOKENS, tag)
    pool_whole(A, tag)
    pool_whole(B, tag)
    same = check_near_ties(torch, B, dict(enumerate(prompts)), done,
                           {u: ref[u] for u in range(n)}, tol,
                           f"{tag} vs phase 5")
    res["d"] = (k2, f"(d) drain: cut by its {deadline:.1f} ms deadline after "
                    f"{(t1 - t0) * 1e3:.1f} ms, shed {shed} (completed "
                    f"{completed}) finished on B ({same} identical to phase "
                    f"5), both pools whole, K2 launches {k2}")
    del A, B
    free_engines(torch)
    return res


def fatal_model(torch, seed):
    """Scenario (e)'s GPT-2 at full width and depth (random bf16 weights
    from ``seed``) and its 8 prompts of 64 random tokens; the same in the
    child and the parent."""
    import numpy as np

    from deepspeed_tpu_torch.models import build_model
    model = build_model("gpt2", seed=seed, dtype=torch.bfloat16,
                        max_seq_len=1024)
    r = np.random.RandomState(seed + 1)
    prompts = [[int(x) for x in r.randint(0, model.config.vocab_size,
                                          FATAL_PROMPT_LEN)]
               for _ in range(FATAL_ENGINE["max_seqs"])]
    return model, prompts


def fatal_child(out_path: str, seed: int) -> None:
    """Scenario (e)'s child process: serve GPT-2 for a few steps, then
    raise a device-side assert (an out-of-range gather on the card)
    inside the guarded readback, on the watchdog's worker thread; the
    error must classify ``fatal`` and ``step()`` raise EngineDeadError.
    The host-side snapshot of the dead engine is pickled to
    ``out_path``; the process ends without tearing the CUDA context
    down (every CUDA call fails after a sticky error)."""
    import os
    import pickle

    import torch

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.inference.failures import (EngineDeadError,
                                                        FailureConfig,
                                                        classify_failure)
    model, prompts = fatal_model(torch, seed)
    eng = InferenceEngine(model, InferenceConfig(
        **FATAL_ENGINE, failure=FailureConfig(dispatch_timeout_ms=30_000.0)))
    done = {u: [] for u in range(len(prompts))}
    for u, p in enumerate(prompts):
        eng.put(u, p)
    fetch = eng._fetch_tokens
    seen = {}

    def asserting_fetch(st):
        import threading
        seen["thread"] = threading.current_thread().name
        with torch.cuda.stream(eng._stream):
            x = torch.zeros(4, device=eng.device)
            x[torch.full((1,), 7, device=eng.device)]
        try:
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — recorded, then re-raised
            seen["error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            seen["verdict"] = classify_failure(e)
            raise
        return fetch(st)

    def arm(e, i):
        if i == FATAL_AT_STEP:
            e._fetch_tokens = asserting_fetch

    dead = None
    try:
        step_loop(eng, done, FATAL_NEW_TOKENS, on_step=arm)
    except EngineDeadError as e:
        dead = str(e).splitlines()[0]
    with open(out_path, "wb") as f:
        pickle.dump(dict(snap=eng.snapshot(), health=eng.health(), done=done,
                         dead=dead, steps=int(eng.timings["steps"]), **seen),
                    f)
    print(f"[serve-failover (e) child] dead={dead!r} error="
          f"{seen.get('error')!r} verdict={seen.get('verdict')!r} on thread "
          f"{seen.get('thread')!r}", flush=True)
    os._exit(0)


def failover_fatal(torch, pa, seed):
    """(e) A real fatal error, in a child process (the CUDA context is
    unusable after it): the child's snapshot restores on a fresh GPT-2
    engine here, and every stream completes equal to an uninterrupted
    run here (or differs first at a near-tie).  Returns the summary
    line."""
    import pickle
    import subprocess
    import tempfile

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    tag = "serve-failover (e) fatal"
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "snapshot.pkl")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--failover-child", path, "--seed", str(seed)],
            capture_output=True, text=True, timeout=600)
        t1 = time.perf_counter()
        for line in proc.stdout.strip().splitlines()[-5:]:
            log(f"[{tag}] child: {line}")
        if proc.returncode != 0 or not Path(path).exists():
            log(proc.stderr[-4000:])
            raise AssertionError(f"{tag}: the child failed "
                                 f"(exit {proc.returncode})")
        with open(path, "rb") as f:
            res = pickle.load(f)
    log(f"[{tag}] child ran {res['steps']} steps and died in {t1 - t0:.1f} s"
        f" (process included): {res['error']} -> {res['verdict']} on "
        f"{res['thread']}; health {res['health']['state']}; snapshot of "
        f"{len(res['snap']['requests'])} requests")
    if res["verdict"] != "fatal" or res["dead"] is None \
            or "device-side assert" not in res["error"] \
            or res["health"]["state"] != "dead":
        raise AssertionError(f"{tag}: the device-side assert did not kill "
                             "the engine as fatal")
    model, prompts = fatal_model(torch, seed)
    cfg = model.config
    icfg = InferenceConfig(**FATAL_ENGINE)
    tol = first_forward_check(torch, model, prompts, tag)
    pa.launches = 0
    ref_eng = InferenceEngine(model, icfg)
    ref = {u: [] for u in range(len(prompts))}
    for u, p in enumerate(prompts):
        ref_eng.put(u, p)
    step_loop(ref_eng, ref, FATAL_NEW_TOKENS)
    t0 = time.perf_counter()
    eng = InferenceEngine.restore(model, res["snap"], icfg)
    done = res["done"]
    step_loop(eng, done, FATAL_NEW_TOKENS)
    torch.cuda.synchronize()
    log(f"[{tag}] restored here and finished in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    k2 = check_failover_launches(torch, pa, [ref_eng, eng], cfg.num_layers,
                                 tag)
    check_tokens(done, cfg, FATAL_NEW_TOKENS, tag)
    pool_whole(eng, tag)
    same = check_near_ties(torch, eng, dict(enumerate(prompts)), done, ref,
                           tol, f"{tag} vs an uninterrupted run")
    del eng, ref_eng, model
    free_engines(torch)
    return (f"(e) fatal: {res['error']} in the child's guarded readback -> "
            f"{res['verdict']}, EngineDeadError, snapshot restored here, "
            f"{same} of {len(prompts)} streams identical to an "
            f"uninterrupted run, K2 launches {k2} (GPT-2)")


def failover_watchdog_cost(torch, model, prompts, ttft):
    """(f) The default FailureConfig's cost: phase 5's rates on fresh
    engines with dispatch_timeout_ms=None and with the default "auto"
    watchdog (which guards every read after the 8th step of a run), in
    turns (off, auto, off, auto) in this call.  Returns the rates by
    turn."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.inference.failures import FailureConfig
    tag = "serve-failover (f) watchdog cost"
    rows = []
    for name in ("off", "auto", "off", "auto"):
        fcfg = FailureConfig(dispatch_timeout_ms=None if name == "off"
                             else "auto")
        icfg = InferenceConfig(**SERVE_ENGINE, failure=fcfg)
        rows.append((name, serve_rates(
            torch, lambda icfg=icfg: InferenceEngine(model, icfg), prompts,
            ttft, f"{tag}, {name}", profile=False)))
    for name, r in rows:
        log(f"[{tag}] {name}: enqueue a decode step "
            f"{r['enqueue_ms']['decode']:.3f} ms, a prefill step "
            f"{r['enqueue_ms']['prefill']:.3f} ms; wait a step "
            f"{r['wait_ms']:.3f} ms; decode {r['decode_tok_s']:.1f} tok/s")
    return rows


def serve_failover(torch, pa, model, prompts, phase5, seed):
    """serve-failover: scenarios (a)-(f) on phase 5's model, traffic and
    engine; the reference streams are phase 5's own.  Ends with one
    ``[serve-failover]`` line a scenario; returns K2's launches over the
    Llama scenarios (a)-(d)."""
    ref, tol = phase5["streams"], phase5["tol"]
    runs = [failover_poison(torch, pa, model, prompts, tol),
            failover_expiry(torch, pa, model, prompts, ref, tol)]
    md = failover_migrate_drain(torch, pa, model, prompts, ref, tol)
    runs += [md["c"], md["d"]]
    lines = [summary for _, summary in runs]
    lines.append(failover_fatal(torch, pa, seed))
    rows = failover_watchdog_cost(torch, model, prompts, phase5["ttft"])
    lines.append("(f) watchdog cost: " + "; ".join(
        f"{name} {r['enqueue_ms']['decode']:.3f} ms a decode step, "
        f"{r['decode_tok_s']:.1f} tok/s" for name, r in rows))
    k2 = sum(k2 for k2, _ in runs)
    lines.append(f"K2 launches over (a)-(d): {k2}")
    for line in lines:
        log(f"[serve-failover] {line}")
    return k2


# bench.py's spec_decode_serving_bench (:1111-1187): GPT-2, 8 prompts of
# 64 tokens, each a 4-6 token motif repeated, 96 greedy new tokens, the
# sync driver, drafts of at most 4
SPEC_ENGINE = dict(token_budget=256, max_seqs=8, kv_block_size=64,
                   num_kv_blocks=256, pipeline_depth=1, spec_max_draft=4)
SPEC_PROMPT_LEN = 64
SPEC_NEW_TOKENS = 96


def serve_spec(torch, pa, seed, device=None, **overrides):
    """serve-spec: GPT-2 at full width and depth (random bf16 weights from
    ``seed``), speculation off then on, each with the default watchdog
    and with none (its cost at depth 1), each after a warm-up run.
    Checks:
    the two token streams identical; fewer steps with speculation on;
    paged-attention launches = layers x steps (verify steps launch it);
    every measured step a replay.  Bitwise identity is not attainable in
    bf16: a verify row runs its GEMMs at another M and K2 splits its keys
    by the batch's work, so the two modes sum in other orders; a stream
    may diverge only at a near-tie (:func:`check_near_ties`).
    ``device``/``overrides`` as in :func:`serving_model`."""
    import numpy as np

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.inference.failures import FailureConfig
    from deepspeed_tpu_torch.models import build_model
    tag = "serve-spec"
    model = build_model("gpt2", seed=seed, dtype=torch.bfloat16,
                        device=device, **dict(dict(max_seq_len=1024),
                                              **overrides))
    cfg = model.config
    r = np.random.RandomState(0)
    prompts = []
    for uid in range(SPEC_ENGINE["max_seqs"]):
        motif = [int(x) for x in r.randint(0, cfg.vocab_size, 4 + uid % 3)]
        reps = -(-SPEC_PROMPT_LEN // len(motif))
        prompts.append((motif * reps)[:SPEC_PROMPT_LEN])
    sp = SamplingParams(max_new_tokens=SPEC_NEW_TOKENS)
    tol = first_forward_check(torch, model, prompts, tag)
    res, streams = {}, {}
    # each mode with the default "auto" watchdog, then with none: at depth
    # 1 the guarded read's thread hand-off is on every step's path
    for mode, wd in (("off", "auto"), ("off", None), ("on", "auto"),
                     ("on", None)):
        run = mode if wd else f"{mode}, watchdog off"
        eng = InferenceEngine(model, InferenceConfig(
            **SPEC_ENGINE, spec_decode=mode,
            failure=FailureConfig(dispatch_timeout_ms=wd)))
        warm_graphs(torch, eng, prompts, (SPEC_NEW_TOKENS,), f"{tag} {run}")
        pa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams[run] = eng.generate(dict(enumerate(prompts)), sp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tm = dict(eng.timings)
        steps = int(tm["steps"])
        produced = sum(len(v) for v in streams[run].values())
        res[run] = dict(tok_s=produced / dt, steps=steps,
                        launches=pa.launches,
                        enqueue_ms=tm["decode_device_ms"]
                        / max(tm["decode_steps"], 1),
                        wait_ms=tm["wait_ms"] / max(steps, 1),
                        guarded=eng.failures.deadline_ms() is not None)
        acc = (tm["spec_accepted_tokens"] / tm["spec_drafted_tokens"]
               if tm["spec_drafted_tokens"] else None)
        if run == "on":
            res["acceptance_rate"] = acc
            res["mean_accepted"] = (tm["spec_accepted_tokens"]
                                    / max(tm["spec_windows"], 1))
        log(f"[{tag}] spec {run}: {produced} tokens in {steps} steps, "
            f"{dt:.3f} s = {produced / dt:.1f} tok/s; enqueue a decode "
            f"step {res[run]['enqueue_ms']:.3f} ms, wait a step "
            f"{res[run]['wait_ms']:.3f} ms; paged_attention "
            f"launches={pa.launches} ({cfg.num_layers} x {steps} = "
            f"{cfg.num_layers * steps}); windows "
            f"{int(tm['spec_windows'])}, drafted "
            f"{int(tm['spec_drafted_tokens'])}, accepted "
            f"{int(tm['spec_accepted_tokens'])}, rejected "
            f"{int(tm['spec_rejected_tokens'])}"
            + (f", acceptance rate {acc:.3f}" if acc is not None else ""))
        check_replayed(tm, f"{tag} {run}")
        check_tokens(streams[run], cfg, SPEC_NEW_TOKENS, tag)
        if pa.launches != cfg.num_layers * steps or steps == 0:
            raise AssertionError(f"{tag} {run}: paged attention did not "
                                 "run in every layer of every step")
        if res[run]["guarded"] != bool(wd):
            raise AssertionError(f"{tag} {run}: the watchdog is "
                                 f"{'off' if wd else 'on'}")
        del eng
        free_engines(torch)
    log(f"[{tag}] steps {res['off']['steps']} -> {res['on']['steps']}; "
        f"decode tok/s {res['off']['tok_s']:.1f} -> {res['on']['tok_s']:.1f}"
        f" ({res['on']['tok_s'] / res['off']['tok_s']:.2f}x)")
    log(f"[{tag}] the default watchdog's cost at depth 1 (off -> auto): "
        + "; ".join(f"spec {m} {res[m + ', watchdog off']['tok_s']:.1f} -> "
                    f"{res[m]['tok_s']:.1f} tok/s, wait a step "
                    f"{res[m + ', watchdog off']['wait_ms']:.3f} -> "
                    f"{res[m]['wait_ms']:.3f} ms" for m in ("off", "on")))
    ref = InferenceEngine(model, InferenceConfig(**SPEC_ENGINE))
    check_near_ties(torch, ref, dict(enumerate(prompts)), streams["on"],
                    streams["off"], tol, f"{tag} on vs off")
    for m in ("off", "on"):
        check_near_ties(torch, ref, dict(enumerate(prompts)), streams[m],
                        streams[f"{m}, watchdog off"], tol,
                        f"{tag} {m}, watchdog auto vs off")
    del ref
    if res["on"]["steps"] >= res["off"]["steps"]:
        raise AssertionError(f"{tag}: speculation took no fewer steps")
    del model
    free_engines(torch)
    return res


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


# ---------------------------------------------------------------------------
# train-ckpt: checkpoints of phase 4's GPT-2 training
# ---------------------------------------------------------------------------

def state_snapshot(torch, engine):
    """The engine's state by checkpoint key: tensors cloned on their
    device, numbers as they are."""
    from deepspeed_tpu_torch.checkpoint.engine import _leaf_paths
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in _leaf_paths(engine.state)}


def state_diffs(torch, a, b):
    """Keys whose values are not bitwise equal (tensors by their bytes)."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.view(torch.uint8), y.view(torch.uint8)))
        return x == y
    return [k for k in a if k not in b or not same(a[k], b[k])]


def nondeterministic_ops(torch, engine, batch):
    """The ops of one training step that PyTorch reports as having no
    deterministic implementation (``use_deterministic_algorithms`` in
    warn-only mode)."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine.train_batch(dict(batch))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def train_ckpt(torch, fa, seed, device=None, **overrides):
    """train-ckpt: GPT-2-small on phase 4's configuration.  Engine A takes
    2 steps, saves, takes 2 more; engine B (other random weights) loads
    and takes the same 2: the restored state bitwise the saved one, B's
    losses and final master and moments bitwise A's.  Then an async save:
    A steps while the write runs, a fresh engine loads the checkpoint and
    equals A's state at the save, and ``consolidate`` equals its master.
    Returns the flash launches by variant (as ``train``)."""
    import tempfile

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.checkpoint import engine as ck
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime import synthetic_lm_data

    spec = TRAIN_RUNS["train"]
    seq = overrides.pop("max_seq_len", spec["seq"])
    micro = overrides.pop("micro", spec["micro"])
    torch.backends.cuda.matmul.allow_tf32 = False

    def engine(s, **extra):
        m = build_model("gpt2", seed=s, device=device, max_seq_len=seq,
                        attention_impl="flash", **overrides)
        cfg = train_config(micro, "bf16")
        cfg.update(extra)
        return ds.initialize(model=m, config=cfg, device=device), m.config

    a, cfg = engine(seed)
    b, _ = engine(seed + 1)
    data = synthetic_lm_data(cfg.vocab_size, micro * 6, seq, seed=seed)
    batches = [{"input_ids": data["input_ids"][i * micro:(i + 1) * micro]}
               for i in range(6)]
    save_walls = []
    real_save_tree = ck.save_tree

    def timed_save_tree(*args, **kw):
        t = time.perf_counter()
        real_save_tree(*args, **kw)
        save_walls.append(time.perf_counter() - t)

    ck.save_tree = timed_save_tree
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=root, prefix="ckpt-")
    try:
        # the main path: counts to 0 just before, read just after
        fa.reset_launches()
        for bt in batches[:2]:
            a.train_batch(dict(bt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = a.save_checkpoint(f"{tmp.name}/sync")
        t_save = time.perf_counter() - t0
        saved = state_snapshot(torch, a)
        nbytes = dir_bytes(d)
        losses_a = [a.train_batch(dict(bt))["loss"] for bt in batches[2:4]]
        final_a = state_snapshot(torch, a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.load_checkpoint(f"{tmp.name}/sync")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        diffs = state_diffs(torch, saved, state_snapshot(torch, b))
        log(f"[train-ckpt] checkpoint {nbytes / 1e9:.3f} GB "
            f"({len(saved)} leaves); save {t_save:.3f} s "
            f"({nbytes / 1e9 / t_save:.2f} GB/s), load {t_load:.3f} s "
            f"({nbytes / 1e9 / t_load:.2f} GB/s); restored state bitwise "
            f"the saved one: {not diffs} {diffs[:3]}")
        if diffs or b.global_steps != 2:
            raise AssertionError(f"train-ckpt: the restored state differs "
                                 f"at {diffs[:5]}")
        losses_b = [b.train_batch(dict(bt))["loss"] for bt in batches[2:4]]
        final_b = state_snapshot(torch, b)
        la = [float(x) for x in losses_a]
        lb = [float(x) for x in losses_b]
        same_loss = all(torch.equal(x, y) for x, y in zip(losses_a,
                                                          losses_b))
        diffs = state_diffs(torch, final_a, final_b)
        log(f"[train-ckpt] after the resume: A losses {la}, B losses {lb}; "
            f"bitwise equal: losses {same_loss}, final state "
            f"{not diffs} ({len(diffs)} leaves differ)")
        if not same_loss or diffs:
            # name the op: run A's last two steps twice from one state
            c, _ = engine(seed + 2)
            c.load_checkpoint(f"{tmp.name}/sync")
            lc = [float(c.train_batch(dict(bt))["loss"])
                  for bt in batches[2:4]]
            spread = [abs(x - y) for x, y in zip(lb, lc)]
            ops = nondeterministic_ops(torch, c, batches[4])
            log(f"[train-ckpt] NOT BITWISE: the same two steps from the "
                f"restored state again: losses {lc}, run-to-run spread "
                f"{spread}; ops without a deterministic implementation: "
                f"{ops}")
            if not ops or any(abs(x - y) > s for x, y, s in
                              zip(la, lb, spread)):
                raise AssertionError("train-ckpt: the resumed run is not "
                                     "the uninterrupted one, beyond the "
                                     "run-to-run spread")
            del c
        # async: A takes one more step while the write runs
        a.config.checkpoint.async_save = True
        save_walls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d2 = a.save_checkpoint(f"{tmp.name}/async")
        t_block = time.perf_counter() - t0
        at_save = state_snapshot(torch, a)
        a.train_batch(dict(batches[4]))
        a.wait_checkpoint()
        t_done = time.perf_counter() - t0
        fresh, _ = engine(seed + 3)
        fresh.load_checkpoint(f"{tmp.name}/async")
        diffs = state_diffs(torch, at_save, state_snapshot(torch, fresh))
        cons = ck.consolidate(d2)
        cons_ok = all(torch.equal(torch.from_numpy(v),
                                  at_save[k].float().cpu())
                      for k, v in cons.items())
        log(f"[train-ckpt] async save: blocking {t_block * 1e3:.1f} ms "
            f"(the host snapshot) against the write's wall "
            f"{save_walls[0] * 1e3:.1f} ms; a step ran meanwhile; save to "
            f"wait_checkpoint {t_done * 1e3:.1f} ms; a fresh engine's load "
            f"bitwise A's state at the save: {not diffs}; consolidate "
            f"equals A's master ({len(cons)} leaves): {cons_ok} "
            f"[{nvidia_smi_line()}]")
        if diffs or not cons_ok or len(cons) != len(
                [k for k in at_save if k.startswith(".master")]):
            raise AssertionError(f"train-ckpt: the async checkpoint differs "
                                 f"at {diffs[:5]} (consolidate {cons_ok})")
        variants = {k: dict(getattr(fa, k).variant_launches)
                    for k in FLASH_KERNELS}
        steps = 4 + 2 + 1 + (0 if same_loss and not diffs else 3)
        log(f"[train-ckpt] flash launches by (dtype, head dim): {variants} "
            f"({steps} training steps x {cfg.num_layers} layers)")
        if any(sum(v.values()) != steps * cfg.num_layers
               for v in variants.values()):
            raise AssertionError("train-ckpt: a step missed a flash kernel")
    finally:
        ck.save_tree = real_save_tree
        tmp.cleanup()
    del a, b, fresh
    free_engines(torch)
    return variants


# ---------------------------------------------------------------------------
# serve-moe: qwen2-moe-a2.7b from an HF-named state dict
# ---------------------------------------------------------------------------

MOE_PRESET = "qwen2-moe-a2.7b"


def qwen2_moe_state_dict(torch, cfg, params):
    """The ``Qwen2MoeForCausalLM`` state dict of a port tree (each tensor
    in HF's [out, in] layout, contiguous): the inverse of the importer's
    map, built here to feed it.  CONSUMES ``params``: each stacked leaf
    is dropped once its layers are copied, so the card holds one copy of
    the weights and one leaf."""
    H, Hkv, D, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    nl = cfg.num_layers
    T = lambda w: w.transpose(-1, -2).contiguous()      # noqa: E731
    b, sd = params["blocks"], {}
    sd["model.embed_tokens.weight"] = params.pop("embed")["table"]

    def per_layer(group, name, key, fn):
        leaf = b[group].pop(name)
        for i in range(nl):
            sd[f"model.layers.{i}." + key] = fn(leaf[i])
        del leaf

    for n, h in (("q", H), ("k", Hkv), ("v", Hkv)):
        per_layer("attn", f"w{n}", f"self_attn.{n}_proj.weight",
                  lambda w, h=h: T(w.reshape(dm, h * D)))
        per_layer("attn", f"b{n}", f"self_attn.{n}_proj.bias",
                  lambda x, h=h: x.reshape(h * D).clone())
    per_layer("attn", "wo", "self_attn.o_proj.weight",
              lambda w: T(w.reshape(H * D, dm)))
    per_layer("ln1", "scale", "input_layernorm.weight", lambda x: x.clone())
    per_layer("ln2", "scale", "post_attention_layernorm.weight",
              lambda x: x.clone())
    per_layer("gate", "kernel", "mlp.gate.weight", T)
    for n, hf in (("wg", "gate_proj"), ("wi", "up_proj"),
                  ("wo", "down_proj")):
        leaf = b["experts"].pop(n)
        for i in range(nl):
            for e in range(cfg.num_experts):
                sd[f"model.layers.{i}.mlp.experts.{e}.{hf}.weight"] = \
                    T(leaf[i, e])
        del leaf
        per_layer("shared", n, f"mlp.shared_expert.{hf}.weight", T)
    per_layer("shared", "gate", "mlp.shared_expert_gate.weight", T)
    sd["model.norm.weight"] = params.pop("ln_f")["scale"]
    sd["lm_head.weight"] = T(params.pop("lm_head")["kernel"])
    return sd


def flat_tree(tree, prefix=""):
    """{path: leaf} of a parameter tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat_tree(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def moe_serving_model(torch, seed, device=None, **overrides):
    """qwen2-moe-a2.7b at full width and depth: random bf16 weights from
    ``seed`` drawn on the card, renamed to the HF state dict (the drawn
    tree consumed) and taken back through
    ``checkpoint.hf.load_hf_state_dict`` (the HF dict consumed), then
    held bitwise against the same draw made again; and phase 5's
    prompts.  At most two copies of the weights live at once."""
    from deepspeed_tpu_torch.checkpoint.hf import load_hf_state_dict
    from deepspeed_tpu_torch.models import Model, build_model

    drawn, prompts = serving_model(torch, MOE_PRESET, seed, tag="serve-moe",
                                   device=device, **overrides)
    cfg = drawn.config
    t0 = time.perf_counter()
    sd = qwen2_moe_state_dict(torch, cfg, drawn.params)
    n_hf = len(sd)
    del drawn
    free_engines(torch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = load_hf_state_dict(cfg, sd, "qwen2_moe")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    left = len(sd)
    del sd
    free_engines(torch)
    ref = build_model(MOE_PRESET, seed=seed, dtype=torch.bfloat16,
                      device=device, **overrides)       # the same draw
    got, want = flat_tree(params), flat_tree(ref.params)
    bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
           or not torch.equal(got[k], want[k])]
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve-moe] HF state dict: {n_hf} tensors built from the drawn "
        f"tree in {t1 - t0:.2f} s, imported by "
        f"checkpoint.hf.load_hf_state_dict in {t2 - t1:.2f} s ({left} "
        f"entries left: consumed); tree bitwise the drawn one: "
        f"{not bad and sorted(got) == sorted(want)}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    if bad or sorted(got) != sorted(want) or left:
        raise AssertionError(f"serve-moe: the imported tree differs from "
                             f"the drawn one at {bad[:5]}")
    del ref, got, want
    free_engines(torch)
    return Model.from_params(cfg, params), prompts


# device time of a step by MoE part: the functions each label wraps (the
# serving forward looks them up at call time)
MOE_PARTS = (("gating", "deepspeed_tpu_torch.parallel.moe",
              "_serving_route"),
             ("dispatch/combine", "deepspeed_tpu_torch.parallel.moe",
              "_slot_dispatch"),
             ("dispatch/combine", "deepspeed_tpu_torch.parallel.moe",
              "_slot_combine"),
             ("expert bmm", "deepspeed_tpu_torch.parallel.moe",
              "experts_apply"),
             ("shared expert", "deepspeed_tpu_torch.inference.model",
              "_shared_expert"),
             ("attention", "deepspeed_tpu_torch.inference.model",
              "paged_attention"),
             ("dense GEMMs", "deepspeed_tpu_torch.inference.model", "_mm"))


def moe_step_kinds(torch, model, prompts, device=None):
    """Device ms of an eager prefill step (2 prompts, 1024 tokens) and a
    decode step (8 sequences) of the MoE serving forward, by part
    (MOE_PARTS, each wrapped in a ``record_function`` range; the rest as
    "other": norms, rotary, embedding, KV writes, LM head), from
    torch.profiler."""
    import importlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from deepspeed_tpu_torch.inference.model import ragged_forward
    from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                            StateManager)
    cfg = model.config
    sm = StateManager(KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                    cfg.head_dim, block_size=64,
                                    num_blocks=96, dtype=torch.bfloat16,
                                    device=model.device), max_seqs=8)
    steps = [[(2 * j + u, prompts[2 * j + u]) for u in range(2)]
             for j in range(4)]
    real = []
    for label, mod, name in MOE_PARTS:
        m = importlib.import_module(mod)
        fn = getattr(m, name)
        real.append((m, name, fn))

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(f"moe:{_label}"):
                return _fn(*a, **kw)
        setattr(m, name, wrapped)
    out = {}
    try:
        def run(sched, tag):
            batch = sm.build_batch(sched, 1024)
            prof = profile(activities=[ProfilerActivity.CUDA,
                                       ProfilerActivity.CPU])
            torch.cuda.synchronize()
            prof.start()
            ragged_forward(cfg, model.params, sm.kv, batch, 64, 16)
            torch.cuda.synchronize()
            prof.stop()
            # a label's ms: the kernels launched inside its range (its
            # host-side event; the device-side annotation of the range
            # spans the gaps between them too, and is left out)
            # K2 launches through ctypes, which the profiler does not tie
            # to the range: attention is its kernels' own time
            total = 0.0
            by = {"attention": 0.0}
            for e in prof.events():
                on_device = str(e.device_type).endswith("CUDA")
                if e.name.startswith("moe:"):
                    if not on_device and e.name != "moe:attention":
                        by[e.name[4:]] = (by.get(e.name[4:], 0.0)
                                          + e.device_time_total / 1e3)
                elif on_device:
                    total += e.self_device_time_total / 1e3
                    if "paged_attention" in e.name:
                        by["attention"] += e.self_device_time_total / 1e3
            kinds = sum(by.values())
            by["other"] = max(total - kinds, 0.0)
            out[tag] = by
            log(f"[serve-moe] {tag} step ({batch.n_tokens} tokens, eager) "
                f"device {total:.2f} ms by part: " + ", ".join(
                    f"{k} {v:.2f} ms ({100 * v / max(total, 1e-9):.1f}%)"
                    for k, v in sorted(by.items(), key=lambda kv: -kv[1])))

        for j, sched in enumerate(steps):
            if j == len(steps) - 1:
                run(sched, "prefill")
            else:
                batch = sm.build_batch(sched, 1024)
                ragged_forward(cfg, model.params, sm.kv, batch, 64, 16)
        run([(u, [int(prompts[u][-1])]) for u in range(8)], "decode")
    finally:
        for m, name, fn in real:
            setattr(m, name, fn)
        del sm
        free_engines(torch)
    return out


def serve_moe(torch, pa, seed, device=None, **overrides):
    """serve-moe: qwen2-moe-a2.7b from the HF-named tree at phase 5's
    traffic and engine (``serve``), then the device ms of a prefill and a
    decode step by MoE part and the resident bytes.  Returns ``serve``'s
    result."""
    model, prompts = moe_serving_model(torch, seed, device=device,
                                       **overrides)
    res = serve(torch, pa, model, prompts, tag="serve-moe")
    moe_step_kinds(torch, model, prompts, device)
    log(f"[serve-moe] resident: weights {tree_bytes(model.params) / 1e9:.2f}"
        f" GB (+ the KV cache above); decode tok/s "
        f"{res['decode_tok_s']:.1f}, TTFT p50 {res['ttft_p50_ms']:.1f} ms "
        f"[{nvidia_smi_line()}]")
    del model
    free_engines(torch)
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
        check_replayed(eng.timings, f"{tag} sampled, depth {depth}",
                       captures_ok=True)
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
    warm_graphs(torch, eng, prompts, (ALIBI_INT8_NEW_TOKENS,),
                f"{tag} int8")
    pa.launches = pa.int8_launches = pa.fp8_launches = 0
    pa.alibi_launches = 0
    out = eng.generate(dict(enumerate(prompts)), SamplingParams(
        max_new_tokens=ALIBI_INT8_NEW_TOKENS))
    torch.cuda.synchronize()
    check_replayed(eng.timings, f"{tag} int8")
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


# ---------------------------------------------------------------------------
# train-offload and train-nvme: ZeRO-Offload and ZeRO-Infinity on one card
# ---------------------------------------------------------------------------

# The card's machine (measured by the device phase of this script: NVIDIA
# H100 80GB HBM3, 700.00 W) has MemAvailable 105.9 GB, below the ~115 GB
# Llama-3-8B's pinned ZeRO-Offload state (8.03 B x 12 bytes = 96.4 GB) and
# the rest of the process need, so train-offload trains gptj-6b at full
# width and depth (6.05 B params: 72.6 GB of host state, 97 GB of training
# state in all, more than the card holds).  Each phase asserts the host
# memory and free disk it needs and stops with a clear error when they are
# missing; none picks a smaller model at run time.
#   train-offload  gptj-6b, 28 layers, d 4096, 16 heads of 256, vocab 50400;
#                  bf16, seq 2048, micro-batch 2, AdamW lr 3e-4, clip 1.0,
#                  ZeRO-2, offload_optimizer cpu (pinned), remat "flash";
#                  the staging ring 4 x 32 MiB (each chunk updated in
#                  spans of 2^20 elements), 1 warm-up + 3 measured steps;
#                  parity at 2 layers
#   train-nvme     gptj-6b at its published widths, depth cut to 4 layers
#                  (1.22 B params); bf16, seq 2048, micro-batch 1, AdamW,
#                  clip 1.0, ZeRO-3; (b) offload_optimizer nvme, (c) plus
#                  offload_param nvme with model= (streaming); 1 + 2 steps
#                  each.  The machine has no local disk: its root is 9p,
#                  which takes 45 GiB of writes a machine, and (b) and (c)
#                  write 15-22 GB a step.  So nvme_path is a temporary
#                  directory in /dev/shm (tmpfs, host memory), and the
#                  disk (a temporary directory under build/, 9p) takes the
#                  aio check and (c)'s checkpoint; both are removed at the
#                  end
OFFLOAD_RUN = dict(preset="gptj-6b", seq=2048, micro=2, warmup=1, steps=3,
                   remat=True, policy="flash", buffer_count=4,
                   buffer_size=32 << 20, parity_layers=2, parity_steps=2,
                   host_share=0.75)
NVME_RUN = dict(preset="gptj-6b", num_layers=4, seq=2048, micro=1, warmup=1,
                steps=2, aio_bytes=2 << 30, host_share=0.75,
                store_dir="/dev/shm")
# the writes the card's machine's disk takes in one run (its 9p root ends a
# process once its disk file passes 45 GiB, deleted files included)
DISK_WRITE_BUDGET = 40 << 30
# the masters of two AdamW trajectories part by at most the sum of their
# steps' sizes: |update| <= lr per step (bias-corrected AdamW, b1 <= b2),
# so the elementwise bound is 2 x lr x steps.  Rounding apart (the host's
# or HostAdam's order of operations, bf16 casts of the working copy), an
# element's grad changes sign only where it is noise, and Adam turns even
# noise into a whole step: the rms of the difference is held to lr / 10,
# no more than 1% of the elements a whole step apart
OFFLOAD_LR = 3e-4
MASTER_RMS = OFFLOAD_LR / 10


def offload_config(micro, stage, **zero):
    cfg = train_config(micro, "bf16")
    cfg["zero_optimization"] = {"stage": stage, **zero}
    return cfg


def host_facts():
    """MemTotal and MemAvailable (bytes), RLIMIT_MEMLOCK, the CPU count."""
    import resource
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                mem[k] = int(v.split()[0]) * 1024
    return dict(mem_total=mem["MemTotal"], mem_available=mem["MemAvailable"],
                memlock=resource.getrlimit(resource.RLIMIT_MEMLOCK),
                cpus=os.cpu_count())


def disk_facts(path):
    """Mount point, filesystem type and free bytes of ``path``."""
    real = os.path.realpath(path)
    best = ("/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    st = os.statvfs(real)
    return dict(mount=best[0], fstype=best[1],
                free=st.f_bavail * st.f_frsize)


def nvme_root():
    """The directory the NVMe phase writes into (git-ignored)."""
    return ROOT / "build"


def peak_rss_bytes():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_empty_cache(torch):
    """Give back the pinned host blocks PyTorch's host allocator caches."""
    gc.collect()
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()


def need_host(what, nbytes, share):
    facts = host_facts()
    have = facts["mem_available"]
    log(f"[{what}] host memory needed {nbytes / 1e9:.2f} GB; MemAvailable "
        f"{have / 1e9:.2f} GB (the phase may use {share:.0%} of it)")
    if nbytes > share * have:
        raise SystemExit(f"chip_smoke {what}: needs {nbytes / 1e9:.2f} GB "
                         f"of host memory, {share:.0%} of MemAvailable is "
                         f"{share * have / 1e9:.2f} GB")


def flash_per_step(fa, engine, batch):
    before = flash_counts(fa)
    met = engine.train_batch(batch)
    return met, tuple(b - a for a, b in zip(before, flash_counts(fa)))


def train_offload(torch, fa, seed, device=None, **overrides):
    """train-offload: ZeRO-Offload of gptj-6b at full width and depth
    (OFFLOAD_RUN).  Returns the flash launches by variant (as ``train``)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime import param_count, synthetic_lm_data
    from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves

    spec = OFFLOAD_RUN
    seq = overrides.pop("max_seq_len", spec["seq"])
    micro = overrides.pop("micro", spec["micro"])
    warmup, steps = spec["warmup"], spec["steps"]
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = build_model(spec["preset"], seed=seed, device=device,
                        max_seq_len=seq, remat=spec["remat"],
                        remat_policy=spec["policy"], attention_impl="flash",
                        dtype=torch.bfloat16, **overrides)
    cfg = model.config
    n = param_count(model.params)
    ring = spec["buffer_count"] * spec["buffer_size"]
    need_host("train-offload", 12 * n + ring, spec["host_share"])
    zero = {"offload_optimizer": {"device": "cpu", "pin_memory": True,
                                  "buffer_count": spec["buffer_count"],
                                  "buffer_size": spec["buffer_size"]}}
    engine = ds.initialize(model=model, config=offload_config(micro, 2,
                                                              **zero),
                           device=device)
    model.params = None            # the engine holds its own copies now
    free_engines(torch)
    state = engine.state
    host = tree_leaves(state.master) + [x for f in state.opt_state
                                        for x in tree_leaves(f)]
    on_card = device is None
    if not all(t.device.type == "cpu" and (t.is_pinned() or not on_card)
               for t in host):
        raise AssertionError("the master and moments are not pinned CPU "
                             "tensors")
    pinned = sum(t.numel() * t.element_size() for t in host) + ring
    log(f"[train-offload] {spec['preset']}: {n / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads of {cfg.head_dim}, vocab {cfg.vocab_size}, seq {seq}; bf16, "
        f"ZeRO-2, offload_optimizer cpu, ring {spec['buffer_count']} x "
        f"{spec['buffer_size']:,} B, AdamW lr 3e-4, clip 1.0, micro-batch "
        f"{micro}, remat_policy={spec['policy']!r}; master and moments: "
        f"{len(host)} pinned CPU tensors, pinned {pinned / 1e9:.2f} GB; "
        f"host update on {torch.get_num_threads()} threads; set up in "
        f"{time.perf_counter() - t0:.1f} s")

    data = synthetic_lm_data(cfg.vocab_size, micro * (warmup + steps), seq,
                             seed=seed)["input_ids"]
    fa.reset_launches()
    fa.flash_attention.fallbacks = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, per_step, splits = [], [], []
    for step in range(warmup + steps):
        if step == warmup:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        t = time.perf_counter()
        met, counts = flash_per_step(
            fa, engine, {"input_ids": data[step * micro:(step + 1) * micro]})
        metrics.append(met)
        per_step.append(counts)
        splits.append(dict(engine.offload_times,
                           wall_s=time.perf_counter() - t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    variants = {k: dict(getattr(fa, k).variant_launches)
                for k in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    log(f"[train-offload] losses {losses}; grad norms {gnorms}")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError("train-offload: non-finite loss or grad norm")
    # remat "flash" saves the flash forward's outputs: the backward does
    # not replay it, so each kernel launches once per layer a step
    want = (cfg.num_layers, cfg.num_layers, cfg.num_layers, 0)
    log(f"[train-offload] flash launches per step {per_step} (want {want}: "
        f"the remat policy keeps the forward's outputs, no replay); by "
        f"(dtype, head dim) {variants}")
    if any(p != want for p in per_step):
        raise AssertionError(f"train-offload: flash launches per step "
                             f"{per_step}, want {want}")
    for s, sp in enumerate(splits):
        d2h_span = sp["d2h_wait_s"] + sp["host_update_s"]
        log(f"[train-offload] step {s}: {sp['wall_s']:.3f} s = device "
            f"forward/backward {sp['fwd_bwd_s']:.3f} s + update sweep "
            f"(grad D2H waits {sp['d2h_wait_s']:.3f} s, host update "
            f"{sp['host_update_s']:.3f} s, last H2D {sp['h2d_tail_s']:.3f} "
            f"s); D2H {sp['d2h_bytes'] / 1e9:.2f} GB in the sweep's "
            f"{d2h_span:.3f} s ({sp['d2h_bytes'] / d2h_span / 1e9:.2f} "
            f"GB/s, overlapped), H2D {sp['h2d_bytes'] / 1e9:.2f} GB "
            f"({sp['h2d_bytes'] / d2h_span / 1e9:.2f} GB/s, overlapped); "
            f"host AdamW {28 * n / sp['host_update_s'] / 1e9:.2f} GB/s "
            f"(28 bytes a param)")
    toks = micro * (seq - 1) * steps
    tok_s = toks / wall
    flops_per_token = 6 * n + 12 * cfg.num_layers * cfg.d_model * (seq - 1)
    mfu = tok_s * flops_per_token / PEAK_BF16_FLOPS
    resident_need = 16 * n
    log(f"[train-offload] {steps} steps in {wall:.3f} s ({wall / steps:.3f} "
        f"s/step): {tok_s:.1f} tokens/s, MFU {100 * mfu:.3f}% of 989 "
        f"TFLOP/s; max_memory_allocated {peak / 1e9:.2f} GB (a run without "
        f"offload needs {resident_need / 1e9:.1f} GB for the bf16 weights, "
        f"fp32 master and AdamW state alone); pinned {pinned / 1e9:.2f} GB; "
        f"peak host RSS {peak_rss_bytes() / 1e9:.2f} GB "
        f"[{nvidia_smi_line()}]")
    if on_card and peak >= 80e9:
        raise AssertionError(f"train-offload: peak device memory "
                             f"{peak / 1e9:.2f} GB is not below 80 GB")
    profile_offload_step(torch, engine, {"input_ids": data[-micro:]},
                         statistics.median(sp["fwd_bwd_s"]
                                           for sp in splits[warmup:]))
    del engine, state, host
    free_engines(torch)
    host_empty_cache(torch)
    offload_parity(torch, seed, device, seq, micro, **overrides)
    free_engines(torch)
    host_empty_cache(torch)
    return variants


def profile_offload_step(torch, engine, batch, fwd_bwd_s):
    """One more train-offload step, its device forward and backward under
    torch.profiler (stopped where the engine hands the gradients to the
    host update), split by kind and by flash kernel against the measured
    steps' unprofiled forward/backward ``fwd_bwd_s``."""
    update = engine._offload_update

    def profiled(prof):
        def stop_then_update(grads, step):
            prof.stop()                   # the device work is synchronised
            del engine._offload_update
            return update(grads, step)
        engine._offload_update = stop_then_update
        prof.start()
        engine.train_batch(batch)
        return engine.offload_times["fwd_bwd_s"]

    device_profile(torch, profiled, fwd_bwd_s, tag="train-offload fwd/bwd",
                   split=[(k, k) for k in ("fwd_kernel", "dq_kernel",
                                           "dkv_split_kernel")])


def offload_parity(torch, seed, device, seq, micro, **overrides):
    """A cut of the same preset to OFFLOAD_RUN's parity_layers trains
    parity_steps steps with offload and without, from the same weights
    and batches: the losses bitwise equal (the device work is the same),
    the masters within 2 x lr x steps elementwise and rms lr / 10 (the
    host and the card may round AdamW's arithmetic differently)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime import synthetic_lm_data
    from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves

    spec = OFFLOAD_RUN
    steps = spec["parity_steps"]
    layers = overrides.pop("num_layers", spec["parity_layers"])
    data = synthetic_lm_data(overrides.get("vocab_size", 50400),
                             micro * steps, seq, seed=seed + 1)["input_ids"]
    runs = {}
    for tag, zero in (("offload", {"offload_optimizer": {
            "device": "cpu", "buffer_count": spec["buffer_count"],
            "buffer_size": spec["buffer_size"]}}), ("resident", {})):
        model = build_model(spec["preset"], seed=seed, device=device,
                            max_seq_len=seq, remat=spec["remat"],
                            remat_policy=spec["policy"],
                            attention_impl="flash", num_layers=layers,
                            **overrides)
        eng = ds.initialize(model=model, config=offload_config(micro, 2,
                                                               **zero),
                            device=device)
        model.params = None
        losses = [float(eng.train_batch(
            {"input_ids": data[s * micro:(s + 1) * micro]})["loss"])
            for s in range(steps)]
        runs[tag] = (losses, [t.detach().to("cpu", copy=True)
                              for t in tree_leaves(eng.state.master)])
        del eng, model
        free_engines(torch)
    (la, ma), (lb, mb) = runs["offload"], runs["resident"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(ma, mb)])
    bound = 2 * OFFLOAD_LR * steps
    rms = float(diffs.double().square().mean().sqrt())
    exact = int((diffs == 0).sum())
    log(f"[train-offload] parity at {layers} layers over {steps} steps: "
        f"losses offload {la} vs resident {lb} (bitwise: {la == lb}); "
        f"masters max |d| {float(diffs.max()):.3e} (bound {bound:.1e}), "
        f"rms {rms:.3e} (bound {MASTER_RMS:.1e}), "
        f"{exact}/{diffs.numel()} elements bitwise")
    if la != lb:
        raise AssertionError("train-offload parity: the losses with and "
                             "without offload are not bitwise equal")
    if float(diffs.max()) > bound or rms > MASTER_RMS:
        raise AssertionError("train-offload parity: the masters disagree "
                             "beyond the stated tolerance")


def aio_check(torch, root, nbytes):
    """(a) a file of ``nbytes`` written and read through AsyncIOHandle with
    each backend the machine has and O_DIRECT on and off: the bytes
    round-trip equal; GB/s each way.  Returns the slowest read GB/s."""
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, uring_available

    facts = disk_facts(root)
    buf = torch.arange(nbytes // 8, dtype=torch.int64)
    back = torch.empty_like(buf)
    path = os.path.join(root, "aio_check.bin")
    backends = ["threads"] + (["uring"] if uring_available() else [])
    if "uring" not in backends:
        log("[train-nvme] (a) io_uring: refused by this kernel "
            "(io_uring_setup or its opcodes); the thread pool only")
    rates = []
    for backend in backends:
        for odirect in (False, True):
            h = AsyncIOHandle(block_size=8 << 20, queue_depth=32,
                              thread_count=8, use_odirect=odirect,
                              backend=backend)
            t = time.perf_counter()
            if h.sync_pwrite(buf, path, truncate=True):
                raise AssertionError("aio write reported failed chunks")
            os.sync()
            tw = time.perf_counter() - t
            back.zero_()
            t = time.perf_counter()
            h.sync_pread(back, path)
            tr = time.perf_counter() - t
            if not torch.equal(buf, back):
                raise AssertionError(f"aio round trip ({backend}, O_DIRECT "
                                     f"{odirect}) changed the bytes")
            log(f"[train-nvme] (a) aio {backend}, O_DIRECT "
                f"{'on' if odirect else 'off'} ({h.odirect_ops()} direct "
                f"chunks): {nbytes / 1e9:.2f} GB written "
                f"{nbytes / tw / 1e9:.2f} GB/s (with fsync), read "
                f"{nbytes / tr / 1e9:.2f} GB/s; round trip equal "
                f"[{facts['fstype']} at {facts['mount']}]")
            rates.append(nbytes / tr / 1e9)
            del h
    os.remove(path)
    del buf, back
    return min(rates)


def nvme_io(engine):
    """NVMe bytes (read, written) so far: the optimizer store's and, when
    streaming, the parameter and grad stores'."""
    r, w = engine._nvme.bytes_read, engine._nvme.bytes_written
    if engine._stream is not None:
        r += engine._stream.io["read"]
        w += engine._stream.io["written"]
    return r, w


def nvme_steps(torch, fa, engine, data, micro, tag, first=0, count=None):
    """Steps of an NVMe engine on consecutive batches; per step the
    seconds (of each sweep when streaming) and the NVMe bytes with GB/s."""
    out = []
    count = NVME_RUN["warmup"] + NVME_RUN["steps"] if count is None \
        else count
    for s in range(first, first + count):
        r0, w0 = nvme_io(engine)
        torch.cuda.synchronize()
        t = time.perf_counter()
        met, counts = flash_per_step(
            fa, engine, {"input_ids": data[s * micro:(s + 1) * micro]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        r1, w1 = nvme_io(engine)
        sweeps = (", ".join(f"{k} {v:.3f} s"
                            for k, v in engine._stream.last_times.items())
                  if engine._stream is not None else
                  f"host update {engine.offload_times['host_update_s']:.3f}"
                  " s")
        log(f"[train-nvme] ({tag}) step {s}: loss {float(met['loss']):.6f}"
            f", {wall:.3f} s ({sweeps}); NVMe read {(r1 - r0) / 1e9:.2f} GB,"
            f" written {(w1 - w0) / 1e9:.2f} GB "
            f"({(r1 - r0 + w1 - w0) / wall / 1e9:.2f} GB/s over the step); "
            f"flash launches {counts}")
        out.append((float(met["loss"]), counts))
    return out


def reckon_stream_peak(cfg, micro, seq, res_params, layer_params):
    """Card bytes of the streamed step from the shapes: the resident bf16
    params and their fp32 grads (kept through the backward sweep), two
    layers' bf16 params, the activation checkpoints, one layer's recompute
    (its saved activations, ~16 [B, S, d_model] bf16 tensors and two of
    [B, S, d_ff], and its bf16 and fp32 grads), and the head's logits in
    bf16 with their grad and a 1 GiB fp32 loss chunk."""
    B, S, d = micro, seq, cfg.d_model
    resident = 2 * res_params + 4 * res_params
    layers = 2 * 2 * layer_params
    acts = cfg.num_layers * 2 * B * S * d
    recompute = 2 * B * S * (16 * d + 2 * cfg.d_ff) + 6 * layer_params
    head = 2 * 2 * B * S * cfg.vocab_size + (1 << 30)
    return resident + layers + acts + recompute + head


def train_nvme(torch, fa, seed, device=None, **overrides):
    """train-nvme: ZeRO-Infinity (NVME_RUN).  Returns the flash launches of
    (c), the streamed run, by variant (as ``train``)."""
    import shutil
    import tempfile

    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.checkpoint import engine as ck
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime import param_count, synthetic_lm_data
    from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves

    spec = NVME_RUN
    seq = overrides.pop("max_seq_len", spec["seq"])
    micro = overrides.pop("micro", spec["micro"])
    aio_bytes = overrides.pop("aio_bytes", spec["aio_bytes"])
    layers = overrides.pop("num_layers", spec["num_layers"])
    store_root = overrides.pop("store_dir", spec["store_dir"])
    nsteps = spec["warmup"] + spec["steps"]
    root = nvme_root()
    root.mkdir(parents=True, exist_ok=True)
    disk = tempfile.mkdtemp(prefix="nvme_", dir=str(root))
    store = tempfile.mkdtemp(prefix="nvme_", dir=store_root)
    # what earlier phases leave allocated on the card (kernel workspaces,
    # held graphs): the peaks below are reckoned above it
    base = torch.cuda.memory_allocated()
    try:
        def make():
            return build_model(spec["preset"], seed=seed, device=device,
                               max_seq_len=seq, attention_impl="flash",
                               num_layers=layers, **overrides)

        model = make()
        cfg = model.config
        n = param_count(model.params)
        dfacts, sfacts = disk_facts(disk), disk_facts(store)
        # the disk takes the aio check and (c)'s checkpoint; the stores
        # (two engines' p, m, v, bf16 layers and fp32 grads) and (b)'s
        # checkpoint live in the store directory
        disk_writes = 2 * aio_bytes + 12 * n
        log(f"[train-nvme] {spec['preset']} cut to {layers} layers: "
            f"{n / 1e9:.3f} B params, d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads of {cfg.head_dim}, vocab "
            f"{cfg.vocab_size}, seq {seq}, micro-batch {micro}; bf16, AdamW "
            f"lr 3e-4, clip 1.0, ZeRO-3; stores in {store} "
            f"({sfacts['fstype']} at {sfacts['mount']}); the disk "
            f"{disk} ({dfacts['fstype']} at {dfacts['mount']}, "
            f"{dfacts['free'] / 1e9:.1f} GB free) takes "
            f"{disk_writes / 1e9:.1f} GB of writes, under the "
            f"{DISK_WRITE_BUDGET / 2**30:.0f} GiB a machine's disk takes")
        if disk_writes > DISK_WRITE_BUDGET or dfacts["free"] < disk_writes:
            raise SystemExit(f"chip_smoke train-nvme: the disk would take "
                             f"{disk_writes / 1e9:.1f} GB of writes")
        if sfacts["fstype"] in ("tmpfs", "ramfs"):
            log(f"[train-nvme] the stores are on {sfacts['fstype']} (host "
                "memory): the card's machine has no local disk, and its 9p "
                "root takes 45 GiB of writes a machine, less than one "
                "engine's 3 steps write; every store GB/s below is that of "
                "memory")
        # two streamed engines' stores, a loaded checkpoint and the
        # process
        need_host("train-nvme", 48 * n, spec["host_share"])
        for where in (disk, store):
            aio_check(torch, where, aio_bytes)

        data = synthetic_lm_data(cfg.vocab_size, micro * (nsteps + 1), seq,
                                 seed=seed)["input_ids"]
        nvme = {"device": "nvme", "nvme_path": store}
        # the plain device-resident engine: the parity reference
        ref = ds.initialize(model=model, config=offload_config(micro, 3),
                            device=device)
        ref_losses = [float(ref.train_batch(
            {"input_ids": data[s * micro:(s + 1) * micro]})["loss"])
            for s in range(nsteps)]
        want = {".master" + k: x.detach().cpu().numpy()
                for k, x in ck._leaf_paths(ref.state.master)}
        del ref
        free_engines(torch)

        results, ckpts, engines = {}, {}, {}
        for tag, zero in (("b", {"offload_optimizer": nvme}),
                          ("c", {"offload_optimizer": nvme,
                                 "offload_param": nvme})):
            if tag == "c":
                model = make()
            t = time.perf_counter()
            eng = ds.initialize(model=model, config=offload_config(
                micro, 3, **zero), device=device)
            model.params = None
            del model
            free_engines(torch)
            log(f"[train-nvme] ({tag}) engine set up in "
                f"{time.perf_counter() - t:.1f} s ("
                + ("streaming" if eng._stream is not None else
                   "NVMe optimizer, working copy on the card") + ")")
            fa.reset_launches()
            fa.flash_attention.fallbacks = 0
            torch.cuda.reset_peak_memory_stats()
            results[tag] = nvme_steps(torch, fa, eng, data, micro, tag)
            peak = torch.cuda.max_memory_allocated() - base
            log(f"[train-nvme] ({tag}) max_memory_allocated "
                f"{peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB allocated "
                f"before the phase [{nvidia_smi_line()}]")
            if tag == "c":
                variants = {k: dict(getattr(fa, k).variant_launches)
                            for k in FLASH_KERNELS}
                st = eng._stream
                res_params = sum(x.numel() for x in tree_leaves(st.resident))
                layer_params = (n - res_params) // layers
                bound = reckon_stream_peak(cfg, micro, seq, res_params,
                                           layer_params)
                groups = sorted(eng._nvme._group_bytes)[-2:]
                meter_bound = sum(groups) + 4 * max(res_params, layer_params)
                log(f"[train-nvme] (c) peak device {peak / 1e9:.3f} GB vs "
                    f"reckoned {bound / 1e9:.3f} GB (resident params and "
                    f"their fp32 grads, 2 layers, activation checkpoints, "
                    f"one layer's recompute with its grads, the head); "
                    f"ResidencyMeter.peak {st.meter.peak / 1e9:.3f} GB vs "
                    f"two swap groups of p, m, v plus a grad group "
                    f"{meter_bound / 1e9:.3f} GB and the model's bf16 bytes "
                    f"{2 * n / 1e9:.3f} GB (one swap group of the embedding "
                    f"alone is {sorted(eng._nvme._group_bytes)[-1] / 1e9:.3f}"
                    f" GB: at 4 layers the meter cannot be under the bf16 "
                    f"model)")
                if device is None and peak > bound:
                    raise AssertionError("train-nvme: the streamed step's "
                                         "peak exceeds its reckoning")
                if st.meter.peak > meter_bound:
                    raise AssertionError("train-nvme: the host residency "
                                         "exceeds two swap groups and a "
                                         "grad group")
                want_l = (2 * layers, layers, layers, 0)
            else:
                want_l = (layers, layers, layers, 0)
            got = [c for _, c in results[tag]]
            if any(c != want_l for c in got):
                raise AssertionError(f"train-nvme ({tag}): flash launches "
                                     f"per step {got}, want {want_l}")
            where = os.path.join(disk if tag == "c" else store, f"ck_{tag}")
            t = time.perf_counter()
            ckpts[tag] = eng.save_checkpoint(where)
            save_s = time.perf_counter() - t
            size = dir_bytes(ckpts[tag])
            log(f"[train-nvme] ({tag}) checkpoint saved in {save_s:.3f} s "
                f"({size / save_s / 1e9:.2f} GB/s, {size / 1e9:.2f} GB, "
                f"{disk_facts(where)['fstype']})")
            got_m = ck.consolidate(ckpts[tag])
            bound_m = 2 * OFFLOAD_LR * nsteps
            worst, sq, count = 0.0, 0.0, 0
            for key, ref_leaf in want.items():
                d = np.abs(got_m[key].astype(np.float64) - ref_leaf)
                worst = max(worst, float(d.max()))
                sq += float(np.square(d).sum())
                count += d.size
            rms = math.sqrt(sq / count)
            del got_m
            log(f"[train-nvme] ({tag}) consolidated master vs resident: "
                f"max |d| {worst:.3e} (bound {bound_m:.1e}), rms {rms:.3e} "
                f"(bound {MASTER_RMS:.1e})")
            if worst > bound_m or rms > MASTER_RMS:
                raise AssertionError(f"train-nvme ({tag}): the master "
                                     "disagrees with the resident engine")
            if tag == "b":
                shutil.rmtree(os.path.dirname(ckpts["b"]))
                del eng
                free_engines(torch)
            else:
                engines[tag] = eng
                del eng
        del want

        # the losses against the resident engine's
        tol = PARITY_FACTOR * PARITY_FLOOR["bf16"]
        for tag in ("b", "c"):
            got = [x for x, _ in results[tag]]
            rel = [abs(a - b) / abs(b) for a, b in zip(got, ref_losses)]
            log(f"[train-nvme] ({tag}) losses {got} vs resident "
                f"{ref_losses}: relative |d| {[f'{r:.2e}' for r in rel]} "
                f"(tol {tol:.2e}, {PARITY_FACTOR} x the bf16 floor)")
            if max(rel) > tol:
                raise AssertionError(f"train-nvme ({tag}): losses disagree "
                                     "with the resident engine")

        # (c)'s checkpoint into a fresh streamed engine
        a = engines.pop("c")
        model = make()
        t = time.perf_counter()
        b = ds.initialize(model=model, config=offload_config(
            micro, 3, offload_optimizer=nvme, offload_param=nvme),
            device=device)
        model.params = None
        del model
        b.load_checkpoint(os.path.dirname(ckpts["c"]))
        load_s = time.perf_counter() - t
        log(f"[train-nvme] (c) fresh streamed engine built and loaded in "
            f"{load_s:.3f} s ({dir_bytes(ckpts['c']) / load_s / 1e9:.2f} "
            f"GB/s with the build)")
        ta, tb = a._stream.state_trees(lazy=True), \
            b._stream.state_trees(lazy=True)
        for col, (x, y) in enumerate(zip(ta, tb)):
            for (k, u), (_, v) in zip(ck._leaf_paths(x), ck._leaf_paths(y)):
                if not np.array_equal(np.asarray(u), np.asarray(v)):
                    raise AssertionError(f"train-nvme: the loaded state "
                                         f"differs at column {col} {k}")
        la = nvme_steps(torch, fa, a, data, micro, "c, saved", first=nsteps,
                        count=1)[0][0]
        lb = nvme_steps(torch, fa, b, data, micro, "c, loaded",
                        first=nsteps, count=1)[0][0]
        log(f"[train-nvme] (c) resume: master and moments bitwise; next "
            f"loss {la} vs {lb} (bitwise {la == lb}); save "
            f"{save_s:.3f} s, load {load_s:.3f} s")
        if la != lb:
            raise AssertionError("train-nvme: the resumed step's loss is "
                                 "not bitwise the saved engine's")
        del a, b
        free_engines(torch)
        return variants
    finally:
        shutil.rmtree(disk, ignore_errors=True)
        shutil.rmtree(store, ignore_errors=True)


def device_profile(torch, run, wall_unprofiled, tag="serve", split=()):
    """The kernels that take the device time, over one more full run under
    torch.profiler (``run(prof)`` returns its wall seconds), and the
    device busy share: that device time over the same run's wall time
    WITHOUT the profiler (``wall_unprofiled``; the profiler slows the host
    several times over).  Returns the device ms by kind (KERNEL_GROUPS),
    empty when the profiler recorded no device time.  ``split``: pairs
    (label, kernel-name substring) whose device ms and launches are logged
    each, with the device's idle ms (the unprofiled wall less the device
    time) beside them."""
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
    if split:
        parts = []
        for label, sub in split:
            us = sum(r[0] for r in rows if sub in r[2])
            n = sum(r[1] for r in rows if sub in r[2])
            parts.append(f"{label} {us / 1e3:.2f} ms ({n}x)")
        log(f"[{tag}] split: " + ", ".join(parts) + f"; device idle "
            f"{wall_unprofiled * 1e3 - total_us / 1e3:.1f} ms of the "
            f"unprofiled {wall_unprofiled * 1e3:.1f} ms")
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
                    default="device,build,kernel,train,train-fp32,"
                            "train-ckpt,serve,serve-quant,serve-burst,"
                            "serve-failover,serve-alibi,serve-mqa,"
                            "serve-spec,serve-moe,train-moe,train-fp16,"
                            "train-offload,train-nvme")
    ap.add_argument("--seed", type=int, default=0)
    # serve-failover (e) runs this script again as its child process
    ap.add_argument("--failover-child", metavar="SNAPSHOT_PATH",
                    help=argparse.SUPPRESS)
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
    if args.failover_child:
        fatal_child(args.failover_child, args.seed)   # never returns
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
    hf = host_facts()
    log(f"[device] host: MemTotal {hf['mem_total'] / 1e9:.2f} GB, "
        f"MemAvailable {hf['mem_available'] / 1e9:.2f} GB, RLIMIT_MEMLOCK "
        f"{hf['memlock']}, os.cpu_count() {hf['cpus']}, "
        f"torch.get_num_threads() {torch.get_num_threads()}")
    nvme_root().mkdir(parents=True, exist_ok=True)
    for where in (str(nvme_root()), NVME_RUN["store_dir"]):
        df = disk_facts(where)
        log(f"[device] NVMe phase directory {where}: mount point "
            f"{df['mount']}, filesystem {df['fstype']}, free "
            f"{df['free'] / 1e9:.2f} GB")
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
    # 4c. checkpoints of phase 4's training
    if "train-ckpt" in phases:
        flash_runs.append(train_ckpt(torch, fa, args.seed))
        phase_done("train-ckpt")

    # 5., 6., 6c. and 6d. the serving paths, bf16, quantized, in decode
    # bursts and under failures, on one model
    launches = failover_launches = None
    quant_runs = {}
    if phases & {"serve", "serve-quant", "serve-burst", "serve-failover"}:
        model, prompts = serving_model(torch, "llama3-8b", args.seed)
        phase5 = None
        if phases & {"serve", "serve-failover"}:
            # serve-failover's reference streams are phase 5's own
            phase5 = serve(torch, pa, model, prompts)
            launches = phase5["launches"]
        if "serve-quant" in phases:
            for tag, over in QUANT_RUNS:
                quant_runs[tag] = serve_quant(torch, pa, mg, model, prompts,
                                              tag, over)
        if "serve-burst" in phases:
            serve_burst(torch, pa, mg, model, prompts, decode_ref=(
                quant_runs["a"]["decode_tok_s"] if "a" in quant_runs
                else None))
        if "serve-failover" in phases:
            failover_launches = serve_failover(torch, pa, model, prompts,
                                               phase5, args.seed)
        del model, phase5
        free_engines(torch)
        phase_done("serve, serve-quant, serve-burst, serve-failover")

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

    # 7c. speculative decoding on GPT-2, spec off then on
    if "serve-spec" in phases:
        serve_spec(torch, pa, args.seed)
        phase_done("serve-spec")

    # 7d. qwen2-moe-a2.7b imported from an HF-named state dict
    moe_launches = None
    if "serve-moe" in phases:
        moe_launches = serve_moe(torch, pa, args.seed)["launches"]
        phase_done("serve-moe")

    # 8b. qwen2-moe-a2.7b training, depth cut to 2 layers
    if "train-moe" in phases:
        flash_runs.append(train(torch, fa, args.seed, "train-moe"))
        phase_done("train-moe")

    # 8. phi-2 in fp16 with the dynamic loss scaler, after falcon is freed
    if "train-fp16" in phases:
        flash_runs.append(train(torch, fa, args.seed, "train-fp16"))
        phase_done("train-fp16")

    # 9. ZeRO-Offload (gptj-6b, full width and depth, state in pinned host
    # memory) and 10. ZeRO-Infinity (gptj-6b cut to 4 layers: the NVMe
    # optimizer, then per-layer parameter streaming), last: their pinned
    # and NVMe state is the largest host footprint of the run
    if "train-offload" in phases:
        flash_runs.append(train_offload(torch, fa, args.seed))
        phase_done("train-offload")
    if "train-nvme" in phases:
        flash_runs.append(train_nvme(torch, fa, args.seed))
        phase_done("train-nvme")

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
            src = ("flash_attention_sm90.cuh"
                   if flash_design(k, dt, d) == "wgmma"
                   else "flash_attention_fp32.cu")
            return dict(name=flash_name(k, dt, d), route="cuda",
                        source=f"deepspeed_tpu_torch/ops/csrc/{src}",
                        replaces=replaces[k], launches=launches,
                        design=flash_design(k, dt, d),
                        **flash_kern[dt, d][k])

        def quant_launches(run, key):
            return quant_runs[run]["launches"][key] if run in quant_runs \
                else None

        # K2 on serve-failover's Llama scenarios (a)-(d), a path of its
        # own (the counts zeroed before each scenario, read after it)
        entries = [dict(name="paged_attention", route="cuda", source=pa_src,
                        replaces=pa_replaces, launches=launches,
                        failover_launches=failover_launches,
                        moe_launches=moe_launches, **kern)]
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
