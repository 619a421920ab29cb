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
    python3 chip_smoke.py --phases device,build,kernel,serve-offload
    python3 chip_smoke.py --phases device,build,kernel,serve-fleet
    python3 chip_smoke.py --phases device,build,kernel,train-fp16
    python3 chip_smoke.py --phases device,build,kernel,train-ckpt,serve-moe,train-moe
    python3 chip_smoke.py --phases device,build,kernel,train-offload,train-nvme
    python3 chip_smoke.py --phases device,build,kernel,hybrid,train-de
    python3 chip_smoke.py --phases device,encode,clip,diffusion,attn-variants
    python3 chip_smoke.py --phases device,build,serve-quant,aux
    python3 chip_smoke.py --phases device,build,comm,serve-tp

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
3b. comm    — comm/ on one card: a world of one rank over NCCL
             (init_distributed(backend="nccl")); every Collectives op
             (all_reduce, its mean, all_gather, reduce_scatter,
             all_to_all, broadcast, barrier) on the backend, each giving
             its input back, with the comms logger's latencies; the tiled
             matmul + all-reduce at serve-tp's down-projection shape
             ([1024, 7168] x [7168, 4096] bf16) bitwise its serial path at
             2, 4 and 8 tiles, and both timed; a comm.bench sweep of every
             op (2^12 to 2^24 bytes) and its overlap leg; an NCCL
             all-reduce captured in a CUDA graph, replayed and checked.
3c. serve-tp — tensor-parallel serving: two ranks (spawned processes)
             share the card over gloo (NCCL puts no two ranks of one
             communicator on one device), MeshConfig(tensor=2).  (a)
             Llama-3-8B at full width and depth in bf16, each rank drawing
             the seeded weights leaf by leaf and keeping its slice (the
             one-rank model's values); its cache holds 4 of the 8 KV heads
             and K2 runs on its 16 query heads (K2-TP); phase 5's traffic,
             every step eager (gloo is not captured): the first prefill's
             logits within 2x the bf16 noise floor of the one-rank
             engine's (the parent's, same seed), both ranks' streams
             equal and equal to the one-rank engine's or first different
             at a near-tie (its teacher-forced margin printed), K2 = 32 x
             steps a rank, TTFT, prefill and decode tok/s, the comm share
             of a prefill and a decode step (every collective timed
             between synchronizations); (b) the same model at 4 layers
             with weight_quant="int8", 2 prompts of 128 tokens, 8 new
             tokens: the quantized tree memory-sharded over the ranks
             and gathered a layer at use, K3 = 7 x 4 x steps and K2 = 4 x
             steps a rank, streams against the one-rank int8 engine
             (near-tie rule).  No number of this
             phase is a multi-card speed.
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
             kinds) and K3's device ms a decode and a prefill step.  Then
             the fp6/fp12 minifloat weights through the same steps, each
             with a bf16 cache (no kernel of their own: each layer
             dequantized with plain torch ops, as in the JAX package):
             (c) weight_quant="fp6" with quantize_embeddings (the
             embedding in the emulated layout), (d) weight_quant="fp12";
             paged attention launches = layers x steps and no
             mixed-input GEMM launch; besides, resident bytes equal to the
             reckoning from the shapes, layer 0's wq payload and scales
             bitwise those quantized on the CPU, the device ms of
             dequantizing every block weight once (its share of a decode
             step), and the device profile of a 4-token run.
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
6e. serve-offload — serving offload on phase 5's model, each mode against
             the same engine resident, built and run here: (a) phase 5's
             engine and traffic with the KV cache in page-locked host
             memory (kv_offload; every layer copied through one working
             layer inside the step's graph): every measured step a replay
             of a graph captured in warm-up, K2 launches = layers x
             steps, the first-forward check with the cache on the host,
             the streams equal but at near-ties, a prefix hit and a COW
             repeat, TTFT, decode tok/s, the host<->card GB/s and the
             card's peak above the model against the resident engine's;
             (b) phase 6 (a)'s configuration (int8 weights and
             embeddings, an int8 cache, mixed_gemm "on") with the block
             weights spilled to a store in /dev/shm and streamed back a
             layer at a time through two page-locked slots, every step
             eager, at phase 5's prompts with 8 new tokens: K3 launches
             = 7 x layers x steps, K2 = layers x steps, the quantized
             first-forward check, the streams equal but at near-ties, the
             store's bytes and spill seconds, read GB/s, the share of the
             run the host blocks on reads and the compute stream waits on
             a slot, decode tok/s (8 / a decode step's host wall), TTFT,
             the resident weights and the peak; (c) the KV block tier
             (kv_tier "on", 128 blocks of 64, a host ring of 16 blocks
             spilling to files in /dev/shm): round 1 phase 5's prompts,
             round 2 distinct prompts until no block of round 1 is
             indexed, round 3 round 1 again: a revive from the ring and
             one from the files, no verify failure, every step a replay,
             round 3's streams equal round 1's but at near-ties, the
             counters and the restage ms and GB/s.  The stores are
             deleted and the page-locked memory released: MemAvailable
             ends within 2 GB of where the phase began.
6f. serve-fleet — a FleetRouter over two replicas of phase 5's model (the
             weights shared, a 4.30 GB cache each; every telemetry plane
             on: the span tracer, anomaly detection, SLO scorecards,
             device telemetry, the flight recorder) behind the port's
             Gateway on 127.0.0.1: phase 5's prompts as 8 streaming
             POST /v1/completions of 32 greedy tokens (prompts 0 and 1,
             then the other six once prompt 0's first token is back).
             Each replica first captures every step shape the router
             can place on it (each token bucket, prompt chunks alone or
             beside a decoding row), then warm-up rounds run through the
             gateway; the measured run: every step a replay, K2 launches = layers x
             replica steps, the streams equal phase 5's but at near-
             ties, prompt 2 placed with prompt 0 on a 256-token prefix
             hit, /metrics parsed (serving_mfu, serving_hbm_bw_util),
             /healthz 200, /debug/slo with evaluated requests; TTFT p50
             and decode tok/s through the gateway, the gateway's and the
             router's host ms a token, the peak above the model.  Then a
             replica killed mid-run (an injected fatal fault: its
             streams migrate and finish, its engine_dead flight dump
             validates, the reconciled statuses partition the requests),
             a 2-step capture window on the survivor merged by
             tools/tracemerge.py with paged attention on its device
             track, and one replica's decode tok/s with telemetry on
             against off, in turns.
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
4d. train-de — phase 4's GPT-2-small (bf16, ZeRO-1, flash, micro-batch
             32) with four data-efficiency features at once for 6 steps:
             a seqlen curriculum 256 -> 1024 in steps of 128, random-LTD
             keeping 512 -> 1024 tokens in steps of 128, PLD (theta 0.5,
             gamma 0.001) and MoQ (16 -> 8 bits, period 2); per step the
             length, kept tokens, theta, bits, loss and K1's launches
             (once a kept layer: a dropped layer is skipped); the flops
             profiler's count at step 2 equal to 2 x M x N x K summed over
             the step's products from the shapes, its TFLOP/s beside
             phase 4's MFU; a first-step parity check of the LTD path
             (640 tokens, 512 kept) against the plain attention; then one
             eigenvalue-paced MoQ boundary under attention_impl "xla"
             (max_iter 3): the eigenvalue (finite) and its seconds.
4e. encode — BERT-base (google-bert/bert-base-uncased's config: 12 layers
             of 768, 12 heads, 512 positions, 2 token types, vocab 30522)
             in bf16: random weights from a seed drawn on the card,
             renamed to BertModel's state dict and imported back through
             checkpoint.hf.load_hf_bert (bitwise the same draw made
             again); then encode_batch on 4 batches of 32 requests with
             lengths in (S/2, S] for S = 64, 128, 256, 512, pool "cls" and
             "mean": sequences/s and tokens/s per bucket; each bucket's
             first batch within NOISE_FACTOR x the bf16 noise floor of an
             fp32 run of the same weights (the floor: each request alone
             in bf16), and a request alone and padded into the 512 bucket
             likewise.  DistilBERT (6 layers, no token types, no pooler)
             the same way through load_hf_distilbert, at S = 128.
4f. clip — CLIP ViT-B/32 (openai/clip-vit-base-patch32's config) in
             bf16 through load_hf_clip from CLIPModel's names (bitwise):
             images/s and texts/s over 32 images of 224x224x3 and 32 texts
             of up to 77 tokens, similarity of the two; the logits within
             the noise-floor rule of fp32 (the floor: 16 images at a time)
             and each image's argmax equal or at a near-tie.
4g. diffusion — the SD-1.x UNet (runwayml/stable-diffusion-v1-5's unet
             config, ~860 M params) and VAE in bf16: a classifier-free
             guidance loop (7.5, tests/test_diffusion.py's toy update) on
             a batch of 2 (uncond + cond) 64x64x4 latents with a 77x768
             context for 10 steps from t 999 down, the VAE's decode to
             one 512x512x3 image and its encode (the mean and a threefry-
             sampled posterior): ms a UNet call, decode and encode ms; the
             first UNet call and the decode within the noise-floor rule of
             fp32 (the floor: each sample alone; the decode of a batch of
             2), every output finite.
4h. attn-variants — GPT-2-small at phase 4's width, seq 1024, micro-batch
             8, bf16 through initialize: (a) attention_impl "xla_flash"
             (ops/xla_attention.py) against "xla", 2 + 3 steps each on
             fresh engines from the same weights, first-step loss and grad
             norm within phase 4's parity rule (the floor: "xla" in fp32),
             both peak memories and step ms; (b) block-sparse attention
             (BSLongformer, block 64) 2 + 3 steps: its density and step ms,
             and DenseSparsityConfig's first-step loss against "xla"; (c)
             evoformer_attention at AlphaFold-2's MSA row attention with
             pair bias at its 256-residue crop (Q/K/V [1, 128, 256, 8, 32],
             both biases), forward and backward in bf16 within the
             noise-floor rule of autograd through the plain formula in
             fp32 (the floor: that formula in bf16), and its ms.  No port
             kernel launches across 4e-4h (K1, K2 and K3's counts read
             before and after): these are the JAX package's plain paths.
             Each of 4e-4h prints its wall seconds, max_memory_allocated
             and weight bytes.
4i. aux     — the aux subsystems: env_report's rows (torch, CUDA, the
             card, page-locked memory, nvcc, triton, each kernel library
             built or not, the aio pool built with g++); see_memory_usage
             against the allocator's counters; autotune over phase 4's
             GPT-2-small (bf16, flash, seq 1024) on the card: micro-batches
             {4, 8} x remat {"nothing", "everything"}, the model-based
             tuner, budget 4, 2 timed steps (each experiment's ms a step,
             flop count, peak and the ranking; K1 launches = 12 x steps,
             the forward twice under "everything"); the launcher's
             LocalRunner under --elastic_training starting a child that
             joins a world-1 group through init_distributed_from_env,
             all-reduces a CUDA tensor (NCCL) and exits non-zero once,
             then relaunching it (2 launches, rc 0).
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
8c. hybrid — the DeepSpeed-Chat actor loop through HybridEngine: phi-2
             at full width and depth (2.78 B params), bf16, ZeRO-1, AdamW,
             remat "flash", flash attention; a serving engine of bf16
             weights and cache (prefix cache on, 64-token blocks, 160
             blocks): 8 prompts of 512 tokens rolled out for 32 greedy
             tokens, 2 actor steps at micro-batch 4, seq 1024 (32
             launches of each flash kernel a step, all bf16 D 80), the
             prompts rolled out again after the refresh: the served
             weights bitwise compute_params, no prefix token reused,
             every step a replay, K2 = layers x steps, the first forward
             on the new weights against the dense forward, the streams
             against a freshly built engine (near-tie rule); the refresh
             ms, TTFT, decode tok/s, training tokens/s, the peak against
             its reckoning.
9. train-offload — ZeRO-Offload (offload_optimizer cpu, pinned) of
             gptj-6b at full width and depth (6.05 B params; the host's
             MemAvailable is below what Llama-3-8B's 96.4 GB of pinned
             state needs, see OFFLOAD_RUN), bf16, seq 2048, micro-batch 2,
             remat "flash", 1 + 1 steps: finite loss and norm, one launch
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
             streaming), 1 + 1 steps each: seconds of each sweep and NVMe
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
serve-moe's measured run, its ``offload_launches`` and ``tier_launches``
those of serve-offload (a)'s measured run and (c)'s rounds (captures
included), its ``fleet_launches`` those of serve-fleet's measured
run; ``stream_launches`` on paged_attention_int8kv and on the int8 K3
entries, serve-offload (b)'s weight-streamed run; the flash entries'
launches include train-ckpt's, train-moe's, train-offload's and
train-nvme (c)'s, train-de's, aux's and hybrid's, and the bf16 D 64 entries
carry train-de's own as ``de_launches`` and the autotuner's (aux) as
``aux_launches``; paged_attention's ``fp6_launches`` and
``fp12_launches`` are serve-quant (c)'s and (d)'s; ``paged_attention_d80``,
timed on phi-2's mixed batch, carries hybrid's refreshed rollout's
launches); the last line, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
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

# K2-TP: one rank's head group of Llama-3-8B under tensor=2 (16 query
# heads over 4 KV heads), what serve-tp (a) launches on each rank
K2_TP_CASES = [("llama3-8b tp2 rank mixed", (16, 4, 128, 64, 512, 20)),
               ("llama3-8b tp2 rank decode", (16, 4, 128, 64, 512, 100))]


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
    ("phi-2 actor", "bfloat16", (4, 32, 32, 1024, 80, 10)),
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
# what a phase's later readers need of it (phase 4's MFU for train-de)
RESULTS = {}

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
    RESULTS[run] = dict(mfu=mfu, tok_s=tok_s)
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


def first_forward_check(torch, model, prompts, tag="serve",
                        kv_offload=False):
    """``kv_offload``: the kernel path's cache in host memory, each layer
    through a working layer on the card (serve-offload (a))."""
    from deepspeed_tpu_torch.inference.model import ragged_forward
    from deepspeed_tpu_torch.inference.ragged.state import (
        KVCacheConfig, StateManager, kv_working_layer)
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
                                    device=model.device, host=kv_offload),
                      max_seqs=2)
    batch = sm.build_batch([(0, prompts[0]), (1, prompts[1])], 1024)
    work = (kv_working_layer(sm.kv, model.device) if kv_offload else None)
    logits, _ = ragged_forward(cfg, model.params, sm.kv, batch, 64, 8,
                               kv_host=work)
    got = logits[[sm.slot(0), sm.slot(1)]]
    del sm, work
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
    if isinstance(tree, (tuple, list)):     # a quantized KV cache; stages
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


def serve_rates(torch, make_engine, prompts, ttft, tag, profile=True,
                profile_new=SERVE_NEW_TOKENS):
    """Prefill alone (1 new token) vs the full 32-token run on fresh
    engines from ``make_engine()``; TTFT (from the main run), token rates,
    peak memory, host phases per step and (``profile``) the device
    profile of a ``profile_new``-token run."""
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
        f"{t_pre:.3f} s); decode {rates['decode_tok_s']:.1f} tok/s "
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
        wall = (t_all if profile_new == SERVE_NEW_TOKENS
                else run(profile_new)[0])
        rates["device_ms_by_kind"] = device_profile(
            torch, lambda prof: run(profile_new, prof)[0], wall, tag=tag)
    del e
    free_engines(torch)
    return rates


# ---------------------------------------------------------------------------
# phase 6 helpers
# ---------------------------------------------------------------------------

# the quantized serving runs: (a) bench.py's llama8b_serving_bench
# configuration (:752-758) without decode bursts, (b) the packed-int4
# weights with an fp8 cache, (c) fp6 weights and embeddings and (d) fp12
# weights, both with phase 5's bf16 cache
QUANT_RUNS = [("a", dict(weight_quant="int8", quantize_embeddings=True,
                         kv_quant="int8")),
              ("b", dict(weight_quant="int4", kv_quant="fp8")),
              ("c", dict(weight_quant="fp6", quantize_embeddings=True)),
              ("d", dict(weight_quant="fp12"))]
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
    # a weight-streamed engine's forwards read the block weights from its
    # store (in fp32 for the fp32 reference, as a resident tree would be)
    stream = eng._wstore

    def forward(params, quant, mixed, kv_dtype=torch.bfloat16):
        sm = StateManager(KVCacheConfig(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, block_size=64,
            num_blocks=32, dtype=kv_dtype,
            quant=eng.icfg.kv_quant or "none",
            device=eng.device), max_seqs=2)
        batch = sm.build_batch([(0, prompts[0]), (1, prompts[1])], 1024)
        logits, _ = ragged_forward(cfg, params, sm.kv, batch, 64, 8,
                                   quant=quant, mixed_gemm=mixed,
                                   stream=stream)
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
        # a bf16 cache (the minifloat runs) is fp32 in the fp32 reference;
        # a quantized one dequantizes into the query's dtype either way
        ref32 = forward(tree_map(lambda t: t.float(), eng.params),
                        retype(eng._quant), False, torch.float32)
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


# new tokens of the profiled minifloat runs of serve-quant (their device
# time by kind: every step dequantizes every layer, thousands of kernels)
MINIFLOAT_PROFILE_TOKENS = 4


def reckon_minifloat_bytes(params, bits, embed):
    """The resident weights of a minifloat engine from the shapes, in
    bytes: each block projection's payload in the layout its shape takes
    and one fp32 scale a (layer, row); the embedding, when quantized, in
    the emulated layout with an fp32 scale a group of default_groups;
    everything else as it is."""
    from deepspeed_tpu_torch.inference.quantization import _BLOCK_WEIGHTS
    from deepspeed_tpu_torch.ops.quant import (default_groups,
                                               minifloat_layout,
                                               minifloat_payload_bytes)
    total = tree_bytes(params)
    for grp in params["blocks"].values():
        if not isinstance(grp, dict):
            continue
        for name, w in grp.items():
            if name in _BLOCK_WEIGHTS and w.dim() >= 3:
                total += (minifloat_payload_bytes(
                    bits, w.shape, minifloat_layout(bits, w.shape))
                    + 4 * w.shape[0] * w.shape[1]
                    - w.numel() * w.element_size())
    if embed:
        tab = params["embed"]["table"]
        total += (minifloat_payload_bytes(bits, tab.shape, None)
                  + 4 * default_groups(tab.numel())
                  - tab.numel() * tab.element_size())
    return total


def check_minifloat_tree(torch, eng, model, over, tag):
    """A minifloat engine's resident weights equal the reckoning from the
    shapes, and layer 0's wq quantized on the card is bitwise the same
    slice quantized on the CPU (payload and scales)."""
    from deepspeed_tpu_torch.ops.quant import (WEIGHT_QUANT_BITS,
                                               _quantize_rowwise_minifloat)
    resident = tree_bytes(eng.params) + tree_bytes(eng._quant)
    reckoned = reckon_minifloat_bytes(
        model.params, WEIGHT_QUANT_BITS[over["weight_quant"]],
        over.get("quantize_embeddings", False))
    blocks = tree_bytes(eng._quant["blocks"])
    embed = tree_bytes(eng._quant["embed"] if "embed" in eng._quant
                       else eng.params["embed"])
    log(f"[{tag}] resident {resident / 1e9:.3f} GB: block payloads and "
        f"scales {blocks / 1e9:.3f} GB, embedding {embed / 1e9:.3f} GB "
        f"{'emulated' if 'embed' in eng._quant else 'bf16'}, the rest "
        f"{(resident - blocks - embed) / 1e9:.3f} GB; reckoned "
        f"{reckoned / 1e9:.3f} GB")
    if resident != reckoned:
        raise AssertionError(f"{tag}: resident {resident} B, reckoned "
                             f"{reckoned} B")
    qt = eng._quant["blocks"]["attn"]["wq"]
    cpu = _quantize_rowwise_minifloat(
        model.params["blocks"]["attn"]["wq"][0].cpu(), qt.layout)
    same = (torch.equal(qt.data[0].cpu(), cpu.data)
            and torch.equal(qt.scale[0].cpu().view(torch.int32),
                            cpu.scale.view(torch.int32)))
    log(f"[{tag}] layer 0 wq {qt.layout} payload {tuple(qt.data[0].shape)} "
        f"uint8 + scales {tuple(qt.scale[0].shape)}: card bitwise the CPU's "
        f"= {same}")
    if not same:
        raise AssertionError(f"{tag}: layer 0's wq payload on the card "
                             "differs from the CPU's")


def dequant_ms_per_step(torch, eng):
    """Device ms of dequantizing every block weight of every layer into
    the serving dtype once (and the embedding table, when quantized):
    what each serving step does, eagerly here; CUDA events, median of 3."""
    from deepspeed_tpu_torch.inference.quantization import layer_weight
    from deepspeed_tpu_torch.ops.quant import dequantize_any
    dt = eng.icfg.param_dtype

    def run():
        for grp in eng._quant["blocks"].values():
            for qt in grp.values():
                for i in range(qt.shape[0]):
                    layer_weight(qt, i, dt)
        if "embed" in eng._quant:
            dequantize_any(eng._quant["embed"]["table"])

    return device_ms(torch, run, iters=3, warmup=1)


def serve_quant(torch, pa, mg, model, prompts, tag, over):
    """One quantized serving run of Llama-3-8B (full width and depth) at
    phase 5's traffic; returns the kernels' launch counts and the rates.
    int8/int4 weights take K3 in every projection; the minifloat ones take
    no K3 (each layer dequantized with plain torch ops) and add their
    resident bytes against the reckoning, layer 0's wq quantized on the
    card against the CPU, and the dequantization's device ms a step."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.models import Model
    from deepspeed_tpu_torch.ops.quant import (MINIFLOAT_BY_BITS,
                                               WEIGHT_QUANT_BITS)

    cfg = model.config
    tag = f"serve-quant {tag}"
    minifloat = WEIGHT_QUANT_BITS[over["weight_quant"]] in MINIFLOAT_BY_BITS
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
    if eng._mixed_gemm_active == minifloat:
        raise AssertionError(f"{tag}: the mixed-input GEMM is "
                             f"{'' if minifloat else 'not '}active")
    if minifloat:
        check_minifloat_tree(torch, eng, model, over, tag)
    ffwd = quant_first_forward_check(torch, eng, prompts, tag)

    k3 = {"int8": mg.mixed_matmul_2d,
          "int4": mg.mixed4_matmul_2d}.get(over["weight_quant"])
    k3_all = (mg.mixed_matmul_2d, mg.mixed4_matmul_2d)
    kv = over.get("kv_quant")
    kv_attr = f"{kv}_launches" if kv else "launches"
    sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    warm_graphs(torch, eng, prompts, (SERVE_NEW_TOKENS,), tag)
    # the main path: counts to 0 just before, read just after
    for fn in k3_all:
        fn.launches = 0
        fn.design_launches = dict.fromkeys(MIXED_KERNELS, 0)
    pa.launches = pa.int8_launches = pa.fp8_launches = 0
    t0 = time.perf_counter()
    out = eng.generate(dict(enumerate(prompts)), sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    all_k3 = sum(fn.launches for fn in k3_all)
    launches = dict(k3=k3.launches if k3 else 0,
                    k3_other=all_k3 - (k3.launches if k3 else 0),
                    kv=getattr(pa, kv_attr),
                    other_pa=pa.launches + pa.int8_launches
                    + pa.fp8_launches - getattr(pa, kv_attr),
                    **(k3.design_launches if k3
                       else dict.fromkeys(MIXED_KERNELS, 0)))
    steps = int(eng.timings["steps"])
    L = cfg.num_layers
    want_k3 = PROJECTIONS_PER_LAYER * L * steps if k3 else 0
    log(f"[{tag}] generate: 8 x 512-token prompts, {SERVE_NEW_TOKENS} new "
        f"tokens each, {steps} steps in {wall:.3f} s; mixed gemm "
        f"{over['weight_quant']} launches={launches['k3']} (expected "
        f"{want_k3}" + (f": {PROJECTIONS_PER_LAYER} x {L} layers x {steps} "
                        f"steps; decode design {launches['decode']}, "
                        f"prefill design {launches['prefill']}" if k3 else
                        ": a minifloat layer takes no mixed-input GEMM")
        + f"); paged_attention {kv or 'bf16'} cache launches="
        f"{launches['kv']} ({L} x {steps} = {L * steps}); other variants: "
        f"{launches['k3_other']} GEMM, {launches['other_pa']} attention")
    check_tokens(out, cfg, SERVE_NEW_TOKENS, tag)
    check_replayed(eng.timings, tag)
    if launches["k3"] != want_k3 or steps == 0 \
            or launches["kv"] != L * steps or launches["k3_other"] \
            or launches["other_pa"]:
        raise AssertionError(f"{tag}: the serving path did not run the "
                             f"run's kernels in every projection and layer "
                             f"of every step: {launches}")
    ttft = sorted(eng.ttft_ms[u] for u in out)
    check_prefix_and_cow(eng, prompts, sp, tag)
    dq_ms = dequant_ms_per_step(torch, eng) if minifloat else None
    # the rate runs reuse this quantized tree through quant_tree=
    dense = Model.from_params(cfg, eng.params)
    quant = eng._quant
    del eng
    free_engines(torch)
    rates = serve_rates(
        torch, lambda: InferenceEngine(dense, icfg, quant_tree=quant),
        prompts, ttft, tag,
        profile_new=MINIFLOAT_PROFILE_TOKENS if minifloat
        else SERVE_NEW_TOKENS)
    del dense, quant
    torch.cuda.empty_cache()
    by_kind = rates.pop("device_ms_by_kind") or {}
    if "mixed gemm other" in by_kind:
        raise AssertionError(f"{tag}: the profile shows a K3 kernel that is "
                             f"neither design's: {by_kind}")
    if minifloat:
        step_ms = 1e3 * len(prompts) / rates["decode_tok_s"]
        rates.update(dequant_ms=dq_ms, dequant_share=dq_ms / step_ms)
        log(f"[{tag}] dequantizing every block weight once (the embedding "
            f"too, when quantized): {dq_ms:.2f} ms of device time = "
            f"{100 * rates['dequant_share']:.1f}% of a {step_ms:.2f} ms "
            f"decode step")
        total = sum(by_kind.values())
        if total:
            rates["elementwise_share"] = sum(
                by_kind.get(k, 0.0) for k in ("elementwise",
                                              "copies and casts",
                                              "other")) / total
            log(f"[{tag}] the profiled run ({MINIFLOAT_PROFILE_TOKENS} new "
                f"tokens): elementwise, copies and casts and other (the "
                f"dequantization's gathers among them) "
                f"{100 * rates['elementwise_share']:.1f}% of the device "
                "time")
        return dict(launches=launches, first_forward=ffwd, streams=out,
                    weight_bytes=dense_bytes + quant_bytes, t_quant=t_quant,
                    **rates)
    # K3's device time a step of each kind (the profiled run repeats the
    # main run's schedule on a fresh engine: the same steps)
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
    return dict(launches=launches, first_forward=ffwd, streams=out,
                weight_bytes=dense_bytes + quant_bytes, t_quant=t_quant,
                **rates)


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
                                   mixed_gemm=eng._mixed_gemm_active,
                                   stream=eng._wstore)
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


# ---------------------------------------------------------------------------
# serve-offload helpers
# ---------------------------------------------------------------------------

# (b) and (c): phase 5's prompts with 8 new tokens (a weight-streamed step
# reads every layer's weights from the store)
OFFLOAD_NEW_TOKENS = 8
# (c): phase 5's engine with 128 blocks of 64: round 1's 8 prompts hold
# 60 of them; the host ring holds TIER_RAM_BLOCKS demoted blocks, the
# rest spills to files in the store directory
TIER_ENGINE = dict(token_budget=1024, max_seqs=8, kv_block_size=64,
                   num_kv_blocks=128)
TIER_RAM_BLOCKS = 16


def offload_dir(name) -> Path:
    """A fresh directory for a serve-offload store, in NVME_RUN's
    ``store_dir`` (tmpfs: the 9p root caps writes)."""
    import shutil
    path = Path(NVME_RUN["store_dir"]) / f"chip_smoke_{name}_{os.getpid()}"
    shutil.rmtree(path, ignore_errors=True)
    return path


def check_eager(tm, ws, tag):
    """Every step of a weight-streamed run ran eagerly (no capture, no
    replay), through page-locked host slots."""
    log(f"[{tag}] {int(tm['eager_steps'])} eager steps of "
        f"{int(tm['steps'])}; host slots pinned {ws.pinned()}, device slots "
        f"{ws.slot_bytes() / 1e9:.3f} GB")
    if tm["eager_steps"] != tm["steps"] or tm["graph_replays"] \
            or tm["compiles"] or not ws.pinned():
        raise AssertionError(f"{tag}: a streamed step was not an eager step "
                             f"through pinned slots: {tm}")


def run_peak(torch, eng, prompts, n_new, base):
    """One greedy run of ``prompts`` on a warmed ``eng`` (fresh_run first):
    (streams, wall s, the card's peak allocated bytes above ``base``)."""
    from deepspeed_tpu_torch.inference import SamplingParams
    fresh_run(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.generate(dict(enumerate(prompts)),
                       SamplingParams(max_new_tokens=n_new))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def offload_kv(torch, pa, model, prompts):
    """serve-offload (a): phase 5's engine and traffic with the KV cache in
    page-locked host memory, each layer copied through the working layer
    inside the step's graph; against the same engine resident, run here
    (streams, peak, rates)."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    tag = "serve-offload a"
    cfg = model.config
    L = cfg.num_layers
    tol = first_forward_check(torch, model, prompts, tag, kv_offload=True)
    sp = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    n_dec = len(prompts) * (SERVE_NEW_TOKENS - 1)
    res = {}
    for name, over in (("resident", {}), ("kv_offload", dict(
            kv_offload=True))):
        free_engines(torch)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE, **over))
        t_build = time.perf_counter() - t0
        kv = eng.state.kv
        log(f"[{tag}] {name}: KV cache {tree_bytes(kv) / 1e9:.3f} GB on "
            f"{kv.device} (pinned {kv.is_pinned()}), engine built in "
            f"{t_build:.2f} s")
        warm_graphs(torch, eng, prompts, (1, SERVE_NEW_TOKENS), tag)
        pa.launches = 0
        out, wall, peak = run_peak(torch, eng, prompts, SERVE_NEW_TOKENS,
                                   base)
        launches, tm = pa.launches, dict(eng.timings)
        steps = int(tm["steps"])
        check_tokens(out, cfg, SERVE_NEW_TOKENS, tag)
        check_replayed(tm, f"{tag} {name}")
        if launches != L * steps or not steps:
            raise AssertionError(f"{tag} {name}: paged_attention launches "
                                 f"{launches} != {L} x {steps} steps")
        ttft = sorted(eng.ttft_ms[u] for u in out)
        _, t_pre, _ = run_peak(torch, eng, prompts, 1, base)
        check_replayed(eng.timings, f"{tag} {name}, 1 new")
        # every layer of the cache in and out once a step
        moved = 2 * tree_bytes(kv) * steps
        r = dict(streams=out, wall=wall, steps=steps, launches=launches,
                 peak=peak, ttft_p50_ms=statistics.median(ttft),
                 decode_tok_s=n_dec / max(wall - t_pre, 1e-9),
                 copy_gb_s=(moved / wall / 1e9 if over else None))
        log(f"[{tag}] {name}: {steps} steps in {wall:.3f} s, K2 launches "
            f"{launches} ({L} x {steps}); TTFT p50 {r['ttft_p50_ms']:.1f} ms;"
            f" decode {r['decode_tok_s']:.1f} tok/s ({n_dec} tokens in "
            f"{wall - t_pre:.3f} s); peak above the model "
            f"{peak / 1e9:.3f} GB"
            + (f"; host<->card {moved / 1e9:.1f} GB over the run, "
               f"{moved / steps / 1e9:.2f} GB a step, {r['copy_gb_s']:.1f} "
               "GB/s over the run's wall" if over else ""))
        if over:
            same = check_near_ties(torch, eng, prompts, out,
                                   res["resident"]["streams"], tol, tag)

            r["identical"] = same
            check_prefix_and_cow(eng, prompts, sp, tag)
        res[name] = r
        del eng, kv
    free_engines(torch)
    host_empty_cache(torch)
    a, b = res["resident"], res["kv_offload"]
    log(f"[{tag}] peak above the model: resident {a['peak'] / 1e9:.3f} GB, "
        f"kv_offload {b['peak'] / 1e9:.3f} GB (-"
        f"{(a['peak'] - b['peak']) / 1e9:.3f} GB); decode tok/s "
        f"{a['decode_tok_s']:.1f} -> {b['decode_tok_s']:.1f}; TTFT p50 "
        f"{a['ttft_p50_ms']:.1f} -> {b['ttft_p50_ms']:.1f} ms")
    return dict(res, tol=tol)


def offload_weights(torch, pa, mg, model, prompts):
    """serve-offload (b): phase 6 (a)'s configuration (int8 weights and
    embeddings, an int8 cache, the mixed-input GEMM) with the block weights
    spilled to a store in tmpfs and streamed back a layer at a time, every
    step eager; against the same engine resident, run here."""
    import shutil

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    tag = "serve-offload b"
    cfg = model.config
    L = cfg.num_layers
    over = dict(QUANT_RUNS[0][1], mixed_gemm="on")
    store = offload_dir("weights")
    n_new = OFFLOAD_NEW_TOKENS
    res = {}
    for name, extra in (("resident", {}), ("weight_stream", dict(
            weight_stream=str(store)))):
        free_engines(torch)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE, **over,
                                                     **extra))
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        ws = eng._wstore
        resident = tree_bytes(eng.params) + tree_bytes(eng._quant)
        if ws is not None:
            ws.measure = True
            store_bytes = ws.layer_bytes * L
            log(f"[{tag}] store {store} ({disk_facts(str(store))['fstype']}):"
                f" {store_bytes / 1e9:.3f} GB ({ws.layer_bytes / 1e6:.1f} MB "
                f"a layer) spilled in {ws.spill_s:.2f} s "
                f"({store_bytes / ws.spill_s / 1e9:.2f} GB/s), engine built "
                f"in {t_build:.2f} s; mixed gemm eligible "
                f"{ws.mixed_gemm_eligible}, active {eng._mixed_gemm_active}")
        if not eng._mixed_gemm_active:
            raise AssertionError(f"{tag} {name}: the mixed-input GEMM is "
                                 "not active")
        if ws is None:
            warm_graphs(torch, eng, prompts, (1, n_new), tag)
        else:
            ffwd = quant_first_forward_check(torch, eng, prompts, tag)
            ws.bytes_read, ws.read_wait_s = 0, 0.0
            ws.stall_ms()
        mg.mixed_matmul_2d.launches = 0
        mg.mixed_matmul_2d.design_launches = dict.fromkeys(MIXED_KERNELS, 0)
        pa.int8_launches = 0
        out, wall, peak = run_peak(torch, eng, prompts, n_new, base)
        tm = dict(eng.timings)
        steps = int(tm["steps"])
        k3, k2 = mg.mixed_matmul_2d.launches, pa.int8_launches
        check_tokens(out, cfg, n_new, tag)
        if ws is None:
            check_replayed(tm, f"{tag} {name}")
        else:
            check_eager(tm, ws, tag)
        if k3 != PROJECTIONS_PER_LAYER * L * steps or k2 != L * steps \
                or not steps:
            raise AssertionError(
                f"{tag} {name}: K3 launches {k3} (want "
                f"{PROJECTIONS_PER_LAYER} x {L} x {steps}), K2 int8-cache "
                f"launches {k2} (want {L} x {steps})")
        ttft = sorted(eng.ttft_ms[u] for u in out)
        design = dict(mg.mixed_matmul_2d.design_launches)
        read = (ws.bytes_read, ws.read_wait_s) if ws is not None else None
        # decode tok/s as phase 5 counts it: the run against a run of the
        # prefill alone (1 new token)
        _, t_pre, _ = run_peak(torch, eng, prompts, 1, base)
        n_dec = len(prompts) * (n_new - 1)
        r = dict(streams=out, wall=wall, steps=steps, peak=peak,
                 resident=resident, k3=k3, k2=k2, design=design,
                 ttft_p50_ms=statistics.median(ttft),
                 decode_tok_s=n_dec / max(wall - t_pre, 1e-9))
        line = (f"[{tag}] {name}: {steps} steps in {wall:.3f} s; K3 "
                f"launches {k3} ({PROJECTIONS_PER_LAYER} x {L} x {steps}; "
                f"{r['design']}), K2 int8-cache {k2} ({L} x {steps}); TTFT "
                f"p50 {r['ttft_p50_ms']:.1f} ms; decode "
                f"{r['decode_tok_s']:.1f} tok/s ({n_dec} tokens in "
                f"{wall - t_pre:.3f} s); resident weights "
                f"{resident / 1e9:.3f} GB; peak above the model "
                f"{peak / 1e9:.3f} GB")
        if ws is not None:
            stall = ws.stall_ms()
            nbytes, blocked = read
            r.update(read_gb_s=nbytes / wall / 1e9,
                     blocked_gb_s=nbytes / max(blocked, 1e-9) / 1e9,
                     read_share=blocked / wall,
                     first_forward=ffwd,
                     stall_share=stall / 1e3 / wall,
                     store_bytes=store_bytes, spill_s=ws.spill_s,
                     slot_bytes=ws.slot_bytes())
            line += (f"; read {nbytes / 1e9:.2f} GB "
                     f"({nbytes / steps / 1e9:.3f} GB a step), "
                     f"{r['read_gb_s']:.2f} GB/s over the run's wall; the "
                     f"host blocked on reads {blocked:.3f} s "
                     f"({r['read_share']:.1%} of the run; "
                     f"{r['blocked_gb_s']:.2f} GB/s over the blocked time)"
                     f", the compute stream waiting on a slot "
                     f"{stall:.1f} ms ({r['stall_share']:.1%})")
            same = check_near_ties(torch, eng, prompts, out,
                                   res["resident"]["streams"], ffwd[1], tag)
            r["identical"] = same
        log(line)
        res[name] = r
        del eng, ws
    free_engines(torch)
    shutil.rmtree(store)
    host_empty_cache(torch)
    a, b = res["resident"], res["weight_stream"]
    log(f"[{tag}] peak above the model: resident {a['peak'] / 1e9:.3f} GB, "
        f"weight_stream {b['peak'] / 1e9:.3f} GB (-"
        f"{(a['peak'] - b['peak']) / 1e9:.3f} GB); resident weights "
        f"{a['resident'] / 1e9:.3f} -> {b['resident'] / 1e9:.3f} GB + "
        f"{b['slot_bytes'] / 1e9:.3f} GB of slots; decode tok/s "
        f"{a['decode_tok_s']:.1f} -> {b['decode_tok_s']:.1f}; TTFT p50 "
        f"{a['ttft_p50_ms']:.1f} -> {b['ttft_p50_ms']:.1f} ms")
    return res


def offload_tier(torch, pa, model, prompts, tol):
    """serve-offload (c): the KV block tier on TIER_ENGINE.  Round 1 serves
    phase 5's prompts; round 2 serves distinct prompts, one at a time,
    until no block of round 1 is left in the prefix index (all demoted:
    the newest into the host ring, the older spilled to files); round 3
    serves round 1's prompts again, reviving their chains from the ring
    and from the files.  Every step replays a graph (captured in the
    run); round 3's streams equal round 1's but at near-ties."""
    import numpy as np

    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.inference.ragged.state import \
        prefix_chain_digests
    tag = "serve-offload c"
    cfg = model.config
    L = cfg.num_layers
    bs = TIER_ENGINE["kv_block_size"]
    block = L * bs * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    spill = offload_dir("tier")
    free_engines(torch)
    eng = InferenceEngine(model, InferenceConfig(
        **TIER_ENGINE, kv_tier="on",
        kv_tier_ram_mb=(TIER_RAM_BLOCKS + 0.5) * block / 2 ** 20,
        kv_tier_dir=str(spill), kv_tier_nvme_mb=4 * 2 ** 10))
    sp = SamplingParams(max_new_tokens=OFFLOAD_NEW_TOKENS)
    pa.launches = 0
    t0 = time.perf_counter()
    first = eng.generate(dict(enumerate(prompts)), sp)
    round1 = {h.hex() for p in prompts for h in prefix_chain_digests(p, bs)}
    r = np.random.RandomState(1)
    served = 0
    while round1 & eng.state.prefix_digests():
        p = [int(x) for x in r.randint(0, cfg.vocab_size, len(prompts[0]))]
        eng.generate({100 + served: p}, sp)
        served += 1
        if served > 64:
            raise AssertionError(f"{tag}: round 1's blocks never left the "
                                 "index")
    t1 = time.perf_counter()
    tm0 = dict(eng.timings)
    again = eng.generate(dict((200 + u, p) for u, p in enumerate(prompts)),
                         sp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tm = eng.timings
    again = {u - 200: t for u, t in again.items()}
    steps = int(tm["steps"])
    counters = {k: int(v) for k, v in tm.items()
                if k.startswith("kv_tier") and "_ms" not in k}
    restage_ms = tm["kv_tier_restage_ms"]
    log(f"[{tag}] round 1: {len(prompts)} prompts of {len(prompts[0])}, "
        f"{OFFLOAD_NEW_TOKENS} new tokens; round 2: {served} distinct "
        f"prompts until round 1's {len(round1)} blocks left the index "
        f"({t1 - t0:.2f} s for rounds 1-2); round 3: round 1 again in "
        f"{t2 - t1:.3f} s, {int(tm['steps'] - tm0['steps'])} steps, "
        f"prefix hits {int(tm['prefix_hits'] - tm0['prefix_hits'])}, cached "
        f"tokens {int(tm['cached_tokens'] - tm0['cached_tokens'])}")
    log(f"[{tag}] tier counters {counters}; ring {TIER_RAM_BLOCKS} blocks "
        f"of {block / 1e6:.2f} MB; restage drains {restage_ms:.1f} ms for "
        f"{tm['kv_tier_restaged_bytes'] / 1e9:.3f} GB "
        f"({tm['kv_tier_restaged_bytes'] / max(restage_ms, 1e-9) / 1e6:.2f}"
        f" GB/s); tier stats {eng.state.tier.stats()}")
    check_replayed(tm, tag, captures_ok=True)
    if pa.launches != L * (steps + tm["compiles"]):
        raise AssertionError(f"{tag}: K2 launches {pa.launches} != {L} x "
                             f"({steps} steps + {int(tm['compiles'])} "
                             "captures)")
    if not (tm["kv_tier_revives_ram"] and tm["kv_tier_revives_nvme"]) \
            or tm["kv_tier_verify_failures"]:
        raise AssertionError(f"{tag}: want a revive from RAM and one from "
                             f"NVMe and no verify failure: {counters}")
    launches = pa.launches
    same = check_near_ties(torch, eng, prompts, again, first, tol, tag)
    del eng
    free_engines(torch)
    import shutil
    shutil.rmtree(spill, ignore_errors=True)
    return dict(launches=launches, counters=counters, identical=same,
                restage_ms=restage_ms,
                restaged_bytes=tm["kv_tier_restaged_bytes"])


# what serve-offload may leave of the host's MemAvailable: less than (a)'s
# 4.3 GB page-locked cache and (b)'s 7.0 GB store, so keeping either fails
OFFLOAD_HOST_SLACK = 4e9


def serve_offload(torch, pa, mg, model, prompts):
    """serve-offload: (a), (b) and (c) on phase 5's model; every store and
    page-locked buffer is gone at the end (train-offload, later, needs
    the host memory): MemAvailable is back to within OFFLOAD_HOST_SLACK
    of the start."""
    start = host_facts()["mem_available"]
    log(f"[serve-offload] host MemAvailable at the start {start / 1e9:.2f} GB")
    a = offload_kv(torch, pa, model, prompts)
    b = offload_weights(torch, pa, mg, model, prompts)
    c = offload_tier(torch, pa, model, prompts, a["tol"])
    host_empty_cache(torch)
    need_host("serve-offload", start - OFFLOAD_HOST_SLACK, 1.0)
    return dict(a=a, b=b, c=c)


# ---------------------------------------------------------------------------
# serve-fleet helpers
# ---------------------------------------------------------------------------

# each replica: phase 5's engine with every telemetry plane on (the span
# tracer, anomaly detection, SLO scorecards, device telemetry; the flight
# recorder through FailureConfig.flight_dir).  The anomaly path arms no
# capture window of its own (a profiler session inside a measured run
# would be timed with it): the phase arms its window explicitly
FLEET_TELEMETRY = dict(trace=True, anomaly="on", slo="on",
                       device_telemetry="on")
FLEET_ANOMALY_CAPTURES = 0
# warm-up rounds through the gateway (a 1-token and a 32-token run each)
# until FLEET_CLEAN_ROUNDS rounds in a row capture no graph: when the six
# later streams reach the router relative to its steps varies run to run,
# and with it the prefill steps' token buckets (one clean round once left
# a bucket for the measured run to capture)
FLEET_WARM_ROUNDS = 6
FLEET_CLEAN_ROUNDS = 2
# the kill run: tokens every stream has read before a replica is killed
FLEET_KILL_AFTER = 8
# the capture window on the surviving replica
FLEET_CAPTURE_STEPS = 2
FLEET_HTTP_TIMEOUT = 300.0


def fleet_dir() -> Path:
    """A fresh directory (under build/, git-ignored) for the replicas'
    flight dumps and the capture window."""
    import shutil
    path = ROOT / "build" / f"chip_smoke_fleet_{os.getpid()}"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def http_request(port, method, path, body=b"", out=None, first=None):
    """One HTTP/1.1 request to the gateway on 127.0.0.1:``port`` over a
    plain socket.  A ``text/event-stream`` response is read frame by
    frame into ``out`` (``tokens``, their arrival times ``t_tokens``,
    the request's ``uid`` from the chunk id, ``finish``), ``first`` set
    at the first token; any other response's body is returned.  Returns
    (status, headers, body or None)."""
    import socket
    out = {} if out is None else out
    head = (f"{method} {path} HTTP/1.1\r\nHost: chip-smoke\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode("ascii")
    sock = socket.create_connection(("127.0.0.1", port),
                                    timeout=FLEET_HTTP_TIMEOUT)
    f = sock.makefile("rb")
    try:
        out["t_send"] = time.perf_counter()
        sock.sendall(head + body)
        code = int(f.readline().split()[1])
        headers = {}
        while True:
            line = f.readline().decode("latin-1").strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        if "text/event-stream" not in headers.get("content-type", ""):
            n = headers.get("content-length")
            return code, headers, f.read(int(n)) if n else f.read()
        out.setdefault("tokens", [])
        out.setdefault("t_tokens", [])
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                break
            ev = json.loads(data)
            out["uid"] = int(ev["id"].rsplit("-", 1)[1])
            choice = ev["choices"][0]
            if choice["token"] is not None:
                out["t_tokens"].append(time.perf_counter())
                out["tokens"].append(int(choice["token"]))
                if first is not None:
                    first.set()
            if choice["finish_reason"] is not None:
                out["finish"] = choice["finish_reason"]
        return code, headers, None
    finally:
        f.close()
        sock.close()


def fleet_run(port, prompts, n_new, during=None):
    """The 8 prompts as 8 streaming ``POST /v1/completions`` of ``n_new``
    greedy tokens each, one client thread a stream: prompts 0 and 1 first
    and, once prompt 0's first token is back (its blocks are then in its
    replica's prefix index), the other six, so that the router's affinity
    can place prompt 2 with prompt 0; all 8 streams are then open at
    once.  ``during(outs)`` runs on the calling thread while the streams
    run.  Returns (the per-prompt stream dicts, the wall seconds)."""
    import threading
    outs = [dict() for _ in prompts]
    codes = [None] * len(prompts)
    first0 = threading.Event()

    def go(i, first=None):
        body = json.dumps({"prompt": prompts[i], "max_tokens": n_new,
                           "stream": True}).encode()
        codes[i] = http_request(port, "POST", "/v1/completions", body,
                                out=outs[i], first=first)[0]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(0, first0)),
               threading.Thread(target=go, args=(1,))]
    for t in threads:
        t.start()
    if not first0.wait(FLEET_HTTP_TIMEOUT):
        raise AssertionError("serve-fleet: no first token for prompt 0")
    later = [threading.Thread(target=go, args=(i,))
             for i in range(2, len(prompts))]
    for t in later:
        t.start()
    if during is not None:
        during(outs)
    for t in threads + later:
        t.join(FLEET_HTTP_TIMEOUT)
    wall = time.perf_counter() - t0
    for i, (o, c) in enumerate(zip(outs, codes)):
        if c != 200 or len(o.get("tokens", ())) != n_new \
                or o.get("finish") != "length":
            raise AssertionError(f"serve-fleet: stream {i} came back "
                                 f"{c}, {len(o.get('tokens', ()))} of "
                                 f"{n_new} tokens, finish "
                                 f"{o.get('finish')}")
    return outs, wall


def thread_cpu_s(thread) -> float:
    """CPU seconds a live thread has used (Linux per-thread clock)."""
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


def record_of(engines, uid):
    """(replica name, request record) of ``uid``'s finished record."""
    for name, e in engines.items():
        for rec in e.requests.records():
            if rec.uid == uid and rec.status == "finished":
                return name, rec
    raise AssertionError(f"serve-fleet: no finished record of uid {uid}")


def decode_rate(torch, eng, prompts):
    """Phase 5's decode tok/s on one warmed engine: 8 x 31 tokens / (the
    32-token run's wall - the 1-token run's)."""
    from deepspeed_tpu_torch.inference import SamplingParams
    walls = []
    for n in (1, SERVE_NEW_TOKENS):
        fresh_run(eng)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(dict(enumerate(prompts)),
                     SamplingParams(max_new_tokens=n))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        check_replayed(eng.timings, f"serve-fleet rate, {n} new")
    return len(prompts) * (SERVE_NEW_TOKENS - 1) / (walls[1] - walls[0])


def capture_step_shapes(torch, eng, tag):
    """Capture the graph of every step shape that phase 5's traffic can
    give one replica of the fleet, wherever its requests land, through
    put/step with random prompts on the idle engine; fails if a shape was
    not captured.  A step's graph is keyed by its token bucket (a power
    of two from max_seqs to the token budget) and its context bucket: a
    step of prompt chunks alone ends every context in 257..512 tokens (a
    512-token prompt, after a cached 256-token prefix or a cut chunk:
    8 blocks), a step with a decoding row holds a context past 512 (16
    blocks).  Leaves the engine as fresh."""
    import numpy as np
    from deepspeed_tpu_torch.inference import SamplingParams
    sp = SamplingParams()
    bs = eng.icfg.kv_block_size
    buckets = [eng.token_bucket(1)]
    while buckets[-1] < eng.icfg.token_budget:
        buckets.append(eng.token_bucket(2 * buckets[-1]))
    rs = np.random.RandomState(0)
    uids = iter(range(1 << 20, 1 << 21))

    def rand(n):
        return rs.randint(0, eng.cfg.vocab_size, n).tolist()

    def run(*prompts, decode=None):
        """One step of these new prompts (and ``decode``'s next token);
        every new prompt is flushed after it.  Returns the step's tokens."""
        if decode is not None:
            eng.put(*decode)
        new = [next(uids) for _ in prompts]
        for u, p in zip(new, prompts):
            eng.put(u, p)
        out = eng.step(sampling=sp)
        for u in new:
            eng.flush(u)
        return out

    t0 = time.perf_counter()
    fresh_run(eng)
    # 8 blocks: a 320-token prompt alone (bucket 512), two (1024), then
    # its first 256 tokens cached before b new ones (bucket b <= 256)
    prefix = rand(5 * bs)
    run(prefix)
    run(rand(5 * bs), rand(5 * bs))
    for b in buckets:
        if b <= 4 * bs:
            run(prefix[:4 * bs] + rand(b))
    # 16 blocks: a 520-token prompt (bucket 1024), then its decoding row
    # beside b - 1 prompt tokens (bucket b), then alone (the least bucket)
    d = next(uids)
    eng.put(d, rand(8 * bs + 8))
    tok = eng.step(sampling=sp)[d]
    for b in buckets[1:]:
        tok = run(rand(b - 1), decode=(d, [tok]))[d]
    run(decode=(d, [tok]))
    eng.flush(d)
    torch.cuda.synchronize()
    want = {("p", b, m, sp.sampler_key) for b in buckets for m in (8, 16)}
    held = set(eng._graphs)
    log(f"[{tag}] step shapes: {int(eng.timings['compiles'])} graphs "
        f"captured in {time.perf_counter() - t0:.1f} s; held (token bucket, "
        f"context blocks) "
        f"{sorted((k[1], k[2]) for k in held if k[0] == 'p')}")
    fresh_run(eng)
    if not want <= held:
        raise AssertionError(f"{tag}: step shapes not captured: "
                             f"{sorted(want - held)}")


def serve_fleet(torch, pa, model, prompts, phase5):
    """serve-fleet: a ``FleetRouter`` over two replicas of phase 5's model
    (the weights shared, a cache each) behind the port's ``Gateway`` on
    127.0.0.1, every telemetry plane on.  Warm-up rounds through the
    gateway capture every graph; the measured 1- and 32-token runs give
    TTFT and decode tok/s through the gateway and the gateway's and the
    router's host ms a token; then checks (streams against phase 5 by
    the near-tie rule, prompt 2 placed with prompt 0 on a prefix hit,
    every step a replay, K2 = layers x steps, ``/metrics``, ``/healthz``,
    ``/debug/slo``), a replica killed mid-run (its streams migrate and
    finish, its flight dump validates, the reconciled statuses partition
    the requests), a 2-step capture window merged by tools/tracemerge.py
    with paged attention on its device track, and one replica's decode
    tok/s with telemetry on against off.  Returns K2's launches over the
    measured 32-token run."""
    from deepspeed_tpu_torch.gateway import GatewayConfig, spawn_gateway
    from deepspeed_tpu_torch.inference import (FailureConfig,
                                               InferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.serving import (FleetRouter,
                                             reconciled_terminal_statuses)
    from deepspeed_tpu_torch.telemetry import (AnomalyConfig,
                                               parse_prometheus_text,
                                               validate_flight_dump)
    from deepspeed_tpu_torch.models.transformer import tree_leaves
    from tools import tracemerge

    tag = "serve-fleet"
    L = model.config.num_layers
    n = len(prompts)
    ref, tol = phase5["streams"], phase5["tol"]
    contexts = dict(enumerate(prompts))
    t_phase = time.perf_counter()
    root = fleet_dir()
    free_engines(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engines = {name: InferenceEngine(model, InferenceConfig(
        **SERVE_ENGINE, **FLEET_TELEMETRY,
        anomaly_cfg=AnomalyConfig(max_captures=FLEET_ANOMALY_CAPTURES),
        failure=FailureConfig(flight_dir=str(root / name))))
        for name in ("r0", "r1")}
    ptrs = [x.data_ptr() for x in tree_leaves(model.params)]
    shared = all([x.data_ptr() for x in tree_leaves(e.params)] == ptrs
                 for e in engines.values())
    log(f"[{tag}] replicas r0, r1 over one model (weights shared: "
        f"{shared}), a {tree_bytes(engines['r0'].state.kv) / 1e9:.3f} GB "
        f"cache each; allocated above the model "
        f"{(torch.cuda.memory_allocated() - base) / 1e9:.3f} GB")
    if not shared:
        raise AssertionError(f"{tag}: the replicas copied the weights")
    # every step shape the router can place on a replica, captured on each
    # before the gateway's loop drives them: where the six later requests
    # land relative to a replica's steps varies run to run
    t0 = time.perf_counter()
    for name, e in engines.items():
        capture_step_shapes(torch, e, f"{tag} {name}")
    log(f"[{tag}] step shapes captured in {time.perf_counter() - t0:.1f} s")
    router = FleetRouter(engines)
    handle = spawn_gateway(router, GatewayConfig(
        ops="on", install_signals=False, max_tokens_cap=SERVE_NEW_TOKENS))
    gw, port = handle.gateway, handle.port

    # host time: the router's step wall less its engines' steps; the
    # gateway's pump wall less the router's step, and its event loop's
    # CPU time
    walls = dict(router=0.0, engines=0.0, pump=0.0)

    def timed(fn, key):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                walls[key] += time.perf_counter() - t
        return call

    router.step = timed(router.step, "router")
    for e in engines.values():
        e.step = timed(e.step, "engines")
    gw._pump = timed(gw._pump, "pump")

    def fresh(all_metrics=False):
        for e in engines.values():
            e.state.reset_prefix_cache()
            if all_metrics:
                e.reset_metrics()
            else:
                e.reset_timings()
            e.ttft_ms.clear()

    t0 = time.perf_counter()
    clean = 0
    for rnd in range(FLEET_WARM_ROUNDS):
        caps = 0
        for n_new in (1, SERVE_NEW_TOKENS):
            fresh()
            fleet_run(port, prompts, n_new)
            caps += sum(int(e.timings["compiles"]) for e in engines.values())
        log(f"[{tag}] warm-up round {rnd}: {caps} graphs captured; held "
            + ", ".join(f"{k} {len(e._graphs)}" for k, e in engines.items()))
        clean = clean + 1 if caps == 0 else 0
        if clean == FLEET_CLEAN_ROUNDS:
            break
    else:
        raise AssertionError(f"{tag}: graphs still captured after "
                             f"{FLEET_WARM_ROUNDS} warm-up rounds")
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up {time.perf_counter() - t0:.1f} s")

    def measured(n_new):
        fresh(all_metrics=True)
        for k in walls:
            walls[k] = 0.0
        cpu0 = thread_cpu_s(handle._thread)
        pa.launches = 0
        torch.cuda.synchronize()
        outs, wall = fleet_run(port, prompts, n_new)
        torch.cuda.synchronize()
        return outs, wall, pa.launches, thread_cpu_s(handle._thread) - cpu0

    _, wall1, _, _ = measured(1)
    outs, wall, launches, loop_cpu = measured(SERVE_NEW_TOKENS)
    steps = {k: int(e.timings["steps"]) for k, e in engines.items()}
    for k, e in engines.items():
        check_replayed(e.timings, f"{tag} {k}")
        tm = e.timings
        log(f"[{tag} {k}] host phases per step over {steps[k]} steps (ms): "
            + ", ".join(f"{ph.split('_')[0]} {tm[ph] / steps[k]:.3f}"
                        for ph in ("schedule_ms", "stage_ms", "device_ms",
                                   "wait_ms", "readback_ms"))
            + " (device = the enqueue)")
    log(f"[{tag}] K2 launches {launches} over {sum(steps.values())} replica "
        f"steps {steps} (x {L} layers = {L * sum(steps.values())})")
    if launches != L * sum(steps.values()) or launches == 0:
        raise AssertionError(f"{tag}: K2 did not run in every layer of "
                             "every replica step")
    got = {i: o["tokens"] for i, o in enumerate(outs)}
    check_near_ties(torch, engines["r0"], contexts, got, ref, tol, tag)
    placed = {i: record_of(engines, o["uid"]) for i, o in enumerate(outs)}
    log(f"[{tag}] placement: " + ", ".join(
        f"prompt {i} -> {name} (cached {rec.cached_tokens})"
        for i, (name, rec) in placed.items()))
    shared_tokens = 4 * SERVE_ENGINE["kv_block_size"]
    if placed[2][0] != placed[0][0] \
            or placed[2][1].cached_tokens < shared_tokens:
        raise AssertionError(f"{tag}: affinity did not place prompt 2 on "
                             f"prompt 0's replica with its {shared_tokens} "
                             "shared tokens cached")
    ttft = sorted((o["t_tokens"][0] - o["t_send"]) * 1e3 for o in outs)
    tokens = n * SERVE_NEW_TOKENS
    decode = n * (SERVE_NEW_TOKENS - 1) / max(wall - wall1, 1e-9)
    eng_ms = sum(e.timings[k] for e in engines.values()
                 for k in ("schedule_ms", "stage_ms", "device_ms", "wait_ms",
                           "readback_ms"))
    router_ms = (walls["router"] - walls["engines"]) * 1e3
    pump_ms = (walls["pump"] - walls["router"]) * 1e3
    log(f"[{tag}] through the gateway: TTFT p50 "
        f"{statistics.median(ttft):.1f} ms (min {ttft[0]:.1f}, max "
        f"{ttft[-1]:.1f}; phase 5 engine-direct {phase5['ttft_p50_ms']:.1f});"
        f" decode {decode:.1f} tok/s ({n} x {SERVE_NEW_TOKENS - 1} tokens in "
        f"{wall - wall1:.3f} s; phase 5 engine-direct "
        f"{phase5['decode_tok_s']:.1f}); walls 1-token {wall1:.3f} s, "
        f"32-token {wall:.3f} s")
    log(f"[{tag}] host ms per emitted token ({tokens} tokens): router "
        f"{router_ms / tokens:.4f} (router.step {walls['router'] * 1e3:.1f}"
        f" ms less its engine steps {walls['engines'] * 1e3:.1f}); gateway "
        f"pump {pump_ms / tokens:.4f} (pump {walls['pump'] * 1e3:.1f} ms "
        f"less router.step), gateway event loop CPU "
        f"{loop_cpu * 1e3 / tokens:.4f}; engines' own phases "
        f"{eng_ms / tokens:.4f}")

    code, _, text = http_request(port, "GET", "/metrics")
    metrics = parse_prometheus_text(text.decode())
    gauges = {name: metrics.get(name, {}).get("samples", {})
              for name in ("serving_mfu", "serving_hbm_bw_util")}
    log(f"[{tag}] /metrics {code}: {len(metrics)} metric families; "
        + "; ".join(f"{name} " + ", ".join(
            f"{dict(labels).get('replica', '-')} {v:.6f}"
            for (_, labels), v in sorted(samples.items()))
            for name, samples in gauges.items()))
    if code != 200 or "serving_steps_total" not in metrics \
            or not all(gauges.values()):
        raise AssertionError(f"{tag}: /metrics lacks the serving series or "
                             "the utilization gauges")
    code, _, body = http_request(port, "GET", "/healthz")
    log(f"[{tag}] /healthz {code}: {body.decode()[:200]}")
    if code != 200:
        raise AssertionError(f"{tag}: /healthz answered {code}")
    code, _, body = http_request(port, "GET", "/debug/slo")
    card = json.loads(body)
    evaluated = sum(o["evaluated"] for c in card.get("classes", {}).values()
                    for o in c["objectives"].values())
    log(f"[{tag}] /debug/slo {code}: {evaluated} objective evaluations "
        f"over classes {sorted(card.get('classes', {}))}")
    if code != 200 or not card.get("enabled") or evaluated <= 0:
        raise AssertionError(f"{tag}: /debug/slo shows no evaluated request")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"[{tag}] max_memory_allocated above the model {peak:.2f} GiB (two "
        f"caches, two graph pools)")

    # a replica killed mid-run: its open streams migrate to the other
    victim = {}

    def kill(outs_k):
        t_end = time.perf_counter() + FLEET_HTTP_TIMEOUT
        while not all(len(o.get("tokens", ())) >= FLEET_KILL_AFTER
                      for o in outs_k):
            if time.perf_counter() > t_end:
                raise AssertionError(f"{tag}: the streams stalled")
            time.sleep(0.001)
        name = max(engines, key=lambda k: len(engines[k].state.seqs))
        victim["name"] = name
        victim["live"] = len(engines[name].state.seqs)
        engines[name].failures.inject("fatal")

    fresh(all_metrics=True)
    outs_k, wall_k = fleet_run(port, prompts, SERVE_NEW_TOKENS, during=kill)
    dead = victim["name"]
    survivor = next(k for k in engines if k != dead)
    if not router.replica(dead).dead:
        raise AssertionError(f"{tag}: the killed replica is not dead")
    check_near_ties(torch, engines[survivor], contexts,
                    {i: o["tokens"] for i, o in enumerate(outs_k)}, ref, tol,
                    f"{tag} kill")
    dumps = sorted((root / dead).glob("flight_engine_dead_*.json"))
    problems = [validate_flight_dump(json.loads(p.read_text()))
                for p in dumps]
    statuses = reconciled_terminal_statuses(router)
    log(f"[{tag}] killed {dead} with {victim['live']} live streams after "
        f"{FLEET_KILL_AFTER} tokens each: every stream finished in "
        f"{wall_k:.3f} s on {survivor}; flight dumps {[p.name for p in dumps]}"
        f" problems {problems}; reconciled statuses {statuses}; migrations "
        f"{int(router.metrics.series_sum('serving_fleet_migrations_total'))}")
    if not dumps or any(problems):
        raise AssertionError(f"{tag}: no valid flight dump of {dead}")
    if statuses != {"finished": n}:
        raise AssertionError(f"{tag}: the reconciled terminal statuses do "
                             f"not partition the {n} requests: {statuses}")

    # a 2-step capture window on the survivor, armed in steady decode
    cdir = {}

    def arm(outs_c):
        while not all(len(o.get("tokens", ())) >= FLEET_KILL_AFTER
                      for o in outs_c):
            time.sleep(0.001)
        cdir["dir"] = engines[survivor].capture(
            FLEET_CAPTURE_STEPS, reason="serve_fleet",
            out_dir=str(root / "captures"))

    fresh()
    fleet_run(port, prompts, SERVE_NEW_TOKENS, during=arm)
    handle.stop()
    captures = engines[survivor].capture_dirs
    if cdir.get("dir") not in captures:
        raise AssertionError(f"{tag}: the capture window did not complete: "
                             f"{cdir} {captures}")
    merged = json.loads(Path(tracemerge.merge_capture(cdir["dir"]))
                        .read_text())
    problems = tracemerge.validate_merged_trace(merged)
    kernels = sorted({e["name"] for e in merged["traceEvents"]
                      if e.get("pid", 0) >= 10_000 and e.get("ph") == "X"
                      and e.get("cat") == "kernel"})
    paged = [k for k in kernels if "paged" in k]
    log(f"[{tag}] capture {Path(cdir['dir']).name}: {len(kernels)} distinct "
        f"kernels on the device track, paged attention: "
        f"{[k[:60] for k in paged]}; merge problems {problems}")
    if problems or not paged:
        raise AssertionError(f"{tag}: the merged capture lacks the "
                             "paged-attention kernel on its device track")

    # one replica's decode tok/s, telemetry on against off, in turns, on
    # two fresh engines built and warmed alike
    del router, handle, gw, engines
    free_engines(torch)
    on = InferenceEngine(model, InferenceConfig(
        **SERVE_ENGINE, **FLEET_TELEMETRY,
        anomaly_cfg=AnomalyConfig(max_captures=FLEET_ANOMALY_CAPTURES),
        failure=FailureConfig(flight_dir=str(root / "on"))))
    off = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE))
    for name, e in (("on", on), ("off", off)):
        warm_graphs(torch, e, prompts, (1, SERVE_NEW_TOKENS),
                    f"{tag} telemetry {name}")
    rates = {"on": [], "off": []}
    for name in ("on", "off", "off", "on"):
        rates[name].append(decode_rate(torch, on if name == "on" else off,
                                       prompts))
    log(f"[{tag}] one replica's decode tok/s, telemetry on "
        f"{[round(r, 1) for r in rates['on']]} vs off "
        f"{[round(r, 1) for r in rates['off']]} (on, off, off, on): "
        f"{100 * (1 - statistics.mean(rates['on']) / statistics.mean(rates['off'])):+.1f}% "
        f"cost")
    del on, off
    free_engines(torch)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    log(f"[time] serve-fleet: {time.perf_counter() - t_phase:.1f} s")
    return launches


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
#                  spans of 2^20 elements), 1 warm-up + 1 measured step;
#                  parity at 2 layers
#   train-nvme     gptj-6b at its published widths, depth cut to 4 layers
#                  (1.22 B params); bf16, seq 2048, micro-batch 1, AdamW,
#                  clip 1.0, ZeRO-3; (b) offload_optimizer nvme, (c) plus
#                  offload_param nvme with model= (streaming); 1 + 1 steps
#                  each.  The machine has no local disk: its root is 9p,
#                  which takes 45 GiB of writes a machine, and (b) and (c)
#                  write 15-22 GB a step.  So nvme_path is a temporary
#                  directory in /dev/shm (tmpfs, host memory), and the
#                  disk (a temporary directory under build/, 9p) takes the
#                  aio check and (c)'s checkpoint; both are removed at the
#                  end
# 1 measured step each: the whole run's time limit (serve-offload took
# the third's time, hybrid and train-de the second's; a step's host update
# ran 18-32 s on the card's machines)
OFFLOAD_RUN = dict(preset="gptj-6b", seq=2048, micro=2, warmup=1, steps=1,
                   remat=True, policy="flash", buffer_count=4,
                   buffer_size=32 << 20, parity_layers=2, parity_steps=2,
                   host_share=0.75)
NVME_RUN = dict(preset="gptj-6b", num_layers=4, seq=2048, micro=1, warmup=1,
                steps=1, aio_bytes=2 << 30, host_share=0.75,
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
                    f" GB: at {layers} layers the meter cannot be under the "
                    f"bf16 model)")
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


# ---------------------------------------------------------------------------
# hybrid: the DeepSpeed-Chat actor loop; train-de: data-efficient training
# ---------------------------------------------------------------------------

# the actor: phi-2 at full width and depth, bf16, ZeRO-1, AdamW, remat
# "flash", K1 in the actor's steps; its rollouts through the serving
# engine (bf16 weights and cache, prefix cache on, 64-token blocks): 8
# prompts of 512 tokens (8 full blocks each), 32 greedy new tokens
HYBRID_RUN = dict(preset="phi-2", micro=4, seq=1024, steps=2, prompt_len=512,
                  new=32)
HYBRID_ENGINE = dict(token_budget=1024, max_seqs=8, kv_block_size=64,
                     num_kv_blocks=160, prefix_cache="on")


def reckon_hybrid_peak(cfg, n_params, micro, seq, kv_bytes):
    """The actor's card memory at the start of its backward, from the
    shapes (bytes): the model's bf16 parameters (the served weights are
    these tensors), the step's bf16 compute copy and its bf16 gradients,
    the fp32 master, AdamW's m and v and the fp32 gradients (16 B a
    parameter), the activations remat "flash" saves (reckon_peak's
    count), the bf16 logits and their gradient, and the serving cache."""
    B, S, dm, dff = micro, seq, cfg.d_model, cfg.d_ff
    acts = cfg.num_layers * (2 * B * S * (7 * dm + dff)
                             + 4 * B * S * cfg.num_heads)
    logits = 2 * 2 * B * S * cfg.vocab_size
    parts = dict(weights=2 * n_params, compute=2 * n_params,
                 grads16=2 * n_params, state=16 * n_params, acts=acts,
                 logits=logits, kv=kv_bytes)
    return sum(parts.values()), parts


def hybrid(torch, fa, pa, seed, device=None, **overrides):
    """The actor loop through ``deepspeed_tpu_torch.HybridEngine``: roll
    out, take HYBRID_RUN["steps"] actor steps, roll out again (the
    refresh happens there).  Checks the served weights bitwise
    ``compute_params``, the first forward against the dense forward on
    them, the refreshed rollout against a freshly built engine on them
    (equal but at near-ties; no stale prefix block reused), every
    rollout step a graph replay with K2 launched layers x steps, and
    each flash kernel once a layer a train step, all of the bf16 variant
    at the model's head dim.  Returns (the flash launches by variant, the
    measured rollout's K2 launches).  ``device`` and ``overrides`` exist
    for a CPU rehearsal at a tiny size."""
    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.models import Model, build_model
    from deepspeed_tpu_torch.models.transformer import tree_leaves
    from deepspeed_tpu_torch.runtime import param_count, synthetic_lm_data

    tag, run = "hybrid", HYBRID_RUN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    micro = overrides.pop("micro", run["micro"])
    seq = overrides.pop("max_seq_len", run["seq"])
    plen = overrides.pop("prompt_len", run["prompt_len"])
    t0 = time.perf_counter()
    model = build_model(run["preset"], seed=seed, device=device,
                        dtype=torch.bfloat16, max_seq_len=max(seq, 2048),
                        remat=True, remat_policy="flash",
                        attention_impl="flash", **overrides)
    cfg = model.config
    n_params = param_count(model.params)
    icfg = InferenceConfig(**HYBRID_ENGINE)
    kv_bytes = (2 * 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
                * icfg.kv_block_size * (icfg.num_kv_blocks + 1))
    reckoned, parts = reckon_hybrid_peak(cfg, n_params, micro, seq, kv_bytes)
    log(f"[{tag}] {run['preset']}: {n_params / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, {cfg.num_heads} heads of {cfg.head_dim}, "
        f"d_model {cfg.d_model}; bf16, ZeRO-1, AdamW lr 3e-4, clip 1.0, "
        f"remat 'flash', micro-batch {micro}, seq {seq}; rollouts: 8 x "
        f"{plen}-token prompts, {run['new']} greedy tokens, engine "
        f"{HYBRID_ENGINE}; reckoned peak {reckoned / 2**30:.2f} GiB ("
        + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in parts.items())
        + f" GiB); built in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    he = ds.HybridEngine(model, train_config(micro, "bf16"),
                         inference_config=icfg, device=device)
    r = np.random.RandomState(seed + 1)
    prompts = {u: list(map(int, r.randint(0, cfg.vocab_size, plen)))
               for u in range(8)}
    sp = SamplingParams(max_new_tokens=run["new"])

    # rollout 1: captures every graph the refreshed rollout replays
    t1 = time.perf_counter()
    he.generate(dict(prompts), sp)
    eng = he.inference_engine
    torch.cuda.synchronize()
    log(f"[{tag}] rollout 1 (serving engine built, graphs captured): "
        f"{time.perf_counter() - t1:.2f} s, {int(eng.timings['compiles'])} "
        f"graphs; KV cache {tree_bytes(eng.state.kv) / 1e9:.3f} GB")

    # the actor's steps: flash counts to 0 just before, read just after
    data = synthetic_lm_data(cfg.vocab_size, micro * run["steps"], seq,
                             seed=seed)["input_ids"]
    fa.reset_launches()
    fa.flash_attention.fallbacks = 0
    losses, step_s = [], []
    for s in range(run["steps"]):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        met = he.train_batch({"input_ids": data[s * micro:(s + 1) * micro]})
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t2)
    counts = flash_counts(fa)
    variants = {k: dict(getattr(fa, k).variant_launches)
                for k in FLASH_KERNELS}
    variant = ("bfloat16", fa.kernel_head_dim(cfg.head_dim))
    want = cfg.num_layers * run["steps"]
    mem = torch.cuda.memory_stats()
    log(f"[{tag}] allocator after the actor steps: reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, allocation retries "
        f"{mem.get('num_alloc_retries', 0)}, cudaMalloc calls "
        f"{mem.get('num_device_alloc', 'n/a')}, cudaFree calls "
        f"{mem.get('num_device_free', 'n/a')}")
    log(f"[{tag}] {run['steps']} actor steps: "
        f"{[round(x * 1e3, 1) for x in step_s]} ms (the first builds the "
        f"engine's state and warms the card), losses "
        f"{[round(x, 4) for x in losses]}, {micro * seq / step_s[-1]:.0f} "
        f"training tokens/s at the last step; "
        f"flash launches fwd={counts[0]} dq={counts[1]} dkv={counts[2]} "
        f"(want {want} each), routed to causal_attention {counts[3]}; by "
        f"(dtype, head dim) {variants}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: non-finite actor loss")
    if counts != (want, want, want, 0) or any(
            v != {variant: want} for v in variants.values()):
        raise AssertionError(f"{tag}: each flash kernel must run once a "
                             f"layer a step, all of the {variant} variant")

    # rollout 2: the refresh, then the measured rollout (K2 counts to 0
    # just before, read just after)
    eng.reset_timings()
    eng.ttft_ms.clear()
    pa.launches = 0
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    got = he.generate(dict(prompts), sp)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t3
    launches = pa.launches
    tm = dict(eng.timings)
    refresh_ms = he.refresh_seconds[-1] * 1e3
    ttft = sorted(eng.ttft_ms[u] for u in got)
    check_tokens(got, cfg, run["new"], tag)
    check_replayed(tm, tag)
    steps = int(tm["steps"])
    log(f"[{tag}] rollout 2: refresh (masters -> served weights, prefix "
        f"cache reset) {refresh_ms:.1f} ms; {steps} steps in {t_all:.3f} s "
        f"(refresh included); cached prompt tokens {int(tm['cached_tokens'])}"
        f"; paged_attention launches {launches} ({cfg.num_layers} layers x "
        f"{steps} steps = {cfg.num_layers * steps})")
    if tm["cached_tokens"] or launches != cfg.num_layers * steps \
            or launches == 0:
        raise AssertionError(f"{tag}: the refreshed rollout reused a cached "
                             "prefix or did not launch K2 in every layer of "
                             "every step")
    # prefill alone on the same weights, for the decode rate
    fresh_run(eng)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    eng.generate(dict(prompts), SamplingParams(max_new_tokens=1))
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t4
    check_replayed(eng.timings, f"{tag} prefill")
    decode_tok_s = len(prompts) * (run["new"] - 1) / max(
        t_all - refresh_ms / 1e3 - t_pre, 1e-9)
    cp = he.engine.compute_params
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(eng.params),
                                                  tree_leaves(cp)))
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] served weights bitwise compute_params: {same}; TTFT p50 "
        f"{statistics.median(ttft):.1f} ms (min {ttft[0]:.1f}, max "
        f"{ttft[-1]:.1f}); prefill {t_pre:.3f} s; decode {decode_tok_s:.0f} "
        f"tok/s; max_memory_allocated {peak / 2**30:.2f} GiB (reckoned "
        f"{reckoned / 2**30:.2f} GiB) [{nvidia_smi_line()}]")
    if not same:
        raise AssertionError(f"{tag}: the served weights are not the "
                             "trained ones")
    del he, eng
    free_engines(torch)
    # the first forward on the new weights (the served tensors are the
    # model's, refreshed in place), and a fresh engine's streams on them
    served = Model.from_params(cfg, cp)
    plist = [prompts[u] for u in range(8)]
    tol = first_forward_check(torch, served, plist, tag)
    fresh = InferenceEngine(served, icfg)
    want_out = fresh.generate(dict(prompts), sp)
    check_near_ties(torch, fresh, prompts, got, want_out, tol,
                    f"{tag} vs a fresh engine")
    del fresh, served, cp, model
    free_engines(torch)
    return variants, launches


# train-de: phase 4's GPT-2-small (bf16, ZeRO-1, flash, micro-batch 32)
# with four data-efficiency features at once for 6 steps; every length a
# multiple of K1's 128-row tile (the JAX routing keeps each step on K1)
DE_RUN = dict(preset="gpt2", micro=32, seq=1024, steps=6, profile_step=2)
DE_FEATURES = {
    "curriculum_learning": {"enabled": True, "min_difficulty": 256,
                            "max_difficulty": 1024,
                            "schedule_type": "fixed_linear",
                            "schedule_config": {"total_curriculum_step": 6,
                                                "difficulty_step": 128}},
    "data_efficiency": {"enabled": True, "data_routing": {
        "enabled": True, "random_ltd": {
            "enabled": True, "min_value": 512, "max_value": 1024,
            "require_steps": 6, "seq_per_step": 128}}},
    "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                               "gamma": 0.001},
    "quantize_training": {"enabled": True, "start_bits": 16,
                          "target_bits": 8, "quantize_period": 2},
}
# the eigenvalue-paced MoQ boundary: attention_impl "xla", micro-batch 4,
# seq 512, 16 -> 8 -> 4 bits a period of 1: step 1 is a boundary
EIG_RUN = dict(micro=4, seq=512, max_iter=3)


def reckon_step_products(cfg, B, S, keep, kept_layers):
    """2 x M x N x K summed over one training step's matrix products of a
    dense GPT-style model (the flops profiler's count): per kept layer the
    projections on ``keep`` tokens a row, forward and the backward's
    input and weight gradients, and flash attention's causal products at
    length ``keep`` (fwd 2, dq 3, dk/dv 4: flash_bound's count); the tied
    head on all S tokens, forward and both gradients."""
    dm, dff, H, D, V = (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim,
                        cfg.vocab_size)
    proj = 2 * B * keep * dm * (3 * dm + dm + 2 * dff)
    flash = 2 * B * H * (keep * keep // 2) * D * (2 + 3 + 4)
    return kept_layers * (3 * proj + flash) + 3 * 2 * B * S * dm * V


def train_de(torch, fa, seed, device=None, **overrides):
    """GPT-2-small with the seqlen curriculum, random-LTD, PLD and MoQ on
    at once (DE_FEATURES), the flops profiler at DE_RUN["profile_step"],
    through deepspeed_tpu_torch.initialize; then one eigenvalue-paced
    MoQ boundary under attention_impl "xla".  Returns the flash launches
    by variant over the 6 steps.  ``device`` and ``overrides`` exist for
    a CPU rehearsal at a tiny size."""
    import dataclasses

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Model, build_model
    from deepspeed_tpu_torch.models.transformer import layer_keys, pld_drops
    from deepspeed_tpu_torch.runtime import param_count, synthetic_lm_data
    from deepspeed_tpu_torch.utils.prng import PRNGKey

    tag, run = "train-de", DE_RUN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    micro = overrides.pop("micro", run["micro"])
    seq = overrides.pop("max_seq_len", run["seq"])
    features = overrides.pop("features", DE_FEATURES)
    eig_run = overrides.pop("eig_run", EIG_RUN)
    model = build_model(run["preset"], seed=seed, device=device,
                        max_seq_len=seq, attention_impl="flash", **overrides)
    cfg = model.config
    config = {**train_config(micro, "bf16"), **features,
              "flops_profiler": {"enabled": True,
                                 "profile_step": run["profile_step"]}}
    engine = ds.initialize(model=model, config=config, device=device)
    data = synthetic_lm_data(cfg.vocab_size, micro * run["steps"], seq,
                             seed=seed)["input_ids"]
    log(f"[{tag}] {run['preset']}: {param_count(model.params) / 1e6:.2f} M "
        f"params, bf16, ZeRO-1, AdamW, flash, micro-batch {micro}, batches "
        f"of {seq}; {json.dumps(features)}")
    fa.reset_launches()
    fa.flash_attention.fallbacks = 0
    rows, walls = [], []
    for s in range(run["steps"]):
        before = flash_counts(fa)
        torch.cuda.synchronize()
        t = time.perf_counter()
        met = engine.train_batch({"input_ids": data[s * micro:(s + 1)
                                                    * micro]})
        loss = float(met["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        per = tuple(b - a for a, b in zip(before, flash_counts(fa)))
        length = engine.curriculum.get_difficulty(s + 1)
        keep = engine._ltd_keep or length
        theta = engine.pld.current_theta
        rng = PRNGKey(engine.config.seed + s)
        _, keys = layer_keys(cfg, rng, keep < length, True)
        kept = cfg.num_layers - sum(pld_drops(cfg, keys, theta))
        rows.append((s, length, keep, theta, engine._moq_bits, loss, per,
                     kept))
        log(f"[{tag}] step {s}: length {length}, kept tokens {keep}, PLD "
            f"theta {theta:.6f} ({cfg.num_layers - kept} layers dropped), "
            f"MoQ bits {engine._moq_bits}, loss {loss:.4f}, K1 launches "
            f"fwd/dq/dkv {per[:3]} (routed {per[3]}), {walls[-1] * 1e3:.1f} "
            f"ms")
        if not math.isfinite(loss):
            raise AssertionError(f"{tag}: non-finite loss at step {s}")
        if per != (kept, kept, kept, 0):
            raise AssertionError(f"{tag}: step {s} must launch each flash "
                                 f"kernel once a kept layer ({kept})")
    variants = {k: dict(getattr(fa, k).variant_launches)
                for k in FLASH_KERNELS}
    if any(set(v) != {("bfloat16", fa.kernel_head_dim(cfg.head_dim))}
           for v in variants.values()):
        raise AssertionError(f"{tag}: a flash launch of another variant: "
                             f"{variants}")
    if not any(r[2] < r[1] for r in rows) or rows[-1][4] != 8:
        raise AssertionError(f"{tag}: random-LTD never dropped tokens or "
                             "MoQ never reached 8 bits")
    # the flops profiler's count at the profiled step against the shapes
    k = run["profile_step"] - 1
    _, length, keep, _, _, _, _, kept = rows[k]
    want = reckon_step_products(cfg, micro, length, keep, kept)
    prof = engine.flops_profile
    tflops = prof["flops"] / walls[k] / 1e12
    mfu4 = RESULTS.get("train", {}).get("mfu")
    log(f"[{tag}] flops profiler at step {run['profile_step']}: "
        f"{prof['flops']:.6e} flops (reckoned from the shapes "
        f"{want:.6e}); by op {prof['by_op']}; {tflops:.1f} TFLOP/s over that "
        f"step's {walls[k] * 1e3:.1f} ms (profiled, with the count's host "
        f"cost); phase 4's MFU "
        + (f"{100 * mfu4:.2f}%" if mfu4 is not None else "not measured "
           "(train not run)") + f" [{nvidia_smi_line()}]")
    if prof["flops"] != want:
        raise AssertionError(f"{tag}: the profiler counted {prof['flops']}, "
                             f"the shapes give {want}")
    del engine
    free_engines(torch)
    de_parity(torch, model, data, features, micro, device)

    # one eigenvalue-paced MoQ boundary under the plain attention
    xm = Model.from_params(dataclasses.replace(cfg, attention_impl="xla"),
                           model.params)
    eng = ds.initialize(model=xm, device=device, config={
        **train_config(eig_run["micro"], "bf16"),
        "quantize_training": {"enabled": True, "start_bits": 16,
                              "target_bits": 4, "quantize_period": 1,
                              "eigenvalue": {"enabled": True,
                                             "max_iter": eig_run["max_iter"]}}})
    for s in range(2):
        eng.train_batch({"input_ids": data[s * eig_run["micro"]:(s + 1)
                                           * eig_run["micro"],
                                           :eig_run["seq"]]})
    eig = eng._moq_eig0
    log(f"[{tag}] eigenvalue-paced MoQ boundary (attention_impl xla, "
        f"micro-batch {eig_run['micro']}, seq {eig_run['seq']}, max_iter "
        f"{eig_run['max_iter']}): |eigenvalue| {eig}, power iteration "
        f"{eng.eigenvalue_seconds[-1]:.3f} s, MoQ bits then {eng._moq_bits}, "
        f"period {eng.moq.period}")
    if eig is None or not math.isfinite(eig) or len(
            eng.eigenvalue_seconds) != 1:
        raise AssertionError(f"{tag}: the eigenvalue was not measured once "
                             "or is not finite")
    del eng, xm, model
    free_engines(torch)
    return variants


def de_parity(torch, model, data, features, micro, device):
    """The random-LTD path's first step, flash kernels (bf16) against the
    plain causal_attention (bf16), with the plain attention in fp32 as the
    noise-floor reference: the batch cut to 640 tokens, 512 of them kept
    (random_ltd alone, its schedule at its start), micro-batch
    PARITY_MICRO."""
    import dataclasses

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Model

    rl = features["data_efficiency"]["data_routing"]["random_ltd"]
    S = min(640, data.shape[1])
    keep = rl["min_value"] if rl["min_value"] < S else S // 2
    ltd = {"data_efficiency": {"enabled": True, "data_routing": {
        "enabled": True, "random_ltd": {**rl, "min_value": keep,
                                        "require_steps": 10 ** 6}}}}
    batch = {"input_ids": data[:PARITY_MICRO, :S]}
    res = {}
    for tag, impl, bf16 in (("flash", "flash", True), ("plain", "xla", True),
                            ("fp32", "xla", False)):
        m = Model.from_params(dataclasses.replace(
            model.config, attention_impl=impl), model.params)
        eng = ds.initialize(model=m, device=device, config={
            **train_config(PARITY_MICRO, "bf16" if bf16 else "fp32"), **ltd})
        met = eng.train_batch(dict(batch))
        if eng._ltd_keep != keep:
            raise AssertionError("de parity: random-LTD was not active")
        res[tag] = (float(met["loss"]), float(met["grad_norm"]))
        del eng
        free_engines(torch)
    for i, what in enumerate(("loss", "grad_norm")):
        got, ref, ref32 = res["flash"][i], res["plain"][i], res["fp32"][i]
        noise = abs(ref - ref32)
        tol = PARITY_FACTOR * max(noise, PARITY_FLOOR["bf16"] * abs(ref32))
        log(f"[train-de] LTD parity (micro-batch {PARITY_MICRO}, {S} tokens, "
            f"{keep} kept, first step) {what}: flash {got:.6f} vs plain "
            f"{ref:.6f} (|d| {abs(got - ref):.3e}); fp32 plain {ref32:.6f}: "
            f"noise {noise:.3e}, tol {tol:.3e}")
        if not math.isfinite(got) or abs(got - ref) > tol:
            raise AssertionError(f"train-de: the LTD step's {what} with the "
                                 "flash kernels disagrees with the plain "
                                 "attention")


# ---------------------------------------------------------------------------
# 4e-4h. the model families and attention variants (no port kernel on their
# paths: the JAX package runs them on plain XLA ops)
# ---------------------------------------------------------------------------

def port_launches(fa, pa, mg):
    """Every launch count of the port's kernels (K1, K2, K3)."""
    return dict(flash_fwd=fa.flash_fwd.launches,
                flash_dq=fa.flash_dq.launches,
                flash_dkv=fa.flash_dkv.launches,
                paged=pa.launches, paged_int8=pa.int8_launches,
                paged_fp8=pa.fp8_launches, paged_alibi=pa.alibi_launches,
                mixed8=mg.mixed_matmul_2d.launches,
                mixed4=mg.mixed4_matmul_2d.launches)


def within_bf16_floor(torch, tag, name, got, ref, wide):
    """The bf16 result within NOISE_FACTOR x the bf16 noise floor of the
    fp32 run: max|got - wide| <= NOISE_FACTOR x max|ref - wide| (fp64),
    ``ref`` an independent bf16 evaluation of the same function (each
    sample alone, another batch, or the plain formula), ``wide`` the fp32
    run on the same (bf16-exact) weights and inputs.  Returns the
    tolerance."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: {name} has non-finite values")
    noise = float((ref.double() - wide.double()).abs().max())
    err = float((got.double() - wide.double()).abs().max())
    tol = NOISE_FACTOR * noise
    log(f"[{tag}] {name}: bf16 vs fp32 max|d| {err:.4e}; bf16 noise floor "
        f"{noise:.4e} -> tol {tol:.4e}; |fp32|max "
        f"{float(wide.abs().max()):.4f}")
    if err > tol:
        raise AssertionError(f"{tag}: {name}: bf16 max|d| {err} from fp32 "
                             f"> {NOISE_FACTOR} x the floor {noise}")
    return tol


def widened(tree):
    """An fp32 copy of a (bf16) tree: the same weights, exactly."""
    from deepspeed_tpu_torch.runtime.runtime_utils import tree_map
    return tree_map(lambda x: x.float(), tree)


def check_same_tree(torch, tag, got, want):
    """The imported tree bitwise the drawn one, key for key."""
    g, w = flat_tree(got), flat_tree(want)
    bad = [k for k in w if k not in g or g[k].dtype != w[k].dtype
           or not torch.equal(g[k], w[k])]
    if bad or sorted(g) != sorted(w):
        raise AssertionError(f"{tag}: the imported tree differs from the "
                             f"drawn one at {bad[:5]}")


def phase_head(torch):
    """TF32 off (the fp32 references are fp32), the peak reset; the
    phase's start time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def phase_tail(torch, tag, t0, weight_bytes):
    torch.cuda.synchronize()
    log(f"[{tag}] phase wall {time.perf_counter() - t0:.2f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; weights {weight_bytes / 1e9:.3f} GB [{nvidia_smi_line()}]")


def encoder_state_dict(torch, cfg, params, layer_fmt, names):
    """The HF state dict (``BertModel`` / ``DistilBertModel`` names,
    [out, in] linears) of an encoder tree, its layers ``layer_fmt`` and
    per-layer names ``names`` (checkpoint.hf's spelling of each family):
    the inverse of the importer, built here to feed it.  CONSUMES
    ``params``."""
    H, D, dm, nl = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.num_layers
    T = lambda w: w.transpose(-1, -2).contiguous()      # noqa: E731
    b, sd = params.pop("blocks"), {}
    emb = "embeddings."
    sd[emb + "word_embeddings.weight"] = params.pop("embed")["table"]
    sd[emb + "position_embeddings.weight"] = params.pop("pos_embed")["table"]
    if "type_embed" in params:
        sd[emb + "token_type_embeddings.weight"] = \
            params.pop("type_embed")["table"]
    ln = params.pop("ln_embed")
    sd[emb + "LayerNorm.weight"], sd[emb + "LayerNorm.bias"] = \
        ln["scale"], ln["bias"]
    per = {f"{names[n]}.weight": lambda i, n=n: T(
        b["attn"]["w" + n][i].reshape(dm, H * D)) for n in "qkv"}
    per.update({f"{names[n]}.bias": lambda i, n=n: b["attn"]["b" + n][i]
                .reshape(H * D).clone() for n in "qkv"})
    per[f"{names['o']}.weight"] = lambda i: T(
        b["attn"]["wo"][i].reshape(H * D, dm))
    per[f"{names['o']}.bias"] = lambda i: b["attn"]["bo"][i].clone()
    for key, (grp, w) in (("fc1", ("mlp", "i")), ("fc2", ("mlp", "o"))):
        per[f"{names[key]}.weight"] = lambda i, w=w: T(b["mlp"]["w" + w][i])
        per[f"{names[key]}.bias"] = lambda i, w=w: b["mlp"]["b" + w][i].clone()
    for key in ("ln_attn", "ln_mlp"):
        per[f"{names[key]}.weight"] = lambda i, k=key: b[k]["scale"][i].clone()
        per[f"{names[key]}.bias"] = lambda i, k=key: b[k]["bias"][i].clone()
    for i in range(nl):
        for name, fn in per.items():
            sd[layer_fmt.format(i) + name] = fn(i)
    del b
    if "pooler" in params:
        p = params.pop("pooler")
        sd["pooler.dense.weight"], sd["pooler.dense.bias"] = \
            T(p["kernel"]), p["bias"]
    return sd


def encoder_from_hf_names(torch, tag, cfg, seed, loader, layer_fmt, names,
                          device):
    """An encoder drawn on the card in bf16 from ``seed``, renamed to HF
    names and imported back through ``loader`` (both dicts consumed),
    held bitwise against the same draw made again."""
    from deepspeed_tpu_torch.models import Encoder
    drawn = Encoder(cfg, seed=seed, dtype=torch.bfloat16, device=device)
    sd = encoder_state_dict(torch, cfg, drawn.params, layer_fmt, names)
    n_hf = len(sd)
    t0 = time.perf_counter()
    params = loader(cfg, sd)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    left = len(sd)
    del sd, drawn
    ref = Encoder(cfg, seed=seed, dtype=torch.bfloat16, device=device)
    check_same_tree(torch, tag, params, ref.params)
    if left:
        raise AssertionError(f"{tag}: {left} HF entries not consumed")
    del ref
    log(f"[{tag}] {n_hf} HF tensors imported by {loader.__name__} in "
        f"{t1 - t0:.3f} s, bitwise the drawn tree; {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads, vocab "
        f"{cfg.vocab_size}, type_vocab {cfg.type_vocab_size}, pooler "
        f"{cfg.pooler}")
    return Encoder.from_params(cfg, params)


ENCODE_BUCKETS = (64, 128, 256, 512)
ENCODE_BATCHES = 4
ENCODE_BATCH = 32


def encode_traffic(seed, cfg):
    """For each bucket S: ENCODE_BATCHES batches of ENCODE_BATCH requests
    of lengths in (S/2, S], ids in [1, vocab)."""
    import numpy as np
    r = np.random.RandomState(seed)
    return {S: [[list(map(int, r.randint(1, cfg.vocab_size, n)))
                 for n in r.randint(S // 2 + 1, S + 1, ENCODE_BATCH)]
                for _ in range(ENCODE_BATCHES)] for S in ENCODE_BUCKETS}


def encode_rates(torch, tag, enc, traffic, buckets):
    """Sequences/s and tokens/s of each bucket's batches, one warm-up
    batch first, each pool once."""
    for S in buckets:
        batches = traffic[S]
        enc.encode_batch(batches[0], pool="cls")
        for pool in ("cls", "mean"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for reqs in batches:
                out = enc.encode_batch(reqs, pool=pool)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if out.shape != (len(batches[-1]), enc.config.d_model):
                raise AssertionError(f"{tag}: embeddings of shape "
                                     f"{tuple(out.shape)}")
            n_seq = sum(len(b) for b in batches)
            n_tok = sum(len(q) for b in batches for q in b)
            log(f"[{tag}] bucket {S}, pool {pool}: {len(batches)} batches "
                f"of {len(batches[0])} in {wall * 1e3:.2f} ms: "
                f"{n_seq / wall:.0f} sequences/s, {n_tok / wall:.0f} "
                f"tokens/s ({n_tok} real tokens)")


def encode_checks(torch, tag, enc, traffic):
    """bf16 CLS and mean vectors of each bucket's first batch within the
    noise-floor rule of the fp32 run (the floor: each request alone, in
    bf16); one request alone and padded into the 512 bucket."""
    from deepspeed_tpu_torch.models import Encoder
    wide = Encoder.from_params(enc.config, widened(enc.params))
    for S in traffic:
        reqs = traffic[S][0]
        for pool in ("cls", "mean"):
            got = enc.encode_batch(reqs, pool=pool)
            ref = torch.cat([enc.encode_batch([q], pool=pool) for q in reqs])
            within_bf16_floor(torch, tag, f"bucket {S} {pool}", got, ref,
                              wide.encode_batch(reqs, pool=pool))
    short, long_ = traffic[64][0][0], traffic[512][0][0]
    for pool in ("cls", "mean"):
        padded = enc.encode_batch([short, long_], pool=pool)[:1]
        within_bf16_floor(torch, tag, f"a {len(short)}-token request padded "
                          f"to 512 vs alone (bucket 64), {pool}", padded,
                          enc.encode_batch([short], pool=pool),
                          wide.encode_batch([short], pool=pool))
    del wide
    free_engines(torch)


def encode_phase(torch, seed, device=None, **over):
    """4e. BERT-base and DistilBERT (encode).  ``device`` and ``over``
    (EncoderConfig fields) exist for a CPU rehearsal at a tiny size."""
    from deepspeed_tpu_torch.checkpoint.hf import (_BERT_NAMES,
                                                   _DISTILBERT_NAMES,
                                                   load_hf_bert,
                                                   load_hf_distilbert)
    from deepspeed_tpu_torch.models import EncoderConfig
    tag = "encode"
    t0 = phase_head(torch)
    # google-bert/bert-base-uncased
    cfg = EncoderConfig(**{"vocab_size": 30522, **over})
    enc = encoder_from_hf_names(torch, tag, cfg, seed, load_hf_bert,
                                "encoder.layer.{}.", _BERT_NAMES, device)
    wbytes = tree_bytes(enc.params)
    traffic = encode_traffic(seed, cfg)
    encode_rates(torch, tag, enc, traffic, ENCODE_BUCKETS)
    encode_checks(torch, tag, enc, traffic)
    del enc
    free_engines(torch)
    # distilbert-base-uncased
    dcfg = EncoderConfig(**{"vocab_size": 30522, **over, "num_layers": 6,
                            "type_vocab_size": 0, "pooler": False})
    enc = encoder_from_hf_names(torch, f"{tag} distilbert", dcfg, seed,
                                load_hf_distilbert, "transformer.layer.{}.",
                                _DISTILBERT_NAMES, device)
    encode_rates(torch, f"{tag} distilbert", enc, traffic, (128,))
    within_bf16_floor(
        torch, f"{tag} distilbert", "bucket 128 mean",
        enc.encode_batch(traffic[128][0], pool="mean"),
        torch.cat([enc.encode_batch([q], pool="mean")
                   for q in traffic[128][0]]),
        type(enc).from_params(dcfg, widened(enc.params)).encode_batch(
            traffic[128][0], pool="mean"))
    del enc
    phase_tail(torch, tag, t0, wbytes)


def clip_state_dict(torch, cfg, params):
    """The HF ``CLIPModel`` state dict of a CLIP tree (the patch kernel
    HWIO -> OIHW, [out, in] linears): the importer's inverse.  CONSUMES
    ``params``."""
    T = lambda w: w.transpose(-1, -2).contiguous()      # noqa: E731
    sd = {}

    def tower(pre, tw, b):
        H, D, w = tw.num_heads, tw.width // tw.num_heads, tw.width
        for i in range(tw.num_layers):
            L = f"{pre}encoder.layers.{i}."
            for n in ("1", "2"):
                sd[L + f"layer_norm{n}.weight"] = b[f"ln{n}"]["scale"][i]
                sd[L + f"layer_norm{n}.bias"] = b[f"ln{n}"]["bias"][i]
            a = b["attn"]
            for n in "qkv":
                sd[L + f"self_attn.{n}_proj.weight"] = T(
                    a["w" + n][i].reshape(w, H * D))
                sd[L + f"self_attn.{n}_proj.bias"] = a["b" + n][i].reshape(
                    H * D).clone()
            sd[L + "self_attn.out_proj.weight"] = T(a["wo"][i].reshape(
                H * D, w))
            sd[L + "self_attn.out_proj.bias"] = a["bo"][i]
            m = b["mlp"]
            sd[L + "mlp.fc1.weight"], sd[L + "mlp.fc1.bias"] = \
                T(m["wi"][i]), m["bi"][i]
            sd[L + "mlp.fc2.weight"], sd[L + "mlp.fc2.bias"] = \
                T(m["wo"][i]), m["bo"][i]

    v, t = params.pop("visual"), params.pop("text")
    V, X = "vision_model.", "text_model."
    sd[V + "embeddings.patch_embedding.weight"] = v["patch_embed"][
        "kernel"].permute(3, 2, 0, 1).contiguous()
    sd[V + "embeddings.class_embedding"] = v["class_embed"]
    sd[V + "embeddings.position_embedding.weight"] = v["pos_embed"]
    sd[V + "pre_layrnorm.weight"] = v["ln_pre"]["scale"]
    sd[V + "pre_layrnorm.bias"] = v["ln_pre"]["bias"]
    tower(V, cfg.vision, v["blocks"])
    sd[V + "post_layernorm.weight"] = v["ln_post"]["scale"]
    sd[V + "post_layernorm.bias"] = v["ln_post"]["bias"]
    sd["visual_projection.weight"] = T(v["proj"])
    sd[X + "embeddings.token_embedding.weight"] = t["embed"]["table"]
    sd[X + "embeddings.position_embedding.weight"] = t["pos_embed"]
    tower(X, cfg.text, t["blocks"])
    sd[X + "final_layer_norm.weight"] = t["ln_final"]["scale"]
    sd[X + "final_layer_norm.bias"] = t["ln_final"]["bias"]
    sd["text_projection.weight"] = T(t["proj"])
    sd["logit_scale"] = params.pop("logit_scale")
    return sd


CLIP_BATCH = 32
CLIP_ITERS = 5


def clip_phase(torch, seed, device=None, **over):
    """4f. CLIP ViT-B/32 (clip).  ``device`` and ``over`` (CLIPConfig
    fields) exist for a CPU rehearsal."""
    import numpy as np

    from deepspeed_tpu_torch.checkpoint.hf import load_hf_clip
    from deepspeed_tpu_torch.models import CLIP, CLIPConfig
    tag = "clip"
    t0 = phase_head(torch)
    cfg = CLIPConfig(**over)                   # openai/clip-vit-base-patch32
    dev = torch.device(device or "cuda")
    drawn = CLIP(cfg, seed=seed, dtype=torch.bfloat16, device=dev)
    sd = clip_state_dict(torch, cfg, drawn.params)
    n_hf = len(sd)
    params = load_hf_clip(cfg, sd)
    left = len(sd)
    del sd, drawn
    check_same_tree(torch, tag, params, CLIP(
        cfg, seed=seed, dtype=torch.bfloat16, device=dev).params)
    if left:
        raise AssertionError(f"{tag}: {left} HF entries not consumed")
    m = CLIP.from_params(cfg, params)
    wbytes = tree_bytes(params)
    log(f"[{tag}] {n_hf} HF tensors imported by load_hf_clip, bitwise the "
        f"drawn tree; vision {cfg.vision.num_layers} x {cfg.vision.width} "
        f"(patch {cfg.patch_size}, {cfg.image_size}px), text "
        f"{cfg.text.num_layers} x {cfg.text.width}, embed {cfg.embed_dim}")
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.randn((CLIP_BATCH, cfg.image_size, cfg.image_size, 3),
                       generator=g, device=dev).to(torch.bfloat16)
    r = np.random.RandomState(seed)
    ids = np.zeros((CLIP_BATCH, cfg.max_text_len), np.int64)
    for i, n in enumerate(r.randint(5, cfg.max_text_len + 1, CLIP_BATCH)):
        ids[i, :n - 1] = r.randint(1, cfg.vocab_size - 1, n - 1)
        ids[i, n - 1] = cfg.vocab_size - 1     # EOT, the highest id
    ids = torch.from_numpy(ids).to(dev)
    rates = {}
    for name, fn, n in (("images", lambda: m.encode_image(imgs), CLIP_BATCH),
                        ("texts", lambda: m.encode_text(ids), CLIP_BATCH),
                        ("similarity", lambda: m.similarity(imgs, ids),
                         CLIP_BATCH)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CLIP_ITERS):
            fn()
        torch.cuda.synchronize()
        rates[name] = CLIP_ITERS * n / (time.perf_counter() - t)
    log(f"[{tag}] {rates['images']:.0f} images/s, {rates['texts']:.0f} "
        f"texts/s (batches of {CLIP_BATCH}; texts padded to "
        f"{cfg.max_text_len}); similarity of {CLIP_BATCH} x {CLIP_BATCH}: "
        f"{1e3 * CLIP_BATCH / rates['similarity']:.2f} ms")
    got, _ = m.similarity(imgs, ids)
    half = CLIP_BATCH // 2
    ref = torch.cat([m.similarity(imgs[:half], ids)[0],
                     m.similarity(imgs[half:], ids)[0]])
    wide, _ = CLIP.from_params(cfg, widened(params)).similarity(
        imgs.float(), ids)
    tol = within_bf16_floor(torch, tag, "logits per image", got, ref, wide)
    a, b = got.float().argmax(-1), wide.argmax(-1)
    rows = torch.arange(CLIP_BATCH, device=dev)
    gap = (wide[rows, b] - wide[rows, a]).abs()
    bad = (a != b) & (gap > tol)
    log(f"[{tag}] argmax per image: {int((a == b).sum())} of {CLIP_BATCH} "
        f"equal, {int(((a != b) & ~bad).sum())} near-ties (fp32 gap <= tol)")
    if bool(bad.any()):
        raise AssertionError(f"{tag}: the bf16 argmax differs from fp32's "
                             "beyond a near-tie")
    del m, params, wide
    phase_tail(torch, tag, t0, wbytes)


DIFFUSION_STEPS = 10
DIFFUSION_GUIDANCE = 7.5


def diffusion_phase(torch, seed, device=None, unet=None, vae=None,
                    latent=64):
    """4g. the SD-1.x UNet and VAE (diffusion).  ``device``, ``unet`` /
    ``vae`` (config fields) and ``latent`` (the latents' side) exist for a
    CPU rehearsal."""
    from deepspeed_tpu_torch.models import (AutoencoderKL, UNet2DCondition,
                                            UNetConfig, VAEConfig)
    from deepspeed_tpu_torch.utils.prng import PRNGKey
    tag = "diffusion"
    t0 = phase_head(torch)
    dev = torch.device(device or "cuda")
    ucfg = UNetConfig(**(unet or {}))   # runwayml/stable-diffusion-v1-5
    vcfg = VAEConfig(**(vae or {}))
    unet = UNet2DCondition(ucfg, seed=seed, dtype=torch.bfloat16, device=dev)
    ubytes = tree_bytes(unet.params)
    vae = AutoencoderKL(vcfg, seed=seed, dtype=torch.bfloat16, device=dev)
    vbytes = tree_bytes(vae.params)
    log(f"[{tag}] UNet {ubytes / 2 / 1e6:.1f} M params (channels "
        f"{ucfg.block_out_channels}, {ucfg.layers_per_block} res a block, "
        f"{ucfg.attention_head_dim} heads, context {ucfg.cross_attention_dim})"
        f"; VAE {vbytes / 2 / 1e6:.1f} M params; bf16")
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn((1, latent, latent, ucfg.in_channels), generator=g,
                      device=dev)
    cond = torch.randn((1, 77, ucfg.cross_attention_dim), generator=g,
                       device=dev)
    ctx2 = torch.cat([torch.zeros_like(cond), cond]).to(torch.bfloat16)
    lat = lat.to(torch.bfloat16)
    # the first call against fp32 (the floor: each sample alone in bf16)
    t_first = torch.full((2,), 999, device=dev)
    first = unet(torch.cat([lat, lat]), t_first, ctx2)
    alone = torch.cat([unet(lat, t_first[:1], ctx2[i:i + 1])
                       for i in range(2)])
    wide_unet = UNet2DCondition.from_params(ucfg, widened(unet.params))
    within_bf16_floor(torch, tag, "first UNet call (batch 2)", first, alone,
                      wide_unet(torch.cat([lat, lat]).float(), t_first,
                                ctx2.float()))
    del wide_unet, alone
    free_engines(torch)
    steps = [999 - i * (999 // (DIFFUSION_STEPS - 1))
             for i in range(DIFFUSION_STEPS)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for step in steps:
        e_un, e_c = unet(torch.cat([lat, lat]), torch.full(
            (2,), step, device=dev), ctx2).chunk(2)
        lat = lat - 0.1 * (e_un + DIFFUSION_GUIDANCE * (e_c - e_un))
    torch.cuda.synchronize()
    unet_ms = (time.perf_counter() - t) / len(steps) * 1e3
    if not bool(torch.isfinite(lat).all()):
        raise AssertionError(f"{tag}: non-finite latents after the loop")
    log(f"[{tag}] classifier-free guidance ({DIFFUSION_GUIDANCE}) on a "
        f"batch of 2 x {latent}x{latent}x4 latents, context 77x"
        f"{ucfg.cross_attention_dim}, t {steps}: "
        f"{unet_ms:.2f} ms a UNet call (with the guidance update)")
    z = lat * vcfg.scaling_factor
    vae.decode(z)
    torch.cuda.synchronize()
    t = time.perf_counter()
    img = vae.decode(z)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t) * 1e3
    side = latent * 2 ** (len(vcfg.block_out_channels) - 1)
    if img.shape != (1, side, side, 3):
        raise AssertionError(f"{tag}: decoded {tuple(img.shape)}")
    wide_vae = AutoencoderKL.from_params(vcfg, widened(vae.params))
    within_bf16_floor(torch, tag, "VAE decode", img,
                      vae.decode(torch.cat([z, z]))[:1],
                      wide_vae.decode(z.float()))
    del wide_vae
    free_engines(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mean = vae.encode(img)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t) * 1e3
    sample = vae.encode(img, rng=PRNGKey(seed, device=dev))
    for name, x in (("encode mean", mean), ("encode sample", sample),
                    ("image", img)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: {name} has non-finite values")
    if mean.shape != lat.shape or torch.equal(mean, sample):
        raise AssertionError(f"{tag}: the posterior mean {tuple(mean.shape)}"
                             " or its sample is wrong")
    log(f"[{tag}] VAE decode to {side}x{side}x3 {dec_ms:.2f} ms, encode "
        f"{enc_ms:.2f} ms (the mean; a threefry-sampled posterior too); "
        f"every output finite")
    del unet, vae
    phase_tail(torch, tag, t0, ubytes + vbytes)


ATTN_RUN = dict(preset="gpt2", seq=1024, micro=8, warmup=2, steps=3)
EVO_SHAPE = (1, 128, 256, 8, 32)       # [B, N (MSA rows), S, H, D]


def attn_first_step(torch, model, attention_fn, impl, batch, precision,
                    device):
    """One step of a fresh engine from ``model``'s weights: (loss, norm)."""
    import dataclasses

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Model
    m = Model.from_params(dataclasses.replace(
        model.config, attention_impl=impl), model.params,
        attention_fn=attention_fn)
    eng = ds.initialize(model=m, config=train_config(
        batch["input_ids"].shape[0], precision), device=device)
    met = eng.train_batch(dict(batch))
    res = (float(met["loss"]), float(met["grad_norm"]))
    del eng, met
    free_engines(torch)
    return res


def attn_engine_run(torch, model, attention_fn, impl, batches, tag, device):
    """A fresh bf16 engine from ``model``'s weights under ``impl`` (or
    ``attention_fn``): ATTN_RUN's warm-up + timed steps; (first step's
    loss and grad norm, ms a timed step, peak memory)."""
    import dataclasses

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import Model
    m = Model.from_params(dataclasses.replace(
        model.config, attention_impl=impl), model.params,
        attention_fn=attention_fn)
    eng = ds.initialize(model=m, config=train_config(ATTN_RUN["micro"]),
                        device=device)
    free_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    mets = []
    for i, batch in enumerate(batches):
        if i == ATTN_RUN["warmup"]:
            torch.cuda.synchronize()
            t = time.perf_counter()
        mets.append(eng.train_batch(dict(batch)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / ATTN_RUN["steps"] * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x["loss"]) for x in mets]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}; {step_ms:.1f} ms a"
        f" step; max_memory_allocated {peak / 2**30:.2f} GiB")
    first = (losses[0], float(mets[0]["grad_norm"]))
    del eng, mets
    free_engines(torch)
    return first, step_ms, peak


def parity_rule(tag, what, got, ref, wide):
    """The first-step rule of phase 4's parity: |got - ref| <=
    PARITY_FACTOR x max(|ref - wide|, PARITY_FLOOR bf16 x |wide|)."""
    noise = abs(ref - wide)
    tol = PARITY_FACTOR * max(noise, PARITY_FLOOR["bf16"] * abs(wide))
    log(f"[{tag}] {what}: {got:.6f} vs xla {ref:.6f} (|d| "
        f"{abs(got - ref):.3e}); fp32 xla {wide:.6f}: noise {noise:.3e}, "
        f"tol {tol:.3e}")
    if not math.isfinite(got) or abs(got - ref) > tol:
        raise AssertionError(f"{tag}: first-step {what} disagrees with the "
                             "plain attention")


def evo_plain(torch, Q, K, V, b1, b2):
    s = torch.einsum("bnqhd,bnkhd->bnhqk", Q, K).float() / math.sqrt(
        Q.shape[-1])
    p = torch.softmax(s + b1.float() + b2.float(), dim=-1).to(Q.dtype)
    return torch.einsum("bnhqk,bnkhd->bnqhd", p, V)


def evoformer_check(torch, seed, tag, device=None, shape=EVO_SHAPE):
    """(c) AlphaFold-2's MSA row attention with pair bias at its 256-residue
    crop: forward and backward against autograd through the plain
    formula, in bf16 against fp32."""
    from deepspeed_tpu_torch.ops import evoformer_attention
    B, N, S, H, D = shape
    dev = torch.device(device or "cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Q, K, V = (torch.randn(shape, generator=g, device=dev)
               for _ in range(3))
    b1 = torch.where(torch.rand((B, N, 1, 1, S), generator=g,
                                device=dev) < 0.1, -1e9, 0.0)
    b2 = torch.randn((B, 1, H, S, S), generator=g, device=dev)
    do = torch.randn(shape, generator=g, device=dev)
    inputs = [x.to(torch.bfloat16) for x in (Q, K, V, b1, b2)]

    def run(fn, xs):
        xs = [x.detach().requires_grad_() for x in xs]
        o = fn(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do.to(o.dtype))]

    fast = lambda Q, K, V, b1, b2: evoformer_attention(   # noqa: E731
        Q, K, V, [b1, b2])
    plain = lambda *xs: evo_plain(torch, *xs)           # noqa: E731
    got = run(fast, inputs)
    ref = run(plain, inputs)
    wide = run(plain, [x.float() for x in inputs])
    for name, a, b, c in zip(("out", "dQ", "dK", "dV", "db1", "db2"), got,
                             ref, wide):
        within_bf16_floor(torch, tag, f"evoformer {name}", a, b, c)
    times = {}
    for name, fn in (("evoformer_attention", fast), ("plain", plain)):
        run(fn, inputs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            run(fn, inputs)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) / 5 * 1e3
    log(f"[{tag}] (c) evoformer Q/K/V {list(shape)} bf16, mask and pair "
        f"bias: forward + backward {times['evoformer_attention']:.2f} ms "
        f"(autograd through the plain formula {times['plain']:.2f} ms)")


def attn_variants_phase(torch, seed, device=None, evo_shape=EVO_SHAPE,
                        **overrides):
    """4h. the attention variants on GPT-2-small (attn-variants).
    ``device``, ``evo_shape`` and ``overrides`` (model-config fields) exist
    for a CPU rehearsal at a tiny size."""
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import (BSLongformerSparsityConfig,
                                         DenseSparsityConfig,
                                         make_block_sparse_attention)
    from deepspeed_tpu_torch.ops.sparse_attention import density
    from deepspeed_tpu_torch.runtime import synthetic_lm_data
    tag = "attn-variants"
    t0 = phase_head(torch)
    seq = overrides.pop("max_seq_len", ATTN_RUN["seq"])
    model = build_model(ATTN_RUN["preset"], seed=seed, device=device,
                        max_seq_len=seq, **overrides)
    n = ATTN_RUN["warmup"] + ATTN_RUN["steps"]
    micro = ATTN_RUN["micro"]
    data = synthetic_lm_data(model.config.vocab_size, micro * n, seq,
                             seed=seed)["input_ids"]
    batches = [{"input_ids": data[i * micro:(i + 1) * micro]}
               for i in range(n)]
    log(f"[{tag}] {ATTN_RUN['preset']}: {model.config.num_layers} layers, "
        f"d_model {model.config.d_model}, seq {seq}, micro-batch {micro}, "
        f"bf16, ZeRO-1, AdamW; {ATTN_RUN['warmup']} + {ATTN_RUN['steps']} "
        f"steps an engine")
    runs = {impl: attn_engine_run(torch, model, None, impl, batches,
                                  f"{tag} {impl}", device)
            for impl in ("xla", "xla_flash")}
    # the noise floor: the plain attention's first step in fp32
    wide = attn_first_step(torch, model, None, "xla", batches[0], "fp32",
                           device)
    ref = runs["xla"][0]
    for i, what in enumerate(("loss", "grad_norm")):
        parity_rule(tag, f"(a) xla_flash first-step {what}",
                    runs["xla_flash"][0][i], ref[i], wide[i])
    log(f"[{tag}] (a) max_memory_allocated xla_flash "
        f"{runs['xla_flash'][2] / 2**30:.2f} GiB vs xla "
        f"{runs['xla'][2] / 2**30:.2f} GiB; ms a step "
        f"{runs['xla_flash'][1]:.1f} vs {runs['xla'][1]:.1f}")
    sparse = BSLongformerSparsityConfig(block=64)
    _, ms, _ = attn_engine_run(torch, model, make_block_sparse_attention(
        sparse), "xla", batches, f"{tag} bslongformer", device)
    log(f"[{tag}] (b) BSLongformer (block 64, window 3, global block 0): "
        f"density {density(sparse.make_layout(seq // 64)):.4f} of the "
        f"causal triangle; {ms:.1f} ms a step")
    dense = attn_first_step(torch, model, make_block_sparse_attention(
        DenseSparsityConfig(block=64)), "xla", batches[0], "bf16", device)
    parity_rule(tag, "(b) DenseSparsityConfig first-step loss", dense[0],
                ref[0], wide[0])
    wbytes = tree_bytes(model.params)
    del model
    free_engines(torch)
    evoformer_check(torch, seed, tag, device, evo_shape)
    phase_tail(torch, tag, t0, wbytes)


FAMILY_PHASES = ("encode", "clip", "diffusion", "attn-variants")


# ---------------------------------------------------------------------------
# aux. the aux subsystems: env_report, see_memory_usage, the autotuner,
# the launcher and its elastic restart loop
# ---------------------------------------------------------------------------

# the autotuner's space on the card: GPT-2-small at phase 4's width (bf16,
# flash, seq 1024), micro-batches x remat policies, the model tuner
AUX_MICRO = (4, 8)
AUX_REMAT = ("nothing", "everything")
AUX_BUDGET = 4
AUX_STEPS = 2
# steps an experiment takes: its first, the flop-counted one, the timed ones
AUX_STEPS_PER_EXP = 2 + AUX_STEPS

# the launcher's child: joins the group through the runner's DSPD_*
# environment (launch.init_distributed_from_env), all-reduces a CUDA
# tensor (NCCL), records what it saw, and exits 17 on its first launch
# (the --elastic_training loop relaunches it once)
AUX_CHILD = """
import json, os, sys, torch, torch.distributed as dist
out = sys.argv[1]
x = torch.full((4,), float(dist.get_rank() + 3), device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
with open(out, "a") as f:
    f.write(json.dumps({"rank": dist.get_rank(),
                        "world": dist.get_world_size(),
                        "backend": dist.get_backend_config(),
                        "sum": x.tolist(), "device": str(x.device)}) + "\\n")
dist.destroy_process_group()
if not os.path.exists(out + ".crashed"):
    open(out + ".crashed", "w").write("exited 17 once")
    sys.exit(17)
"""


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def aux_autotune(torch, fa, seed):
    """autotune over GPT-2-small on the card; returns the flash launches by
    variant and the ranked experiments."""
    import numpy as np

    from deepspeed_tpu_torch.autotuning import autotune, build_space
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime import param_count

    def model_fn(remat_policy):
        return build_model("gpt2", seed=seed, max_seq_len=1024,
                           attention_impl="flash",
                           remat=remat_policy != "nothing",
                           remat_policy=remat_policy)

    def batch_fn(n):
        return {"input_ids": np.random.RandomState(seed).randint(
            0, 50257, (n, 1024))}

    space = build_space(1, micro_batches=AUX_MICRO,
                        remat_policies=AUX_REMAT)
    n_params = param_count(model_fn("nothing").params)
    free_engines(torch)
    # the main path: counts to 0 just before, read just after
    fa.reset_launches()
    fa.flash_attention.fallbacks = 0
    t0 = time.perf_counter()
    ranked = autotune(model_fn, train_config(AUX_MICRO[0]), batch_fn,
                      n_params=n_params, space=space, tuner="model",
                      budget=AUX_BUDGET, steps=AUX_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: getattr(fa, k).launches for k in FLASH_KERNELS}
    variants = {k: dict(getattr(fa, k).variant_launches)
                for k in FLASH_KERNELS}
    for i, e in enumerate(ranked):
        log(f"[aux] autotune #{i + 1} {e.label()}: "
            + (f"{e.step_time_s * 1e3:.1f} ms a step, "
               f"{e.flops_per_step / 1e12:.3f} TFLOP a step (flop-counted "
               f"step), peak {e.peak_bytes / 2**30:.2f} GiB, first step "
               f"{e.compile_time_s:.2f} s (build included), state "
               f"{e.est_state_bytes / 1e9:.2f} GB reckoned"
               if e.ok else f"not run: {e.error or e.pruned}"))
    ok = [e for e in ranked if e.ok]
    n_remat = sum(e.overrides["remat_policy"] != "nothing" for e in ok)
    steps = AUX_STEPS_PER_EXP * len(ok)
    want = {"flash_fwd": 12 * (steps + AUX_STEPS_PER_EXP * n_remat),
            "flash_dq": 12 * steps, "flash_dkv": 12 * steps}
    log(f"[aux] autotune: {len(space)} experiments (micro-batches "
        f"{AUX_MICRO} x remat {AUX_REMAT}), model tuner, budget "
        f"{AUX_BUDGET}, {AUX_STEPS} timed steps: {len(ok)} ran in "
        f"{wall:.1f} s; ranking {[e.label() for e in ok]}; K1 launches "
        f"{counts} over {steps} steps ({n_remat} experiments recompute the "
        f"forward under remat 'everything'): expected {want}; "
        f"fallbacks {fa.flash_attention.fallbacks}")
    times = [e.step_time_s for e in ok]
    if len(ok) != len(space) or times != sorted(times):
        raise AssertionError(f"aux: autotune ran {len(ok)} of {len(space)} "
                             f"experiments or did not rank them: "
                             f"{[(e.label(), e.error) for e in ranked]}")
    if counts != want or fa.flash_attention.fallbacks:
        raise AssertionError(f"aux: K1 launches {counts} != {want}")
    if any(not e.flops_per_step or not e.peak_bytes for e in ok):
        raise AssertionError("aux: an experiment lacks its flops or peak")
    return variants, ok


def aux_phase(torch, fa, seed):
    """env_report's rows; see_memory_usage against the allocator; autotune
    over GPT-2-small (K1 on every step); the launcher's LocalRunner under
    --elastic_training starting a child that joins a world-1 group (NCCL
    for its CUDA tensor) through init_distributed_from_env, all-reduces
    and exits non-zero once, then its relaunch.  Returns the flash
    launches by variant."""
    import contextlib
    import io
    import shutil
    import tempfile

    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.launcher import runner
    from deepspeed_tpu_torch.runtime import see_memory_usage

    tag = "aux"
    t0 = phase_head(torch)
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = env_report.main()
    for line in buf.getvalue().splitlines():
        log(f"[{tag}] env_report: {line}")
    if rc != 0 or "devices" not in buf.getvalue():
        raise AssertionError(f"{tag}: env_report returned {rc}")
    log(f"[{tag}] [time] env_report {time.perf_counter() - t:.1f} s")

    x = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    st = see_memory_usage("aux", force=True)
    alloc = torch.cuda.memory_allocated(0)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[{tag}] see_memory_usage: {st}; torch.cuda.memory_allocated "
        f"{alloc}, max_memory_allocated {torch.cuda.max_memory_allocated(0)}"
        f", total_memory {total}")
    mine = st.get("0", {})
    if (mine.get("bytes_in_use") != alloc or mine.get("bytes_limit") != total
            or mine.get("peak_bytes_in_use")
            != torch.cuda.max_memory_allocated(0)):
        raise AssertionError(f"{tag}: see_memory_usage {st} disagrees with "
                             "the allocator")
    del x

    t = time.perf_counter()
    variants, ok = aux_autotune(torch, fa, seed)
    log(f"[{tag}] [time] autotune {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    # the launched children import the package from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=str(ROOT / "build")))
    child = work / "child.py"
    child.write_text(AUX_CHILD)
    out = work / "child.jsonl"
    port = free_port()
    # one host: the runner takes its LocalRunner
    rc = runner.main(["--master_port", str(port), "--master_addr",
                      "localhost", "--elastic_training",
                      "--max_elastic_restarts", "2", str(child), str(out)])
    runs = ([json.loads(line) for line in out.read_text().splitlines()]
            if out.exists() else [])
    log(f"[{tag}] launcher: LocalRunner (localhost:{port}), "
        f"--elastic_training, a child that joins through "
        f"init_distributed_from_env, all-reduces a CUDA tensor and exits 17 "
        f"on its first launch: rc {rc}, {len(runs)} launches, each saw "
        f"{runs}; {time.perf_counter() - t:.1f} s")
    if rc != 0 or len(runs) != 2 or any(
            r.get("world") != 1 or "cuda:nccl" not in r.get("backend", "")
            or r.get("sum") != [3.0] * 4
            or not r.get("device", "").startswith("cuda") for r in runs):
        raise AssertionError(f"{tag}: the launched children: rc {rc}, "
                             f"{runs}")
    shutil.rmtree(work, ignore_errors=True)
    phase_tail(torch, tag, t0, 0)
    return variants


# ---------------------------------------------------------------------------
# comm: the collectives at world 1 over NCCL
# ---------------------------------------------------------------------------

# serve-tp's down-projection on a rank: [token budget, d_ff / 2] x
# [d_ff / 2, d_model] (Llama-3-8B, tensor=2)
COMM_MM = (1024, 7168, 4096)
COMM_TILES = (2, 4, 8)
COMM_SWEEP = (12, 24)       # log2 of the sweep's message bytes


def comm_phase(torch, seed, device=None):
    """``comm/`` on one card: a world of one rank over NCCL.  Every
    ``Collectives`` op runs on the backend (an axis of size 1 keeps its
    one-rank group) and must give its input back; the tiled matmul +
    all-reduce is bitwise its serial path at every tile count; a small
    ``comm.bench`` sweep and its overlap leg; an NCCL all-reduce captured
    in a CUDA graph and replayed.  Returns the facts for PERF.md."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import (Collectives, MeshTopology, bench,
                                          comms_logger, init_distributed,
                                          overlapped_matmul_allreduce)
    from deepspeed_tpu_torch.comm.collectives import exact_psum
    from deepspeed_tpu_torch.config.config import MeshConfig
    dev = torch.device(device or "cuda")
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        topo = MeshTopology.build(MeshConfig())
        log(f"[comm] process group: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}; mesh {topo.axis_sizes}; a one-rank "
            f"group on every axis: {topo.group('tensor') is not None}")
        col = Collectives(topo)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((4096, 1024), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        # the first call of each op builds NCCL's communicator: the
        # second round is the one logged
        for logged in (False, True):
            if logged:
                comms_logger.configure(enabled=True, prof_all=True)
                comms_logger.reset()
            outs = {"all_reduce": col.all_reduce(x),
                    "all_reduce mean": col.all_reduce(x, op="mean"),
                    "all_gather": col.all_gather(x),
                    "reduce_scatter": col.reduce_scatter(x),
                    "all_to_all": col.all_to_all(x, split_dim=0,
                                                 concat_dim=1),
                    "broadcast": col.broadcast(x, src=0)}
        col.barrier()
        comms_logger.configure(enabled=False)
        bad = [k for k, v in outs.items() if not torch.equal(v, x)]
        table = comms_logger.log_all(print_log=False)
        log("[comm] Collectives over NCCL at world 1 (4096 x 1024 bf16, "
            "8 MiB): " + ", ".join(
                f"{op} {rec['avg_latency_ms']:.4f} ms" for op, sizes in
                sorted(table.items()) for rec in sizes.values())
            + f"; each gives its input back: {not bad}; calls counted "
            f"{int(col.metrics.counter('training_comm_collective_calls_total').value(op='all_reduce'))}"
            " all_reduce")
        if bad:
            raise AssertionError(f"comm: {bad} changed the tensor at world 1")

        rows, k, n = COMM_MM
        u = torch.randn((rows, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev,
                        dtype=torch.bfloat16) * k ** -0.5
        g, size = topo.group("tensor"), topo.size("tensor")
        serial = exact_psum(u @ w, g, size)
        tiled = {t: overlapped_matmul_allreduce(u, w, "tensor", tiles=t,
                                                topology=topo)
                 for t in COMM_TILES}
        not_bitwise = [t for t, y in tiled.items()
                       if not torch.equal(y, serial)]
        ms_serial = time_ms(torch, lambda: exact_psum(u @ w, g, size), 20)
        ms_tiled = time_ms(torch, lambda: overlapped_matmul_allreduce(
            u, w, "tensor", tiles=4, topology=topo), 20)
        log(f"[comm] matmul + all-reduce [{rows}, {k}] x [{k}, {n}] bf16: "
            f"tiles {COMM_TILES} bitwise the serial path: "
            f"{not not_bitwise and 'all'}{not_bitwise or ''}; serial "
            f"{ms_serial:.4f} ms, 4 tiles {ms_tiled:.4f} ms (CUDA events)")
        if not_bitwise:
            raise AssertionError(f"comm: tiles {not_bitwise} are not bitwise "
                                 "the serial matmul + all-reduce")

        recs = bench.sweep(list(bench.OPS), *COMM_SWEEP, trials=10,
                           warmups=3, dtype="bfloat16", print_table=False,
                           device=dev)
        big = {r["op"]: r for r in recs if r["bytes"] == 1 << COMM_SWEEP[1]}
        log(f"[comm] bench sweep 2^{COMM_SWEEP[0]}..2^{COMM_SWEEP[1]} bytes "
            f"({len(recs)} records); at 2^{COMM_SWEEP[1]}: " + ", ".join(
                f"{op} {r['latency_us']:.1f} us ({r['algbw_gbps']:.1f} "
                f"Gbps)" for op, r in big.items()))
        leg = bench.overlap_bench(rows=rows, k=4096, nmodel=n, tiles=4,
                                  trials=10, warmups=3, dtype="bfloat16",
                                  device=dev)
        log(f"[comm] overlap leg: {leg}")

        # an NCCL all-reduce in a CUDA graph: captured once, replayed
        y = torch.empty_like(x)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):           # the communicator's warm-up
            y.copy_(x)
            dist.all_reduce(y)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y.copy_(x)
            y.mul_(2)
            dist.all_reduce(y)
        x.add_(1)
        graph.replay()
        torch.cuda.synchronize(dev)
        ok = torch.equal(y, x * 2)
        replay_ms = time_ms(torch, graph.replay, 20)
        log(f"[comm] NCCL all-reduce captured in a CUDA graph: replay gives "
            f"2x the updated input: {ok}; {replay_ms:.4f} ms a replay")
        if not ok:
            raise AssertionError("comm: the captured all-reduce replayed "
                                 "wrong values")
        del graph
    finally:
        dist.destroy_process_group()
    log(f"[comm] phase wall {time.perf_counter() - t0:.2f} s "
        f"[{nvidia_smi_line()}]")
    return dict(serial_ms=ms_serial, tiled_ms=ms_tiled, replay_ms=replay_ms)


# ---------------------------------------------------------------------------
# serve-tp: Llama-3-8B over two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

TP_MESH = dict(tensor=2)
TP_WORLD = 2
# (b): int8 weights, the model cut to 4 layers, and its traffic cut to 2
# prompts of 128 tokens and 8 new tokens: each step gathers every layer's
# payload through host memory (gloo): ~2.7 s a step on an H100 at 700 W
TP_QUANT_LAYERS = 4
TP_QUANT_PROMPTS = (2, 128)
TP_QUANT_NEW = 8
TP_TIMEOUT = 600.0           # seconds a rank job may take


def tp_first_logits(torch, cfg, params, prompts, kv_heads, shard_mesh=None,
                    comm=None):
    """The first prefill's logits of prompts 0 and 1 (first_forward_check's
    batch) on a fresh cache of ``kv_heads`` heads a layer, fp32 [2, vocab]
    on the host."""
    from deepspeed_tpu_torch.inference.model import ragged_forward
    from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                            StateManager)
    dev = params["ln_f"]["scale"].device
    sm = StateManager(KVCacheConfig(cfg.num_layers, kv_heads, cfg.head_dim,
                                    block_size=64, num_blocks=64,
                                    dtype=torch.bfloat16, device=dev),
                      max_seqs=2)
    batch = sm.build_batch([(0, prompts[0]), (1, prompts[1])], 1024)
    logits, _ = ragged_forward(cfg, params, sm.kv, batch, 64, 8,
                               shard_mesh=shard_mesh, comm=comm)
    return logits[[sm.slot(0), sm.slot(1)]].float().cpu()


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tp_engine_run(torch, eng, prompts, n_new, rates=True):
    """A rank's measured run on its engine: ``n_new`` greedy tokens a
    prompt with the K2 and K3 counts zeroed just before and read just
    after.  With ``rates``: a 1-token warm-up and a 1-token run first
    (prefill tok/s; decode tok/s from the two runs' walls), then one
    prefill and one decode step with every collective timed between
    synchronizations (the comm share of a step)."""
    import importlib

    from deepspeed_tpu_torch.inference import SamplingParams
    pa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")\
        .paged_attention
    mg = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")
    dev = eng.device
    traffic = dict(enumerate(prompts))

    def run(n):
        fresh_run(eng)
        _sync(torch, dev)
        t = time.perf_counter()
        out = eng.generate(traffic, SamplingParams(max_new_tokens=n))
        _sync(torch, dev)
        return time.perf_counter() - t, out, dict(eng.timings)

    out = {}
    if rates:
        run(1)
        t_pre, _, tm_pre = run(1)
    pa.launches = pa.int8_launches = 0
    mg.mixed_matmul_2d.launches = 0
    mg.mixed_matmul_2d.design_launches = {k: 0 for k in
                                          mg.mixed_matmul_2d.design_launches}
    t_all, streams, tm = run(n_new)
    out.update(streams={u: list(v) for u, v in streams.items()},
               steps=int(tm["steps"]), eager_steps=int(tm["eager_steps"]),
               launches=dict(k2=pa.launches, k3=mg.mixed_matmul_2d.launches,
                             k3_design=dict(
                                 mg.mixed_matmul_2d.design_launches)),
               wall_s=t_all)
    if not rates:
        return out
    computed = tm_pre["prompt_tokens"] - tm_pre["cached_tokens"]
    ttft = sorted(eng.ttft_ms[u] for u in streams)
    fresh_run(eng)
    shard, share, nxt = eng._shard, {}, {}

    def timed_step(kind):
        shard.measure, shard.comm_ms = True, 0.0
        _sync(torch, dev)
        t = time.perf_counter()
        got = eng.step()
        _sync(torch, dev)
        wall = (time.perf_counter() - t) * 1e3
        shard.measure = False
        share[kind] = dict(step_ms=wall, comm_ms=shard.comm_ms,
                           share=shard.comm_ms / wall)
        return got

    # the bare exact all-reduce a step's rows take, with no model work
    # beside it: a decode step's [8, d_model] and a prefill step's
    # [1024, d_model] bf16 partial sums
    bare = {}
    for rows in (len(prompts), SERVE_ENGINE["token_budget"]):
        x = torch.ones((rows, eng.cfg.d_model), dtype=torch.bfloat16,
                       device=dev)
        shard.psum(x)
        _sync(torch, dev)
        t = time.perf_counter()
        for _ in range(10):
            shard.psum(x)
        _sync(torch, dev)
        bare[rows] = (time.perf_counter() - t) / 10 * 1e3
    for u, p in traffic.items():
        eng.put(u, p)
    nxt.update(timed_step("prefill"))
    while len(nxt) < len(traffic):
        nxt.update(eng.step())
    for u, t in nxt.items():
        eng.put(u, [t])
    timed_step("decode")
    for u in traffic:
        eng.flush(u)
    out.update(ttft_p50_ms=statistics.median(ttft),
               prefill_tok_s=computed / t_pre,
               decode_tok_s=len(prompts) * (n_new - 1)
               / max(t_all - t_pre, 1e-9), comm=share, bare_psum_ms=bare)
    return out


def tp_serve_a(seed, prompts, device=None, overrides=None):
    """serve-tp (a) on a rank: Llama-3-8B drawn leaf by leaf in
    init_params' order, each leaf cut to this rank's slice as it is drawn
    (the values are the one-device model's), served with
    ``MeshConfig(tensor=2)``."""
    import torch

    from deepspeed_tpu_torch.comm import MeshTopology
    from deepspeed_tpu_torch.config.config import MeshConfig
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.inference.engine import rank_cut
    from deepspeed_tpu_torch.models import Model, build_config
    from deepspeed_tpu_torch.models.transformer import (
        init_params_and_axes, tree_leaves)
    dev = torch.device(device or "cuda", torch.cuda.current_device()) \
        if (device or "cuda") == "cuda" else torch.device(device)
    cfg = build_config("llama3-8b", **(overrides or {}))
    topo = MeshTopology.build(MeshConfig(**TP_MESH))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, axes = init_params_and_axes(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev,
        torch.bfloat16, cut=rank_cut(cfg, topo))
    model = Model.from_params(cfg, params, axes)
    draw_s = time.perf_counter() - t0
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE),
                          topology=topo)
    kv = eng.state.kv
    logits = tp_first_logits(torch, cfg, eng.params, prompts,
                             kv.shape[4], eng._shard, eng._serving_comm)
    out = tp_engine_run(torch, eng, prompts, SERVE_NEW_TOKENS)
    out.update(logits=logits, kv_shape=tuple(kv.shape),
               weight_bytes=weight_bytes, draw_s=draw_s,
               comm_plan=str(eng._serving_comm and eng._serving_comm._replace(
                   mesh=None)),
               rank=topo.rank, peak_gib=(
                   torch.cuda.max_memory_allocated() / 2**30
                   if dev.type == "cuda" else 0.0))
    del eng, model, params
    free_engines(torch) if dev.type == "cuda" else gc.collect()
    return out


def tp_serve_b(seed, prompts, device=None, overrides=None):
    """serve-tp (b) on a rank: the same model at TP_QUANT_LAYERS layers
    with ``weight_quant="int8"`` under ``MeshConfig(tensor=2)``: the
    quantized tree memory-sharded, each layer gathered at use and run
    through the mixed-input GEMM (K3) on the rank."""
    import torch

    from deepspeed_tpu_torch.comm import MeshTopology
    from deepspeed_tpu_torch.config.config import MeshConfig
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine)
    from deepspeed_tpu_torch.models import build_model
    dev = torch.device(device or "cuda", torch.cuda.current_device()) \
        if (device or "cuda") == "cuda" else torch.device(device)
    topo = MeshTopology.build(MeshConfig(**TP_MESH))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build_model("llama3-8b", seed=seed, dtype=torch.bfloat16,
                        device=dev, **{"num_layers": TP_QUANT_LAYERS,
                                       **(overrides or {})})
    eng = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE,
                                                 weight_quant="int8"),
                          topology=topo)
    q = eng._quant["blocks"]["mlp"]["wi"]
    out = tp_engine_run(torch, eng, prompts, TP_QUANT_NEW, rates=False)
    out.update(kv_shape=tuple(eng.state.kv.shape),
               wi_local=tuple(q.data.shape), wi_shape=q.shape,
               mixed=eng._mixed_gemm_active, rank=topo.rank,
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else 0.0))
    del eng, model
    free_engines(torch) if dev.type == "cuda" else gc.collect()
    return out


def tp_check_ranks(res, cfg, layers, n_new, tag):
    """Both ranks served the same streams of ``n_new`` tokens; K2 launched
    once a layer a step on each (every step eager: gloo is not
    captured)."""
    for r in res:
        line = (f"[{tag}] rank {r['rank']}: {r['steps']} steps "
                f"({r['eager_steps']} eager) in {r['wall_s']:.2f} s, K2 "
                f"launches {r['launches']['k2']} (= {layers} x "
                f"{r['steps']}), K3 {r['launches']['k3']} "
                f"{r['launches']['k3_design']}; KV cache a rank "
                f"{r['kv_shape']}; peak {r['peak_gib']:.2f} GiB")
        if "comm" in r:
            c = r["comm"]
            line += (f"; TTFT p50 {r['ttft_p50_ms']:.1f} ms, prefill "
                     f"{r['prefill_tok_s']:.0f} tok/s, decode "
                     f"{r['decode_tok_s']:.1f} tok/s; comm share of a "
                     f"prefill step {100 * c['prefill']['share']:.1f}% "
                     f"({c['prefill']['comm_ms']:.2f} of "
                     f"{c['prefill']['step_ms']:.2f} ms), of a decode step "
                     f"{100 * c['decode']['share']:.1f}% "
                     f"({c['decode']['comm_ms']:.2f} of "
                     f"{c['decode']['step_ms']:.2f} ms); a bare all-reduce "
                     f"(ms by rows): " + ", ".join(
                         f"{k}: {v:.3f}" for k, v in
                         r["bare_psum_ms"].items()))
        log(line)
        check_tokens(r["streams"], cfg, n_new, tag)
        if r["launches"]["k2"] != layers * r["steps"] \
                or r["launches"]["k2"] == 0 or r["eager_steps"] != r["steps"]:
            raise AssertionError(f"{tag}: rank {r['rank']} did not launch K2 "
                                 "on its head group in every layer of every "
                                 "eager step")
        if r["kv_shape"][4] != cfg.num_kv_heads // TP_MESH["tensor"]:
            raise AssertionError(f"{tag}: rank {r['rank']}'s cache holds "
                                 f"{r['kv_shape'][4]} KV heads")
    if any(r["streams"] != res[0]["streams"] for r in res[1:]):
        raise AssertionError(f"{tag}: the ranks' streams differ")


def serve_tp(torch, seed, device=None, **overrides):
    """serve-tp: (a) Llama-3-8B at full width and depth (bf16) under
    MeshConfig(tensor=2), two ranks sharing the card over gloo, against
    the one-rank engine on the same seeded weights: the first prefill's
    logits within 2x the bf16 noise floor, the greedy streams equal or
    first different at a near-tie; (b) the same model at 4 layers with
    int8 weights, K3 on memory-sharded weights.  Returns the K2 and K3
    launches a rank and the rates."""
    from deepspeed_tpu_torch.inference import (InferenceConfig,
                                               InferenceEngine,
                                               SamplingParams)
    from deepspeed_tpu_torch.models import build_model
    tag = "serve-tp a"
    t0 = time.perf_counter()
    from deepspeed_tpu_torch.comm.ranks import RankPool
    # the ranks run this script's tp_serve_* (it is each rank's __main__)
    ranks = RankPool(TP_WORLD, __name__,
                     init_method=f"tcp://127.0.0.1:{free_port()}",
                     device=device or "cuda", timeout=TP_TIMEOUT)
    try:
        model, prompts = serving_model(torch, "llama3-8b", seed, tag=tag,
                                       device=device, **overrides)
        cfg = model.config
        tol = first_forward_check(torch, model, prompts, tag)
        ref_logits = tp_first_logits(torch, cfg, model.params, prompts,
                                     cfg.num_kv_heads)
        eng1 = InferenceEngine(model, InferenceConfig(**SERVE_ENGINE))
        ref = eng1.generate(dict(enumerate(prompts)),
                            SamplingParams(max_new_tokens=SERVE_NEW_TOKENS))
        log(f"[{tag}] the one-rank engine's streams taken; ranks start "
            f"({time.perf_counter() - t0:.1f} s into the phase)")
        t_a = time.perf_counter()
        res = ranks.run("tp_serve_a", seed, prompts, device, overrides)
        log(f"[{tag}] ranks done in {time.perf_counter() - t_a:.1f} s; each "
            f"drew its slice in {res[0]['draw_s']:.2f} s "
            f"({res[0]['weight_bytes'] / 1e9:.3f} GB a rank); comm plan "
            f"{res[0]['comm_plan']}; backend gloo, {TP_WORLD} ranks on one "
            f"card")
        for r in res:
            err = float((r["logits"] - ref_logits).abs().max())
            log(f"[{tag}] rank {r['rank']} first prefill logits vs the "
                f"one-rank engine's: max|d| {err:.4f} (tol {tol:.4f}, 2x the "
                f"bf16 noise floor)")
            if not bool(torch.isfinite(r["logits"]).all()) or err > tol:
                raise AssertionError(f"{tag}: rank {r['rank']}'s first "
                                     f"logits off by {err} > {tol}")
        tp_check_ranks(res, cfg, cfg.num_layers, SERVE_NEW_TOKENS, tag)
        got = {int(u): v for u, v in res[0]["streams"].items()}
        check_near_ties(torch, eng1, dict(enumerate(prompts)), got,
                        {u: list(v) for u, v in ref.items()}, tol, tag)
        out = dict(a=res)
        del eng1, model
        free_engines(torch) if device is None else gc.collect()

        tag = "serve-tp b"
        over_b = {"num_layers": TP_QUANT_LAYERS, **overrides}
        t_b = time.perf_counter()
        model = build_model("llama3-8b", seed=seed, dtype=torch.bfloat16,
                            device=device, **over_b)
        tol_b = first_forward_check(torch, model, prompts, tag)
        n_b, len_b = TP_QUANT_PROMPTS
        prompts_b = [p[:len_b] for p in prompts[:n_b]]
        eng1 = InferenceEngine(model, InferenceConfig(
            **SERVE_ENGINE, weight_quant="int8"))
        ref = eng1.generate(dict(enumerate(prompts_b)),
                            SamplingParams(max_new_tokens=TP_QUANT_NEW))
        res = ranks.run("tp_serve_b", seed, prompts_b, device, overrides)
        log(f"[{tag}] {TP_QUANT_LAYERS} layers, int8 weights: wi's payload "
            f"a rank {res[0]['wi_local']} of {res[0]['wi_shape']} "
            f"(memory-sharded, gathered at use); mixed-input GEMM "
            f"{res[0]['mixed']}; ranks done in "
            f"{time.perf_counter() - t_b:.1f} s")
        tp_check_ranks(res, model.config, TP_QUANT_LAYERS, TP_QUANT_NEW, tag)
        for r in res:
            k3 = r["launches"]["k3"]
            if k3 != 7 * TP_QUANT_LAYERS * r["steps"] or k3 == 0:
                raise AssertionError(f"{tag}: rank {r['rank']}: K3 launched "
                                     f"{k3} times, not 7 x "
                                     f"{TP_QUANT_LAYERS} x {r['steps']}")
        got = {int(u): v for u, v in res[0]["streams"].items()}
        check_near_ties(torch, eng1, dict(enumerate(prompts_b)), got,
                        {u: list(v) for u, v in ref.items()}, tol_b, tag)
        out["b"] = res
        del eng1, model
        free_engines(torch) if device is None else gc.collect()
    finally:
        ranks.close()
    log(f"[serve-tp] phase wall {time.perf_counter() - t0:.2f} s "
        f"[{nvidia_smi_line()}]")
    return out


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
                            "train-ckpt,train-de,aux,encode,clip,diffusion,"
                            "attn-variants,serve,serve-quant,"
                            "serve-burst,"
                            "serve-failover,serve-offload,serve-fleet,"
                            "serve-alibi,"
                            "serve-mqa,"
                            "serve-spec,serve-moe,train-moe,train-fp16,"
                            "hybrid,comm,serve-tp,train-offload,train-nvme")
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
    mqa_kern, d80_kern, tp_kern = {}, {}, {}
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
            elif name == "phi-2 mixed":      # the hybrid rollouts' width
                d80_kern.setdefault("bf16", res)
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
        for name, (H, Hkv, D, bs, nblk, iters) in K2_TP_CASES:
            make = decode_batch if "decode" in name else mixed_batch
            case = make(torch, H, Hkv, D, bs, nblk, args.seed, dev)
            tp_kern.setdefault("bf16", check_kernel_case(
                torch, pa, name, case, H, Hkv, D, iters))
            del case
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

    # 3b. comm/ at world 1 over NCCL; 3c. Llama-3-8B tensor-parallel over
    # two gloo ranks on the card (early: a multi-process phase on a free
    # card)
    if "comm" in phases:
        comm_phase(torch, args.seed)
        phase_done("comm")
    tp_run = {}
    if "serve-tp" in phases:
        tp_run = serve_tp(torch, args.seed)
        phase_done("serve-tp")

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
    # 4d. data-efficient training of phase 4's GPT-2
    de_flash = None
    if "train-de" in phases:
        de_flash = train_de(torch, fa, args.seed)
        flash_runs.append(de_flash)
        phase_done("train-de")

    # 4i. the aux subsystems (the autotuner trains phase 4's GPT-2)
    aux_flash = None
    if "aux" in phases:
        aux_flash = aux_phase(torch, fa, args.seed)
        flash_runs.append(aux_flash)
        phase_done("aux")

    # 4e-4h. the model families and the attention variants: their paths
    # hold no port kernel, and none launches across them
    if phases & set(FAMILY_PHASES):
        before = port_launches(fa, pa, mg)
        for name, run_phase in (("encode", encode_phase),
                                ("clip", clip_phase),
                                ("diffusion", diffusion_phase),
                                ("attn-variants", attn_variants_phase)):
            if name in phases:
                run_phase(torch, args.seed)
                phase_done(name)
        after = port_launches(fa, pa, mg)
        log(f"[families] port kernel launches across "
            f"{sorted(phases & set(FAMILY_PHASES))}: before {before}, after "
            f"{after}")
        if after != before:
            raise AssertionError("a port kernel launched on a model-family "
                                 "or attention-variant path")

    # 5., 6., 6c., 6d. and 6e. the serving paths, bf16, quantized, in
    # decode bursts, under failures and offloaded, on one model
    launches = failover_launches = fleet_launches = None
    quant_runs, offload = {}, {}
    if phases & {"serve", "serve-quant", "serve-burst", "serve-failover",
                 "serve-offload", "serve-fleet"}:
        model, prompts = serving_model(torch, "llama3-8b", args.seed)
        phase5 = None
        if phases & {"serve", "serve-failover", "serve-fleet"}:
            # serve-failover's reference streams are phase 5's own
            phase5 = serve(torch, pa, model, prompts)
            launches = phase5["launches"]
        if "serve-quant" in phases:
            for tag, over in QUANT_RUNS:
                t_q = time.perf_counter()
                quant_runs[tag] = serve_quant(torch, pa, mg, model, prompts,
                                              tag, over)
                log(f"[time] serve-quant {tag} ({over['weight_quant']}): "
                    f"{time.perf_counter() - t_q:.1f} s")
        if "serve-burst" in phases:
            serve_burst(torch, pa, mg, model, prompts, decode_ref=(
                quant_runs["a"]["decode_tok_s"] if "a" in quant_runs
                else None))
        if "serve-failover" in phases:
            failover_launches = serve_failover(torch, pa, model, prompts,
                                               phase5, args.seed)
        if "serve-offload" in phases:
            t_off = time.perf_counter()
            offload = serve_offload(torch, pa, mg, model, prompts)
            log(f"[time] serve-offload: {time.perf_counter() - t_off:.1f} s")
        if "serve-fleet" in phases:
            fleet_launches = serve_fleet(torch, pa, model, prompts, phase5)
        del model, phase5
        free_engines(torch)
        phase_done("serve, serve-quant, serve-burst, serve-failover, "
                   "serve-offload, serve-fleet")

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

    # 8c. the RLHF actor loop on phi-2 (bf16): training and rollouts on
    # one set of weights through HybridEngine
    hybrid_launches = None
    if "hybrid" in phases:
        hybrid_flash, hybrid_launches = hybrid(torch, fa, pa, args.seed)
        flash_runs.append(hybrid_flash)
        phase_done("hybrid")

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
            # train-de's and the autotuner's own launches on the bf16 D 64
            # entries
            de = ({"de_launches": de_flash[k].get((dt, d), 0)
                   if de_flash is not None else None,
                   "aux_launches": aux_flash[k].get((dt, d), 0)
                   if aux_flash is not None else None}
                  if (dt, d) == ("bfloat16", 64) else {})
            return dict(name=flash_name(k, dt, d), route="cuda",
                        source=f"deepspeed_tpu_torch/ops/csrc/{src}",
                        replaces=replaces[k], launches=launches,
                        design=flash_design(k, dt, d), **de,
                        **flash_kern[dt, d][k])

        def quant_launches(run, key):
            return quant_runs[run]["launches"][key] if run in quant_runs \
                else None

        def offload_launches(part, name, key):
            run = offload.get(part, {})
            return (run.get(name, run) or {}).get(key) if run else None

        # K2 on serve-failover's Llama scenarios (a)-(d), a path of its
        # own (the counts zeroed before each scenario, read after it);
        # serve-offload's paths likewise: (a) the host-memory cache, (b)
        # the streamed weights' int8 cache, (c) the KV tier's rounds; and
        # serve-fleet's measured run through the gateway
        def tp_launches(run, key):
            # a rank's count in serve-tp's run (every rank's is checked
            # equal to layers x steps; rank 0's is reported)
            return tp_run[run][0]["launches"][key] if run in tp_run \
                else None

        def tp_k3(design):
            return (tp_run["b"][0]["launches"]["k3_design"][design]
                    if "b" in tp_run else None)

        entries = [dict(name="paged_attention", route="cuda", source=pa_src,
                        replaces=pa_replaces, launches=launches,
                        tp_launches=tp_launches("a", "k2"),
                        failover_launches=failover_launches,
                        fleet_launches=fleet_launches,
                        moe_launches=moe_launches,
                        fp6_launches=quant_launches("c", "kv"),
                        fp12_launches=quant_launches("d", "kv"),
                        offload_launches=offload_launches(
                            "a", "kv_offload", "launches"),
                        tier_launches=offload_launches("c", None,
                                                       "launches"),
                        **kern)]
        entries += [dict(name=f"paged_attention_{code}kv", route="cuda",
                         source=pa_src, replaces=pa_replaces,
                         launches=quant_launches(run, "kv"),
                         **({"stream_launches": offload_launches(
                             "b", "weight_stream", "k2")}
                            if code == "int8" else {}),
                         **qkv_kern[code])
                    for code, run in (("int8", "a"), ("fp8", "b"))]
        entries += [flash_entry(k, dt, d) for dt, d in FLASH_VARIANTS
                    for k in FLASH_KERNELS]
        # K3: one entry per (bits, design); the prefill design keeps the
        # name of the slice that ported it
        stream_design = offload_launches("b", "weight_stream", "design")
        entries += [dict(name=f"mixed_matmul_int{bits}"
                         + ("" if design == "prefill" else f"_{design}"),
                         route="cuda",
                         source="deepspeed_tpu_torch/ops/csrc/mixed_gemm.cu",
                         replaces=f"deepspeed_tpu/ops/mixed_gemm.py:{line}",
                         launches=quant_launches(run, design),
                         **({"stream_launches": (stream_design or {}).get(
                             design), "tp_launches": tp_k3(design)}
                            if bits == 8 else {}),
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
        # K2 at phi-2's head dim 80 (timed on its mixed batch): the hybrid
        # phase's refreshed rollout
        entries += [dict(name="paged_attention_d80", route="cuda",
                         source=pa_src, replaces=pa_replaces,
                         launches=hybrid_launches, **d80_kern["bf16"])]
        # K2-TP: K2 on one rank's head group (16 query heads over 4 KV
        # heads, tensor=2), timed at that shape; launches a rank in
        # serve-tp (a)
        entries += [dict(name="paged_attention_tp", route="cuda",
                         source=pa_src,
                         replaces="deepspeed_tpu/inference/model.py:96",
                         launches=tp_launches("a", "k2"),
                         tp_launches=tp_launches("a", "k2"),
                         **tp_kern["bf16"])]
        print(json.dumps({"kernels": entries}), flush=True)
    print(rep["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
