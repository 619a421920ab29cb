"""Time the port's kernels from two checkouts on one card, in turns (A,
B, B, A per round), so that two versions of a kernel compare within one
run on one card.

    python3 tools/flash_ab.py DIR_A DIR_B [--rounds 2] [--dtypes float32]
    python3 tools/flash_ab.py DIR_A DIR_B --family mixed [--M 8,1024]

Each turn is a fresh process that imports ``deepspeed_tpu_torch`` and
``chip_smoke`` from one checkout (which builds its kernels into its own
``build/kernels/``) and times with CUDA events.  ``--family flash`` (the
default): the forward, dq and dk/dv at the main paths' shapes of
``chip_smoke.FLASH_CASES`` (bf16 GPT-2 and Llama-3-8B, fp16 phi-2, fp32
GPT-2 and phi-2 width; ``--dtypes float32`` keeps the fp32 ones).
``--family mixed``: the int8 and int4 mixed-input GEMM (K3) at
Llama-3-8B's five projections (wi, mlp wo, wq, wk, attn wo) at M 8 (a
decode step) and 1024 (a prefill budget), on random codes and scales
made from a seed, through ``mixed_matmul_2d`` / ``mixed4_matmul_2d``
(the API every checkout since the port's third slice has), each call
queued behind a sleep kernel so that the host's time a call does not
stretch the kernel's.  It prints
one line a turn and, last, the mean of each (checkout, case, kernel)
over its turns.  Only CUDA: without a card every turn fails.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (case name, dtype) of chip_smoke.FLASH_CASES that the main paths run
CASES = [("gpt2 train", "bfloat16"), ("llama3-8b", "bfloat16"),
         ("phi-2 train", "float16"), ("gpt2 train", "float32"),
         ("phi-2 train", "float32")]
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# K3: (name, K, N) of Llama-3-8B's projections
MIXED_CASES = [("wi", 4096, 14336), ("mlp wo", 14336, 4096),
               ("wq", 4096, 4096), ("wk", 4096, 1024),
               ("attn wo", 4096, 4096)]


def emit(line: str) -> None:
    print(line, flush=True)  # tpulint: disable=print  (CLI output)


def time_checkout(root: str, dtypes) -> dict:
    """ms per call of each of KERNELS at each case of ``dtypes``, from the
    checkout ``root``."""
    sys.path.insert(0, root)
    import importlib

    import torch
    cs = importlib.import_module("chip_smoke")
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    builder = importlib.import_module("deepspeed_tpu_torch.ops.builder")
    # the libraries of ``dtypes`` at once; cached after the first turn
    builder.build_all({fa._KERNEL_DTYPES[getattr(torch, dt)][1]
                       for dt in dtypes})
    out = {}
    for name, dt, (B, H, Hkv, S, D, iters) in cs.FLASH_CASES:
        if (name, dt) not in CASES or dt not in dtypes:
            continue
        gen = torch.Generator(device="cuda").manual_seed(S + D)
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                       .to(dtype) for shape in ((B, H, S, D), (B, Hkv, S, D),
                                                (B, Hkv, S, D), (B, H, S, D)))
        o, lse = fa.flash_fwd(q, k, v, D ** -0.5, True)
        delta = (do.float() * o.float()).sum(-1)
        args = {"flash_fwd": (q, k, v, D ** -0.5, True),
                "flash_dq": (q, k, v, do, lse, delta, D ** -0.5, True)}
        args["flash_dkv"] = args["flash_dq"]
        for kname in KERNELS:
            fn, a = getattr(fa, kname), args[kname]
            out[f"{name} {dt} {kname}"] = cs.time_ms(
                torch, lambda: fn(*a), iters)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return out


def queued_ms(torch, fn, iters: int) -> float:
    """Device ms a call of ``fn``, the calls queued behind a sleep kernel
    that outlasts their enqueue (a call's host time can exceed a decode
    step's kernel time)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_mixed(root: str, ms) -> dict:
    """ms per call of the int8 and int4 mixed-input GEMM at MIXED_CASES x
    ``ms``, from the checkout ``root``."""
    sys.path.insert(0, root)
    import importlib

    import torch
    mg = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")
    mg.BUILDER.load()
    out = {}
    for bits in (8, 4):
        kern = mg.mixed_matmul_2d if bits == 8 else mg.mixed4_matmul_2d
        for name, K, N in MIXED_CASES:
            gen = torch.Generator(device="cuda").manual_seed(K + N + bits)
            rows = K if bits == 8 else K // 2
            data = torch.randint(-128, 128, (rows, N), device="cuda",
                                 generator=gen, dtype=torch.int8)
            s = torch.rand(K, device="cuda", generator=gen) / 64
            for M in ms:
                x = torch.randn(M, K, device="cuda", generator=gen).to(
                    torch.bfloat16)
                out[f"int{bits} {name} M={M}"] = queued_ms(
                    torch, lambda: kern(x, data, s), 50 if M <= 64 else 10)
            del data
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dtypes", default=",".join(sorted({d for _, d in CASES})),
                    help="comma-separated dtypes of the cases to time")
    ap.add_argument("--family", choices=("flash", "mixed"), default="flash")
    ap.add_argument("--M", default="8,1024",
                    help="comma-separated M of the mixed cases")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        times = (time_mixed(args.time, [int(m) for m in args.M.split(",")])
                 if args.family == "mixed"
                 else time_checkout(args.time, args.dtypes.split(",")))
        emit(json.dumps(times))
        return 0
    if len(args.dirs) != 2:
        ap.error("two checkouts to compare")
    runs = {d: [] for d in args.dirs}
    a, b = args.dirs
    for _ in range(args.rounds):
        for d in (a, b, b, a):
            res = subprocess.run(
                [sys.executable, __file__, "--time", str(Path(d).resolve()),
                 "--dtypes", args.dtypes, "--family", args.family,
                 "--M", args.M],
                capture_output=True, text=True)
            if res.returncode != 0:
                emit(f"{d}: exit {res.returncode}\n{res.stderr[-4000:]}")
                return 1
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[d].append(times)
            emit(f"{d}: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in times.items()))
    for d, rs in runs.items():
        mean = {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        emit(f"mean {d} ({len(rs)} turns): " + json.dumps(mean))
    return 0


if __name__ == "__main__":
    sys.exit(main())
