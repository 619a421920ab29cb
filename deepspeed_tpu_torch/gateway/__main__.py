"""``python -m deepspeed_tpu_torch.gateway`` — serve a demo engine over HTTP
(on the card unless given ``--device cpu``).

The real-SIGTERM drill: run it, point a client at
``POST /v1/completions``, then ``kill -TERM`` the pid and watch
in-flight streams finish while new arrivals get 503.  Production
deployments construct their own engine/fleet and call
``Gateway.start()``; this entry point exists so the wire surface is
drivable without writing any code (and so the drain contract can be
exercised with a real signal, not just the programmatic
``shutdown()`` the tests use).
"""

from __future__ import annotations

import argparse
import asyncio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve a tiny demo engine over HTTP (SSE streaming)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=None,
                    help="base sampling key (temperature sampling)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-queued", type=int, default=32,
                    help="admission queue bound (shed policy: reject)")
    ap.add_argument("--drain-ms", type=float, default=30_000.0)
    ap.add_argument("--device", default=None,
                    help="where the demo model lives: the card by default "
                    "(raises without one), or 'cpu' for a rehearsal")
    args = ap.parse_args(argv)

    from ..inference import InferenceConfig, InferenceEngine, SamplingParams
    from ..inference.overload import OverloadConfig
    from ..models import build_model
    from .server import Gateway, GatewayConfig

    model = build_model("llama-tiny", vocab_size=256, num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, max_seq_len=256, device=args.device)
    eng = InferenceEngine(model, InferenceConfig(
        token_budget=64, max_seqs=8, kv_block_size=8, num_kv_blocks=96,
        max_seq_len=256,
        overload=OverloadConfig(max_queued_requests=args.max_queued,
                                shed_policy="reject")))
    gw = Gateway(eng, GatewayConfig(
        host=args.host, port=args.port, seed=args.seed,
        sampling=SamplingParams(temperature=args.temperature,
                                max_new_tokens=1 << 30),
        drain_deadline_ms=args.drain_ms))

    async def serve() -> None:
        await gw.start()
        await gw.wait_stopped()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
