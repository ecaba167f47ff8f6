"""Entry point: ``python -m repro_torch.serve.api [--smoke] [--device cpu]``.

Builds goom-rnn-124m (or any registered ``--arch``: rwkv6-7b, gemma3-1b,
...) with seeded random weights, at full width
unless ``--smoke`` is given, on the card unless ``--device cpu`` is given,
wraps it in Engine -> Gateway -> ServeAPI, and serves until interrupted::

    PYTHONPATH=src python -m repro_torch.serve.api --device cpu --smoke --port 8000 &
    curl -N localhost:8000/v1/completions -d \
      '{"prompt": [3, 1, 4, 1, 5], "max_tokens": 8, "stream": true}'
    curl localhost:8000/status
"""

from __future__ import annotations

import argparse
import asyncio

from .gateway import Gateway
from .server import ServeAPI, build_engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.api")
    ap.add_argument("--arch", default="goom-rnn-124m")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size config (default: full width)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-len", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args(argv)

    eng, cfg = build_engine(
        args.arch, smoke=args.smoke, max_slots=args.slots,
        page_len=args.page_len, chunk=args.chunk, backend=args.backend,
        device=args.device)
    gateway = Gateway(eng, max_queue=args.max_queue).start()
    print(f"serving {cfg.name} on http://{args.host}:{args.port} "
          f"({args.slots} slots x page {args.page_len}, "
          f"queue watermark {args.max_queue}, device {eng.model.device})",
          flush=True)

    async def _serve():
        api = await ServeAPI(gateway, args.host, args.port).start()
        print(f"POST /v1/completions (SSE with \"stream\": true) | "
              f"GET /status — port {api.port}", flush=True)
        try:
            await api.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await api.stop()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    finally:
        gateway.stop()


if __name__ == "__main__":
    main()
