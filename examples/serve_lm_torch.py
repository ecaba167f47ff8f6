"""Serving demo on the PyTorch port: concurrent HTTP clients against the
streaming front door, the run of ``examples/serve_lm.py``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --arch olmo-1b --tokens 32
      [--device cpu]

Part 1 boots the serving stack in-process, ``serve.Engine`` on its own
thread behind the asyncio HTTP server (``repro_torch.serve.api``), and
drives it with more concurrent streaming clients than decode slots,
token-by-token SSE consumption, and a ``/status`` snapshot at the end.  The
same server is what ``python -m repro_torch.serve.api`` exposes standalone.
Part 2 runs the lockstep static batch (``serve.generate``, its decode step
one CUDA graph on the card) over prompts of the full length, among them
those part 1's clients sent, and counts where both paths gave the same
greedy tokens.  The model is the arch's smoke config with seeded random
weights.
"""

import argparse
import threading
import time

import torch

from repro_torch import DecoderLM, Engine, get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve import generate, slot_cache_bytes
from repro_torch.serve.api import BackgroundServer, Gateway
from repro_torch.serve.api import client as api


def _client(host, port, i, prompt, n_tokens, out, t_start):
    """One streaming client: consume SSE tokens, retry on 429."""
    while True:
        try:
            toks = []
            for event in api.stream_completion(
                    host, port, {"prompt": prompt, "max_tokens": n_tokens}):
                choice = event["choices"][0]
                toks.append(choice["token"])
                if choice["finish_reason"] is not None:
                    out[i] = (toks, choice["finish_reason"],
                              time.perf_counter() - t_start)
            return
        except api.RetryLater as e:
            print(f"  client {i}: 429, retrying in {e.retry_after}s")
            time.sleep(e.retry_after)


def _tokens(seed, n, vocab):
    return torch.randint(0, vocab, (n,), generator=torch.Generator().manual_seed(seed))


def main(argv=None):
    """Returns {"model", "prompts" (the clients'), "http" ((tokens,
    finish reason, seconds) a client), "batch" (part 2's prompts),
    "generated" (B, tokens), "rows" (part 2's rows that hold the prompt of
    the client of the same index)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    dev = resolve_device(args.device)
    model = DecoderLM(cfg, device=dev)

    page_len = args.prompt_len + args.tokens
    sb = slot_cache_bytes(model, args.slots, page_len)
    print(f"== HTTP front door: {args.requests} streaming clients on "
          f"{args.slots} slots x page {page_len} "
          f"({sb['per_slot']/2**10:.0f} KiB/slot)")

    eng = Engine(model, max_slots=args.slots, page_len=page_len, chunk=args.chunk)
    srv = BackgroundServer(Gateway(eng, max_queue=2 * args.requests)).start()
    print(f"serving on http://{srv.host}:{srv.port} "
          f"(standalone: python -m repro_torch.serve.api)")
    prompts = []
    try:
        t0 = time.perf_counter()
        out = [None] * args.requests
        threads = []
        for i in range(args.requests):
            # staggered workload: prompts and budgets vary per request
            p = args.prompt_len - (i % 3)
            n = max(2, args.tokens - 4 * i)
            prompts.append(_tokens(i, p, cfg.vocab).tolist())
            threads.append(threading.Thread(
                target=_client, args=(srv.host, srv.port, i, prompts[-1], n, out, t0),
                daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_eng = time.perf_counter() - t0
        n_tok = sum(len(toks) for toks, _, _ in out)
        print(f"server: {n_tok} tokens to {args.requests} clients in "
              f"{t_eng*1e3:.0f} ms ({n_tok/t_eng:.0f} tok/s aggregate)")
        for i, (toks, reason, dt) in enumerate(out):
            print(f"  req {i}: {len(toks):3d} tokens ({reason}) in "
                  f"{dt*1e3:6.0f} ms — {toks[:8]}"
                  f"{' ...' if len(toks) > 8 else ''}")
        snap = api.get_status(srv.host, srv.port)
        lat = snap["latency_ms"]
        print(f"/status: {snap['requests']['finished']} finished, "
              f"decode step p50 {lat['decode_step']['p50']:.1f} ms, "
              f"ttft p50 {lat['ttft']['p50']:.0f} ms, "
              f"request p50 {lat['request']['p50']:.0f} ms")
    finally:
        srv.stop()

    print(f"\n== lockstep batch: {args.requests} x {args.tokens} tokens")
    # the clients' prompts of the full length, fresh prompts in the other rows
    rows = [i for i in range(args.requests) if len(prompts[i]) == args.prompt_len]
    batch = torch.stack([torch.tensor(prompts[i]) if i in rows
                         else _tokens(99 + i, args.prompt_len, cfg.vocab)
                         for i in range(args.requests)]).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = generate(model, batch, n_tokens=args.tokens, max_len=page_len)
    seqs = seqs.cpu()
    t_leg = time.perf_counter() - t0
    n_tok = args.requests * args.tokens
    print(f"lockstep: {n_tok} tokens in {t_leg*1e3:.0f} ms "
          f"({n_tok/t_leg:.0f} tok/s; every sequence decodes to the max; the "
          "first call, on the card, captures the decode graph)")
    same = sum(len(out[i][0]) for i in rows if seqs[i, :len(out[i][0])].tolist() == out[i][0])
    total = sum(len(out[i][0]) for i in rows)
    print(f"generate vs HTTP on the clients' full-length prompts (rows {rows}): "
          f"{same} of {total} tokens in rows that agree throughout")
    return dict(model=model, prompts=prompts, http=out, batch=batch.cpu(),
                generated=seqs, rows=rows)


if __name__ == "__main__":
    main()
