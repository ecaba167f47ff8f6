"""GC204/GC206 reproducers: a clock read outside the _deadline_clock
guard, and host-sync pulls outside the _TokenFlight transfer buffer.

The port's counterpart of tests/fixtures/goomcheck/bad/serve/scheduler.py.
Both rules only apply to files ending serve/scheduler.py (GC206 also to
serve/steps.py), which is why this fixture lives at bad/serve/.
"""

import time


def sweep(active):
    now = time.monotonic()
    return [r for r in active if r.deadline > now]


def flush_blocking(pending):
    # a raw per-step host pull in the hot loop: GC206
    arr = pending.cpu()
    return arr


def drain(tokens, first):
    toks = tokens.tolist()
    return toks + [int(first.item())]
