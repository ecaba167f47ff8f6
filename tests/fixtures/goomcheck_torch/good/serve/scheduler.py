"""Known-good scheduler: the clock is read only inside _deadline_clock,
and every device->host materialization lives in the _TokenFlight transfer
buffer (host-side data is built with an explicit dtype).

The port's counterpart of tests/fixtures/goomcheck/good/serve/scheduler.py.
"""

import time

import numpy as np


def _deadline_clock():
    return time.monotonic()


def sweep(active):
    now = _deadline_clock()
    return [r for r in active if r.deadline > now]


class _TokenFlight:
    def __init__(self):
        self._blocks = []

    def push(self, block):
        self._blocks.append(block.to("cpu", non_blocking=True))

    def take(self):
        blocks, self._blocks = self._blocks, []
        return np.concatenate([b.numpy() for b in blocks], axis=0)

    def scalar(self, x):
        return int(x.item())


def admit(prompt):
    # host-side data prep with an explicit dtype: not a device pull
    ids = np.asarray(prompt, np.int64).reshape(-1)
    return ids.tolist()
