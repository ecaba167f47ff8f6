"""GC103 reproducer: a bare log op outside safe_log.

The port's counterpart of tests/fixtures/goomcheck/bad/gc103.py.
torch.log on a linear value has an unbounded derivative at 0; the port's
safe_log floors both the value and the gradient (paper eq. 6).
"""

import torch


def bare_log(x):
    return torch.log(x)


GOOMCHECK_TRACES = [
    {"name": "bare_log", "fn": bare_log, "args": [("linear", (8,), "float32")]},
]
