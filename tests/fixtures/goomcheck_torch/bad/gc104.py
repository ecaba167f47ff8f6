"""GC104 reproducer: a linear reduction over exp'd, unrescaled log values.

The port's counterpart of tests/fixtures/goomcheck/bad/gc104.py.  The GC101
at the exp site is suppressed on purpose so the corpus has a finding
isolating the reduction rule itself (a real fix would route the sum through
the max-rescaled LSE/LMME monoid instead).
"""

import torch


def unrescaled_sum(x):
    p = torch.exp(x)  # goomcheck: disable=GC101 -- isolate the reduction rule
    return torch.sum(p)


GOOMCHECK_TRACES = [
    {"name": "unrescaled_sum", "fn": unrescaled_sum,
     "args": [("log", (8,), "float32")]},
]
