"""GC101 reproducer: exp of an unrescaled log-space magnitude.

The port's counterpart of tests/fixtures/goomcheck/bad/gc101.py.  The
argument is seeded as a raw log magnitude; exponentiating it without first
subtracting a dominating max is exactly the overflow escape GOOMs exist to
prevent.
"""

import torch


def exp_escape(x):
    return torch.exp(x)


GOOMCHECK_TRACES = [
    {"name": "exp_escape", "fn": exp_escape, "args": [("log", (8,), "float32")]},
]
