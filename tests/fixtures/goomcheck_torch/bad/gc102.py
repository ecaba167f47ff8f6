"""GC102 reproducer: narrowing a log-space carry to bf16.

The port's counterpart of tests/fixtures/goomcheck/bad/gc102.py.  bf16 has
~8 bits of mantissa; a log magnitude carried across scan steps loses the
low-order log bits that the whole representation depends on.
"""

import torch


def demote(x):
    return x.to(torch.bfloat16)


GOOMCHECK_TRACES = [
    {"name": "demote", "fn": demote, "args": [("log", (8,), "float32")]},
]
