"""GC203 reproducer: torch.cuda.is_available() outside the cached
dispatch read.

The port's counterpart of tests/fixtures/goomcheck/bad/gc203.py
(jax.default_backend()).
"""

import torch


def platform():
    return "cuda" if torch.cuda.is_available() else "cpu"
