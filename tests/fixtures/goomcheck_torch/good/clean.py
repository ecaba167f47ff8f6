"""Known-good corpus: the sanctioned counterparts of the bad fixtures.

The port's counterpart of tests/fixtures/goomcheck/good/clean.py.  Every
pattern here must produce zero *active* findings; the one exp site carries
a justified suppression, which is itself part of what the good corpus
locks in (suppressed findings must not gate).
"""

import torch

from repro_torch.core.goom import safe_log


def rescaled_exp(x):
    """exp is safe once a dominating (detached) max is subtracted."""
    m = x.amax().detach()
    return torch.exp(x - m)  # bounded in (0, 1]; goomcheck: disable=GC202


def guarded_log(x):
    """The only sanctioned spelling of log on linear values."""
    return safe_log(x)


GOOMCHECK_TRACES = [
    {"name": "rescaled_exp", "fn": rescaled_exp,
     "args": [("log", (8,), "float32")]},
    {"name": "guarded_log", "fn": guarded_log,
     "args": [("linear", (8,), "float32")]},
]
