"""GC202 reproducer: raw torch.exp outside core/goom.py and kernels/.

The port's counterpart of tests/fixtures/goomcheck/bad/gc202.py; the tensor
method form is caught too.
"""

import torch


def blow_up(x):
    return torch.exp(x)


def blow_up_method(x):
    return x.log_()
