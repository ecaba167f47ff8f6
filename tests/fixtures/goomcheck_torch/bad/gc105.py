"""GC105 reproducer: a host read in a traced hot path.

The port's counterpart of tests/fixtures/goomcheck/bad/gc105.py (whose
jax.debug.print lowers to a debug_callback).  ``.item()`` pulls a value to
the host, a round-trip per dispatch that serializes the serving step loop.
"""


def chatty(x):
    print("x =", x.sum().item())
    return x + 1.0


GOOMCHECK_TRACES = [
    {"name": "chatty", "fn": chatty, "args": [("linear", (8,), "float32")]},
]
