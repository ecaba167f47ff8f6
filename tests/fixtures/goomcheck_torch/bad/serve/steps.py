"""GC206 reproducer in the second scoped file (serve/steps.py).

The port's counterpart of tests/fixtures/goomcheck/bad/serve/steps.py.
"""


def decode_multi(block):
    return block.numpy()
