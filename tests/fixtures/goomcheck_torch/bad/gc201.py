"""GC201 reproducer: block/tile plumbing named outside kernels/.

The port's counterpart of tests/fixtures/goomcheck/bad/gc201.py.  Both a
BlockConfig(...) literal and a `matmul=` keyword are rejected: callers go
through engine.use_blocks and the autotune cache.
"""


def run(engine, goom_ops, x):
    cfg = goom_ops.BlockConfig(block_t=128)
    return engine.lmme(x, x, matmul=cfg)
