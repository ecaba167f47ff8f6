"""The port's synthetic data stream against the JAX package's, batch for
batch, and its prefetcher.

``repro_torch.train.data`` is the port's own copy of
``repro/train/data.py`` (it imports nothing of the JAX package); the same
config must give equal numpy batches at every step, and after a cursor is
saved and restored.
"""

import numpy as np
import pytest
import torch

from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticStream as JaxStream
from repro_torch.train.data import DataConfig, Prefetcher, SyntheticStream

CONFIGS = {
    "markov": dict(task="markov", vocab=64, seq_len=48, global_batch=4, seed=3),
    "copy": dict(task="copy", vocab=256, seq_len=64, global_batch=8, seed=5),
    "copy_host1of2": dict(task="copy", vocab=256, seq_len=40, global_batch=8, seed=5,
                          process_index=1, process_count=2),
}


def _equal(a, b):
    assert set(a) == set(b) == {"tokens", "labels"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batches_equal_jax_at_any_step(name):
    ours = SyntheticStream(DataConfig(**CONFIGS[name]))
    theirs = JaxStream(JaxDataConfig(**CONFIGS[name]))
    for step in (0, 1, 7, 123):
        _equal(ours.generate(step), theirs.generate(step))
    for _ in range(3):                      # iteration advances the cursor
        _equal(next(ours), next(theirs))
    assert ours.state_dict() == theirs.state_dict() == {"step": 3}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_restored_cursor_resumes_the_stream(name):
    ref = JaxStream(JaxDataConfig(**CONFIGS[name]))
    ref.load_state_dict({"step": 11})
    ours = SyntheticStream(DataConfig(**CONFIGS[name]))
    ours.load_state_dict({"step": 11})
    for _ in range(2):
        _equal(next(ours), next(ref))
    assert ours.state_dict() == {"step": 13}


def test_stream_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        SyntheticStream(DataConfig(task="text"))
    with pytest.raises(ValueError):
        SyntheticStream(DataConfig(global_batch=3, process_count=2))


def test_prefetcher_moves_batches_in_order():
    stream = SyntheticStream(DataConfig(**CONFIGS["copy"]))
    with Prefetcher((stream.generate(i) for i in range(5)), "cpu", depth=2) as pf:
        got = list(pf)
    assert len(got) == 5
    for i, b in enumerate(got):
        want = stream.generate(i)
        for k in want:
            assert b[k].dtype == torch.long and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), want[k])
    with pytest.raises(StopIteration):   # stays ended
        next(pf)


def test_prefetcher_raises_the_worker_error_and_closes():
    def batches():
        yield SyntheticStream(DataConfig(**CONFIGS["copy"])).generate(0)
        raise IndexError("bad batch")

    pf = Prefetcher(batches(), "cpu")
    next(pf)
    with pytest.raises(IndexError, match="bad batch"):
        next(pf)
    pf.close()
    assert not pf._t.is_alive()

    endless = Prefetcher(iter(SyntheticStream(DataConfig(**CONFIGS["copy"]))), "cpu",
                         depth=2)
    next(endless)
    endless.close(timeout=10.0)              # the worker is blocked on a full queue
    assert not endless._t.is_alive()
