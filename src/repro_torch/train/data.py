"""Deterministic synthetic LM streams, and a prefetcher onto the device.

The port's own copy of ``repro/train/data.py``'s ``DataConfig`` and
``SyntheticStream`` (numpy only; the JAX package is not imported): each
step's batch is drawn from ``default_rng((seed, step, process_index))``, so
it depends only on those three and a restart resumes mid-stream from the
cursor saved with the checkpoint.  Batches are numpy ``{tokens, labels}``
(int32); :class:`Prefetcher` moves them to the device on a thread.

Two tasks with learnable structure:
  * ``markov`` — an order-k Markov chain over the vocab;
  * ``copy``   — the paper's Copy-Memory task (§4.3): recall a prefix after
                 a long gap.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    task: str = "markov"        # markov | copy
    vocab: int = 256
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    order: int = 2              # markov order
    copy_len: int = 16          # tokens to memorize (copy task)
    process_index: int = 0
    process_count: int = 1


class SyntheticStream:
    """Stateful, checkpointable iterator of {tokens, labels} numpy batches."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.process_count:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.process_count
        self._step = 0
        base = np.random.default_rng(cfg.seed)
        if cfg.task == "markov":
            # sparse-ish transition tensor with entropy well below log(V)
            v = cfg.vocab
            logits = base.gumbel(size=(v,) * cfg.order + (v,)) * 2.0
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            self.trans = probs / probs.sum(-1, keepdims=True)
        elif cfg.task != "copy":
            raise ValueError(cfg.task)

    # -- checkpointable state -------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step}

    def load_state_dict(self, d: Dict[str, int]):
        self._step = int(d["step"])

    # -- batch generation ------------------------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        # content depends only on (seed, step, host): restart-stable
        return np.random.default_rng((self.cfg.seed, step, self.cfg.process_index))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.generate(self._step)
        self._step += 1
        return batch

    def generate(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng_for(step)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab

        if cfg.task == "markov":
            toks = np.zeros((b, s), np.int64)
            toks[:, : cfg.order] = rng.integers(0, v, (b, cfg.order))
            u = rng.random((b, s))
            for t in range(cfg.order, s):
                ctx = tuple(toks[:, t - k - 1] for k in range(cfg.order))[::-1]
                p = self.trans[ctx]  # (b, v)
                toks[:, t] = (p.cumsum(-1) > u[:, t, None]).argmax(-1)
            labels = np.roll(toks, -1, axis=1)
            labels[:, -1] = -1
        else:  # copy-memory
            L = cfg.copy_len
            toks = rng.integers(2, v, (b, s))
            toks[:, L:-L] = 0                       # blank gap
            toks[:, -L - 1] = 1                     # "recall" marker
            labels = np.full((b, s), -1, np.int64)
            labels[:, -L - 1 : -1] = toks[:, :L]    # predict the prefix
            toks[:, -L:] = 0

        return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device`` (the embedding and the
    loss's gather index with them)."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


class _End:
    """The worker's last item: the exception it stopped on, or None."""

    def __init__(self, error=None):
        self.error = error


class Prefetcher:
    """Moves the batches of ``it`` to ``device`` on a thread, up to ``depth``
    ahead of the consumer; an exception in the thread is raised to the
    consumer.  Close it when done (``close``, or use it as a context
    manager)."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], device, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            end = _End()
            try:
                for item in it:
                    if self._stop.is_set():
                        break
                    self._q.put(to_device(item, device))
            except Exception as e:  # handed to the consumer by __next__
                end = _End(e)
            self._q.put(end)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if isinstance(item, _End):
            self._q.put(item)   # every later call ends too
            if item.error is not None:
                raise item.error
            raise StopIteration
        return item

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the thread and wait up to ``timeout`` s for it, draining what
        it put so that it is never left blocked on a full queue."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._t.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._t.join(max(0.0, deadline - time.monotonic()))
