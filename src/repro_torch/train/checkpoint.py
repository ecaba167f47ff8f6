"""Atomic, asynchronous checkpoints in the JAX package's layout
(``repro/train/checkpoint.py``), so a checkpoint moves between the two
packages in both directions.

Layout:  <dir>/step_<N>/           (written as step_<N>.tmp, renamed when done)
             index.json            {"step", "leaves": {name: shape, dtype,
                                   n_shards}, "extra"}
             <leafpath>.p0s0.npy   one file per leaf (one process, one shard)
             COMPLETE              marker

A tree is nested dicts of arrays; a leaf's path is its keys joined by dots,
e.g. ``params.group_0.b0.mixer.A``, which is the JAX package's leaf name for
the same leaf of a dict or TrainState tree.

Contract, as in JAX:
  * a save is atomic: a crash mid-save leaves a .tmp directory that
    ``latest_step`` and ``restore`` ignore;
  * ``latest_step`` is the newest COMPLETE checkpoint (auto-resume);
  * ``extra`` carries the data cursor, so a restart neither replays nor
    skips batches;
  * ``save`` copies every leaf to the host before it returns and writes the
    files on a thread; the next save, ``wait`` or ``restore`` waits for it
    and raises what the write raised;
  * the newest ``keep`` checkpoints are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.extend(_leaves(v, name + "."))
        else:
            out.append((name, v))
    return out


def _host(x) -> np.ndarray:
    """A host copy that later in-place updates of ``x`` do not reach."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.numpy().copy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- discovery ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMPLETE"))):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The newest COMPLETE step, after the write in flight (if any)."""
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Mapping[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Blocking device→host copy; disk write on a background thread."""
        self.wait()
        host = [(name, _host(leaf)) for name, leaf in _leaves(tree)]
        index = {"step": step, "extra": extra or {},
                 "leaves": {name: {"shape": list(a.shape), "dtype": str(a.dtype),
                                   "n_shards": 1} for name, a in host}}

        def write():
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            for name, a in host:
                np.save(os.path.join(tmp, f"{name}.p0s0.npy"), a)
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump(index, f)
            with open(os.path.join(tmp, "COMPLETE"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if not self.async_save:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:  # raised to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def restore(self, step: int, target: Mapping[str, Any]
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree of numpy arrays shaped like ``target``, extra).  Only the
        leaves ``target`` names are read; each must be in the checkpoint
        with the target leaf's shape."""
        self.wait()
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)

        def load(node: Mapping[str, Any], prefix: str):
            out = {}
            for k, v in node.items():
                name = f"{prefix}{k}"
                if isinstance(v, Mapping):
                    out[k] = load(v, name + ".")
                    continue
                if name not in index["leaves"]:
                    raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
                a = np.load(os.path.join(d, f"{name}.p0s0.npy"))
                if tuple(a.shape) != tuple(np.shape(v)):
                    raise ValueError(f"{name}: checkpoint shape {a.shape} != "
                                     f"target {tuple(np.shape(v))}")
                out[k] = a
            return out

        return load(target, ""), index["extra"]

    def restore_latest(self, target: Mapping[str, Any]):
        """(step, tree, extra) of the newest COMPLETE checkpoint, or None."""
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, target)
        return step, tree, extra
