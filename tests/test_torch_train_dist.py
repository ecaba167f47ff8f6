"""Training and serving on ranks (gloo on the CPU), and int8 gradient
compression, against one process and the JAX package.

* the launcher under ``torch.distributed.run`` with 2 ranks: ``--seq-shards
  2`` (every GOOM scan time-sharded) against the single-process launcher on
  the same seed, and ``--mesh host`` data parallel (2, 1) against one
  process on the full batch (both data ranks' slices), 3 f32 steps each;
* ``compress_int8`` / ``decompress_int8`` bit-equal to JAX's, and the
  int8 train step as the plain step on JAX-rounded gradients;
* the Engine and ``generate`` under a 2-rank mesh (goom-rnn's smoke config
  in both scan variants, a smoke Jamba), tokens equal to local runs.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import DecoderLM, get_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import free_port, spawn_ranks
from repro_torch.train import (AdamW, DataConfig, SyntheticStream, cosine_schedule,
                               init_train_state, make_train_step)
from repro_torch.train.data import to_device
from repro_torch.train.optimizer import compress_int8, decompress_int8

import torch_dist_workers as workers

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGV = ["--arch", "goom-rnn-124m", "--smoke", "--device", "cpu", "--task", "copy",
        "--seq-len", "32", "--batch", "4", "--steps", "3", "--lr", "3e-3", "--warmup", "1",
        "--compute-dtype", "float32"]
RTOL = 1e-5


def torchrun(argv, out):
    """2 ranks of the launcher; what rank 0 wrote to ``--metrics-out``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "localhost", "--master-port", str(free_port()),
           "-m", "repro_torch.launch.train", *argv, "--dist-backend", "gloo",
           "--metrics-out", str(out)]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The 2-rank runs (seq shards, then data), started together, and the
    single-process run."""
    tmp = tmp_path_factory.mktemp("dist")
    one = tmp / "one.json"
    launch_train.main(ARGV + ["--metrics-out", str(one)])
    return {"seq": torchrun(ARGV + ["--seq-shards", "2"], tmp / "seq.json"),
            "data": torchrun(ARGV + ["--mesh", "host"], tmp / "data.json"),
            "one": json.loads(one.read_text())}


def test_seq_sharded_launcher_tracks_one_process(launches):
    """Rank 0's losses and gradient norms of ``--seq-shards 2`` equal the
    single process's: the scans run on half the time axis each and are
    stitched, the rest is replicated."""
    got, want = launches["seq"], launches["one"]
    assert got["world"] == 2 and want["world"] == 1
    assert len(got["steps"]) == len(want["steps"]) == 3
    for g, w in zip(got["steps"], want["steps"]):
        assert abs(g["loss"] - w["loss"]) <= RTOL * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * abs(w["grad_norm"])
        assert g["lr"] == w["lr"]


def test_data_parallel_launcher_equals_one_process_on_the_full_batch(launches):
    """``--mesh host`` (2, 1): each data rank draws its slice
    (``process_index``), the gradients and metrics are averaged over the
    data group; one process stepping on both slices together agrees."""
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                              compute_dtype=torch.float32)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = AdamW(cosine_schedule(3e-3, 1, 3))
    state, step = init_train_state(model, opt), make_train_step(model, opt)
    streams = [SyntheticStream(DataConfig(task="copy", vocab=cfg.vocab, seq_len=32,
                                          global_batch=4, seed=0, process_index=i,
                                          process_count=2)) for i in range(2)]
    for i, row in enumerate(launches["data"]["steps"]):
        parts = [s.generate(i) for s in streams]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        state, m = step(state, to_device(batch, "cpu"))
        for key in ("loss", "grad_norm"):
            assert abs(row[key] - float(m[key])) <= RTOL * abs(float(m[key])), (i, key)
        assert row["tokens"] == float(m["tokens"])


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compression_is_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    grads = {"w": rng.normal(size=(64, 32)) * 3.0, "b": rng.normal(size=7) * 1e-3,
             "zero": np.zeros(5), "big": rng.normal(size=(3, 3)) * 1e4,
             "ties": np.array([0.5, 1.5, 2.5, -2.5, 127.0, -127.0])}
    grads = {k: v.astype(np.float32) for k, v in grads.items()}
    got = compress_int8({k: torch.tensor(v) for k, v in grads.items()})
    want = jopt.compress_int8({k: jnp.asarray(v) for k, v in grads.items()})
    for k in grads:
        q, scale = got[k]
        jq, jscale = want[k]
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(scale).tobytes() == np.float32(jscale).tobytes()
    back = decompress_int8(got)
    jback = jopt.decompress_int8(want)
    for k in grads:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


def test_int8_train_step_rounds_as_jax():
    """A step with ``grad_compression="int8"`` is the plain step on
    gradients rounded by JAX's ``compress_int8``/``decompress_int8``, cast
    back, then clipped (the JAX step's order): the same parameters and
    gradient norm, bit for bit.  (Two packages' gradients agree to ~1e-6,
    and a rounding boundary between them moves an element by a quantum, so
    the rounding is held to JAX's on the port's own gradients.)"""
    from repro_torch.train.optimizer import clip_by_global_norm

    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                              compute_dtype=torch.float32)
    a, b = (DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    opt = AdamW(cosine_schedule(3e-3, 1, 3))
    batch = to_device(SyntheticStream(DataConfig(task="copy", vocab=cfg.vocab, seq_len=32,
                                                 global_batch=4)).generate(0), "cpu")
    state_a, m = make_train_step(a, opt, grad_compression="int8")(
        init_train_state(a, opt), batch)

    state_b = init_train_state(b, opt)
    loss, _ = b.loss(batch["tokens"], batch["labels"])
    names = list(state_b.params)
    grads = torch.autograd.grad(loss, [state_b.params[n] for n in names])
    q = jopt.compress_int8({n: jnp.asarray(g.numpy()) for n, g in zip(names, grads)})
    back = jopt.decompress_int8(q)   # a dict in JAX's (sorted) key order
    grads = {n: torch.tensor(np.asarray(back[n])) for n in names}
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    opt.update(grads, state_b.opt_state, state_b.params,
               opt.decay_mask(cfg, names))
    assert float(m["grad_norm"]) == float(gnorm)
    for n in names:
        assert torch.equal(state_a.params[n], state_b.params[n]), n


def test_unknown_grad_compression_raises():
    cfg = get_config("goom-rnn-124m", smoke=True)
    model = DecoderLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(model, AdamW(cosine_schedule(1e-3, 1, 2)), grad_compression="fp8")


def test_nccl_without_a_card_is_refused(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="nccl needs --device cuda"):
        launch_train.main(ARGV + ["--dist-backend", "nccl"])


# ---------------------------------------------------------------------------
# serving under a mesh
# ---------------------------------------------------------------------------
MODELS = [("goom-rnn-124m", "shared_a"), ("goom-rnn-124m", "generic"), ("jamba-v0.1", None)]


@pytest.fixture(scope="module")
def served():
    return spawn_ranks(workers.serve_rank, 2, MODELS, timeout=300)


@pytest.mark.parametrize("arch,variant", MODELS)
def test_engine_and_generate_under_a_mesh_equal_local_runs(served, arch, variant):
    """Two ranks serve the same requests under a (1, 2) mesh (the prompts'
    scans time-sharded: goom-rnn's matrix scan, Jamba's full-length diagonal
    scan): the Engine's and ``generate``'s tokens equal a local run's."""
    want = workers.serve_tokens(workers._smoke_model(arch, variant))
    for got_served, got_gen, shards in (r[(arch, variant)] for r in served):
        assert shards == 2
        assert got_served == want[0]
        np.testing.assert_array_equal(got_gen, want[1])
