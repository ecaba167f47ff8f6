"""The port's launch-knob registry and autotuner against the JAX package's
(``tests/test_autotune.py``'s cases that apply), with the cache isolated in
a temporary file.

On ``torch_reference`` the knob is the plain matrix scan's time chunk, JAX
``xla_reference``'s; on ``cuda`` it is the with-B and zero-B kernels' chunk
L (their candidates are checked here; a sweep on the card runs in
``chip_smoke.py``).  With no cache entry and no override, every launch keeps
its default L.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.goom import Goom as JGoom
from repro.kernels import autotune as jautotune
from repro.kernels import blocks as jblocks
from repro_torch.core import engine
from repro_torch.core.goom import Goom
from repro_torch.kernels import autotune, dispatch
from repro_torch.kernels.blocks import DEFAULTS, BlockConfig, default_blocks, merge, shape_bucket
from repro_torch.kernels.goom_scan import REF_CHUNK, matrix_scan_cuda


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """The process's autotune cache in a fresh temporary file."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    autotune.load_cache(path, reload=True)
    yield path
    autotune._CACHE = None
    autotune._CACHE_FILE = None


def _goom(rng, shape, scale=0.5):
    v = rng.normal(size=shape).astype(np.float32) * scale
    return np.log(np.abs(v)), np.sign(v).astype(np.float32)


def _pair(planes):
    return Goom(torch.tensor(planes[0]), torch.tensor(planes[1])), \
        JGoom(jnp.asarray(planes[0]), jnp.asarray(planes[1]))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_shape_bucket_pow2_as_jax():
    assert shape_bucket((3, 500, 1024)) == (4, 512, 1024)
    assert shape_bucket((1,)) == (1,)
    for dims in [(1, 2, 3), (17, 64, 65), (4096, 512), (2001, 128)]:
        assert shape_bucket(dims) == jblocks.shape_bucket(dims)


def test_block_config_and_merge_as_jax():
    import dataclasses

    assert [f.name for f in dataclasses.fields(BlockConfig)] == \
        [f.name for f in dataclasses.fields(jblocks.BlockConfig)]
    base, over = BlockConfig(block_t=128, algo="seq"), BlockConfig(block_t=8)
    jb = jblocks.merge(jblocks.BlockConfig(block_t=128, algo="seq"),
                       jblocks.BlockConfig(block_t=8))
    assert merge(base, over).to_dict() == jb.to_dict() == {"block_t": 8, "algo": "seq"}


def test_defaults_keep_every_launch_as_it_was():
    """No override, no cache: the cuda scans launch at their own default L
    (the registered implementation is the wrapper itself), and the plain
    matrix scan chunks at JAX's 128."""
    for op in ("lmme", "diagonal_scan", "matrix_scan", "cumulative_lmme"):
        assert DEFAULTS[(op, "cuda")] == BlockConfig()
    assert default_blocks("matrix_scan", "torch_reference").block_t == REF_CHUNK == \
        jblocks.default_blocks("matrix_scan", "xla_reference").block_t
    assert dispatch.get_impl("matrix_scan", "cuda", BlockConfig()) is matrix_scan_cuda
    with pytest.raises(KeyError):
        default_blocks("matrix_scan", "pallas_tpu")


@pytest.mark.parametrize("chunk", [8, 16])
def test_use_blocks_sets_the_plain_chunk_as_jax(chunk):
    """A pinned chunk reaches the plain matrix scan: the states equal JAX's
    xla_reference under the same ``use_blocks`` (positive operands: no
    cancellation for the two libraries' f32 sums to part on)."""
    rng = np.random.default_rng(chunk)

    def positive(shape):
        log, sign = _goom(rng, shape)
        return log, np.abs(sign)

    a, ja = _pair(positive((32, 4, 4)))
    b, jb = _pair(positive((32, 4, 2)))
    with engine.use_blocks(matrix_scan={"block_t": chunk}):
        got = engine.matrix_scan(a, b)
    with jengine.use_backend("xla_reference"), jengine.use_blocks(
            matrix_scan={"block_t": chunk}):
        want = jax.jit(jengine.matrix_scan)(ja, jb)
    np.testing.assert_allclose(got.log_abs.numpy(), np.asarray(want.log_abs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))


def test_use_blocks_rejects_unknown_ops():
    with pytest.raises(ValueError, match="unknown engine op"):
        with engine.use_blocks(selective_reset_scan={"block_t": 8}):
            pass


# ---------------------------------------------------------------------------
# the cache (test_autotune.py's cases)
# ---------------------------------------------------------------------------
def test_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/nonexistent/jax.json")
    assert autotune.cache_path().endswith("repro_torch/autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "elsewhere.json")
    assert autotune.cache_path() == "elsewhere.json"
    assert autotune.device_kind() == "cpu"


def test_autotune_writes_cache_and_get_impl_consumes(cache_file):
    shapes = (32, 4, 4)
    report = autotune.autotune_op("matrix_scan", "torch_reference", shapes, reps=1)
    with open(cache_file) as f:
        data = json.load(f)
    key = autotune.cache_key("matrix_scan", "torch_reference", shape_bucket(shapes))
    assert report["key"] == key and autotune.device_kind() in key
    assert data["entries"][key]["blocks"] == report["blocks"]
    winner = autotune.cached_blocks("matrix_scan", "torch_reference", shapes)
    assert winner.block_t == report["blocks"]["block_t"]
    assert autotune.cached_blocks("matrix_scan", "torch_reference", (31, 3, 3)).block_t \
        == winner.block_t   # the same pow2 bucket
    assert autotune.cached_blocks("matrix_scan", "torch_reference", (4096, 64, 64)) == \
        default_blocks("matrix_scan", "torch_reference")


def test_engine_autotune_end_to_end(cache_file):
    """engine.autotune() persists winners that the next engine call consumes
    (no caller names a block size); the states stay JAX's."""
    reports = engine.autotune(("matrix_scan",), shapes={"matrix_scan": (16, 4, 4)}, reps=1)
    assert set(reports) == {"matrix_scan"} and reports["matrix_scan"]["blocks"]
    rng = np.random.default_rng(0)
    a, ja = _pair(_goom(rng, (16, 4, 4)))
    b, jb = _pair(_goom(rng, (16, 4, 2)))
    got = engine.matrix_scan(a, b)
    with jengine.use_backend("xla_reference"):
        want = jax.jit(jengine.matrix_scan)(ja, jb)
    np.testing.assert_allclose(got.log_abs.numpy(), np.asarray(want.log_abs),
                               rtol=1e-4, atol=1e-3)


def test_use_blocks_beats_cache(cache_file):
    shapes = (16, 4, 4)
    autotune.save_entry(autotune.cache_key("matrix_scan", "cuda", shape_bucket(shapes)),
                        BlockConfig(block_t=128, algo="chunked"), 1.0, 1)
    with engine.use_blocks(matrix_scan={"block_t": 8}):
        blocks = engine._block_overrides(engine.get_config(), "matrix_scan", "cuda", shapes)
    assert blocks.block_t == 8 and blocks.algo == "chunked"   # field by field
    with engine.use_blocks("torch_reference", matrix_scan={"block_t": 8}):
        assert engine._block_overrides(engine.get_config(), "matrix_scan", "cuda",
                                       shapes) is None   # another backend's pin


def test_explicit_cache_path_is_sticky_and_consumed(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    autotune._CACHE = None
    autotune._CACHE_FILE = None
    custom = str(tmp_path / "elsewhere" / "tune.json")
    try:
        engine.autotune(("matrix_scan",), shapes={"matrix_scan": (16, 4, 4)}, reps=1,
                        cache_path=custom, backend="torch_reference")
        winner = autotune.cached_blocks("matrix_scan", "torch_reference", (16, 4, 4))
        key = autotune.cache_key("matrix_scan", "torch_reference", shape_bucket((16, 4, 4)))
        assert winner.block_t == json.load(open(custom))["entries"][key]["blocks"]["block_t"]
        assert not (tmp_path / "home").exists()
    finally:
        autotune._CACHE = None
        autotune._CACHE_FILE = None


def test_corrupt_cache_is_ignored(cache_file):
    with open(cache_file, "w") as f:
        f.write("{not json")
    assert autotune.load_cache(cache_file, reload=True) == {}
    assert autotune.cached_blocks("matrix_scan", "cuda", (8, 8, 8)) == \
        default_blocks("matrix_scan", "cuda")


def test_candidates_clip_to_problem():
    cands = autotune.candidates_for("matrix_scan", "torch_reference", (8, 4, 4))
    tiles = sorted({c.block_t for c in cands})
    assert tiles == [32]   # nothing up to max(16, 2t): the smallest survives, as JAX's
    assert [c.block_t for c in autotune.candidates_for(
        "matrix_scan", "torch_reference", (512, 4, 4))] == \
        [c.block_t for c in jautotune.candidates_for("matrix_scan", "xla_reference",
                                                     (512, 4, 4))]


@pytest.mark.parametrize("t,d,want", [
    (512, 16, [32, 64, 128, 256]),   # K = ceil(T/L) <= 16 chunks at d <= 16
    (512, 32, [128, 256]),           # K <= 4 at d <= 32
    (64, 16, [4, 8, 16, 32]),
    (512, 64, []),                   # above d = 32 a block walks: L = T alone
    (1, 16, []),
])
def test_with_b_candidates_are_the_kernels_chunks(t, d, want):
    cands = autotune.candidates_for("matrix_scan", "cuda", (t, d, 4))
    assert [c.block_t for c in cands if c.algo == "chunked"] == want
    assert cands[-1] == BlockConfig(algo="seq")
    kmax = 16 if d <= 16 else 4
    assert all(-(-t // c.block_t) <= kmax for c in cands[:-1])


def test_zero_b_and_fixed_tile_candidates():
    cands = autotune.candidates_for("cumulative_lmme", "cuda", (100, 16))
    assert [c.block_t for c in cands[:-1]] == [2, 4, 8, 16, 32, 64]
    assert cands[-1].algo == "seq"
    for op, shapes in (("lmme", (8, 8, 8)), ("diagonal_scan", (64, 8))):
        assert autotune.candidates_for(op, "cuda", shapes) == [BlockConfig()]


def test_autotune_every_op_runs_tiny(cache_file):
    shapes = {"lmme": (8, 8, 8), "diagonal_scan": (16, 8), "matrix_scan": (8, 4, 4),
              "cumulative_lmme": (8, 4)}
    reports = engine.autotune(shapes=shapes, reps=1)
    assert set(reports) == set(shapes)
    entries = autotune.load_cache(reload=True)
    # per op: one per-algo entry ("-": no algorithm axis) and the "best" slot
    assert len(entries) == 8
    for op in shapes:
        key = autotune.cache_key(op, "torch_reference", shape_bucket(shapes[op]))
        assert key in entries and key.replace("|best", "|-") in entries


def test_a_candidate_that_fails_is_recorded_with_its_error(cache_file, monkeypatch):
    real = dispatch._REGISTRY[("matrix_scan", "torch_reference")]

    def factory(blocks):
        if blocks.block_t == 64:
            def refuse(a, b, x0=None):
                raise RuntimeError("launch refused")
            return refuse
        return real(blocks)

    monkeypatch.setitem(dispatch._REGISTRY, ("matrix_scan", "torch_reference"), factory)
    report = autotune.autotune_op("matrix_scan", "torch_reference", (64, 4, 4), reps=1)
    rows = {r["blocks"]["block_t"]: r for r in report["table"]}
    assert "launch refused" in rows[64]["error"] and "ms" in rows[32]
    assert report["blocks"]["block_t"] != 64


# ---------------------------------------------------------------------------
# v2 keys
# ---------------------------------------------------------------------------
def test_cache_key_is_five_part_with_algo():
    key = autotune.cache_key("matrix_scan", "cuda", (512, 16, 16), kind="gpu0")
    assert key == "matrix_scan|cuda|gpu0|512x16x16|best"
    assert autotune.cache_key("matrix_scan", "cuda", (512, 16, 16), kind="gpu0",
                              algo="seq").endswith("|seq")


def test_v1_cache_is_ignored_wholesale(cache_file):
    with open(cache_file, "w") as f:
        json.dump({"version": 1, "entries": {"matrix_scan|cuda|cpu|8x4x4": {
            "blocks": {"block_t": 999}, "ms": 0.1, "candidates": 1}}}, f)
    assert autotune.load_cache(cache_file, reload=True) == {}
    assert autotune.cached_blocks("matrix_scan", "cuda", (8, 4, 4)) == \
        default_blocks("matrix_scan", "cuda")


def test_stale_four_part_key_in_v2_file_is_dropped(cache_file):
    good = autotune.cache_key("matrix_scan", "torch_reference", (8, 4, 4))
    with open(cache_file, "w") as f:
        json.dump({"version": 2, "entries": {
            "matrix_scan|torch_reference|cpu|8x4x4": {"blocks": {}},
            good: {"blocks": {"block_t": 16}, "ms": 0.1, "candidates": 1}}}, f)
    assert list(autotune.load_cache(cache_file, reload=True)) == [good]
