"""The port's examples (``examples/*_torch.py``) run on the CPU at small
sizes through their ``main(argv)``, as ``chip_smoke.py`` runs them on the
card: the quickstart's five sections, the Lyapunov spectra (the parallel
spectrum held to the JAX package's estimator on the same Jacobians within
1e-3) and the serving demo (every client served, ``generate``'s tokens
equal to the HTTP stream's on the same prompts)."""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import lyapunov as jlyap
from repro_torch.core import lyapunov

torch.set_num_threads(2)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_its_five_sections(capsys):
    found = _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for section in range(1, 6):
        assert f"{section}. " in out
    assert out.rstrip().endswith("done.")
    assert found["chain_finite"] and found["chain_max"] > 88.0   # past f32's e^88
    assert found["lmme_err"] <= 1e-4 and found["lmme_log_err"] <= 1e-4


def test_lyapunov_example_matches_jax_on_the_same_jacobians(monkeypatch, capsys):
    """The example's rollout is swapped for JAX's Jacobians: its parallel
    spectrum equals JAX's ``spectrum_parallel`` on them within 1e-3."""
    steps, chunk = 512, 64
    jacs = {name: np.asarray(jlyap.trajectory_and_jacobians(sys_, steps)[1])
            for name, sys_ in jlyap.SYSTEMS.items()}
    assert set(jacs) == set(lyapunov.SYSTEMS)
    mod = _example("lyapunov_spectra_torch")
    monkeypatch.setattr(mod, "trajectory_and_jacobians", lambda system, n, device: (
        None, torch.tensor(jacs[system.name])))
    out = mod.main(["--steps", str(steps), "--chunk", str(chunk), "--device", "cpu"])
    printed = capsys.readouterr().out
    for name, js in jacs.items():
        sys_ = jlyap.SYSTEMS[name]
        want = jax.jit(lambda j: jlyap.spectrum_parallel(j, sys_.dt, chunk_size=chunk))(js)
        np.testing.assert_allclose(out[name]["par"], np.sort(np.asarray(want))[::-1],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(out[name]["par"], out[name]["seq"], rtol=1e-3, atol=1e-3)
        assert np.isfinite(out[name]["lle"]) and f"{name} ({steps} steps" in printed


@pytest.mark.parametrize("arch", ["olmo-1b", "goom-rnn-124m"])
def test_serve_example_serves_every_client_and_matches_generate(arch, capsys):
    out = _example("serve_lm_torch").main(
        ["--arch", arch, "--requests", "4", "--tokens", "12", "--device", "cpu"])
    for i, (toks, reason, _) in enumerate(out["http"]):
        assert reason == "length" and len(toks) == max(2, 12 - 4 * i)
    assert out["rows"] == [0, 3] and out["generated"].shape == (4, 12)
    for i in out["rows"]:
        assert out["batch"][i].tolist() == out["prompts"][i]
        toks = out["http"][i][0]
        assert out["generated"][i, :len(toks)].tolist() == toks
    assert "/status: 4 finished" in capsys.readouterr().out
