"""The corpus documents of the continuum explicit elastoplastic transients
(dyn-solid-transient-plastic.json, dyn-plane-transient-plastic.json)
through the port's CLI and the JAX package's on the CPU, both on the
float64 tier: every result value within F64_RTOL (the largest difference
over the largest JAX value), the summary lines, and the residual closed
form the documents are built on.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402

from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# The float64 tier: measured up to 3.4e-13 (velocities).
F64_RTOL = 1e-10
CPU = "cpu"


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def corpus_runs(tmp_path_factory):
    """{name: (JAX CLI result, port CLI result, both logs)} of the corpus
    plastic transients through both CLIs on the CPU."""
    runs = {}
    for name in ("dyn-solid-transient-plastic.json",
                 "dyn-plane-transient-plastic.json"):
        doc = (CORPUS / name).read_text()
        outs, logs = [], []
        for cli, sub in ((jax_cli, "jax"), (torch_cli, "torch")):
            d = tmp_path_factory.mktemp(sub)
            (d / name).write_text(doc)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("PINN_FEM_TORCH_DEVICE", CPU)
                assert cli.main([str(d / name)]) == 0
            outs.append(json.loads((d / name.replace(".json", ".res.json"))
                                   .read_text()))
            logs.append((d / name.replace(".json", ".log")).read_text())
            logging.getLogger("pinn_fem_tpu").handlers.clear()
        runs[name] = (*outs, logs)
    return runs


@pytest.mark.parametrize("name", ["dyn-solid-transient-plastic.json",
                                  "dyn-plane-transient-plastic.json"])
def test_corpus_documents_through_both_clis(name, corpus_runs):
    """The corpus plastic transients through both CLIs (the float64 tier):
    the same keys and values at F64_RTOL, and the ANALYSIS SUMMARY line
    with the plastic work."""
    want, got, logs = corpus_runs[name]
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, dict):
            for sub, v in value.items():
                assert rel_err(got[key][sub], v) <= F64_RTOL, (key, sub)
        elif isinstance(value, (list, float)) and value != []:
            assert rel_err(got[key], value) <= F64_RTOL, key
        else:
            assert got[key] == value, key
    for log in logs:
        assert "plastic work" in log


@pytest.mark.parametrize("name, tip", [
    ("dyn-solid-transient-plastic.json", (-1, 0.4)),
    ("dyn-plane-transient-plastic.json", (-2, 0.8))])
def test_energy_balance_and_residual_state(name, tip, corpus_runs):
    """The corpus trapezoid load, yield and unload under mass damping:
    KE + SE + W_p never above W_ext (the damping dissipates the rest; 2e-2
    of its largest value), alpha = (16 - 12) / 20 = 0.2 in every element
    at the end and the stress-free tip at L alpha (the residual closed
    form)."""
    _, out, _ = corpus_runs[name]
    assert np.allclose(out["final"]["eq_plastic_strain"], 0.2, atol=2e-3)
    column, value = tip
    assert abs(out["displacements"][-1][column] - value) <= 1e-2 * value
    ke, se, wp, we = (np.asarray(out[k]) for k in (
        "kinetic_energy", "strain_energy", "plastic_work", "external_work"))
    assert np.all(ke + se + wp <= we + 2e-2 * np.abs(we).max())


