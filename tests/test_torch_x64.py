"""The port's float64 opt-in and its parsed-document meta against the JAX
package, on the CPU.

PINN_FEM_TPU_X64=1 makes the JAX package compute in float64
(pinn_fem_tpu/utils/runtime.py); the port reads the same variable at each
`default_dtype()` call, draws its NN weights as jax.random's float64
uniform does, and runs its Adam and tolerances in the state's dtype.  The
JAX side runs under `jax.enable_x64(True)`, a context that leaves the
rest of the process in float32.  On a card the CUDA kernels refuse
float64 (tests/test_torch_cuda.py holds that).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
import pinn_fem_tpu_torch as T  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.utils import prng  # noqa: E402
from pinn_fem_tpu_torch.utils.runtime import (X64_VARIABLE,  # noqa: E402
                                              default_dtype)

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"
CORPUS_NAMES = sorted(p.name for p in CORPUS.glob("example*.json"))

# Port vs JAX, both in float64: u within 1e-10 of max |u| (measured: 0 on
# example1, 1.5e-16 on example2 and example7-P), the same iteration
# counts; NN parameters within 1e-10 of their largest entry (measured
# 1.9e-14; `tests/measure_torch_agreement.py x64`).
X64_RTOL = 1e-10


@pytest.fixture()
def x64(monkeypatch):
    monkeypatch.setenv(X64_VARIABLE, "1")
    with jax.enable_x64(True):
        yield


# --- fault 3.12: ParsedProblem.meta -----------------------------------------


def meta_documents():
    docs = {name: json.loads((CORPUS / name).read_text())
            for name in CORPUS_NAMES}
    docs["thermal_grid"] = eg.thermal_grid_document(4, 8)
    docs["analysis"] = dict(docs["example1.json"],
                            analysis={"type": "modal", "n_modes": 2},
                            description="modal check")
    return docs


def test_corpus_has_eighteen_documents():
    assert len(CORPUS_NAMES) == 18


@pytest.mark.parametrize("name", sorted(meta_documents()))
def test_parsed_meta_matches_jax(name):
    doc = meta_documents()[name]
    meta = parse_problem_dict(doc).meta
    assert meta == j_parse(doc).meta
    assert set(meta) == {"solver_type", "description", "analysis", "thermal"}


def test_cli_routes_on_parsed_meta(tmp_path, monkeypatch):
    """The CLI reads the analysis block from the parsed meta, as the JAX
    CLI does: a parse that sets it routes the document, whatever the raw
    JSON says."""
    from pinn_fem_tpu_torch.io import schema

    inner = schema.parse_problem_dict

    def with_analysis(raw, seed=0):
        parsed = inner(raw, seed=seed)
        parsed.meta["analysis"] = {"type": "identification"}
        return parsed

    monkeypatch.setattr(torch_cli, "parse_problem_dict", with_analysis)
    path = tmp_path / "example1.json"
    path.write_text((CORPUS / "example1.json").read_text())
    with pytest.raises(NotImplementedError, match="ROADMAP item 23"):
        torch_cli.run(str(path), device="cpu")


# --- fault 3.11: the float64 opt-in -----------------------------------------


def test_default_dtype_reads_the_variable_at_call_time(monkeypatch):
    monkeypatch.delenv(X64_VARIABLE, raising=False)
    assert default_dtype() == torch.float32
    monkeypatch.setenv(X64_VARIABLE, "1")
    assert default_dtype() == torch.float64
    monkeypatch.setenv(X64_VARIABLE, "0")
    assert default_dtype() == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2001, 123456789])
@pytest.mark.parametrize("shape,fan_in", [((3, 20), 3), ((20,), 3),
                                          ((20, 15), 20), ((10, 1), 10)])
def test_float64_uniform_bit_equal_to_jax(seed, shape, fan_in):
    bound = 1.0 / np.sqrt(fan_in)
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.uniform(keys[1], shape, jnp.float64,
                                             -bound, bound))
    got = prng.uniform(prng.split(prng.PRNGKey(seed), 3)[1], shape, -bound,
                       bound, np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_float64_mlp_field_bit_equal_to_jax(x64):
    want = J.make_mlp_field(jax.random.PRNGKey(7), 2, 15, input_dim=3,
                            scale=2.5)
    got = T.make_mlp_field(prng.PRNGKey(7), 2, 15, input_dim=3, scale=2.5)
    assert got.scale.dtype == torch.float64
    for (wj, bj), (wt, bt) in zip(want.layers, got.layers):
        assert wt.dtype == torch.float64
        assert np.array_equal(np.asarray(wj), wt.numpy())
        assert np.array_equal(np.asarray(bj), bt.numpy())


def run_both(tmp_path, name, doc=None):
    """One document through both CLIs' run() (the port on the CPU)."""
    text = json.dumps(doc) if doc else (CORPUS / f"{name}.json").read_text()
    src = tmp_path / f"{name}.json"
    src.write_text(text)
    j = jax_cli.run(str(src), str(tmp_path / "jax.res.json"))
    t = torch_cli.run(str(src), str(tmp_path / "port.res.json"),
                      device="cpu")
    return j, t


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("name", ["example1", "example2", "example7-P"])
def test_float64_corpus_matches_jax(tmp_path, x64, name):
    """example1 (nr, dense), example2 (scalar gd) and example7-P (hybrid,
    three NN fields from the float64 draw), both packages in float64."""
    j, t = run_both(tmp_path, name)
    assert t["iterations"] == j["iterations"]
    assert t["converged"] is j["converged"] is True
    assert rel_err(j["displacements"], t["displacements"]) <= X64_RTOL
    assert rel_err(j["reactions"], t["reactions"]) <= X64_RTOL
    for key, value in (j.get("nn_parameters") or {}).items():
        assert rel_err(value, t["nn_parameters"][key]) <= X64_RTOL, key


def test_float64_state_everywhere_on_the_cpu(x64):
    parsed = parse_problem_dict(json.loads(
        (CORPUS / "example7-P.json").read_text()))
    data = parsed.problem.to_device("cpu")
    assert data.loads.dtype == data.gvec.dtype == torch.float64
    field = parsed.problem.material.young
    assert all(w.dtype == torch.float64 for w, _ in field.layers)
    result = T.solve_gd(parsed.problem, parsed.config.with_(
        max_iterations=3), parsed.measured_disp, parsed.measured_dofs,
        device="cpu")
    assert result.displacements.dtype == np.float64


def test_float64_banded_newton_on_the_cpu(x64):
    """Above the dense limit the CPU runs the banded Newton in float64:
    the fused PCG's twins keep the kernels' float32 loop state, so float64
    takes the plain recurrence.  u lies within 1e-8 of the float64 scipy
    solve (float32 reaches 3.9e-5 at 40k DOFs)."""
    nodes, elements, loads, fixed = eg.grid_arrays(24, 48)
    problem = eg.grid_problem(24, 48)
    assert problem.ndof > 2048
    result = T.solve_nr(problem, T.SolverConfig(tolerance=1e-12,
                                                max_iterations=10),
                        device="cpu")
    u = result.displacements.reshape(-1)
    u_ref = eg.float64_solution(nodes, elements, loads, fixed)
    assert rel_err(u_ref, u) <= 1e-8


def test_without_the_variable_the_port_stays_float32(monkeypatch):
    monkeypatch.delenv(X64_VARIABLE, raising=False)
    parsed = parse_problem_dict(json.loads(
        (CORPUS / "example7-P.json").read_text()))
    assert parsed.problem.to_device("cpu").loads.dtype == torch.float32
    assert parsed.problem.material.young.layers[0][0].dtype == torch.float32
