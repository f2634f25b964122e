"""The port's slice end to end against the JAX package, on the CPU.

The same JSON documents go through both CLIs' `run()`: corpus examples 1,
1-1 and 8 (dense Newton) and two cross-braced grids above the dense limit
(banded Newton with the fused PCG inner solve, which runs the kernels'
twins on the CPU).  The parser, the dense
assembly and the reactions are compared on the corpus documents one by
one.  Then the CLI contract
(errors, exit codes) and the rule that the port never imports JAX.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.examples_grid import grid_document  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"


def run_both(tmp_path, name, doc=None):
    """Run one document through the JAX CLI and the port's CLI (CPU)."""
    outs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        dst = d / name
        if doc is None:
            shutil.copy(CORPUS / name, dst)
        else:
            dst.write_text(json.dumps(doc))
        if tag == "jax":
            outs.append(jax_cli.run(str(dst)))
        else:
            outs.append(torch_cli.run(str(dst), device="cpu"))
        assert (d / name.replace(".json", ".res.json")).exists()
    return outs


@pytest.mark.parametrize("name,expected", [
    ("example1.json", [0, 0, 1, 0, 2, 0, 3, 0]),
    ("example1-1.json", [0, 0, 1, 0]),
    ("example8.json", [0, 0, 1, 0, 2, 0, 3, 0]),   # full-nr -> NR
])
def test_corpus_dense_newton_matches_jax(tmp_path, name, expected):
    j, t = run_both(tmp_path, name)
    assert t["converged"] is True and j["converged"] is True
    assert t["iterations"] == j["iterations"] == 1
    # _ANALYTIC bound of tests/test_examples_e2e.py:29-31.
    np.testing.assert_allclose(t["displacements"], expected, atol=2e-5)
    np.testing.assert_allclose(t["displacements"], j["displacements"],
                               atol=2e-5)
    np.testing.assert_allclose(t["reactions"], j["reactions"], atol=2e-5)
    tj, tt = j["history"][-1], t["history"][-1]
    for key in ("load_factor", "iterations", "converged"):
        assert tt[key] == tj[key], key
    # Residual and strain are float32 results of differently ordered sums.
    assert tt["residual"] <= 1e-6
    np.testing.assert_allclose(tt["max_strain"], tj["max_strain"], rtol=1e-5)


@pytest.mark.parametrize("name", ["example1.json", "example1-1.json",
                                  "example8.json", "example2.json"])
def test_parse_assemble_reactions_match_jax(name):
    """parse_problem_file, the dense assembly and reactions_of against the
    JAX package on each document, at a seeded random displacement."""
    from pinn_fem_tpu.io.schema import parse_problem_file as j_parse
    from pinn_fem_tpu.ops.assembly import assemble_system as j_assemble
    from pinn_fem_tpu.solvers.phases import reactions_of as j_reactions
    from pinn_fem_tpu_torch.io.schema import parse_problem_file
    from pinn_fem_tpu_torch.ops.assembly import assemble_system
    from pinn_fem_tpu_torch.solvers.phases import reactions_of

    jp, tp = j_parse(CORPUS / name), parse_problem_file(CORPUS / name)
    for key in ("nodes", "elements", "loads", "fixed_dofs", "dimension"):
        np.testing.assert_array_equal(getattr(tp.problem, key),
                                      getattr(jp.problem, key), key)
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)
    for key in ("measured_disp", "measured_dofs"):
        want, got = getattr(jp, key), getattr(tp, key)
        assert (got is None) == (want is None), key
        if want is not None:
            np.testing.assert_array_equal(got, want, key)

    import jax.numpy as jnp

    jd = jp.problem.to_device(use_native=False)
    td = tp.problem.to_device("cpu")
    u = (np.random.default_rng(5).normal(size=tp.problem.ndof)
         * 1e-3).astype(np.float32)
    k_j, f_j, s_j = j_assemble(jd, jp.problem.material, jnp.asarray(u), 0.7)
    k_t, f_t, s_t = assemble_system(td, tp.problem.material,
                                    torch.from_numpy(u), 0.7)
    for got, want in ((k_t, k_j), (f_t, f_j), (s_t, s_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    r_j = np.asarray(j_reactions(jd, jp.problem.material, jnp.asarray(u), 0.7))
    r_t = reactions_of(td, tp.problem.material, torch.from_numpy(u), 0.7)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0,
                               atol=1e-6 * np.abs(r_j).max())


GRIDS = [(24, 48, 1e-4), (16, 72, 1e-4), (24, 48, 1e-5), (16, 72, 1e-5)]


@pytest.fixture(scope="module", params=GRIDS,
                ids=[f"{r}x{c}-tol{t:g}" for r, c, t in GRIDS])
def grid_case(request, tmp_path_factory):
    """A grid document and the JAX CLI's result on it (run once per case)."""
    rows, cols, tol = request.param
    doc = grid_document(rows, cols, tolerance=tol, n_increments=2)
    path = tmp_path_factory.mktemp("jax") / "grid.json"
    path.write_text(json.dumps(doc))
    return request.param, doc, jax_cli.run(str(path))


def float64_solution(doc):
    """(u, reactions) of a truss document by a float64 sparse direct solve
    (E = A = 1 as in grid_document)."""
    from pinn_fem_tpu_torch.examples_grid import (float64_solution as solve64,
                                                  float64_stiffness)

    f = np.asarray(doc["loads"], float)
    u = solve64(doc["nodes"], doc["elements"], f, doc["fixed_dofs"])
    reactions = float64_stiffness(doc["nodes"], doc["elements"]) @ u - f
    reactions[np.setdiff1d(np.arange(f.size), doc["fixed_dofs"])] = 0.0
    return u, reactions


# Bound on max|u - u_ref| / max|u_ref| (same for reactions).  On 24x48 it
# is the 1e-4 of the JAX comparison.  The 16x72 strip is slender: at the
# float32 floor of its force residual (~3-4e-5) each package's solution
# lies up to 1.8e-4 from the float64 solution, and the two up to 2.7e-4
# from each other (measured on this mesh at both tolerances; PERF.md lists
# the readings), so no two float32 solvers agree to 1e-4 there; its bound
# is 5e-4, against the float64 solution and between the packages.
U_BOUND = {(24, 48): 1e-4, (16, 72): 5e-4}


def test_grid_banded_newton_matches_jax(tmp_path, grid_case):
    (rows, cols, tol), doc, j = grid_case
    path = tmp_path / "grid.json"
    path.write_text(json.dumps(doc))
    t = torch_cli.run(str(path), device="cpu")
    assert len(doc["loads"]) == 2304          # above DENSE_DOF_LIMIT
    assert t["converged"] == j["converged"] is True
    assert len(t["history"]) == len(j["history"])
    bound = U_BOUND[(rows, cols)]
    for key, ref in zip(("displacements", "reactions"), float64_solution(doc)):
        scale = np.abs(ref).max()
        for want in (np.asarray(j[key]), ref):
            np.testing.assert_allclose(t[key], want, rtol=0,
                                       atol=bound * scale)
        np.testing.assert_allclose(j[key], ref, rtol=0, atol=bound * scale)
    it_j = j["history"][-1]["iterations"]
    it_t = t["history"][-1]["iterations"]
    res_j = j["history"][-1]["residual"]
    res_t = t["history"][-1]["residual"]
    if tol == 1e-4:
        # The float32 floor of the force residual (~2-5e-5 here) lies below
        # tol: Newton stops on the tolerance, after the same steps.
        assert it_t == it_j
        assert res_t <= tol and res_j <= tol
    else:
        # tol = 1e-5 lies below that floor, and the inner PCG tolerance
        # (1e-6) below the PCG's own: both packages run each PCG to its
        # float32 breakdown point and stop Newton on the first step that
        # fails to lower the residual, accepted under sqrt(tol).  Where
        # that happens rides on the last bits of each PCG solution (the
        # JAX package's own XLA and Pallas PCG stop at 180 and 157
        # iterations on the 16x72 grid at 1e-6), so the Newton counts
        # (JAX: 3 on 24x48, 4 on 16x72) may differ by the one step that
        # was or was not rejected; the stall acceptance must hold for both.
        # On 24x48 both stop after the same steps (3); the slender 16x72
        # strip is where the one-step difference shows.
        assert tol < res_t <= tol ** 0.5 and tol < res_j <= tol ** 0.5
        if (rows, cols) == (24, 48):
            assert it_t == it_j
        assert abs(it_t - it_j) <= 1
        assert 2 <= it_t < doc["solver_config"]["max_iterations"]


def run_main(tmp_path, monkeypatch, name, text, device="cpu"):
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", device)
    path = tmp_path / name
    path.write_text(text)
    rc = torch_cli.main([str(path)])
    return rc, (tmp_path / name.replace(".json", ".log")).read_text()


def test_cli_usage_without_arguments(capsys):
    assert torch_cli.main([]) == 1
    assert "Usage" in capsys.readouterr().out


def test_cli_malformed_json_exits_1(tmp_path, monkeypatch):
    rc, log = run_main(tmp_path, monkeypatch, "bad.json", "{not json")
    assert rc == 1 and "[ERROR]" in log


def test_cli_element_document_not_yet_ported(tmp_path, monkeypatch):
    doc = {"element_type": "solid", "nodes": [[0, 0, 0], [1, 0, 0],
                                              [0, 1, 0], [0, 0, 1]],
           "elements": [[0, 1, 2, 3]]}
    rc, log = run_main(tmp_path, monkeypatch, "solid.json", json.dumps(doc))
    assert rc == 1 and "[ERROR]" in log and "not yet ported" in log
    assert "ROADMAP item 19" in log


def test_cli_example1_writes_result(tmp_path, monkeypatch):
    rc, log = run_main(tmp_path, monkeypatch, "example1.json",
                       (CORPUS / "example1.json").read_text())
    assert rc == 0 and "[SUCCESS]" in log
    out = json.loads((tmp_path / "example1.res.json").read_text())
    assert set(out) >= {"success", "converged", "iterations",
                        "displacements", "reactions", "history"}
    np.testing.assert_allclose(out["displacements"], [0, 0, 1, 0, 2, 0, 3, 0],
                               atol=2e-5)


def test_cli_cuda_without_card_is_an_error(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, log = run_main(tmp_path, monkeypatch, "example1.json",
                       (CORPUS / "example1.json").read_text(), device="cuda")
    assert rc == 1 and "[ERROR]" in log and "cuda" in log
    assert not (tmp_path / "example1.res.json").exists()


@pytest.mark.parametrize("doc,item", [
    ({"analysis": {"type": "identification"}}, "ROADMAP item 23"),
])
def test_unported_documents_name_their_roadmap_item(tmp_path, doc, item):
    base = json.loads((CORPUS / "example1.json").read_text())
    base.update(doc)
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(base))
    with pytest.raises(NotImplementedError, match=item):
        torch_cli.run(str(path), device="cpu")


def test_banded_newton_solves_with_the_fused_pcg(monkeypatch):
    """The banded Newton core's inner solve is the fused PCG entry point,
    on every device (on the CPU it runs the kernels' twins)."""
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import kernels
    from pinn_fem_tpu_torch.solvers.newton import solve_nr

    calls = []
    fused = kernels.fused_cg_solve

    def counting(*args, **kwargs):
        calls.append(args[2].device)
        return fused(*args, **kwargs)

    monkeypatch.setattr(kernels, "fused_cg_solve", counting)
    res = solve_nr(grid_problem(4, 8), linear_solver="cg-dia", device="cpu")
    assert res.converged and calls
    assert all(d.type == "cpu" for d in calls)


def test_unknown_preconditioner_raises():
    """dia_cg_solve and the banded Newton take "jacobi" and "mg" (and
    solve_nr "auto"); any other preconditioner raises ValueError."""
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
    from pinn_fem_tpu_torch.ops.dia import (assemble_dia, dia_cg_solve,
                                            dia_layout)
    from pinn_fem_tpu_torch.solvers.newton import solve_nr

    p = grid_problem(3, 4)
    data = p.to_device("cpu")
    layout = dia_layout(data.dof_map.numpy(), p.ndof)
    diags = assemble_dia(layout, stiffness_coefficients(data, p.material),
                         data.gvec)
    with pytest.raises(ValueError, match="unknown preconditioner 'ilu'"):
        dia_cg_solve(layout, diags, data.loads, data.free_mask,
                     precond="ilu")
    with pytest.raises(ValueError, match="unknown preconditioner 'ilu'"):
        solve_nr(p, linear_solver="cg-dia", cg_precond="ilu", device="cpu")


def test_port_never_imports_jax(tmp_path):
    shutil.copy(CORPUS / "example1.json", tmp_path / "example1.json")
    # Every module of the port (the API CLIs, legacy and scalar solvers
    # included) is imported, then the CLI runs.
    code = ("import importlib, pkgutil, sys, pinn_fem_tpu_torch\n"
            "for m in pkgutil.walk_packages(pinn_fem_tpu_torch.__path__,\n"
            "                               'pinn_fem_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'pinn_fem_tpu_torch.cli.api_pinn_nr' in sys.modules\n"
            "from pinn_fem_tpu_torch.cli.generic import main\n"
            f"rc = main([{str(tmp_path / 'example1.json')!r}])\n"
            "print('RESULT', rc, 'jax' in sys.modules,"
            " 'pinn_fem_tpu' in sys.modules)\n")
    env = dict(os.environ, PINN_FEM_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "RESULT 0 False False" in proc.stdout
