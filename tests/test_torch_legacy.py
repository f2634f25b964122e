"""The port's legacy solvers, scalar identification and the four JSON API
CLIs against the JAX package, on the CPU.

The cases are those of tests/test_legacy_and_gn.py and the legacy cases of
tests/test_cli.py, run through both packages on the same inputs: NN
weights are drawn by jax.random and carried over with
`material_from_numpy`.  The JAX package runs in-process; the port's CLIs
also run as processes (argv, exit codes, error JSON, the timestamped
log), with PINN_FEM_TORCH_DEVICE=cpu.

Bounds, from the measured port-vs-JAX gaps (float32;
`tests/measure_torch_agreement.py legacy` prints them):
  * incremental Newton u and reactions: 0 on the chain, 7.4e-8 of max |u|
    on the 4 x 8 PINN grid with three frozen MLP fields; the iteration
    count of one grid increment differs by 1 where JAX's relative du
    lands at 8e-7 against tol 1e-6 (the float32 floor), so counts are
    held equal on the chain and within 1 on the grid;
  * legacy GD: the first history row 1.0e-7 of each column's largest
    value, 300 rows 7.4e-7, u 3.3e-7, NN parameters 5.2e-7 (PR 9's GD
    bound, 1e-4, holds them);
  * Gauss-Newton (solve_pinn_newton_raphson): the same row count, rows
    7.5e-7, u 0;
  * scalar identification: GN E*A within 1e-6 of JAX's (measured 6e-8),
    the same row count; GD E*A within 1e-5 (4.2e-7 after 2000 Adam steps)
    and the first row 1e-6 (0).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
from pinn_fem_tpu.cli import _api_common as j_api  # noqa: E402
from pinn_fem_tpu.cli import api_fem_solver as j_fem  # noqa: E402
from pinn_fem_tpu.cli import api_pinn_gd as j_pinn_gd  # noqa: E402
from pinn_fem_tpu.cli import api_pinn_nr as j_pinn_nr  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.solvers import scalar_inverse as j_scalar  # noqa: E402
import pinn_fem_tpu_torch as T  # noqa: E402
from pinn_fem_tpu_torch.cli import _api_common as t_api  # noqa: E402
from pinn_fem_tpu_torch.cli import api_fem_solver as t_fem  # noqa: E402
from pinn_fem_tpu_torch.cli import api_pinn_gd as t_pinn_gd  # noqa: E402
from pinn_fem_tpu_torch.cli import api_pinn_nr as t_pinn_nr  # noqa: E402
from pinn_fem_tpu_torch.cli import legacy_generic  # noqa: E402
from pinn_fem_tpu_torch.examples_grid import pinn_grid_document  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import material_kernel  # noqa: E402
from pinn_fem_tpu_torch.solvers import legacy  # noqa: E402
from pinn_fem_tpu_torch.solvers import scalar_inverse  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"

NEWTON_RTOL = 1e-5
GD_FIRST_ROW_RTOL = 1e-5
GD_RTOL = 1e-4
GN_RTOL = 1e-4
SCALAR_GN_EA_RTOL = 1e-6
SCALAR_GD_EA_RTOL = 1e-5
# The CLIs' stresses and strains come from u on the host in float64, so
# they inherit u's bound.
API_RTOL = 1e-4

MEASURED = {"measured_disp": np.array([1.0, 2.0, 3.0]),
            "measured_dofs": np.array([2, 4, 6])}


def chain_problem(M, material=None):
    material = material or M.Material(young=1.0, area=1.0, density=1.0)
    return M.TrussProblem(
        nodes=np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]]),
        elements=np.array([[0, 1], [1, 2], [2, 3]]),
        material=material,
        loads=np.array([0, 0, 0, 0, 0, 0, 1.0, 0]),
        fixed_dofs=np.array([0, 1, 3, 5, 7]),
        dimension=2,
    )


def nn_material(seed=0, width=8):
    """tests/test_legacy_and_gn.py's NN material: one MLP field
    (input_dim 3) and two scalars, so it takes the torch form."""
    return J.Material(
        young=J.make_mlp_field(jax.random.PRNGKey(seed), 1, width,
                               input_dim=3, scale=1.0),
        area=J.to_field(1.0), density=J.to_field(1.0))


def leaves(field):
    if isinstance(field, J.ScalarField):
        return np.asarray(field.value)
    return {"layers": [(np.asarray(w), np.asarray(b))
                       for w, b in field.layers],
            "scale": np.asarray(field.scale), "input_dim": field.input_dim,
            "enforce_positive": field.enforce_positive}


def carried(material):
    """The port's copy of a JAX material."""
    return T.material_from_numpy(leaves(material.young),
                                 leaves(material.area),
                                 leaves(material.density))


def both_chains(material=None):
    if material is None:
        return chain_problem(J), chain_problem(T)
    return chain_problem(J, material), chain_problem(T, carried(material))


def grid_both(rows=4, cols=8):
    """The PINN grid (three MLP fields of input_dim 3: kernel 4's
    dispatch) parsed by both packages, the port on JAX's weights."""
    doc = pinn_grid_document(rows, cols)
    jp, tp = j_parse(doc), parse_problem_dict(doc)
    tp.problem.material = carried(jp.problem.material)
    return jp, tp


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def rows_err(hj, ht) -> float:
    """Largest |difference| over each column's largest |value|."""
    assert [set(e) for e in ht] == [set(e) for e in hj]
    keys = sorted(hj[0])
    a = np.array([[e[k] for k in keys] for e in hj], float)
    b = np.array([[e[k] for k in keys] for e in ht], float)
    scale = np.maximum(np.abs(a).max(axis=0), 1e-30)
    return float((np.abs(a - b).max(axis=0) / scale).max())


@pytest.fixture()
def dispatch_calls(monkeypatch):
    """Counts calls of kernel 4's dispatch (its twin on the CPU)."""
    calls = []
    inner = material_kernel.fused_material_coefficients

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    from pinn_fem_tpu_torch.ops import assembly
    monkeypatch.setattr(assembly, "fused_material_coefficients", counted)
    return calls


# --- solve_incremental_newton -----------------------------------------------


@pytest.mark.parametrize("kind", ["scalar", "frozen_nn"])
def test_incremental_newton_matches_jax(kind):
    pj, pt = both_chains(nn_material() if kind == "frozen_nn" else None)
    rj = J.solve_incremental_newton(pj, J.LegacySolverConfig())
    rt = T.solve_incremental_newton(pt, T.LegacySolverConfig(), device="cpu")
    assert rt.converged is rj.converged is True
    assert len(rt.history) == 10
    assert [set(e) for e in rt.history] == [set(e) for e in rj.history]
    for ej, et in zip(rj.history, rt.history):
        for key in ("increment", "load_factor", "iterations", "converged"):
            assert et[key] == ej[key], key
    assert rel_err(rj.displacements, rt.displacements) <= NEWTON_RTOL
    assert rel_err(rj.reactions, rt.reactions) <= NEWTON_RTOL
    if kind == "scalar":
        np.testing.assert_allclose(rt.displacements[:, 0], [0, 1, 2, 3],
                                   atol=2e-5)
        assert rt.reactions[0, 0] == pytest.approx(-1.0, abs=1e-5)
    else:
        assert 1.5 < rt.displacements[-1, 0] < 2.95


def test_incremental_newton_frozen_fields_take_kernel_dispatch(
        dispatch_calls):
    """Three frozen MLP fields: every assembly (each Newton iteration and
    the final reactions) evaluates them through kernel 4's dispatch."""
    jp, tp = grid_both()
    cfg = dict(n_increments=3)
    rj = J.solve_incremental_newton(jp.problem, J.LegacySolverConfig(**cfg))
    rt = T.solve_incremental_newton(tp.problem, T.LegacySolverConfig(**cfg),
                                    device="cpu")
    newton = sum(int(e["iterations"]) for e in rt.history)
    assert len(dispatch_calls) == newton + 1
    assert rt.converged is rj.converged is True
    assert [e["load_factor"] for e in rt.history] == \
        [e["load_factor"] for e in rj.history]
    assert all(abs(ej["iterations"] - et["iterations"]) <= 1
               for ej, et in zip(rj.history, rt.history))
    assert rel_err(rj.displacements, rt.displacements) <= NEWTON_RTOL
    assert rel_err(rj.reactions, rt.reactions) <= NEWTON_RTOL


def test_incremental_newton_singular_tangent_raises():
    problem = T.TrussProblem(
        nodes=np.array([[0.0, 0.0], [1.0, 0.0]]), elements=np.array([[0, 1]]),
        material=T.Material(young=1.0, area=1.0, density=1.0),
        loads=np.array([0.0, 0.0, 1.0, 0.0]), fixed_dofs=np.array([0, 1]),
        dimension=2)
    with pytest.raises(RuntimeError, match="singular"):
        T.solve_incremental_newton(problem, device="cpu")


# --- solve_pinn_gradient_descent --------------------------------------------


@pytest.mark.parametrize("measured", [True, False])
def test_legacy_pinn_gd_matches_jax(measured):
    pj, pt = both_chains(nn_material())
    kw = MEASURED if measured else {}
    cfg = dict(max_iterations=300, learning_rate_u=0.01,
               learning_rate_theta=1e-3)
    rj = J.solve_pinn_gradient_descent(
        pj, pj.loads, config=J.PINNGradientDescentConfig(**cfg), **kw)
    rt = T.solve_pinn_gradient_descent(
        pt, pt.loads, config=T.PINNGradientDescentConfig(**cfg),
        device="cpu", **kw)
    assert set(rt.history[0]) == {"iteration", "loss_total", "loss_physics",
                                  "loss_data", "u_norm"}
    assert len(rt.history) == len(rj.history) == 300
    assert rt.converged is rj.converged
    assert rows_err(rj.history[:1], rt.history[:1]) <= GD_FIRST_ROW_RTOL
    assert rows_err(rj.history, rt.history) <= GD_RTOL
    assert rel_err(rj.displacements, rt.displacements) <= GD_RTOL
    assert set(rt.nn_parameters) == set(rj.nn_parameters)
    for key, value in rj.nn_parameters.items():
        assert rt.nn_parameters[key].shape == value.shape
        assert rel_err(value, rt.nn_parameters[key]) <= GD_RTOL
    if not measured:
        assert all(e["loss_data"] == 0.0 for e in rt.history)
    # theta written back into the problem's material
    w = pt.material.young.layers[0][0].detach().numpy()
    np.testing.assert_array_equal(w.T, rt.nn_parameters["param_0"])


def test_legacy_pinn_gd_contract():
    """tests/test_legacy_and_gn.py's case: the gate after iteration 10 and
    the fit to the measurements."""
    _, pt = both_chains(nn_material())
    result = T.solve_pinn_gradient_descent(
        pt, pt.loads, config=T.PINNGradientDescentConfig(
            max_iterations=3000, learning_rate_u=0.01,
            learning_rate_theta=1e-3, tolerance=1e-4),
        device="cpu", **MEASURED)
    assert result.converged and len(result.history) >= 12
    assert result.nn_parameters
    np.testing.assert_allclose(result.displacements[1:, 0], [1, 2, 3],
                               atol=5e-2)


def test_legacy_pinn_gd_three_fields_take_the_kernel_dispatch(
        dispatch_calls):
    """The PINN grid: one kernel-4 evaluation per GD iteration (its
    backward is kernel 4b's twin), rows against JAX's."""
    jp, tp = grid_both()
    cfg = dict(max_iterations=40, learning_rate_u=1e-3,
               learning_rate_theta=1e-3, tolerance=0.0)
    rj = J.solve_pinn_gradient_descent(
        jp.problem, jp.problem.loads, jp.measured_disp, jp.measured_dofs,
        J.PINNGradientDescentConfig(**cfg))
    rt = T.solve_pinn_gradient_descent(
        tp.problem, tp.problem.loads, tp.measured_disp, tp.measured_dofs,
        T.PINNGradientDescentConfig(**cfg), device="cpu")
    assert len(dispatch_calls) == len(rt.history) == 40
    assert rows_err(rj.history[:1], rt.history[:1]) <= GD_FIRST_ROW_RTOL
    assert rows_err(rj.history, rt.history) <= GD_RTOL
    assert rel_err(rj.displacements, rt.displacements) <= GD_RTOL


def test_legacy_pinn_gd_requires_nn():
    _, pt = both_chains()
    with pytest.raises(ValueError, match="trainable"):
        T.solve_pinn_gradient_descent(pt, pt.loads, device="cpu")


# --- solve_pinn_newton_raphson ----------------------------------------------


def test_legacy_pinn_newton_raphson_matches_jax():
    pj, pt = both_chains(nn_material(seed=3))
    loads = pt.loads.copy()
    cfg = dict(max_iterations=50, alpha_physics=0.1, alpha_data=10.0)
    rj = J.solve_pinn_newton_raphson(pj, pj.loads,
                                     config=J.PINNSolverConfig(**cfg),
                                     **MEASURED)
    rt = T.solve_pinn_newton_raphson(pt, pt.loads,
                                     config=T.PINNSolverConfig(**cfg),
                                     device="cpu", **MEASURED)
    assert set(rt.history[0]) == {"iteration", "r_physics", "r_data",
                                  "r_total", "relative_error", "step_size"}
    assert len(rt.history) == len(rj.history) <= 50
    assert rt.converged is rj.converged
    assert rows_err(rj.history, rt.history) <= GN_RTOL
    assert rel_err(rj.displacements, rt.displacements) <= GN_RTOL
    np.testing.assert_allclose(rt.displacements[1:, 0], [1, 2, 3], atol=1e-2)
    np.testing.assert_array_equal(pt.loads, loads)


def test_legacy_pinn_newton_raphson_restores_loads_on_error(monkeypatch):
    _, pt = both_chains(nn_material(seed=3))
    loads = pt.loads

    def fails(problem, *args, **kwargs):
        assert np.array_equal(problem.loads, 2.0 * loads)
        raise RuntimeError("solver failed")

    monkeypatch.setattr(legacy, "solve_gauss_newton", fails)
    with pytest.raises(RuntimeError, match="solver failed"):
        T.solve_pinn_newton_raphson(pt, 2.0 * loads, device="cpu")
    assert pt.loads is loads


# --- scalar identification ---------------------------------------------------


def si_problem(M, young=100e9, area=0.01):
    mat = M.Material(young=M.to_field(young), area=M.to_field(area),
                     density=M.to_field(0.0))
    return M.TrussProblem(nodes=np.array([[0.0, 0.0], [1.0, 0.0]]),
                          elements=np.array([[0, 1]]), material=mat,
                          loads=np.array([0.0, 0.0, 1e6, 0.0]),
                          fixed_dofs=np.array([0, 1, 3]), dimension=2)


SI = dict(u_measured=np.array([5e-4]), measured_dofs=np.array([2]),
          young_init=100e9, area_init=0.01)


def test_identify_scalars_gn_matches_jax():
    kw = dict(SI, max_iterations=60, tolerance=1e-10)
    pj, pt = si_problem(J), si_problem(T)
    a = j_scalar.identify_scalars_gn(pj, pj.loads, **kw)
    b = scalar_inverse.identify_scalars_gn(pt, pt.loads, device="cpu", **kw)
    ea = b["young_final"] * b["area_final"]
    assert ea == pytest.approx(2e9, rel=1e-4)
    assert ea == pytest.approx(a["young_final"] * a["area_final"],
                               rel=SCALAR_GN_EA_RTOL)
    assert b["converged"] is a["converged"]
    assert len(b["history"]) == len(a["history"])
    assert b["history"][0].keys() == {"iteration", "residual", "young",
                                      "area"}
    assert b["history"][0] == a["history"][0]
    assert rel_err(a["u_final"], b["u_final"]) <= SCALAR_GN_EA_RTOL


def test_identify_scalars_gd_matches_jax():
    kw = dict(SI, n_iterations=2000, learning_rate=3e-3, beta=1e3)
    pj, pt = si_problem(J), si_problem(T)
    a = j_scalar.identify_scalars_gd(pj, pj.loads, **kw)
    b = scalar_inverse.identify_scalars_gd(pt, pt.loads, device="cpu", **kw)
    ea = b["young_final"] * b["area_final"]
    assert ea == pytest.approx(2e9, rel=1e-2)
    assert ea == pytest.approx(a["young_final"] * a["area_final"],
                               rel=SCALAR_GD_EA_RTOL)
    assert len(b["history"]) == len(a["history"]) == 2000
    assert b["history"][0].keys() == {"iteration", "loss_total",
                                      "loss_physics", "loss_data", "young",
                                      "area"}
    assert rows_err(a["history"][:1], b["history"][:1]) <= 1e-6


def test_identify_scalars_gd_projects_onto_the_bounds():
    """The clip follows the Adam step: with a bound at the start value,
    young never leaves it."""
    pt = si_problem(T)
    out = scalar_inverse.identify_scalars_gd(
        pt, pt.loads, device="cpu", n_iterations=50, learning_rate=1e-2,
        young_bounds=(1e9, 100e9), **SI)
    assert max(e["young"] for e in out["history"]) <= 100e9 * (1 + 1e-6)
    assert out["young_final"] <= 100e9 * (1 + 1e-6)


# --- the API CLIs: parse_and_solve, port vs JAX ------------------------------


FEM_INPUT = {
    "nodes": [{"x": 0, "y": 0, "fixed": True},
              {"x": 1, "y": 0, "fixed_y": True}],
    "elements": [{"nodes": [0, 1]}],
    "material": {"young": 210e9, "area": 0.01},
    "loads": [0, 0, 1000, 0],
    "solver_config": {"max_iterations": 50, "tolerance": 1e-6},
}
SI_INPUT = dict(FEM_INPUT, material={"young": 100e9, "area": 0.01},
                loads=[0, 0, 1e6, 0], measured_disp=[5e-4],
                measured_dofs=[2])
API_CASES = {
    "api_fem_solver": (j_fem, t_fem, FEM_INPUT),
    "api_pinn_nr": (j_pinn_nr, t_pinn_nr, dict(SI_INPUT, solver_config={
        "max_iterations": 60, "tolerance": 1e-10, "lambda_lm": 1e-3})),
    "api_pinn_gd": (j_pinn_gd, t_pinn_gd, dict(SI_INPUT, solver_config={
        "max_iterations": 400, "learning_rate": 3e-3, "beta": 1e3})),
}


def api_numbers(out):
    flat = []
    for key in sorted(out):
        value = out[key]
        if isinstance(value, dict):
            flat += [value[k] for k in sorted(value)]
        elif isinstance(value, list) and value and isinstance(value[0], dict):
            flat += [e[k] for e in value for k in sorted(e)]
        elif isinstance(value, list):
            flat += value
        elif value is not None and not isinstance(value, bool):
            flat.append(value)
    return np.asarray(flat, float)


@pytest.mark.parametrize("name", sorted(API_CASES))
def test_api_parse_and_solve_matches_jax(name):
    j_mod, t_mod, payload = API_CASES[name]
    want = j_mod.parse_and_solve(json.loads(json.dumps(payload)))
    got = t_mod.parse_and_solve(json.loads(json.dumps(payload)), "cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, bool):
            assert got[key] is value, key
        elif isinstance(value, list):
            assert len(got[key]) == len(value), key
            if value and isinstance(value[0], dict):
                assert [set(e) for e in got[key]] == [set(e) for e in value]
    a, b = api_numbers(want), api_numbers(got)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(a), 1e-30)
    # each entry against itself, except entries at the float32 floor
    floor = np.abs(a) < 1e-6 * np.abs(a).max()
    assert float(np.max(np.where(floor, 0.0, np.abs(a - b) / scale))) \
        <= API_RTOL
    if name == "api_fem_solver":
        assert got["displacements"][2] == pytest.approx(1000 / 2.1e9,
                                                        rel=1e-4)
        assert len(got["convergence_history"]) == 10
    if name == "api_pinn_gd":
        assert len(got["convergence_history"]) == 40   # every 10th row
        assert got["final_loss"] == pytest.approx(want["final_loss"],
                                                  rel=API_RTOL, abs=1e-12)


def test_api_node_parsing_and_strains_equal_jax():
    """The elif quirk (fixed_x and fixed_y without "fixed" lock x only)
    and the engineering strain of the deformed geometry."""
    payload = {"nodes": [{"x": 0, "y": 0, "fixed_x": True, "fixed_y": True},
                         {"x": 1, "y": 0.5, "fixed_y": True},
                         {"x": 2, "y": 0, "fixed": True},
                         {"x": 1, "y": 1}],
               "elements": [{"nodes": [0, 1]}, {"nodes": [1, 2]},
                            {"nodes": [1, 3]}]}
    nodes, fixed = t_api.parse_nodes_2d(payload)
    j_nodes, j_fixed = j_api.parse_nodes_2d(payload)
    np.testing.assert_array_equal(fixed, j_fixed)
    np.testing.assert_array_equal(fixed, [0, 3, 4, 5])
    elements = t_api.parse_elements_obj(payload)
    u = np.random.default_rng(0).normal(scale=1e-2, size=8)
    got = t_api.element_stresses_2d(nodes, elements, u, 2e11)
    want = j_api.element_stresses_2d(j_nodes, elements, u, 2e11)
    assert got == want


def test_api_pinn_requires_measurements():
    for mod in (t_pinn_gd, t_pinn_nr):
        with pytest.raises(ValueError, match="measured_disp"):
            mod.parse_and_solve(dict(FEM_INPUT), "cpu")


# --- the four CLIs as processes (the port only) ------------------------------


def run_cli(module, args, cwd, timeout=120):
    env = dict(os.environ, PINN_FEM_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO))
    env.pop("PINN_FEM_TPU_X64", None)
    return subprocess.run(
        [sys.executable, "-m", f"pinn_fem_tpu_torch.cli.{module}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("module,payload,rc,check", [
    ("api_fem_solver", None, 1, "usage"),
    ("api_fem_solver", {"nodes": "garbage"}, 1, "error"),
    ("api_pinn_gd", FEM_INPUT, 1, "measured_disp"),
    ("api_pinn_nr", API_CASES["api_pinn_nr"][2], 0, "identified"),
])
def test_api_cli_processes(tmp_path, module, payload, rc, check):
    if payload is None:
        proc = run_cli(module, [], tmp_path)
        assert proc.returncode == rc
        assert "Usage" in proc.stdout
        return
    inp, outp = tmp_path / "in.json", tmp_path / "out.json"
    inp.write_text(json.dumps(payload))
    proc = run_cli(module, [str(inp), str(outp)], tmp_path)
    assert proc.returncode == rc, proc.stderr[-2000:]
    out = json.loads(outp.read_text())
    if rc == 1:
        assert set(out) == {"error", "type"}
        assert "Traceback" in proc.stderr
        if check == "measured_disp":
            assert "measured_disp" in out["error"]
            assert out["type"] == "ValueError"
    else:
        assert set(out) == {"displacements", "stresses", "strains",
                            "identified_params", "convergence_history",
                            "final_residual"}
        ea = out["identified_params"]["young"] * \
            out["identified_params"]["area"]
        assert ea == pytest.approx(2e9, rel=1e-3)


def test_legacy_generic_process_writes_a_timestamped_log(tmp_path):
    dst = tmp_path / "example1.json"
    dst.write_text((CORPUS / "example1.json").read_text())
    proc = run_cli("legacy_generic", [str(dst)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    logs = list(tmp_path.glob("example1_????????_??????.log"))
    assert len(logs) == 1, list(tmp_path.iterdir())
    assert re.search(r"example1_\d{8}_\d{6}\.log$", logs[0].name)
    assert not (tmp_path / "example1.log").exists()
    out = json.loads((tmp_path / "example1.res.json").read_text())
    assert out["converged"]
    np.testing.assert_allclose(out["displacements"],
                               [0, 0, 1, 0, 2, 0, 3, 0], atol=2e-5)
    assert run_cli("legacy_generic", [], tmp_path).returncode == 1


LEGACY_WEB_NN = {
    "nodes": [{"x": 0, "y": 0, "fixed": True},
              {"x": 1, "y": 0, "fixed_y": True},
              {"x": 2, "y": 0, "fixed_y": True},
              {"x": 3, "y": 0, "fixed_y": True}],
    "elements": [[0, 1], [1, 2], [2, 3]],
    "loads": [0, 0, 0, 0, 0, 0, 1.0, 0],
    "material": {"young": 1.0, "area": 1.0, "density": 1.0},
    "measured_displacements": {"nodes": [1, 2, 3], "ux": [1.0, 2.0, 3.0],
                               "uy": [0, 0, 0]},
    "nn_config": {"young": {"enabled": True, "hiddenLayers": 2,
                            "neuronsPerLayer": 8}},
    "pinn_config": {"max_iterations": 1500, "learning_rate_u": 0.01,
                    "learning_rate_theta": 1e-3, "tolerance": 1e-5},
    "solver_type": "pinn-gd",
}


def test_legacy_web_nn_flow_matches_jax(tmp_path, monkeypatch,
                                        dispatch_calls):
    """tests/test_cli.py's legacy web payload (an input_dim 1 net): the
    torch form, never kernel 4's dispatch; u within 1e-2 of [1, 2, 3] and
    the JAX CLI's iteration count."""
    dst = tmp_path / "legacy_nn.json"
    dst.write_text(json.dumps(LEGACY_WEB_NN))
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    assert legacy_generic.main([str(dst)]) == 0
    assert len(list(tmp_path.glob("legacy_nn_????????_??????.log"))) == 1
    assert dispatch_calls == []
    out = json.loads((tmp_path / "legacy_nn.res.json").read_text())
    u = np.asarray(out["displacements"])
    np.testing.assert_allclose(u[[2, 4, 6]], [1.0, 2.0, 3.0], atol=1e-2)
    assert "identified_properties" in out
    want = jax_cli.run(str(dst), str(tmp_path / "jax.res.json"))
    assert out["iterations"] == want["iterations"]
    assert rel_err(want["displacements"], u) <= 1e-3


def test_port_exports_the_legacy_names():
    import pinn_fem_tpu

    names = {"LegacySolverConfig", "PINNGradientDescentConfig",
             "PINNSolverConfig", "PINNSolverResult",
             "solve_incremental_newton", "solve_pinn_gradient_descent",
             "solve_pinn_newton_raphson", "to_field"}
    assert names <= set(pinn_fem_tpu.__all__)
    assert names <= set(T.__all__)
    for name in names:
        assert getattr(T, name) is not None
