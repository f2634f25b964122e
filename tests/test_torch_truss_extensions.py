"""The port's thermal loads, support settlement and Green-Lagrange Newton
against the JAX package, on the CPU, and the dense Newton's singular
tangent.

Each case gives the same inputs to both packages.  The bounds are the
gaps that `tests/measure_torch_agreement.py truss_ext` prints, times the
margin stated beside each, and never tighter than the float32 floors.
The 24 x 48 grid documents (2,304 DOFs) take the banded Newton, whose
inner PCG runs the kernels' twins here.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import pinn_fem_tpu as jp  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.ops import assembly as j_assembly  # noqa: E402
from pinn_fem_tpu.ops import elements as j_elements  # noqa: E402
from pinn_fem_tpu.ops import thermal as j_thermal  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops import assembly as t_assembly  # noqa: E402
from pinn_fem_tpu_torch.ops import elements as t_elements  # noqa: E402
from pinn_fem_tpu_torch.ops import thermal as t_thermal  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"
SINGULAR = "Tangent stiffness became singular during solve"

# f_th, port vs JAX: the JAX package scatters in float32, the port in
# float64 (ROADMAP fault 3.4); measured up to 7.8e-8 of max |f_th| (equal
# in 1D, 3D and on the ring); bound 1e-6, margin 13.
F_TH_RTOL = 1e-6
# Green-Lagrange element and assembly, port vs JAX on random elements:
# measured equal in 2D and 3D; bound 1e-5, float32 noise of another
# summation order.
GL_RTOL = 1e-5
# Banded 24 x 48 documents.  The port against float64 (scipy): measured
# up to 3.4e-5 of max |u| and 4.3e-5 of max |reaction|, held to the
# grid's 1e-4 of tests/test_torch_slice.py.  The JAX package against
# float64: 4.7e-6 (settlement only) to 9.0e-4, its float32 scatter of f_th
# and of the diagonals (fault 3.4), so port vs JAX is held to 2e-3
# (measured up to 8.7e-4; margin 2.3).
GRID_F64_RTOL = 1e-4
GRID_JAX_RTOL = 2e-3
# Dense documents (example1 heated, the settled bar, the Green-Lagrange
# grid): measured up to 2.2e-7 of the largest entry between the packages;
# bound 1e-5, margin 45.
DENSE_RTOL = 1e-5


def problems(nodes, elements, loads, fixed, dim, young=1.0, area=1.0):
    """The same truss in both packages."""
    args = (np.asarray(nodes, float), np.asarray(elements))
    j = jp.TrussProblem(*args, jp.Material(young=young, area=area,
                                           density=1.0),
                        np.asarray(loads, float), np.asarray(fixed), dim)
    t = tp.TrussProblem(*args, tp.Material(young=young, area=area,
                                           density=1.0),
                        np.asarray(loads, float), np.asarray(fixed), dim)
    return j, t


def run_both(tmp_path, name, doc):
    """run() of both CLIs on one document (the port on the CPU)."""
    outs = []
    for tag, cli in (("jax", jax_cli), ("torch", torch_cli)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        path = d / name
        path.write_text(json.dumps(doc))
        outs.append(cli.run(str(path)) if tag == "jax"
                    else cli.run(str(path), device="cpu"))
    return outs


def main_both(tmp_path, monkeypatch, name, doc):
    """main() of both CLIs: [(exit code, log text), ...] (JAX, port)."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    outs = []
    for tag, cli in (("jax", jax_cli), ("torch", torch_cli)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        path = d / name
        path.write_text(json.dumps(doc))
        rc = cli.main([str(path)])
        for lg in (logging.getLogger("pinn_fem_tpu"),
                   logging.getLogger("pinn_fem_tpu_torch")):
            for h in lg.handlers:
                h.flush()
        outs.append((rc, path.with_suffix(".log").read_text()))
    return outs


# --- thermal loads ---------------------------------------------------------


def _ring():
    a = 2 * np.pi * np.arange(4) / 4
    return (np.stack([np.cos(a), np.sin(a)], 1),
            [[0, 1], [1, 2], [2, 3], [3, 0]], 2)


def _thermal_case(name):
    """(nodes, elements, dim, alpha, delta_t) of one f_th case."""
    rng = np.random.default_rng(7)
    if name == "1d-scalar":
        return np.arange(5.0), [[i, i + 1] for i in range(4)], 1, 1e-3, 40.0
    if name == "2d-per-node":
        nodes, elements, _, _ = eg.grid_arrays(4, 6)
        return nodes, elements, 2, 1e-2, eg.grid_delta_t(4, 6, 50.0)
    if name == "2d-per-element":
        nodes, elements, _, _ = eg.grid_arrays(4, 6)
        n = len(elements)
        return (nodes, elements, 2, rng.uniform(1e-3, 2e-2, n),
                rng.uniform(-30.0, 60.0, n))
    if name == "3d-per-node":
        nodes = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]]
        elements = [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3], [1, 4],
                    [2, 4], [3, 4]]
        return nodes, elements, 3, 2e-3, rng.uniform(0.0, 80.0, 5)
    nodes, elements, dim = _ring()
    return nodes, elements, dim, 1e-2, np.array([0.0, 10.0, 20.0, 30.0])


@pytest.mark.parametrize("name", ["1d-scalar", "2d-per-node",
                                  "2d-per-element", "3d-per-node",
                                  "ring-nelm-eq-nnode"])
def test_thermal_loads_match_jax(name):
    nodes, elements, dim, alpha, delta_t = _thermal_case(name)
    nnode = len(nodes)
    j, t = problems(nodes, elements, np.zeros(dim * nnode), [0], dim)
    jd, td = j.to_device(), t.to_device("cpu")
    dt_j = j_thermal.element_delta_t(jd, delta_t, nnode)
    dt_t = t_thermal.element_delta_t(td, delta_t, nnode)
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), rtol=1e-6)
    if name == "ring-nelm-eq-nnode":
        # Per node wins (tests/test_review_fixes.py:201-216).
        np.testing.assert_allclose(dt_t.numpy(), [5.0, 15.0, 25.0, 15.0])
    eps_j = j_thermal.thermal_free_strains(jd, alpha, dt_j)
    eps_t = tp.thermal_free_strains(td, alpha, dt_t)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=1e-6)
    f_j = np.asarray(j_thermal.thermal_loads(jd, j.material, alpha, dt_j))
    f_t = tp.thermal_loads(td, t.material, alpha, dt_t)
    assert f_t.dtype == torch.float32 and f_t.shape == (dim * nnode,)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0,
                               atol=F_TH_RTOL * np.abs(f_j).max())


def test_thermal_shape_errors_match_jax():
    j, t = problems(np.arange(4.0), [[0, 1], [1, 2], [2, 3]], np.zeros(4),
                    [0], 1)
    jd, td = j.to_device(), t.to_device("cpu")
    for fn in (lambda: j_thermal.element_delta_t(jd, [1.0, 2.0], 4),
               lambda: t_thermal.element_delta_t(td, [1.0, 2.0], 4)):
        with pytest.raises(ValueError, match="delta_t"):
            fn()
    for d, lib in ((jd, j_thermal), (td, t_thermal)):
        with pytest.raises(ValueError, match="alpha"):
            lib.thermal_free_strains(d, [1.0, 2.0], 1.0)


def _bar_doc(n, fixed, delta_t, alpha=1e-3, young=3.0, area=0.7,
             loads=None):
    return {"nodes": [[float(i)] for i in range(n)],
            "elements": [[i, i + 1] for i in range(n - 1)],
            "material": {"young": young, "area": area, "density": 1.0},
            "loads": loads or [0.0] * n, "fixed_dofs": fixed,
            "solver_type": "fem",
            "solver_config": {"n_increments": 1, "tolerance": 1e-6},
            "thermal": {"alpha": alpha, "delta_t": delta_t}}


def _solve_doc(doc, parse, solve, **kw):
    parsed = parse(doc)
    r = solve(parsed.problem, parsed.config, 1.0, **kw)
    return (np.asarray(r.displacements, float).reshape(-1),
            np.asarray(r.reactions, float).reshape(-1), r.converged)


@pytest.mark.parametrize("case", ["clamped-bar", "free-bar",
                                  "determinate-truss"])
def test_thermal_closed_forms(case):
    """The anchors of pinn_fem_tpu/ops/thermal.py:8-14 through both
    packages' parser and solve_nr."""
    alpha, dt = 1e-3, 40.0
    if case == "clamped-bar":
        doc = _bar_doc(4, [0, 3], dt, alpha)
    elif case == "free-bar":
        doc = _bar_doc(4, [0], dt, alpha)
    else:
        # A statically determinate 2D truss (a triangle on a pin and a
        # roller), heated uniformly: u = alpha dT (x - x_pin).
        doc = {"nodes": [[0.0, 0.0], [2.0, 0.0], [0.5, 1.5]],
               "elements": [[0, 1], [1, 2], [0, 2]],
               "material": {"young": 5.0, "area": 0.2, "density": 1.0},
               "loads": [0.0] * 6, "fixed_dofs": [0, 1, 3],
               "solver_type": "fem",
               "solver_config": {"n_increments": 1, "tolerance": 1e-6},
               "thermal": {"alpha": alpha, "delta_t": dt}}
    u_j, r_j, c_j = _solve_doc(doc, j_parse, jp.solve_nr)
    u_t, r_t, c_t = _solve_doc(doc, parse_problem_dict,
                               lambda *a: tp.solve_nr(*a, device="cpu"))
    assert c_j and c_t
    strain = alpha * dt
    if case == "clamped-bar":
        force = 3.0 * 0.7 * strain
        np.testing.assert_allclose(u_t, 0.0, atol=1e-9)
        np.testing.assert_allclose([r_t[0], r_t[-1]], [force, -force],
                                   rtol=1e-5)
    elif case == "free-bar":
        np.testing.assert_allclose(u_t, strain * np.arange(4.0), rtol=1e-5,
                                   atol=1e-10)
        np.testing.assert_allclose(r_t, 0.0, atol=1e-7)
    else:
        x = np.asarray(doc["nodes"]).reshape(-1)
        np.testing.assert_allclose(u_t, strain * x, rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(r_t, 0.0, atol=1e-6)
    # Scales: the free elongation over the longest span, the clamped force.
    young_area = doc["material"]["young"] * doc["material"]["area"]
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=DENSE_RTOL * strain * 3)
    np.testing.assert_allclose(r_t, r_j, rtol=0,
                               atol=DENSE_RTOL * young_area * strain)


def test_thermal_refuses_nn_material():
    doc = {"nodes": [[0.0], [1.0], [2.0]], "elements": [[0, 1], [1, 2]],
           "material": {"young": 1.0, "area": 1.0, "density": 1.0},
           "nn_config": {"young": {"enabled": True}},
           "loads": [0.0, 0.0, 0.0], "fixed_dofs": [0],
           "solver_type": "pinn-gd",
           "thermal": {"alpha": 1e-4, "delta_t": 10.0}}
    msgs = []
    for parse in (j_parse, parse_problem_dict):
        with pytest.raises(ValueError, match="trainable") as e:
            parse(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_thermal_example1_through_both_clis(tmp_path):
    doc = json.loads((CORPUS / "example1.json").read_text())
    doc["thermal"] = {"alpha": 0.01, "delta_t": [0.0, 10.0, 20.0, 30.0]}
    j, t = run_both(tmp_path, "example1.json", doc)
    assert j["converged"] is t["converged"] is True
    assert len(t["history"]) == len(j["history"])
    # Element dT 5, 15, 25: free-end x = 1*3 + 0.01*(5 + 15 + 25) = 3.45.
    assert t["displacements"][6] == pytest.approx(3.45, rel=1e-5)
    for key in ("displacements", "reactions"):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=DENSE_RTOL
                                   * np.abs(j[key]).max())
    for key in ("load_factor", "iterations", "converged"):
        assert t["history"][-1][key] == j["history"][-1][key]


# --- support settlement ----------------------------------------------------

DELTA = 0.01


def _settle_bar(n=6, loads=None):
    nodes = np.arange(n, dtype=float)
    elements = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loads = np.zeros(n) if loads is None else loads
    return problems(nodes, elements, loads, [0, n - 1], 1, young=3.0,
                    area=0.7)


def _settle(problem, solve, up=None, **kw):
    cfg_cls = jp.SolverConfig if solve is jp.solve_nr else tp.SolverConfig
    r = solve(problem, cfg_cls(max_iterations=10, tolerance=1e-6), 1.0,
              prescribed_u=up, **kw)
    return (np.asarray(r.displacements, float).reshape(-1),
            np.asarray(r.reactions, float).reshape(-1), r)


def test_settlement_closed_form():
    """tests/test_settlement.py's bar, both packages: u = delta x / L,
    reactions -+ E A delta / L; the prescribed value persists."""
    n = 6
    up = np.zeros(n)
    up[-1] = DELTA
    (jb, tb), L = _settle_bar(n), n - 1.0
    u_j, r_j, res_j = _settle(jb, jp.solve_nr, up)
    u_t, r_t, res_t = _settle(tb, tp.solve_nr, up, device="cpu")
    assert res_t.converged and res_j.converged
    np.testing.assert_allclose(u_t, DELTA * np.arange(n) / L, rtol=1e-5,
                               atol=1e-10)
    assert u_t[-1] == np.float32(DELTA)
    force = 3.0 * 0.7 * DELTA / L
    np.testing.assert_allclose([r_t[0], r_t[-1]], [-force, force],
                               rtol=1e-4)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=DENSE_RTOL * DELTA)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=DENSE_RTOL * force)
    assert res_t.history == [dict(res_j.history[0],
                                  residual=res_t.history[0]["residual"],
                                  max_strain=res_t.history[0]["max_strain"])]


def test_settlement_with_loads_superposes():
    n = 6
    loads = np.zeros(n)
    loads[3] = 1.0
    up = np.zeros(n)
    up[-1] = DELTA
    (_, t_plain), (_, t_loaded) = _settle_bar(n), _settle_bar(n, loads)
    both = _settle(t_loaded, tp.solve_nr, up, device="cpu")[0]
    only_load = _settle(t_loaded, tp.solve_nr, device="cpu")[0]
    only_set = _settle(t_plain, tp.solve_nr, up, device="cpu")[0]
    np.testing.assert_allclose(both, only_load + only_set, rtol=1e-4,
                               atol=1e-9)
    j_loaded = _settle_bar(n, loads)[0]
    np.testing.assert_allclose(both, _settle(j_loaded, jp.solve_nr, up)[0],
                               rtol=0, atol=DENSE_RTOL * np.abs(both).max())


def test_settlement_through_both_clis(tmp_path, monkeypatch):
    """A prescribed DOF that is not fixed becomes fixed; one Newton solve,
    one history row; the log names the prescribed DOFs."""
    doc = {"nodes": [[float(i)] for i in range(6)],
           "elements": [[i, i + 1] for i in range(5)],
           "material": {"young": 3.0, "area": 0.7, "density": 1.0},
           "loads": [0.0] * 6, "fixed_dofs": [0], "solver_type": "fem",
           "prescribed_displacements": {"dofs": [5], "values": [DELTA]}}
    parsed = parse_problem_dict(doc)
    np.testing.assert_array_equal(parsed.problem.fixed_dofs, [0, 5])
    np.testing.assert_array_equal(parsed.prescribed,
                                  j_parse(doc).prescribed)
    (rc_j, log_j), (rc_t, log_t) = main_both(tmp_path, monkeypatch,
                                             "settle.json", doc)
    assert rc_j == rc_t == 0
    for log in (log_j, log_t):
        assert "Prescribed displacements on 1 DOFs" in log
    j, t = (json.loads((tmp_path / tag / "settle.res.json").read_text())
            for tag in ("jax", "torch"))
    assert set(t) == set(j) and t["converged"] is j["converged"] is True
    assert len(t["history"]) == len(j["history"]) == 1
    np.testing.assert_allclose(t["displacements"], DELTA * np.arange(6) / 5,
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(t["reactions"], j["reactions"], rtol=0,
                               atol=DENSE_RTOL * np.abs(j["reactions"]).max())


def test_settlement_refuses_other_methods(tmp_path):
    doc = {"nodes": [[0.0], [1.0], [2.0]], "elements": [[0, 1], [1, 2]],
           "material": {"young": 1.0, "area": 1.0, "density": 1.0},
           "loads": [0.0, 0.0, 0.0], "fixed_dofs": [0],
           "solver_type": "fem", "solver_config": {"method": "gd"},
           "prescribed_displacements": {"dofs": [2], "values": [0.1]}}
    msgs = []
    for tag, run in (("jax", jax_cli.run),
                     ("torch", lambda p: torch_cli.run(p, device="cpu"))):
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps(doc))
        with pytest.raises(ValueError, match="Newton-Raphson") as e:
            run(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    bad = dict(doc, prescribed_displacements={"dofs": [1, 2],
                                              "values": [0.1]})
    for parse in (j_parse, parse_problem_dict):
        with pytest.raises(ValueError, match="length mismatch"):
            parse(bad)


def test_analysis_plus_prescribed_exits_1(tmp_path, monkeypatch):
    doc = {"nodes": [[0.0], [1.0], [2.0]], "elements": [[0, 1], [1, 2]],
           "material": {"young": 1.0, "area": 1.0, "density": 1.0},
           "loads": [0.0, 0.0, 0.0], "fixed_dofs": [0],
           "solver_type": "fem",
           "prescribed_displacements": {"dofs": [2], "values": [0.1]},
           "analysis": {"type": "modal", "n_modes": 1}}
    msg = ("[ERROR] prescribed_displacements cannot be combined with an "
           "analysis block")
    for rc, log in main_both(tmp_path, monkeypatch, "bad.json", doc):
        assert rc == 1 and msg in log


# --- the banded path: 24 x 48 grid documents --------------------------------


def _grid_doc(kind):
    if kind == "thermal":
        return eg.thermal_grid_document(24, 48, tolerance=1e-4,
                                        n_increments=1)
    return eg.settlement_grid_document(
        24, 48, top_load=-1e-2 if kind == "settlement" else 0.0,
        tolerance=1e-4, n_increments=1)


@pytest.mark.parametrize("kind", ["thermal", "settlement",
                                  "settlement-only"])
def test_banded_documents_match_jax(tmp_path, kind):
    doc = _grid_doc(kind)
    j, t = run_both(tmp_path, "grid.json", doc)
    assert len(doc["loads"]) == 2304                 # above DENSE_DOF_LIMIT
    hj, ht = j["history"][-1], t["history"][-1]
    u64, r64, _, _ = eg.float64_reference(doc)
    np.testing.assert_allclose(t["displacements"], u64, rtol=0,
                               atol=GRID_F64_RTOL * np.abs(u64).max())
    np.testing.assert_allclose(t["displacements"], j["displacements"],
                               rtol=0, atol=GRID_JAX_RTOL * np.abs(u64).max())
    np.testing.assert_allclose(t["reactions"], r64, rtol=0,
                               atol=GRID_F64_RTOL * np.abs(r64).max())
    if kind != "thermal":
        # The settled values persist through the masked PCG steps.
        pd = doc["prescribed_displacements"]
        u = np.asarray(t["displacements"]).reshape(-1)
        assert np.all(u[pd["dofs"]] == np.float32(pd["values"][0]))
    if kind == "settlement-only":
        # Fault 3.9: ||(f - K u)_free|| / max(||f_free||, min_denom) with
        # f_free = 0 divides by 1e-10, so neither package converges, while
        # u is as accurate as above.
        assert t["converged"] is j["converged"] is False
        assert hj["residual"] > 1.0 and ht["residual"] > 1.0
    else:
        # The same Newton steps at tol 1e-4 (measured; fault 3.5), each
        # accepted under sqrt(tol).
        assert t["converged"] is j["converged"] is True
        assert ht["iterations"] == hj["iterations"]
        assert ht["residual"] <= 1e-2 and hj["residual"] <= 1e-2


# --- Green-Lagrange --------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_green_lagrange_batch_matches_jax(dim):
    rng = np.random.default_rng(dim)
    n = 64
    x0 = rng.uniform(-1.0, 1.0, (n, 2, dim)).astype(np.float32)
    u_e = rng.uniform(-0.3, 0.3, (n, 2 * dim)).astype(np.float32)
    inv_len = (1.0 / np.linalg.norm(x0[:, 1] - x0[:, 0], axis=1)).astype(
        np.float32)
    young = rng.uniform(0.5, 2.0, n).astype(np.float32)
    area = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = j_elements.truss2d_green_lagrange_batch(x0, u_e, inv_len, young,
                                                   area)
    got = t_elements.truss2d_green_lagrange_batch(
        *(torch.from_numpy(a) for a in (x0, u_e, inv_len, young, area)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GL_RTOL * np.abs(w).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_assemble_system_nonlinear_matches_jax(dim):
    rng = np.random.default_rng(10 + dim)
    if dim == 2:
        nodes, elements, _, _ = eg.grid_arrays(3, 4)
    else:
        nodes = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                          [1, 1, 1]], float)
        elements = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3],
                             [1, 4], [2, 4], [3, 4]])
    ndof = dim * len(nodes)
    j, t = problems(nodes, elements, np.zeros(ndof), [0], dim, young=2.0,
                    area=0.5)
    u = rng.uniform(-0.2, 0.2, ndof).astype(np.float32)
    want = j_assembly.assemble_system_nonlinear(j.to_device(), j.material,
                                                u, 1.0)
    got = t_assembly.assemble_system_nonlinear(
        t.to_device("cpu"), t.material, torch.from_numpy(u), 1.0)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GL_RTOL * np.abs(w).max())


def test_single_element_wrappers_match_jax():
    cases = [
        ("truss1d_linear_element", (0.0, 2.0, 0.1, 0.3, 2.0, 0.5)),
        ("truss2d_linear_element", ([0.0, 0.0], [1.0, 2.0], [0.0, 0.1],
                                    [0.2, -0.1], 2.0, 0.5)),
        ("truss2d_element_state", ([0.0, 0.0], [1.0, 2.0], [0.0, 0.1],
                                   [0.2, -0.1], 2.0, 0.5)),
    ]
    for name, args in cases:
        want = getattr(j_elements, name)(*args)
        got = getattr(t_elements, name)(*args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def _single_bar(load, lib):
    return lib.TrussProblem(
        nodes=np.array([[0.0, 0.0], [1.0, 0.0]]), elements=np.array([[0, 1]]),
        material=lib.Material(young=1.0, area=1.0, density=0.0),
        loads=np.array([0.0, 0.0, load, 0.0]),
        fixed_dofs=np.array([0, 1, 3]), dimension=2)


def test_gl_small_displacement_limit_matches_linear():
    """tests/test_geometric_nonlinear.py, on the port."""
    r_lin = tp.solve_nr(_single_bar(1e-4, tp), tp.SolverConfig(), 1.0,
                        device="cpu")
    r_gl = tp.solve_nr(_single_bar(1e-4, tp), tp.SolverConfig(), 1.0,
                       geometric_nonlinear=True, device="cpu")
    assert r_gl.converged
    np.testing.assert_allclose(r_gl.displacements, r_lin.displacements,
                               rtol=1e-3, atol=1e-9)


def test_gl_large_stretch_satisfies_equilibrium():
    f = 0.4
    r = tp.solve_nr(_single_bar(f, tp), tp.SolverConfig(max_iterations=100),
                    1.0, geometric_nonlinear=True, device="cpu")
    assert r.converged
    u = float(r.displacements[1, 0])
    e_gl = ((1.0 + u) ** 2 - 1.0) / 2.0
    assert e_gl * (1.0 + u) == pytest.approx(f, rel=1e-3)
    assert abs(u - 0.4) > 0.02
    r_j = jp.solve_nr(_single_bar(f, jp), jp.SolverConfig(max_iterations=100),
                      1.0, geometric_nonlinear=True)
    np.testing.assert_allclose(r.displacements, r_j.displacements, rtol=0,
                               atol=DENSE_RTOL * u)
    np.testing.assert_allclose(r.reactions, r_j.reactions, rtol=0,
                               atol=DENSE_RTOL * f)
    assert r.history[0]["iterations"] == r_j.history[0]["iterations"]


def test_gl_transverse_load_requires_geometric_stiffness():
    """The string's tangent at u = 0 is singular; a sag given as u_initial
    (under nr_warm_start) regularises the first step."""
    def string(lib):
        return lib.TrussProblem(
            nodes=np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]),
            elements=np.array([[0, 1], [1, 2]]),
            material=lib.Material(young=1.0, area=1.0, density=0.0),
            loads=np.array([0, 0, 0.0, -0.01, 0, 0]),
            fixed_dofs=np.array([0, 1, 2, 4, 5]), dimension=2)

    u_init = np.array([0, 0, 0.0, -0.05, 0, 0])
    r = tp.solve_nr(string(tp), tp.SolverConfig(max_iterations=200), 1.0,
                    u_initial=u_init, geometric_nonlinear=True, device="cpu")
    assert r.converged
    v = float(r.displacements[1, 1])
    assert v < -1e-3
    assert 2.0 * (v * v / 2.0) * (-v) == pytest.approx(0.01, rel=5e-2)
    r_j = jp.solve_nr(string(jp), jp.SolverConfig(max_iterations=200), 1.0,
                      u_initial=u_init, geometric_nonlinear=True)
    assert v == pytest.approx(float(r_j.displacements[1, 1]), rel=1e-4)
    # Cold, the same string has a singular tangent in both packages.
    for lib, kw in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match=SINGULAR):
            lib.solve_nr(string(lib), lib.SolverConfig(max_iterations=5),
                         1.0, geometric_nonlinear=True, **kw)


@pytest.mark.parametrize("case", ["1d", "cg-dia"])
def test_gl_refusals_match_jax(case):
    if case == "1d":
        def make(lib):
            return lib.TrussProblem(
                nodes=np.array([0.0, 1.0]), elements=np.array([[0, 1]]),
                material=lib.Material(young=1.0, area=1.0, density=0.0),
                loads=np.array([0.0, 0.1]), fixed_dofs=np.array([0]),
                dimension=1)
        kw, match = {}, "2D"
    else:
        def make(lib):
            return _single_bar(0.1, lib)
        kw, match = {"linear_solver": "cg-dia"}, "dense linear solver"
    for lib, extra in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            lib.solve_nr(make(lib), lib.SolverConfig(), 1.0,
                         geometric_nonlinear=True, **kw, **extra)


def test_gl_grid_matches_jax():
    """A 4 x 8 grid stretched to strains of 10-40 %: the Newton history
    row, u and the reactions, port vs JAX and against the float64
    Green-Lagrange equilibrium recomputed from u."""
    nodes, elements, loads, fixed = eg.grid_arrays(4, 8)
    loads = loads * 0.3
    j, t = problems(nodes, elements, loads, fixed, 2)
    cfg = dict(max_iterations=50, tolerance=1e-6)
    r_j = jp.solve_nr(j, jp.SolverConfig(**cfg), 1.0,
                      geometric_nonlinear=True)
    r_t = tp.solve_nr(t, tp.SolverConfig(**cfg), 1.0,
                      geometric_nonlinear=True, device="cpu")
    r_lin = tp.solve_nr(t, tp.SolverConfig(**cfg), 1.0, device="cpu")
    assert r_t.converged and r_j.converged
    hj, ht = r_j.history[0], r_t.history[0]
    assert ht["iterations"] == hj["iterations"]
    assert 0.1 <= ht["max_strain"] <= 0.4
    assert ht["max_strain"] == pytest.approx(hj["max_strain"], rel=1e-5)
    u = np.asarray(r_t.displacements, float).reshape(-1)
    scale = np.abs(u).max()
    np.testing.assert_allclose(u, np.asarray(r_j.displacements).reshape(-1),
                               rtol=0, atol=DENSE_RTOL * scale)
    np.testing.assert_allclose(r_t.reactions, r_j.reactions, rtol=0,
                               atol=DENSE_RTOL * np.abs(r_j.reactions).max())
    f_int = eg.float64_green_lagrange_force(nodes, elements, u)
    free = np.setdiff1d(np.arange(loads.size), fixed)
    assert (np.linalg.norm((f_int - loads)[free])
            / np.linalg.norm(loads[free])) < 1e-4
    u_lin = np.asarray(r_lin.displacements).reshape(-1)
    assert np.abs(u - u_lin).max() > 0.02 * scale


# --- the singular tangent --------------------------------------------------


def _mechanism(lib):
    """One 2D bar whose far node's y is free: K is singular."""
    return lib.TrussProblem(
        nodes=np.array([[0.0, 0.0], [1.0, 0.0]]), elements=np.array([[0, 1]]),
        material=lib.Material(young=1.0, area=1.0, density=1.0),
        loads=np.array([0.0, 0.0, 1.0, 0.0]), fixed_dofs=np.array([0, 1]),
        dimension=2)


def test_singular_tangent_raises_like_jax():
    errors = []
    for lib, kw in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(RuntimeError) as e:
            lib.solve_nr(_mechanism(lib), lib.SolverConfig(), 1.0, **kw)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1] == (RuntimeError, SINGULAR)


def test_singular_tangent_through_both_clis(tmp_path, monkeypatch):
    doc = {"nodes": [[0.0, 0.0], [1.0, 0.0]], "elements": [[0, 1]],
           "material": {"young": 1.0, "area": 1.0, "density": 1.0},
           "loads": [0.0, 0.0, 1.0, 0.0], "fixed_dofs": [0, 1],
           "solver_type": "fem", "solver_config": {"n_increments": 2}}
    for rc, log in main_both(tmp_path, monkeypatch, "mech.json", doc):
        assert rc == 1 and f"[ERROR] {SINGULAR}" in log
    for tag in ("jax", "torch"):
        assert not (tmp_path / tag / "mech.res.json").exists()


def test_nr_phase_reads_one_flag_an_iteration(monkeypatch):
    """The Cholesky info rides in the convergence test's read: one host
    read per Newton iteration, as before the repair."""
    from pinn_fem_tpu_torch.solvers import phases

    reads = []
    real_int = int

    def counting_int(x, *a):
        if isinstance(x, torch.Tensor):
            reads.append(1)
        return real_int(x, *a)

    monkeypatch.setattr(phases, "int", counting_int, raising=False)
    t = _single_bar(0.4, tp)
    data = t.to_device("cpu")
    out = phases.nr_phase(data, t.material, torch.zeros(4), 1.0, 50, 1e-6,
                          1e-10, nonlinear=True)
    assert out.converged and len(reads) == out.n_iters
