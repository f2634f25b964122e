"""The port's arc-length continuation (solvers/riks.py, ops/host's
host_nonlinear_system, the "continuation" document) and Guyan /
Craig-Bampton reduction (solvers/reduction.py, the "reduction" document)
against the JAX package, on the CPU.

Each case gives the same inputs, made by numpy, to both packages, tier
against tier:

  * float64 (Riks' dense default and host=True, every reduction): the
    path, displacements and residual within F64_RTOL of the largest JAX
    value, equal corrector iterations and point counts;
  * Riks' float32 device tier (host=False): the von Mises path point by
    point within F32_RTOL where both take the same steps; with the large
    first step of tests/test_riks.py the two float32 runs take different
    steps (a corrector test of 1e-8 at the float32 residual floor,
    ROADMAP §3 fault 3.19), so each path is held to the exact curve
    instead.

The sign rule of Craig-Bampton modes: eigh's eigenvector signs differ
between LAPACK and torch, so each modal column of the recovery basis t
(and the matching rows and columns of k_red and m_red) is multiplied by
the sign that aligns it with the JAX package's column before the
comparison; the master block and the reduced frequencies are compared as
they are.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu.solvers.newton as j_newton  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import analysis as j_analysis  # noqa: E402
from pinn_fem_tpu.ops import host as j_host  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import analysis as t_analysis  # noqa: E402
from pinn_fem_tpu_torch.ops import host as t_host  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# Float64 against the JAX host tier and LAPACK: measured up to 4.7e-16.
F64_RTOL = 1e-10
# Riks' float32 tier against the JAX device tier on the same steps:
# measured 8.0e-7 (lambda) and 9.3e-9 (u).
F32_RTOL = 1e-5
# The exact von Mises curve: JAX's float64 bound (tests/test_riks.py
# :101), and for the float32 paths about 7 eps32 of the largest |lambda|
# (2.6; measured up to 8.5e-7).
CURVE_ATOL = 5e-6
CURVE_ATOL_F32 = 2e-6


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def von_mises(pkg):
    """tests/test_riks.py's two-bar truss, apex load downward."""
    loads = np.zeros(6)
    loads[5] = -1.0
    return pkg.TrussProblem(np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                            np.array([[0, 2], [1, 2]]),
                            pkg.Material(young=1.0, area=1.0, density=1.0),
                            loads, np.array([0, 1, 2, 3, 4]), 2)


def lam_exact(w):
    return 2.0 * (w - 1.5 * w * w + 0.5 * w ** 3) / 2.0 ** 1.5


def beyond_snap(u, lam):
    return -u[5] > 2.3


def tower(pkg, stories=4):
    """The cross-braced 2-chord tower of tests/test_torch_modal.py, a
    horizontal load at the top."""
    nodes, elements = [], []
    for s in range(stories + 1):
        nodes += [[0.0, float(s)], [1.0, float(s)]]
    for s in range(stories):
        a, b, c, d = 2 * s, 2 * s + 1, 2 * s + 2, 2 * s + 3
        elements += [[a, c], [b, d], [c, d], [a, d], [b, c]]
    loads = np.zeros(2 * len(nodes))
    loads[2 * (2 * stories)] = 1.0
    return pkg.TrussProblem(np.array(nodes), np.array(elements),
                            pkg.Material(young=1000.0, area=1.0, density=1.0),
                            loads, np.array([0, 1, 2, 3]), 2)


TOP = [16, 17, 18, 19]          # the tower's top nodes' DOFs


# --------------------------------------------------------------- Riks

RIKS_CASES = {"path": dict(n_steps=400, initial_dlambda=0.01),
              "large-first-step": dict(n_steps=80, initial_dlambda=0.2)}


@pytest.mark.parametrize("host", [None, True], ids=["default", "host"])
@pytest.mark.parametrize("case", list(RIKS_CASES))
def test_riks_float64_tier_matches_jax(case, host):
    """The von Mises snap-through past both folds (stop beyond w = 2.3 h)
    and the large first step that forces the quarter-cut retries: the
    dense float64 tier against the JAX host tier point by point."""
    kw = RIKS_CASES[case]
    j = jp.solve_riks(von_mises(jp), stop_fn=beyond_snap, host=host, **kw)
    t = tp.solve_riks(von_mises(tp), stop_fn=beyond_snap, host=host,
                      device="cpu", **kw)
    assert t.converged and j.converged
    assert t.load_factors.size == j.load_factors.size >= 3
    for key in ("load_factors", "displacements"):
        assert rel_err(getattr(t, key), getattr(j, key)) <= F64_RTOL, key
    np.testing.assert_array_equal(t.iterations, j.iterations)
    assert np.abs(t.residuals - j.residuals).max() <= 1e-14
    np.testing.assert_allclose(t.load_factors,
                               lam_exact(-t.displacements[:, 5]),
                               atol=CURVE_ATOL)


@pytest.mark.parametrize("case", list(RIKS_CASES))
def test_riks_float32_tier_matches_jax(case):
    """host=False: the float32 tiers.  On the resolved path both take the
    same steps and agree point by point within F32_RTOL; with the large
    first step each converges, passes the snap and lies on the exact
    curve within CURVE_ATOL_F32."""
    kw = RIKS_CASES[case]
    j = jp.solve_riks(von_mises(jp), stop_fn=beyond_snap, host=False, **kw)
    t = tp.solve_riks(von_mises(tp), stop_fn=beyond_snap, host=False,
                      device="cpu", **kw)
    assert t.converged and j.converged
    if case == "path":
        assert t.load_factors.size == j.load_factors.size
        assert rel_err(t.load_factors, j.load_factors) <= F32_RTOL
        assert rel_err(t.displacements, j.displacements) <= F32_RTOL
    for res in (t, j):
        w = -res.displacements[:, 5]
        assert w.max() > 2.0 and res.load_factors.size >= 3
        np.testing.assert_allclose(res.load_factors, lam_exact(w),
                                   atol=CURVE_ATOL_F32)


def test_riks_refusals_match_jax():
    """A zero load pattern is refused, with the JAX package's message."""
    msgs = []
    for pkg, kw in ((jp, {}), (tp, {"device": "cpu"})):
        p = von_mises(pkg)
        p = pkg.TrussProblem(p.nodes, p.elements, p.material,
                             np.zeros(6), p.fixed_dofs, 2)
        with pytest.raises(ValueError) as err:
            pkg.solve_riks(p, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------- reduction

def align_modes(t_port, t_jax, n_m: int) -> np.ndarray:
    """The signs (n_red,) that align the port's modal columns (from n_m
    on) with the JAX package's; 1 on the master columns."""
    signs = np.ones(t_jax.shape[1])
    signs[n_m:] = np.sign(np.sum(t_port[:, n_m:] * t_jax[:, n_m:], axis=0))
    assert np.all(signs != 0)
    return signs


def assert_reduced_equal(t, j):
    n_m = j.master_dofs.size
    s = align_modes(t.t, j.t, n_m)
    np.testing.assert_array_equal(t.master_dofs, j.master_dofs)
    np.testing.assert_array_equal(t.free_dofs, j.free_dofs)
    assert rel_err(t.t * s, j.t) <= F64_RTOL
    for key in ("k_red", "m_red"):
        got, want = getattr(t, key), getattr(j, key)
        assert rel_err(got[:n_m, :n_m], want[:n_m, :n_m]) <= F64_RTOL
        assert np.abs(s[:, None] * got * s[None, :] - want).max() \
            <= F64_RTOL * np.abs(want).max()


@pytest.mark.parametrize("method", ["guyan_reduce", "craig_bampton"])
def test_truss_reduction_matches_jax(method):
    """guyan_reduce and craig_bampton (4 modes) of the tower onto its top
    nodes, under the sign rule; reduce_loads and expand too."""
    j = getattr(jp, method)(tower(jp), TOP)
    t = getattr(tp, method)(tower(tp), TOP, device="cpu")
    assert_reduced_equal(t, j)
    loads = tower(jp).loads
    s = align_modes(t.t, j.t, len(TOP))
    assert rel_err(tp.reduce_loads(t, loads) * s,
                   jp.reduce_loads(j, loads)) <= F64_RTOL
    u_m = np.linalg.solve(t.k_red, tp.reduce_loads(t, loads))
    u_j = np.linalg.solve(j.k_red, jp.reduce_loads(j, loads))
    assert rel_err(t.expand(u_m, 20), j.expand(u_j, 20)) <= F64_RTOL


def plane_strip():
    """tests/test_reduction.py's consistent-mass plane strip (JAX)."""
    from pinn_fem_tpu.models.plane import PlaneProblem, rect_mesh

    nodes, elems = rect_mesh(3.0, 1.0, 6, 2, "quad")
    left = np.flatnonzero(nodes[:, 0] == 0.0)
    return PlaneProblem(nodes=nodes, elements=elems, young=200.0,
                        poisson=0.3, thickness=0.5, density=2.0,
                        loads=np.zeros(2 * nodes.shape[0]),
                        fixed_dofs=np.concatenate([2 * left, 2 * left + 1]))


@pytest.mark.parametrize("method", ["guyan_reduce_dense",
                                    "craig_bampton_dense"])
def test_dense_cores_match_jax(method):
    """The dense cores on the plane strip's consistent (K, M) from the JAX
    package, masters at the free end: the port's Cholesky-congruence eigh
    against scipy's generalized eigh, under the sign rule."""
    from pinn_fem_tpu.models.plane import plane_matrices

    p = plane_strip()
    k, m = plane_matrices(p)
    right = np.flatnonzero(p.nodes[:, 0] == 3.0)
    masters = np.concatenate([2 * right, 2 * right + 1])
    j = getattr(jp, method)(k, m, p.fixed_dofs, masters)
    t = getattr(tp, method)(k, m, p.fixed_dofs, masters, device="cpu")
    assert_reduced_equal(t, j)


def continuum_and_limit_calls():
    return {
        "data": (lambda pkg, kw: pkg.guyan_reduce(
            tower(pkg), TOP, data=tower(pkg).to_device(**kw)), ValueError),
        "duplicates": (lambda pkg, kw: pkg.craig_bampton(
            tower(pkg), [16, 16], **kw), ValueError),
        "fixed-master": (lambda pkg, kw: pkg.guyan_reduce(
            tower(pkg), [0, 16], **kw), ValueError),
        "method": (lambda pkg, kw: pkg.reduce_model(
            tower(pkg), TOP, method="modal", **kw), ValueError),
        "not-a-problem": (lambda pkg, kw: pkg.reduce_model(
            SimpleNamespace(ndof=4), TOP, **kw), TypeError),
        "continuum": (lambda pkg, kw: pkg.reduce_model(
            shell_roof(pkg), [60, 62], **kw), None),
    }


def shell_roof(pkg):
    """The 4 x 4 Scordelis-Lo roof (R 25, L 50, 40 deg, t 0.25) with its
    end diaphragms and the axial pin, of either package."""
    nodes, el = pkg.cylinder_panel_mesh(25.0, 50.0, 40.0, 4, 4)
    ends = np.flatnonzero((nodes[:, 1] == 0.0) | (nodes[:, 1] == 50.0))
    return pkg.ShellProblem(
        nodes=nodes, elements=el, young=4.32e8, poisson=0.0, thickness=0.25,
        density=1.0, loads=np.zeros(6 * len(nodes)),
        fixed_dofs=np.concatenate([6 * ends, 6 * ends + 2, [1]]))


@pytest.mark.parametrize("name", ["data", "duplicates", "fixed-master",
                                  "method", "not-a-problem", "limit"])
def test_reduction_refusals_match_jax(name, monkeypatch):
    """Each refusal with the JAX package's error type and message: a
    `data` argument, duplicate or fixed masters, an unknown method, a
    non-problem, and a problem above DENSE_DOF_LIMIT."""
    if name == "limit":
        monkeypatch.setattr(j_newton, "DENSE_DOF_LIMIT", 16)
        monkeypatch.setattr(t_newton, "DENSE_DOF_LIMIT", 16)
        call, kind = (lambda pkg, kw: pkg.guyan_reduce(tower(pkg), TOP,
                                                       **kw), ValueError)
    else:
        call, kind = continuum_and_limit_calls()[name]
    msgs = []
    for pkg, kw in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(kind) as err:
            call(pkg, kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_continuum_reduction_refused():
    """reduce_model on the continuum problem it refused until ROADMAP item
    22 (a ShellProblem; the plane, solid, frame and plate branches are
    tests/test_torch_plane.py, tests/test_torch_solid.py,
    tests/test_torch_frame*.py and tests/test_torch_plate.py): the 4 x 4
    roof's Guyan reduction equals the JAX package's (float64 on both
    sides)."""
    call, _ = continuum_and_limit_calls()["continuum"]
    got, want = call(tp, {"device": "cpu"}), call(jp, {})
    for a, b in ((got.k_red, want.k_red), (got.m_red, want.m_red),
                 (got.t, want.t)):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    assert np.array_equal(got.master_dofs, want.master_dofs)


@pytest.mark.parametrize("analysis, match", [
    ({"method": "guyan"}, "master_nodes or master_dofs"),
    ({"master_nodes": [0]}, "resolve to no free DOFs"),
    ({"master_dofs": TOP, "method": "svd"}, "guyan"),
])
def test_reduction_document_refusals_match_jax(analysis, match):
    msgs = []
    for run, pkg, args in ((j_analysis.run_analysis, jp, ()),
                           (t_analysis.run_analysis, tp, ("cpu",))):
        with pytest.raises(ValueError, match=match) as err:
            run(tower(pkg), dict(analysis, type="reduction"), *args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ the documents

def cli_pair(tmp_path, doc, name):
    """((exit code, result) of the JAX CLI, of the port's)."""
    out = []
    for pkg, cli in (("jax", jax_cli), ("port", torch_cli)):
        path = tmp_path / f"{name}-{pkg}.json"
        path.write_text(json.dumps(doc))
        rc = cli.main([str(path)])
        out.append((rc, json.loads((tmp_path / f"{name}-{pkg}.res.json")
                                   .read_text())))
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    return out


def assert_close_tree(t, j, rtol, path=""):
    """Equal keys and flags, numbers within rtol of each array's largest
    JAX value; a list of relative errors (float64 noise in both) within
    rtol absolute."""
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for key in j:
            assert_close_tree(t[key], j[key], rtol, f"{path}/{key}")
    elif isinstance(j, list) and j and not isinstance(j[0], str) \
            and None not in j:
        if path.endswith("rel_error"):
            assert np.abs(np.subtract(t, j)).max() <= rtol, path
        else:
            assert rel_err(t, j) <= rtol, path
    elif isinstance(j, float):
        assert t == pytest.approx(j, rel=rtol), path
    else:
        assert t == j, path


def signed_reduction(t: dict, j: dict) -> None:
    """The sign rule on a reduction document: flip the port's modal rows
    and columns of k_red and m_red to the JAX signs (read from m_red's
    master-modal coupling)."""
    n_m = len(j["master_dofs"])
    mt, mj = np.asarray(t["m_red"]), np.asarray(j["m_red"])
    s = np.ones(mj.shape[0])
    s[n_m:] = np.sign(np.sum(mt[:n_m, n_m:] * mj[:n_m, n_m:], axis=0))
    assert np.all(s != 0)
    for key in ("k_red", "m_red"):
        a = np.asarray(t[key])
        t[key] = (s[:, None] * a * s[None, :]).tolist()


@pytest.mark.parametrize("name", ["dyn-continuation", "dyn-reduction",
                                  "reduction-guyan"])
def test_documents_through_both_clis(tmp_path, monkeypatch, name):
    """dyn-continuation.json (Riks, float64), dyn-reduction.json
    (Craig-Bampton with compare_full) and its Guyan variant: equal exit
    codes, equal keys and flags, numbers within F64_RTOL (the sign rule
    on Craig-Bampton's modal rows and columns)."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    doc = json.loads((CORPUS / f"{name}.json").read_text()
                     if name.startswith("dyn-")
                     else (CORPUS / "dyn-reduction.json").read_text())
    if name == "reduction-guyan":
        doc["analysis"] = dict(doc["analysis"], method="guyan")
    (rc_j, j), (rc_t, t) = cli_pair(tmp_path, doc, name)
    assert rc_j == rc_t == 0 and j["success"]
    if "m_red" in j:
        signed_reduction(t, j)
    assert_close_tree(t, j, F64_RTOL)


def test_host_nonlinear_system_matches_jax():
    """ops/host.host_nonlinear_system against the JAX mirror at a seeded
    state of the tower (1e-12 of the largest entry)."""
    u = np.random.default_rng(4).uniform(-0.1, 0.1, 20)
    u[:4] = 0.0
    for w, g in zip(j_host.host_nonlinear_system(tower(jp), u, 1.2),
                    t_host.host_nonlinear_system(tower(tp), u, 1.2)):
        assert rel_err(g, w) <= 1e-12
