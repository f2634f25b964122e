"""Reliability on the CPU: pinn_fem_tpu_torch against the JAX package with
the same numpy inputs (solvers/reliability.py, the frame family's FORM and
RBDO, solvers/continuum_reliability.py, the two reliability corpus
documents through both CLIs, and the refusals).

Bounds, each the largest difference over the largest JAX value:

  * float64 (PINN_FEM_TPU_X64=1 with jax.enable_x64): F64_RTOL = 1e-6 on
    beta, alpha, p_f, design points, the Ditlevsen and SORM bounds
    (measured 1e-12 to 1e-9; the HL-RF runs 50 fixed iterations);
  * Monte Carlo: both packages draw u from numpy's default_rng(seed); the
    failure tables agree to at most MC_SAMPLE_SLACK samples (float32
    ratios on either side of 1);
  * the corpus documents in float32: DOC_RTOL (measured 3.9e-5 on p_f,
    1.3e-6 on beta); dyn-plane-reliability's beta also against the
    closed-form lognormal R - S index, 1e-4.

In float64 the JAX package's form_reliability writes into read-only
views of its fetched buffers and raises (ROADMAP fault 3.41); its float64
runs here patch its numpy with a copying asarray (`_CopyingNumpy`), and
`test_jax_float64_form_reliability_fault` shows the fault.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import schema as j_schema  # noqa: E402
from pinn_fem_tpu.models import frame as JF  # noqa: E402
from pinn_fem_tpu.solvers import reliability as j_rel  # noqa: E402
from pinn_fem_tpu_torch import examples_grid  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import schema as t_schema  # noqa: E402
from pinn_fem_tpu_torch.models import frame as TF  # noqa: E402
from pinn_fem_tpu_torch.solvers import (  # noqa: E402
    continuum_reliability as t_cr)
from pinn_fem_tpu_torch.solvers import reliability as t_rel  # noqa: E402
from pinn_fem_tpu_torch.utils.runtime import X64_VARIABLE  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
CPU = "cpu"
F64_RTOL = 1e-6
MC_SAMPLE_SLACK = 1
DOC_RTOL = 2e-4
CLOSED_FORM_RTOL = 1e-4


class _CopyingNumpy:
    """numpy with asarray copying (the JAX package's float64 fault 3.41)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(*args, **kwargs):
        return np.array(*args, **kwargs)


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setenv(X64_VARIABLE, "1")
    monkeypatch.setattr(j_rel, "np", _CopyingNumpy())
    with jax.enable_x64(True):
        yield


def rel_err(got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def corpus(name: str) -> dict:
    return json.loads((CORPUS / f"{name}.json").read_text())


def both_problems(doc: dict):
    return (j_schema.parse_problem_dict(json.loads(json.dumps(doc))).problem,
            t_schema.parse_problem_dict(json.loads(json.dumps(doc))).problem)


@pytest.fixture(scope="module")
def ten_bar():
    return both_problems(corpus("dyn-reliability"))


VARIABLES = corpus("dyn-reliability")["analysis"]["variables"]


def assert_same(got, want, rtol=F64_RTOL):
    """Every FORM field of two ReliabilityResults within rtol."""
    finite = np.isfinite(want.beta)
    assert np.array_equal(np.isfinite(got.beta), finite)
    for key in ("beta", "pf", "alpha", "design_point", "alpha_correlation"):
        a, b = np.asarray(getattr(got, key)), np.asarray(getattr(want, key))
        if key == "beta":
            a, b = a[finite], b[finite]
        assert rel_err(a, b) <= rtol, key
    for key in ("system_pf_lower", "system_pf_upper",
                "system_pf_ditlevsen_lower", "system_pf_ditlevsen_upper",
                "system_pf_sorm_lower", "system_pf_sorm_upper"):
        assert np.isclose(getattr(got, key), getattr(want, key), rtol=rtol,
                          atol=0.0, equal_nan=True), key
    assert np.array_equal(got.converged, want.converged)
    assert got.labels == want.labels and got.variables == want.variables


# Limit states and models of form_reliability (float64).
FORM_CASES = {
    "stress-sorm": (VARIABLES, {"type": "stress", "variable": "R",
                                "elements": [0, 5]},
                    dict(sorm=True)),
    "stress-correlated": (VARIABLES, {"type": "stress", "variable": "R",
                                      "elements": [0, 2]},
                          dict(correlation=[["S", "R", -0.3],
                                            ["E", "S", 0.2]])),
    "displacement": (VARIABLES[:2], {"type": "displacement", "limit": 20.0,
                                     "probe_dofs": [9, 11]}, {}),
    "random-field": ([dict(VARIABLES[0], field={"correlation_length": 0.5}),
                      VARIABLES[1]],
                     {"type": "stress", "limit": 1.6, "elements": [0, 5]},
                     {}),
    "frequency": ([dict(VARIABLES[0], mean=1.0), {
        "name": "rho", "kind": "density", "mean": 1.0, "cov": 0.1}],
        {"type": "frequency", "min_frequency_hz": 0.03}, {}),
    "fatigue": ([{"name": "S", "kind": "load_scale",
                  "distribution": "lognormal", "mean": 1.0, "cov": 0.2},
                 {"name": "C", "kind": "resistance", "mean": 1.2,
                  "cov": 0.3}],
                {"type": "fatigue", "variable": "C", "min_life_s": 1e6,
                 "elements": [0, 1, 4],
                 "fatigue": {"psd": 1e-3, "omegas": list(np.linspace(
                     0.05, 6.0, 40)), "damping": [0.3, 1e-3],
                             "sn": {"exponent": 3.0}}}, {}),
}


@pytest.mark.parametrize("case", list(FORM_CASES))
def test_form_reliability_float64(ten_bar, case, x64):
    """form_reliability on each limit-state type and model (SORM, Nataf
    correlation, a random field) in float64 against the JAX package."""
    variables, ls, kw = FORM_CASES[case]
    jp, tp = ten_bar
    want = j_rel.form_reliability(jp, variables, ls, **kw)
    got = t_rel.form_reliability(tp, variables, ls, device=CPU, **kw)
    assert_same(got, want)
    assert rel_err(got.history, want.history) <= F64_RTOL
    if "sorm" in kw:
        assert rel_err(got.pf_sorm, want.pf_sorm) <= F64_RTOL


def test_jax_float64_form_reliability_fault(ten_bar, monkeypatch):
    """ROADMAP fault 3.41: under x64 the JAX package's form_reliability
    raises on its read-only fetched buffers; the port copies them."""
    jp, tp = ten_bar
    ls = {"type": "stress", "variable": "R", "elements": [0]}
    monkeypatch.setenv(X64_VARIABLE, "1")
    with jax.enable_x64(True):
        with pytest.raises(ValueError, match="read-only"):
            j_rel.form_reliability(jp, VARIABLES, ls)
    got = t_rel.form_reliability(tp, VARIABLES, ls, device=CPU)
    assert np.all(np.isfinite(got.beta))


@pytest.mark.parametrize("method", ["crude", "importance"])
def test_monte_carlo(ten_bar, method):
    """Monte Carlo in float32 on the same numpy samples: p_f per limit
    state and for the system within MC_SAMPLE_SLACK samples (crude), the
    importance-sampling estimate within DOC_RTOL (its weights are float64
    on the host)."""
    jp, tp = ten_bar
    ls = {"type": "stress", "variable": "R", "elements": [0, 2, 5]}
    kw = dict(mc_samples=3000, mc_seed=4, mc_chunk=1024, mc_method=method)
    want = j_rel.form_reliability(jp, VARIABLES, ls, **kw)
    got = t_rel.form_reliability(tp, VARIABLES, ls, device=CPU, **kw)
    assert got.mc_n == want.mc_n == 3000 and got.mc_method == method
    if method == "crude":
        assert abs(got.mc_pf - want.mc_pf) * 3000 <= MC_SAMPLE_SLACK + 1e-9
        assert np.max(np.abs(got.mc_pf_per_ls - want.mc_pf_per_ls)) \
            * 3000 <= MC_SAMPLE_SLACK + 1e-9
    else:
        assert abs(got.mc_pf - want.mc_pf) <= DOC_RTOL * want.mc_pf
        assert abs(got.mc_std_error - want.mc_std_error) \
            <= DOC_RTOL * want.mc_std_error


# ------------------------------------------------ frames and continua

def frame_pair():
    from pinn_fem_tpu.io import frame_io as j_io
    from pinn_fem_tpu_torch.io import frame_io as t_io

    doc = {"element_type": "frame",
           "nodes": [[0, 0], [0, 3], [4, 3], [4, 0]],
           "elements": [[0, 1], [1, 2], [2, 3]],
           "material": {"young": 200.0, "area": 0.4, "inertia": 0.05,
                        "density": 2.0, "section_modulus": 0.2},
           "member_loads": [[0.0, 0.0], [0.0, -2.0], [0.0, 0.0]],
           "loads": [0, 0, 0, 1.0, 0, 0, 0.5, 0, 0, 0, 0, 0],
           "fixed_nodes": [0, 3], "analysis": {"type": "static"}}
    return (j_io.parse_frame_document(json.loads(json.dumps(doc)))[0],
            t_io.parse_frame_document(json.loads(json.dumps(doc)))[0])


FRAME_VARS = [{"name": "E", "kind": "young", "mean": 200.0, "cov": 0.1},
              {"name": "I", "kind": "inertia", "mean": 0.05, "cov": 0.05,
               "elements": [1]},
              {"name": "S", "kind": "load_scale", "mean": 1.0, "std": 0.2},
              {"name": "R", "kind": "resistance", "mean": 40.0,
               "cov": 0.1}]
FRAME_CASES = {
    "displacement": {"type": "displacement", "limit": 0.3,
                     "probe_dofs": [3, 6]},
    "stress": {"type": "stress", "variable": "R"},
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_frame_reliability_float64(case, x64):
    """frame_reliability (form_core) in float64, with a correlation."""
    jp, tp = frame_pair()
    kw = dict(correlation=[["E", "S", 0.3]])
    want = JF.frame_reliability(jp, FRAME_VARS, FRAME_CASES[case], **kw)
    got = TF.frame_reliability(tp, FRAME_VARS, FRAME_CASES[case],
                               device=CPU, **kw)
    assert_same(got, want)


def test_frame_rbdo_float64(x64):
    """optimize_frame_inertia_rbdo, cut to 4 x 2 iterations, in float64:
    inertia, weight, achieved betas and history."""
    jp, tp = frame_pair()
    sway = abs(JF.solve_frame_static(jp).displacements[3])
    args = (FRAME_VARS[:1] + FRAME_VARS[2:3], 3.0 * sway, [3], 2.0)
    kw = dict(n_iter=4, outer_rounds=2)
    want = JF.optimize_frame_inertia_rbdo(jp, *args, **kw)
    got = TF.optimize_frame_inertia_rbdo(tp, *args, device=CPU, **kw)
    for g, j in zip(got, want):
        assert rel_err(g, j) <= F64_RTOL


CONTINUUM = {
    "plane": ({"element_type": "plane",
               "mesh": {"type": "rect", "width": 2.0, "height": 1.0,
                        "nx": 3, "ny": 2},
               "material": {"young": 100.0, "poisson": 0.3},
               "fixed_nodes": "left",
               "edge_loads": [{"nodes": "right", "traction": [0.5, -1.0]}]},
              {"type": "stress", "variable": "R", "elements": [0, 3]}),
    "solid": ({"element_type": "solid",
               "mesh": {"type": "box", "lx": 1.0, "ly": 1.0, "lz": 2.0,
                        "nx": 1, "ny": 1, "nz": 2},
               "material": {"young": 100.0, "poisson": 0.3},
               "fixed_nodes": "z_min",
               "surface_loads": [{"face": "z_max",
                                  "traction": [0.1, 0.0, -1.0]}]},
              {"type": "displacement", "limit": 0.05, "probe_nodes": [9]}),
    "plate": ({"element_type": "plate",
               "mesh": {"type": "rect", "width": 1.0, "height": 0.6,
                        "nx": 3, "ny": 2},
               "material": {"young": 200.0, "poisson": 0.3,
                            "thickness": 0.05},
               "pressure": -1.0, "supports": {"clamped": ["left"]}},
              {"type": "stress", "variable": "R", "elements": [0, 5]}),
    "shell": ({"element_type": "shell",
               "mesh": {"type": "cylinder_panel", "radius": 25.0,
                         "length": 40.0, "half_angle_deg": 40.0, "nx": 2,
                         "ny": 2},
               "material": {"young": 4.32e8, "poisson": 0.2,
                            "thickness": 1.0},
               "supports": [{"nodes": "y_min",
                             "dofs": [0, 1, 2, 3, 4, 5]}],
               "body_force": [0.0, 0.0, -90.0]},
              {"type": "displacement", "limit": 0.02,
               "probe_dofs": [38, 50]}),
}


def continuum_pair(family: str):
    import importlib

    doc = dict(CONTINUUM[family][0], analysis={"type": "static"})
    out = []
    for pkg in ("pinn_fem_tpu", "pinn_fem_tpu_torch"):
        io = importlib.import_module(f"{pkg}.io.{family}_io")
        out.append(getattr(io, f"parse_{family}_document")(
            json.loads(json.dumps(doc)))[0])
    return out


def continuum_variables(family: str, problem):
    young = float(np.mean(problem.young))
    v = [{"name": "E", "kind": "young", "mean": young, "cov": 0.1},
         {"name": "S", "kind": "load_scale", "mean": 1.0, "std": 0.2}]
    if family != "solid":
        v.append({"name": "t", "kind": "thickness",
                  "mean": float(np.mean(problem.thickness)), "cov": 0.05,
                  "elements": [0]})
    ls = CONTINUUM[family][1]
    if ls["type"] == "stress":
        j_stress = {"plane": 1.5, "plate": 1.4e3}[family]
        v.append({"name": "R", "kind": "resistance", "mean": j_stress,
                  "cov": 0.1})
    return v


@pytest.mark.parametrize("family", list(CONTINUUM))
def test_continuum_reliability_float64(family, x64):
    """continuum_reliability on each family in float64 against the JAX
    package (io probe_nodes expansion through the runner)."""
    from pinn_fem_tpu.io import _common as j_common
    from pinn_fem_tpu_torch.io import _common as t_common

    jp, tp = continuum_pair(family)
    analysis = {"type": "reliability",
                "variables": continuum_variables(family, tp),
                "limit_state": CONTINUUM[family][1]}
    want = j_common.run_continuum_reliability(jp, dict(analysis), family)
    got = t_common.run_continuum_reliability(tp, dict(analysis), family,
                                             CPU)
    assert sorted(got) == sorted(want)
    for key in ("beta", "pf", "alpha", "system_pf_bounds",
                "system_pf_ditlevsen_bounds"):
        assert rel_err(np.asarray(got[key], float),
                       np.asarray(want[key], float)) <= F64_RTOL, key
    assert got["labels"] == want["labels"]
    assert got["converged"] == want["converged"]


# ---------------------------------------------------- corpus documents

def run_both(tmp_path, name: str, doc: dict):
    src = tmp_path / f"{name}.json"
    src.write_text(json.dumps(doc))
    j = jax_cli.run(str(src), str(tmp_path / "jax.res.json"))
    t = torch_cli.run(str(src), str(tmp_path / "port.res.json"),
                      device=CPU)
    return j, t


def test_dyn_reliability_document(tmp_path):
    """dyn-reliability.json (FORM, SORM, 20,000 Monte-Carlo samples)
    through both CLIs: keys, beta / p_f / SORM within DOC_RTOL, the Monte
    Carlo within MC_SAMPLE_SLACK samples."""
    j, t = run_both(tmp_path, "dyn-reliability", corpus("dyn-reliability"))
    assert sorted(j) == sorted(t) and t["success"] is True
    for key in ("beta", "pf", "pf_sorm", "alpha", "design_points",
                "system_pf_bounds", "system_pf_ditlevsen_bounds",
                "system_pf_sorm_bounds"):
        assert rel_err(t[key], j[key]) <= DOC_RTOL, key
    n = j["mc"]["n_samples"]
    assert t["mc"]["n_samples"] == n == 20000
    assert abs(t["mc"]["pf"] - j["mc"]["pf"]) * n <= MC_SAMPLE_SLACK
    assert t["converged"] == j["converged"]


def test_dyn_plane_reliability_document(tmp_path):
    """dyn-plane-reliability.json through both CLIs, and its closed form:
    beta = ln(R_med / S_med) / sqrt(zeta_R^2 + zeta_S^2) on every element
    (the element of the minimum may differ: the betas tie)."""
    j, t = run_both(tmp_path, "dyn-plane-reliability",
                    corpus("dyn-plane-reliability"))
    assert sorted(j) == sorted(t)
    for key in ("beta", "pf", "alpha", "system_pf_bounds",
                "system_pf_ditlevsen_bounds"):
        assert rel_err(t[key], j[key]) <= DOC_RTOL, key
    zr, zs = (math.sqrt(math.log1p(c * c)) for c in (0.15, 0.2))
    r_med = 2.0 / math.sqrt(1.0 + 0.15 ** 2)
    s_med = 1.0 / math.sqrt(1.0 + 0.2 ** 2)
    beta = math.log(r_med / s_med) / math.hypot(zr, zs)
    np.testing.assert_allclose(t["beta"], beta, rtol=CLOSED_FORM_RTOL)
    assert abs(t["beta_min"] - beta) <= CLOSED_FORM_RTOL * beta


# ------------------------------------------------------------- refusals

def _truss_doc(**analysis):
    doc = corpus("dyn-reliability")
    doc["analysis"] = dict(doc["analysis"], **dict({"validate_mc": 0},
                                                   **analysis))
    return doc


REFUSALS = {
    "above_dense_limit": dict(examples_grid.grid_document(24, 48),
                              analysis={"type": "reliability",
                                        "variables": VARIABLES,
                                        "limit_state": {"limit": 1.0}}),
    "no_variables": _truss_doc(variables=[]),
    "field_on_load_scale": _truss_doc(variables=[
        dict(VARIABLES[1], field={"correlation_length": 1.0})]),
    "unknown_limit_state": _truss_doc(limit_state={"type": "buckling"}),
    "resistance_not_resistance": _truss_doc(
        limit_state={"type": "stress", "variable": "E"}),
    "bad_correlation": _truss_doc(correlation=[["E", "E", 0.5]]),
    "unknown_mc_method": _truss_doc(validate_mc=10, mc_method="lhs"),
    "displacement_without_probe": _truss_doc(
        limit_state={"type": "displacement", "limit": 1.0}),
    "fatigue_without_spec": _truss_doc(
        limit_state={"type": "fatigue", "min_life_s": 1.0}),
    "solid_thickness": dict(CONTINUUM["solid"][0], analysis={
        "type": "reliability", "limit_state": CONTINUUM["solid"][1],
        "variables": [{"name": "t", "kind": "thickness", "mean": 1.0,
                       "cov": 0.1}]}),
    "plane_density": dict(CONTINUUM["plane"][0], analysis={
        "type": "reliability", "limit_state": CONTINUUM["plane"][1],
        "variables": [{"name": "rho", "kind": "density", "mean": 1.0,
                       "cov": 0.1}]}),
    "frame_density": {"element_type": "frame", "nodes": [[0, 0], [0, 3]],
                      "elements": [[0, 1]], "fixed_nodes": [0],
                      "material": {"young": 1.0, "area": 1.0,
                                   "inertia": 1.0},
                      "loads": [0, 0, 0, 1.0, 0, 0],
                      "analysis": {"type": "reliability", "variables": [
                          {"name": "rho", "kind": "density", "mean": 1.0,
                           "cov": 0.1}]}},
    "plane_bare": dict(CONTINUUM["plane"][0],
                       analysis={"type": "reliability"}),
    "solid_bare": dict(CONTINUUM["solid"][0],
                       analysis={"type": "reliability"}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_equal_jax(tmp_path, case):
    """A refused reliability block raises the JAX package's error, word for
    word."""
    src = tmp_path / f"{case}.json"
    src.write_text(json.dumps(REFUSALS[case]))
    errs = []
    for run, kw in ((jax_cli.run, {}), (torch_cli.run, {"device": CPU})):
        with pytest.raises(Exception) as err:
            run(str(src), str(tmp_path / "out.json"), **kw)
        errs.append((type(err.value), str(err.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("call", [
    lambda tp: t_rel.form_reliability(
        tp, VARIABLES, {"type": "stress", "variable": "R"}, mesh=object(),
        device=CPU),
    lambda tp: t_cr.continuum_reliability(
        continuum_pair("plane")[1], VARIABLES[1:2],
        {"type": "displacement", "limit": 1.0, "probe_dofs": [0]}, "plane",
        mesh=object(), device=CPU),
], ids=["form_reliability", "continuum_reliability"])
def test_mesh_is_refused(ten_bar, call):
    """mesh= (the Monte Carlo samples over a device mesh) is ROADMAP item
    15's multi-device row: NotImplementedError before any solve."""
    with pytest.raises(NotImplementedError, match="item 15"):
        call(ten_bar[1])
