"""The port's elastoplasticity (ops/plastic.py, ops/host.py's plastic
mirrors, solvers/plasticity.py, the "plastic" document and the transient
"plasticity" key) against the JAX package, on the CPU.

Each case gives the same inputs, made by numpy, to both packages, tier
against tier:

  * the float64 tiers (the host mirrors, the dense default of
    solve_elastoplastic and solve_transient_plastic below
    DENSE_DOF_LIMIT, host=True) are held to the JAX host tier at 1e-12
    (elementwise) and 1e-10 of each quantity's largest value, with equal
    Newton iterations, n_plastic and converged flags;
  * the float32 device tiers (host=False, or above the lowered limit) are
    held to the JAX package's own host=False bounds
    (tests/test_plasticity.py:185-193 for statics, :330-336 for the
    transient), with equal n_plastic.  The port's static device tier
    counts a trial yield function within 16 eps32 of the surface as
    elastic (ops/plastic.return_map, ROADMAP fault 3.18); the loads keep
    every member off the threshold otherwise.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu.solvers.newton as j_newton  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import analysis as j_analysis  # noqa: E402
from pinn_fem_tpu.ops import host as j_host  # noqa: E402
from pinn_fem_tpu.solvers import plasticity as j_pl  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import analysis as t_analysis  # noqa: E402
from pinn_fem_tpu_torch.ops import host as t_host  # noqa: E402
from pinn_fem_tpu_torch.ops import plastic as t_plastic  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import dia_kernel  # noqa: E402
from pinn_fem_tpu_torch.solvers import plasticity as t_pl  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# Elementwise float64 mirrors: measured 0.
MIRROR_RTOL = 1e-12
# The float64 solver tiers against the JAX host tier, of each quantity's
# largest value: measured up to 2.6e-15 (statics) and 1.9e-16 (the
# transient).
F64_RTOL = 1e-10
E, L = 100.0, 2.0
GRID = (4, 6)              # 48 DOFs
BANDED_LIMIT = 16          # DENSE_DOF_LIMIT patched below GRID


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@contextlib.contextmanager
def dense_limit(limit):
    saved = (j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT)
    j_newton.DENSE_DOF_LIMIT = t_newton.DENSE_DOF_LIMIT = limit
    try:
        yield
    finally:
        j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT = saved


def bar(pkg, n_bars=1):
    """n_bars coincident bars, fixed left end, unit end load pattern
    (tests/test_plasticity.py's bar_1d and parallel bars)."""
    return pkg.TrussProblem(np.array([0.0, L]),
                            np.array([[0, 1]] * n_bars),
                            pkg.Material(young=E, area=1.0, density=1.0),
                            np.array([0.0, 1.0]), np.array([0]), 1)


def ten_bar(pkg, density=1.0):
    """tests/test_plasticity.py's 2D cantilever truss."""
    nodes = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0],
                      [2.0, 0.0], [2.0, 1.0]])
    elements = np.array([[0, 2], [2, 4], [1, 3], [3, 5], [2, 3],
                         [4, 5], [0, 3], [1, 2], [2, 5], [3, 4]])
    loads = np.zeros(12)
    loads[9] = -1.0
    loads[5] = -1.0
    return pkg.TrussProblem(nodes, elements,
                            pkg.Material(young=E, area=1.0, density=density),
                            loads, np.array([0, 1, 2, 3]), 2)


def grid(pkg):
    nodes, elements, loads, fixed = eg.grid_arrays(*GRID)
    return pkg.TrussProblem(nodes, elements,
                            pkg.Material(young=50.0, area=1.0, density=1.0),
                            loads, fixed, 2)


CYCLIC = np.concatenate([j_pl.ramp_schedule(3.0, 6),
                         np.linspace(2.0, -1.0, 4), [0.0]])
SIGMA_Y_LIST = np.linspace(1.6, 2.6, 10).tolist()
# Per-element yield stresses on which the JAX host tier's Newton cycles
# from the first unloading step on (ROADMAP fault 3.18).
CYCLING_SIGMA_Y = [2.0, 2.5, 1.8, 3.0, 2.2, 2.0, 2.4, 1.9, 2.1, 2.6]
STATIC_CASES = {
    "ramp": (bar, dict(sigma_y=1.0, hardening_iso=10.0,
                       target_load_factor=1.5, n_steps=15)),
    "unload-reload": (bar, dict(sigma_y=1.0, hardening_iso=10.0,
                                load_factors=np.concatenate([
                                    j_pl.ramp_schedule(1.5, 15),
                                    j_pl.ramp_schedule(1.5, 15)[::-1][1:],
                                    [0.0], j_pl.ramp_schedule(1.5, 15)]))),
    "bauschinger": (bar, dict(sigma_y=1.0, hardening_kin=10.0,
                              load_factors=np.concatenate([
                                  j_pl.ramp_schedule(1.5, 15),
                                  np.linspace(1.3, -1.5, 15)]))),
    "parallel-bars": (lambda pkg: bar(pkg, 3),
                      dict(sigma_y=[1.0, 2.0, 3.0], hardening_iso=10.0,
                           target_load_factor=5.5, n_steps=11)),
    "ten-bar-cyclic": (ten_bar, dict(sigma_y=2.0, hardening_iso=20.0,
                                     hardening_kin=10.0,
                                     load_factors=CYCLIC)),
    "ten-bar-sigma-list": (ten_bar, dict(sigma_y=SIGMA_Y_LIST,
                                         hardening_iso=20.0,
                                         hardening_kin=10.0,
                                         load_factors=CYCLIC)),
    "over-limit": (bar, dict(sigma_y=1.0, load_factors=[0.5, 1.05],
                             max_iter=40)),
    # From an elastic state into yield in one step, one Newton update: the
    # step ends unconverged and (sigma, state) are re-evaluated at the
    # final u.
    "max-iter-1": (ten_bar, dict(sigma_y=2.0, hardening_iso=20.0,
                                 hardening_kin=10.0, load_factors=[0.8, 3.0],
                                 max_iter=1)),
}
# Cases whose members start a step on the yield surface after continued
# loading: the trial yield function's sign there is rounding, so Newton
# takes one iteration more or fewer in either package (ROADMAP fault
# 3.18) while the converged solution agrees.
ROUNDING_ITERATIONS = ("ten-bar-sigma-list",)
STATIC_FIELDS = ("displacements", "stresses", "plastic_strain", "alpha",
                 "back_stress")


# ------------------------------------------------------------ the mirrors

def random_state(seed=5, n=40):
    rng = np.random.default_rng(seed)
    return dict(eps=rng.uniform(-0.05, 0.05, n),
                eps_p=rng.uniform(-0.01, 0.01, n),
                alpha=rng.uniform(0.0, 0.02, n),
                back=rng.uniform(-0.5, 0.5, n),
                young=rng.uniform(50.0, 150.0, n),
                sigma_y=rng.uniform(0.5, 2.0, n),
                h_iso=rng.uniform(0.0, 20.0, n),
                h_kin=rng.uniform(0.0, 20.0, n))


def test_return_map_matches_jax():
    """ops/host.host_return_map and the torch return_map in float64 against
    the JAX host mirror, on seeded strains about the yield surface."""
    s = random_state()
    args = [s[k] for k in ("eps", "eps_p", "alpha", "back", "young",
                           "sigma_y", "h_iso", "h_kin")]
    want = j_host.host_return_map(*args)
    got = t_host.host_return_map(*args)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    sig, e_tan, st = t_plastic.return_map(
        t["eps"], t_plastic.PlasticState(t["eps_p"], t["alpha"], t["back"]),
        t["young"], t_plastic.PlasticParams(t["sigma_y"], t["h_iso"],
                                            t["h_kin"]))
    on_torch = (sig, e_tan, *st)
    assert 0 < np.count_nonzero(want[1] != s["young"]) < len(s["eps"])
    for w, g, h in zip(want, got, on_torch):
        assert rel_err(g, w) <= MIRROR_RTOL
        assert rel_err(h.numpy(), w) <= MIRROR_RTOL


@pytest.mark.parametrize("system", ["plastic", "nonlinear"])
def test_host_systems_match_jax(system):
    """host_plastic_system and host_nonlinear_system against the JAX
    mirrors at a seeded state of the 10-bar truss; the torch dense
    assembly in float64 (ops/plastic.assemble_plastic_system) too."""
    rng = np.random.default_rng(9)
    u = rng.uniform(-0.05, 0.05, 12) * t_host.host_masks(ten_bar(tp))
    if system == "nonlinear":
        want = j_host.host_nonlinear_system(ten_bar(jp), u)
        got = t_host.host_nonlinear_system(ten_bar(tp), u)
        for w, g in zip(want, got):
            assert rel_err(g, w) <= MIRROR_RTOL
        return
    s = random_state(3, 10)
    args = (u, s["eps_p"], s["alpha"], s["back"], s["sigma_y"], s["h_iso"],
            s["h_kin"])
    want = j_host.host_plastic_system(ten_bar(jp), *args, load_factor=1.5)
    got = t_host.host_plastic_system(ten_bar(tp), *args, load_factor=1.5)
    data = ten_bar(tp).to_device("cpu", torch.float64)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    dev = t_plastic.assemble_plastic_system(
        data, ten_bar(tp).material, torch.as_tensor(u),
        t_plastic.PlasticState(t["eps_p"], t["alpha"], t["back"]),
        t_plastic.PlasticParams(t["sigma_y"], t["h_iso"], t["h_kin"]), 1.5)
    for w, g, h in zip(want[:3], got[:3], dev[:3]):
        assert rel_err(g, w) <= MIRROR_RTOL
        assert rel_err(h.numpy(), w) <= MIRROR_RTOL
    for w, g, h in zip(want[3], got[3], dev[3]):
        assert rel_err(g, w) <= MIRROR_RTOL
        assert rel_err(h.numpy(), w) <= MIRROR_RTOL


def test_params_arrays_refusals_match_jax():
    for kw in (dict(sigma_y=0.0), dict(sigma_y=1.0, h_iso=-1.0),
               dict(sigma_y=1.0, h_kin=np.inf)):
        msgs = []
        for mod in (j_pl, t_pl):
            with pytest.raises(ValueError) as err:
                mod.params_arrays(3, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ----------------------------------------------------------------- statics

@pytest.mark.parametrize("host", [None, True], ids=["default", "host"])
@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_float64_tier_matches_jax(case, host):
    """The dense float64 tier (on the caller's device; host=True on the
    CPU) against the JAX host tier: every field within F64_RTOL, equal
    n_plastic and converged (the over-limit and max_iter=1 cases end
    unconverged in both), equal iterations (within one a step where a
    member starts on the yield surface, ROUNDING_ITERATIONS)."""
    make, kw = STATIC_CASES[case]
    j = jp.solve_elastoplastic(make(jp), host=host, **kw)
    t = tp.solve_elastoplastic(make(tp), host=host, device="cpu", **kw)
    assert t.displacements.dtype == np.float64
    for key in STATIC_FIELDS + ("load_factors",):
        assert rel_err(getattr(t, key), getattr(j, key)) <= F64_RTOL, key
    if case in ROUNDING_ITERATIONS:
        assert np.abs(t.iterations - j.iterations).max() <= 1
    else:
        np.testing.assert_array_equal(t.iterations, j.iterations)
    np.testing.assert_array_equal(t.n_plastic, j.n_plastic)
    assert t.converged == j.converged
    # Converged residuals are float64 noise (~1e-14) in both.
    np.testing.assert_allclose(t.residuals, j.residuals, rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["ten-bar-cyclic", "ten-bar-sigma-list",
                                  "max-iter-1"])
def test_float32_tier_matches_jax(case):
    """host=False: the float32 device tiers, within the JAX package's own
    host=False bounds (tests/test_plasticity.py:185-193): displacements
    2e-5 and stresses 1e-4 of their largest, plastic strain 1e-5, equal
    n_plastic; both converge except at max_iter=1, where neither does."""
    make, kw = STATIC_CASES[case]
    j = jp.solve_elastoplastic(make(jp), host=False, **kw)
    t = tp.solve_elastoplastic(make(tp), host=False, device="cpu", **kw)
    scale = np.abs(j.displacements).max()
    np.testing.assert_allclose(t.displacements, j.displacements,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(t.stresses, j.stresses,
                               atol=1e-4 * np.abs(j.stresses).max())
    np.testing.assert_allclose(t.plastic_strain, j.plastic_strain,
                               atol=1e-5)
    np.testing.assert_array_equal(t.n_plastic, j.n_plastic)
    assert t.converged == j.converged == (case != "max-iter-1")
    if case == "max-iter-1":
        assert t.iterations.max() == j.iterations.max() == 1


def test_trial_yield_rounding_fault():
    """ROADMAP fault 3.18: the cyclic history of the 10-bar truss with
    CYCLING_SIGMA_Y.  At the first unloading step members that yielded
    start ON the surface; where their trial f_tr rounds positive the
    plastic tangent overshoots and the JAX host tier's Newton cycles to
    max_iter on every step from there.  The port's float32 static tier
    counts f_tr within 16 eps32 of the surface as elastic and converges,
    with the JAX solution's yielded sets and displacements (float32
    bounds) on the steps before."""
    kw = dict(sigma_y=CYCLING_SIGMA_Y, hardening_iso=15.0,
              load_factors=CYCLIC)
    j = jp.solve_elastoplastic(ten_bar(jp), **kw)
    assert not j.converged and (j.iterations[6:] == 30).all()
    t = tp.solve_elastoplastic(ten_bar(tp), host=False, device="cpu", **kw)
    assert t.converged and t.residuals.max() <= 1e-5
    np.testing.assert_array_equal(t.n_plastic[:6], j.n_plastic[:6])
    np.testing.assert_allclose(
        t.displacements[:6], j.displacements[:6],
        atol=2e-5 * np.abs(j.displacements[:6]).max())


def test_tiers_by_dispatch():
    """Below the limit the default is float64; host=False, a given `data`
    and a problem above the limit take the float32 device tier; the
    device tier's tolerance is floored at 1e-5 (the JAX contract)."""
    kw = dict(sigma_y=2.0, hardening_iso=20.0, load_factors=CYCLIC)
    p = ten_bar(tp)
    assert tp.solve_elastoplastic(p, device="cpu", **kw).residuals.max() \
        <= 1e-9
    f32 = tp.solve_elastoplastic(p, data=p.to_device("cpu"), **kw)
    assert f32.converged and f32.residuals.max() <= 1e-5
    assert f32.residuals.max() > 1e-9
    g = grid(tp)
    with dense_limit(BANDED_LIMIT):
        big = tp.solve_elastoplastic(g, sigma_y=0.6, hardening_iso=5.0,
                                     load_factors=[0.5, 1.0], device="cpu")
    small = tp.solve_elastoplastic(g, sigma_y=0.6, hardening_iso=5.0,
                                   load_factors=[0.5, 1.0], device="cpu")
    assert big.converged and small.converged
    assert big.n_plastic[-1] == small.n_plastic[-1] > 0
    assert rel_err(big.displacements, small.displacements) <= 1e-4


def test_static_refusals_match_jax():
    for kw in (dict(sigma_y=0.0), dict(sigma_y=1.0, hardening_iso=-1.0),
               dict(sigma_y=1.0, load_factors=[])):
        msgs = []
        for pkg, extra in ((jp, {}), (tp, {"device": "cpu"})):
            with pytest.raises(ValueError) as err:
                pkg.solve_elastoplastic(bar(pkg), **kw, **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- transient

PULSE = np.concatenate([np.linspace(0, 4.0, 200), np.zeros(200)])
TRANSIENT_KW = dict(sigma_y=2.0, hardening_iso=20.0, hardening_kin=5.0,
                    n_steps=400, amplitude=PULSE, damping=(0.5, 2e-3),
                    record_every=20, probe_dofs=[9, 11])
TRANSIENT_FIELDS = ("times", "displacements", "velocities",
                    "kinetic_energy", "strain_energy", "plastic_work",
                    "external_work", "stress_envelope", "final_displacement",
                    "final_plastic_strain", "final_alpha")


@pytest.mark.parametrize("host", [None, True], ids=["default", "host"])
def test_transient_float64_tier_matches_jax(host):
    """beta != 0 (a dense float64 K0) and record_every 20: every record
    within F64_RTOL of the JAX host loop, the same dt."""
    j = jp.solve_transient_plastic(ten_bar(jp), host=host, **TRANSIENT_KW)
    t = tp.solve_transient_plastic(ten_bar(tp), host=host, device="cpu",
                                   **TRANSIENT_KW)
    assert t.dt == j.dt
    assert j.plastic_work[-1] > 0.0
    for key in TRANSIENT_FIELDS:
        assert rel_err(getattr(t, key), getattr(j, key)) <= F64_RTOL, key


def test_transient_float32_tier_matches_jax():
    """host=False: the gather form of K0 v in float32 against the JAX
    scan, within its own bounds (tests/test_plasticity.py:330-336)."""
    j = jp.solve_transient_plastic(ten_bar(jp), host=False, **TRANSIENT_KW)
    t = tp.solve_transient_plastic(ten_bar(tp), host=False, device="cpu",
                                   **TRANSIENT_KW)
    scale = np.abs(j.displacements).max()
    np.testing.assert_allclose(t.displacements, j.displacements,
                               atol=5e-4 * scale)
    np.testing.assert_allclose(t.plastic_work[-1], j.plastic_work[-1],
                               rtol=5e-3, atol=1e-8)
    np.testing.assert_allclose(t.final_plastic_strain,
                               j.final_plastic_strain, atol=1e-6)


def test_transient_banded_tier_matches_jax(monkeypatch):
    """Above the lowered limit the grid (a banded layout) takes K0 v from
    kernel 1's dispatch (its twin here), once a step with beta != 0, and
    agrees with the JAX scan (gather form) within its bounds, with the
    same yielded members."""
    calls = []
    inner = dia_kernel.dia_matvec
    monkeypatch.setattr(dia_kernel, "dia_matvec",
                        lambda *a: calls.append(1) or inner(*a))
    n = 300
    amp = np.concatenate([np.linspace(0.0, 1.5, 150), np.zeros(150)])
    kw = dict(sigma_y=0.9, hardening_iso=5.0, n_steps=n, amplitude=amp,
              damping=(0.02, 0.05), record_every=30, probe_dofs=[11, 23, 47])
    with dense_limit(BANDED_LIMIT):
        j = jp.solve_transient_plastic(grid(jp), **kw)
        t = tp.solve_transient_plastic(grid(tp), device="cpu", **kw)
    assert len(calls) == n
    assert np.count_nonzero(j.final_alpha) > 0
    np.testing.assert_array_equal(t.final_alpha > 0, j.final_alpha > 0)
    scale = np.abs(j.displacements).max()
    np.testing.assert_allclose(t.displacements, j.displacements,
                               atol=5e-4 * scale)
    np.testing.assert_allclose(t.plastic_work[-1], j.plastic_work[-1],
                               rtol=5e-3)


def test_transient_refusals_match_jax():
    for kw in (dict(n_steps=11, record_every=2),
               dict(n_steps=10, amplitude=[1.0, 2.0])):
        msgs = []
        for pkg, extra in ((jp, {}), (tp, {"device": "cpu"})):
            with pytest.raises(ValueError) as err:
                pkg.solve_transient_plastic(bar(pkg), sigma_y=1.0, **kw,
                                            **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


TRANSIENT_DOC = {"type": "transient", "dt": "auto", "n_steps": 400,
                 "record_every": 20, "damping": [0.5, 2e-3],
                 "amplitude": PULSE.tolist(), "probe_nodes": [4, 5],
                 "plasticity": {"sigma_y": 2.0, "hardening": 20.0,
                                "kinematic_hardening": 5.0}}


@pytest.mark.parametrize("extra", [
    {"prestress": True}, {"load": {"type": "moving"}},
    {"checkpoint": {"dir": "x", "every": 10}}, {"amplitudes": [[1.0]]},
    {"probe_elements": [0]}, {"include_stress_envelope": True},
    {"geometric_nonlinear": True}, {"method": "newmark"},
    {"plasticity": {"hardening": 1.0}}, {"plasticity": 2.0},
])
def test_transient_document_refusals_match_jax(extra):
    """Every compose refusal of the "plasticity" key, with the JAX
    package's message."""
    analysis = dict(TRANSIENT_DOC, **extra)
    msgs = []
    for run, pkg, args in ((j_analysis.run_analysis, jp, ()),
                           (t_analysis.run_analysis, tp, ("cpu",))):
        with pytest.raises(ValueError) as err:
            run(ten_bar(pkg), analysis, *args)
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
    JAX value."""
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for key in j:
            assert_close_tree(t[key], j[key], rtol, f"{path}/{key}")
    elif isinstance(j, list) and j and not isinstance(j[0], str) \
            and None not in j:
        assert rel_err(t, j) <= rtol, path
    elif isinstance(j, float):
        assert t == pytest.approx(j, rel=rtol), path
    else:
        assert t == j, path


def ten_bar_document() -> dict:
    p = ten_bar(tp)
    return {"nodes": p.nodes.tolist(), "elements": p.elements.tolist(),
            "material": {"young": E, "area": 1.0, "density": 1.0},
            "loads": p.loads.tolist(), "fixed_dofs": [0, 1, 2, 3],
            "solver_type": "fem", "analysis": TRANSIENT_DOC}


@pytest.mark.parametrize("name", ["dyn-plastic", "transient-plastic"])
def test_plastic_documents_through_both_clis(tmp_path, monkeypatch, name):
    """dyn-plastic.json and a plastic transient document of the 10-bar
    truss (the dense float64 tiers): equal exit codes, equal keys and
    flags, numbers within F64_RTOL."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    doc = (json.loads((CORPUS / f"{name}.json").read_text())
           if name.startswith("dyn-") else ten_bar_document())
    (rc_j, j), (rc_t, t) = cli_pair(tmp_path, doc, name)
    assert rc_j == rc_t == 0
    assert j["success"] and j["yielded_elements"]
    assert_close_tree(t, j, F64_RTOL)
