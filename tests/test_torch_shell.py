"""The port's flat-facet shell family (models/shell.py, ops/shell_plastic.py,
solvers/shell_plasticity.py, io/shell_io.py, the shell branches of
solvers/continuum_spectrum.py, solvers/reduction.reduce_model and
io/_common._family_modal, and shell documents through the CLI) against the
JAX package, on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * ELEM_RTOL: the facet blocks, K, M, K_g and the load vectors;
  * F64_RTOL: the float64 analyses (dense statics, buckling, harmonic,
    Guyan reduction, the response spectrum, the random response and the
    stress FRFs); Newmark at NEWMARK_RTOL (its initial acceleration solves
    with the ridged mass);
  * the modal pencil: the ridged shell mass has a condition number near
    2e10, so the JAX package's scipy.linalg.eigh(K, M) (the congruence
    through M's Cholesky factor) leaves the low eigenvalues 1e-7 to 1e-6
    off (ROADMAP fault 3.32); the port takes the reciprocal pencil through
    K's Cholesky factor, held to scipy's float64 eigh of that pencil at
    F64_RTOL and to the JAX package at JAX_EIG_RTOL, as is Craig-Bampton's
    fixed-interface pencil; the spectrum documents fix the drilling
    rotations (global theta_z), which the JAX package's mechanism guard
    needs (ROADMAP fault 3.33), and agree at F64_RTOL;
  * the banded tier: u within 6e-3 max|u| of the dense float64 solve (the
    JAX test's own bound, tests/test_shell.py), the Jacobi count within
    +-2 of the JAX recurrence on the port's float32 diagonals at a
    tolerance above the float32 floor;
  * the plastic host tier at PLASTIC_RTOL (each run stops at |r| / |f| <=
    1e-9); the float32 plastic tier against the port's float64 tier.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import pinn_fem_tpu.models.shell as JS  # noqa: E402
import pinn_fem_tpu.solvers.continuum_spectrum as JCS  # noqa: E402
from pinn_fem_tpu.io import shell_io as j_io  # noqa: E402
from pinn_fem_tpu.ops import dia as j_dia  # noqa: E402
from pinn_fem_tpu.solvers import newton as j_newton  # noqa: E402
from pinn_fem_tpu.solvers import reduction as j_red  # noqa: E402
import scipy.linalg  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.shell as TS  # noqa: E402
import pinn_fem_tpu_torch.solvers.continuum_spectrum as TCS  # noqa: E402
from pinn_fem_tpu_torch.io import _common as t_common  # noqa: E402
from pinn_fem_tpu_torch.io import shell_io as t_io  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as t_dia  # noqa: E402
from pinn_fem_tpu_torch.solvers import newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch.solvers import reduction as t_red  # noqa: E402
from pinn_fem_tpu_torch.solvers.shell_plasticity import \
    solve_shell_plastic as t_plastic  # noqa: E402
from test_torch_frame import aligned, both_clis  # noqa: E402
from test_torch_plate import tree_gaps  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
ELEM_RTOL = 1e-12
F64_RTOL = 1e-10
JAX_EIG_RTOL = 1e-5
PLASTIC_RTOL = 1e-9
# Newmark: a_0 = M_ff^-1 f through the ridged mass (condition ~2e10) carries
# the solvers' rounding into every step; measured 1.9e-10.
NEWMARK_RTOL = 1e-9
BANDED_DENSE_RTOL = 6e-3
CPU = "cpu"


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def both(**kw):
    return TS.ShellProblem(**kw), JS.ShellProblem(**kw)


def roof(n=4, t=1.0, **extra):
    """The Scordelis-Lo roof (R 25, L 50, 40 deg) on an n x n mesh with
    end diaphragms, thickness t, nu 0.1, per-element E, random nodal loads,
    self-weight, a normal pressure and point masses (seeded)."""
    rng = np.random.default_rng(5)
    nodes, el = JS.cylinder_panel_mesh(25.0, 50.0, 40.0, n, n)
    ends = np.flatnonzero((nodes[:, 1] == 0.0) | (nodes[:, 1] == 50.0))
    fixed = np.concatenate([6 * ends, 6 * ends + 2, [1]])
    kw = dict(nodes=nodes, elements=el,
              young=4.32e8 * rng.uniform(0.8, 1.2, el.shape[0]),
              poisson=0.1, thickness=t, density=1.0,
              loads=1e3 * rng.standard_normal(6 * nodes.shape[0]),
              fixed_dofs=fixed, body_force=[0.0, 0.0, -90.0],
              pressure=30.0, point_masses=0.3)
    kw.update(extra)
    return both(**kw)


@pytest.fixture(scope="module")
def shell():
    return roof()


def reciprocal_modes(k, m, free, n):
    """The low modes of K phi = lambda M phi (ridged M) by scipy's float64
    eigh of the reciprocal pencil M phi = mu K phi: (lambda, phi rows)."""
    kf, mf = k[np.ix_(free, free)], m[np.ix_(free, free)]
    mu, vec = scipy.linalg.eigh(mf, kf)
    mu, vec = mu[::-1][:n], vec[:, ::-1][:, :n]
    vec = vec / np.sqrt(np.einsum("ij,ij->j", vec, mf @ vec))
    return 1.0 / mu, vec.T


def test_element_library_matches_jax(shell, monkeypatch):
    """The facet frames, the global blocks of both drilling tiers, K, M,
    K_g and the pressure / body-force and thermal load vectors."""
    tp, jp = shell
    r, c2, warp = JS._facet_frames(jp)
    for got, want in zip(TS._facet_frames(tp), (r, c2, warp)):
        assert rel_err(got, want) <= ELEM_RTOL
    k_t, m_t = TS.shell_matrices(tp, device=CPU)
    k_j, m_j = JS.shell_matrices(jp)
    assert rel_err(k_t.numpy(), k_j) <= ELEM_RTOL
    assert rel_err(m_t.numpy(), m_j) <= ELEM_RTOL
    # The banded tier's blocks: the JAX package's float64 facet blocks with
    # its banded drilling eps.
    monkeypatch.setattr(JS, "_DRILL_EPS", JS._DRILL_EPS_BANDED)
    k_loc, _, _, _ = JS._facet_blocks(jp)
    t24 = JS._transformation_shell(r)
    want = np.einsum("mji,mjk,mkl->mil", t24, k_loc, t24)
    monkeypatch.undo()
    got = TS._stiffness_blocks(tp, CPU, TS._DRILL_EPS_BANDED)
    assert rel_err(got.numpy(), want) <= ELEM_RTOL
    nf = [-1e3, 4e2, 1e2]
    assert rel_err(TS.shell_geometric_stiffness(tp, nf, device=CPU).numpy(),
                   JS.shell_geometric_stiffness(jp, nf)) <= ELEM_RTOL
    assert rel_err(TS._load_vectors(tp).numpy(),
                   JS._load_vectors_shell(jp)) <= ELEM_RTOL
    tp2, jp2 = roof(alpha_cte=1e-5, temperature=np.linspace(5, 20, 16),
                    temperature_gradient=3.0)
    assert rel_err(TS._thermal_load_vectors(tp2).numpy(),
                   JS._thermal_load_vectors_shell(jp2)) <= ELEM_RTOL
    got = TS.solve_shell_static(tp2, device=CPU)
    want = JS.solve_shell_static(jp2)
    for key in ("displacements", "membrane_forces", "moments", "reactions"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL


def test_dense_analyses_match_jax(shell):
    """Statics, modal with and without a membrane prestress (module
    docstring: the reciprocal pencil), buckling under the problem's own
    membrane state, Newmark and harmonic."""
    tp, jp = shell
    got, want = TS.solve_shell_static(tp, device=CPU), \
        JS.solve_shell_static(jp)
    for key in ("displacements", "membrane_forces", "moments", "reactions"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    k, m = JS.shell_matrices(jp)
    m = m + 1e-10 * np.diag(m).max() * np.eye(m.shape[0])
    free = tp.free_dofs()
    for nf in (None, [-2e3, 5e2, 1e2]):
        got = TS.shell_modal(tp, 5, membrane_force=nf, device=CPU)
        want = JS.shell_modal(jp, 5, membrane_force=nf)
        kk = k if nf is None else k + JS.shell_geometric_stiffness(jp, nf)
        lam, vec = reciprocal_modes(kk, m, free, 5)
        assert rel_err(got.eigenvalues, lam) <= F64_RTOL
        assert rel_err(aligned(got.mode_shapes[:, free], vec), vec) \
            <= F64_RTOL
        assert rel_err(got.eigenvalues, want.eigenvalues) <= JAX_EIG_RTOL
    got = TS.shell_buckling(tp, n_modes=3, device=CPU)
    want = JS.shell_buckling(jp, n_modes=3)
    assert rel_err(got.load_factors, want.load_factors) <= F64_RTOL
    assert rel_err(got.membrane_forces, want.membrane_forces) <= F64_RTOL
    assert rel_err(aligned(got.modes, want.modes), want.modes) <= F64_RTOL
    w1 = float(np.sqrt(lam[0]))
    kw = dict(damping=(0.02 * w1, 1e-5), amplitude=np.cos(
        np.arange(30) * 0.3), probe_dofs=[30, 31, 62], record_every=4)
    got = TS.solve_shell_transient(tp, 0.5 / w1, 30, device=CPU, **kw)
    want = JS.solve_shell_transient(jp, 0.5 / w1, 30, **kw)
    assert rel_err(got.times, want.times) <= F64_RTOL
    assert rel_err(got.displacements, want.displacements) <= NEWMARK_RTOL
    om = np.linspace(0.5, 2.0, 4) * w1
    got = TS.shell_harmonic(tp, om, damping=(0.02 * w1, 1e-5), device=CPU)
    want = JS.shell_harmonic(jp, om, damping=(0.02 * w1, 1e-5))
    for key in ("amplitude", "real", "imag"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL


@pytest.mark.parametrize("method", ["guyan", "craig_bampton"])
def test_reduction_matches_jax(shell, method):
    """reduce_model's shell branch (the ridged mass) and _family_modal:
    Guyan at F64_RTOL; Craig-Bampton's modal rows and columns
    sign-aligned, at JAX_EIG_RTOL (the fixed-interface pencil of the
    ridged slave mass goes through M_ss's Cholesky factor in both
    packages)."""
    tp, jp = shell
    masters = [60, 62, 64]
    got = t_red.reduce_model(tp, masters, method=method, n_modes=3,
                             device=CPU)
    want = j_red.reduce_model(jp, masters, method=method, n_modes=3)
    sign = np.ones(got.k_red.shape[0])
    bound = F64_RTOL
    if method == "craig_bampton":
        sign[3:] = np.sign(np.sum(got.t[:, 3:] * want.t[:, 3:], axis=0))
        bound = JAX_EIG_RTOL
    for a, b in ((got.k_red, want.k_red), (got.m_red, want.m_red)):
        assert rel_err(sign[:, None] * a * sign[None, :], b) <= bound
    om, _ = t_common._family_modal(tp, 3, CPU)
    assert rel_err(om, JS.shell_modal(jp, 3).omegas) <= JAX_EIG_RTOL


def test_banded_statics_matches_jax_and_float64():
    """solve_shell_static_banded on the 12 x 12 Scordelis-Lo roof (t =
    0.25, the JAX test's): the layout (69 diagonals, bandwidth 6 (nx + 2) +
    5 = 89), u and the membrane forces within 6e-3 of the dense float64
    solve.  On the 8 x 8 roof at t = 1 the Jacobi count at tol 1e-5 within
    +-2 of the JAX recurrence on the port's float32 diagonals (on the thin
    roof the float32 counts of the two recurrences drift apart by about 9
    in 1,500, as the frame family's do: ROADMAP fault 3.28)."""
    tp, jp = roof(12, t=0.25, young=4.32e8, poisson=0.0, pressure=None,
                  point_masses=None, loads=np.zeros(6 * 169))
    layout = TS.shell_dia_layout(tp)
    assert (layout.n_diags, layout.bandwidth) == (69, 89)
    dense = JS.solve_shell_static(jp)
    got, iters, rel = TS.solve_shell_static_banded(tp, tol=1e-8,
                                                   device=CPU)
    assert 0 < iters and rel <= 1e-8
    for key in ("displacements", "membrane_forces"):
        assert rel_err(getattr(got, key), getattr(dense, key)) \
            <= BANDED_DENSE_RTOL
    tp, jp = roof(8)
    _, iters5, _ = TS.solve_shell_static_banded(tp, tol=1e-5, device=CPU)
    layout = TS.shell_dia_layout(tp)
    diags = t_dia.assemble_dia_blocks(layout, TS._stiffness_blocks(
        tp, CPU, TS._DRILL_EPS_BANDED)).float()
    f = TS._static_loads(tp, CPU).float()
    jl = j_dia.dia_layout(jp.dof_map(), jp.ndof, max_diags=224)
    _, j_iters, _ = j_dia.dia_cg_solve(
        jl, jnp.asarray(diags.numpy()), jnp.asarray(f.numpy()),
        jnp.asarray(jp.free_mask(), jnp.float32), tol=1e-5,
        max_iter=40000, components=6)
    assert abs(iters5 - int(j_iters)) <= 2


PLASTIC_DOC = json.loads((CORPUS / "dyn-shell-plastic.json").read_text())


def test_plastic_float32_tier_against_float64():
    """The float32 device tier (host=False) on the strip with hardening, up
    to a partly plastic step: converged at its 1e-5 floor, u within 1e-3
    and the yielding counts equal to the float64 tier's."""
    tp = t_io.parse_shell_document(PLASTIC_DOC)[0]
    kw = dict(sigma_y=300.0, hardening_iso=2e4, n_layers=4,
              load_factors=[0.4, 0.8])
    f64 = t_plastic(tp, host=True, **kw)
    f32 = t_plastic(tp, host=False, device=CPU, **kw)
    assert f64.converged and f32.converged
    assert f64.n_plastic[-1] > 0
    assert rel_err(f32.displacements, f64.displacements) <= 1e-3
    assert np.array_equal(f32.n_plastic, f64.n_plastic)


def spectral_doc(**analysis):
    return {"element_type": "shell",
            "mesh": {"type": "cylinder_panel", "radius": 25.0,
                     "length": 40.0, "half_angle_deg": 40.0, "nx": 4,
                     "ny": 3},
            "material": {"young": 4.32e8, "poisson": 0.2, "thickness": 1.0,
                         "density": 2.0},
            "supports": [{"nodes": "y_min", "dofs": [0, 1, 2, 3, 4, 5]},
                         {"nodes": list(range(20)), "dofs": [5]}],
            "body_force": [0.0, 0.0, -90.0], "pressure": 20.0,
            "analysis": analysis}


@pytest.fixture(scope="module")
def spectral():
    doc = spectral_doc(type="static")
    tp, jp = t_io.parse_shell_document(doc)[0], \
        j_io.parse_shell_document(doc)[0]
    w = float(JS.shell_modal(jp, 1).omegas[0])
    return tp, jp, np.linspace(0.3, 2.5, 12) * w, (0.05 * w, 0.01 / w)


def test_spectrum_and_random_match_jax(spectral):
    """continuum_response_spectrum (CQC, a tilted direction: the modes at
    JAX_EIG_RTOL, module docstring) and continuum_random_response at
    F64_RTOL; the participations by magnitude."""
    tp, jp, om, damping = spectral
    kw = dict(direction=[0.3, 1.0, -0.2], n_modes=4, combination="cqc")
    got = TCS.continuum_response_spectrum(tp, 3.0, device=CPU, **kw)
    want = JCS.continuum_response_spectrum(jp, 3.0, **kw)
    for key in ("displacements", "omegas", "effective_mass", "stresses",
                "von_mises"):
        assert rel_err(getattr(got, key), getattr(want, key)) \
            <= JAX_EIG_RTOL, key
    assert rel_err(np.abs(got.participation), np.abs(want.participation)) \
        <= JAX_EIG_RTOL
    probe = [6 * 7 + 2, 6 * 12 + 1]
    got = TCS.continuum_random_response(tp, 2.0, om, damping=damping,
                                        probe_dofs=probe, device=CPU)
    want = JCS.continuum_random_response(jp, 2.0, om, damping=damping,
                                         probe_dofs=probe)
    for key in ("psd", "rms", "frf_amplitude"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL


def test_fatigue_and_fiber_frf_match_jax(spectral):
    """shell_fiber_stress_frf (its own sweep and from `fields`) and the
    governing-fiber spectral fatigue (Dirlik with an S-N curve) at
    F64_RTOL."""
    tp, jp, om, damping = spectral
    probe = [0, 5, 11]
    want = JCS.shell_fiber_stress_frf(jp, om, damping=damping,
                                      probe_elements=probe)
    got = TCS.shell_fiber_stress_frf(tp, om, damping=damping,
                                     probe_elements=probe, device=CPU)
    assert rel_err(np.abs(got), np.abs(want)) <= F64_RTOL
    assert rel_err(got.real, want.real) <= F64_RTOL
    fields = TCS.harmonic_fields(tp, om, damping, CPU)
    assert np.array_equal(TCS.shell_fiber_stress_frf(
        tp, om, damping=damping, probe_elements=probe, device=CPU,
        fields=fields), got)
    kw = dict(damping=damping, probe_elements=probe, sn_exponent=4.0,
              sn_coefficient=1e30, method="dirlik", duration=60.0)
    got = TCS.continuum_spectral_fatigue(tp, 2.0, om, device=CPU,
                                         fields=fields, **kw)
    want = JCS.continuum_spectral_fatigue(jp, 2.0, om, **kw)
    assert rel_err(got.eq_psd, want.eq_psd) <= F64_RTOL
    for key in ("rms", "damage_rate", "nu0", "expected_peak"):
        assert rel_err(getattr(got.fatigue, key),
                       getattr(want.fatigue, key)) <= F64_RTOL, key


@pytest.mark.parametrize("name", ["dyn-shell", "dyn-shell-plastic"])
def test_corpus_documents_match_jax(tmp_path, monkeypatch, name):
    """dyn-shell.json (the 16 x 16 Scordelis-Lo roof, dense) and
    dyn-shell-plastic.json (the float64 plastic tier, with its history of
    resultants and fiber stresses) through both CLIs: exit codes 0, the
    result JSON within F64_RTOL (the plastic fields at PLASTIC_RTOL, the
    iteration and yielding counts equal, its residual, rounding noise,
    within 1e-9), the summary lines equal."""
    doc = json.loads((CORPUS / f"{name}.json").read_text())
    if name == "dyn-shell-plastic":
        doc["analysis"]["include_history"] = True
    (rc_j, want, log_j), (rc_t, got, log_t) = both_clis(
        tmp_path, monkeypatch, name, doc)
    assert rc_j == rc_t == 0
    bound = F64_RTOL
    if "max_residual" in want:
        assert max(got.pop("max_residual"), want.pop("max_residual")) \
            <= 1e-9
        for key in ("iterations", "n_plastic"):
            assert got.pop(key) == want.pop(key)
        bound = PLASTIC_RTOL
    gaps = tree_gaps(got, want)
    assert max(gaps.values()) <= bound, gaps
    lines = log_j.splitlines()
    at = next(i for i, ln in enumerate(lines) if "SUMMARY" in ln)
    for ln in lines[at:at + 2] + [ln for ln in lines
                                  if "Shell document" in ln]:
        assert ln.split("] ", 1)[1] in log_t


def small_doc(**analysis):
    doc = spectral_doc(**analysis)
    doc["point_masses"] = [[7, 0.5]]
    doc["point_loads"] = [[12, 1, 300.0], [13, 4, -50.0]]
    return doc


DOCUMENTS = {
    "static": {"type": "static", "probe_nodes": [9]},
    "shell": {"type": "shell"},
    "buckling": {"type": "buckling", "n_modes": 2},
    "buckling-given": {"type": "buckling", "n_modes": 2,
                       "membrane_force": [-1e3, 0.0, 0.0],
                       "include_shapes": False},
    "transient": {"type": "transient", "dt": 2e-3, "n_steps": 20,
                  "damping": [0.5, 1e-5], "record_every": 3,
                  "probe_nodes": [18]},
    "harmonic": {"type": "harmonic", "damping": [0.5, 1e-5],
                 "omegas": {"start": 20.0, "stop": 200.0, "num": 5},
                 "probe_nodes": [18]},
    "reduction": {"type": "reduction", "method": "guyan",
                  "master_nodes": [17, 19]},
    "random-fatigue": {"type": "random", "psd": 1.0, "damping": [0.5, 1e-5],
                       "omegas": {"start": 20.0, "stop": 200.0, "num": 6},
                       "probe_nodes": [18], "probe_elements": [0, 7],
                       "fatigue": {"sn": {"exponent": 3.0,
                                          "coefficient": 1e30}}},
}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_document_analyses_match_jax(name):
    doc = small_doc(**DOCUMENTS[name])
    want = json.loads(json.dumps(j_io.run_shell_document(
        json.loads(json.dumps(doc)))))
    got = json.loads(json.dumps(t_io.run_shell_document(
        json.loads(json.dumps(doc)), CPU)))
    if "buckling_modes" in want:
        got["buckling_modes"] = aligned(got["buckling_modes"],
                                        want["buckling_modes"]).tolist()
    if "max_residual" in want:
        assert max(got.pop("max_residual"), want.pop("max_residual")) \
            <= 1e-9
    gaps = tree_gaps(got, want)
    bound = JAX_EIG_RTOL if name == "reduction" else F64_RTOL
    assert max(gaps.values()) <= bound, gaps


# The banded static payload's keys (pinn_fem_tpu/io/shell_io.py:280-300).
BANDED_KEYS = {"success", "analysis", "element_type", "tier", "iterations",
               "relative_residual", "max_displacement",
               "max_displacement_dof", "max_abs_membrane_force",
               "max_abs_moment", "probe_dofs", "probe_displacements"}


def test_banded_document_matches_jax(monkeypatch):
    """Above DENSE_DOF_LIMIT (patched to 64 in both packages) the static
    document takes the banded tier with the JAX package's payload keys,
    the probe within BANDED_DENSE_RTOL of the dense float64 solve; modal
    and buckling refuse with the JAX package's words."""
    monkeypatch.setattr(j_newton, "DENSE_DOF_LIMIT", 64)
    monkeypatch.setattr(t_newton, "DENSE_DOF_LIMIT", 64)
    doc = small_doc(type="static", tolerance=1e-8, probe_nodes=[18])
    got = t_io.run_shell_document(json.loads(json.dumps(doc)), CPU)
    assert set(got) == BANDED_KEYS and got["tier"] == "banded"
    assert got["probe_dofs"] == list(range(108, 114))
    assert got["relative_residual"] <= 1e-8
    tp = t_io.parse_shell_document(doc)[0]
    u = TS.solve_shell_static(tp, device=CPU).displacements
    assert rel_err(got["probe_displacements"], u[got["probe_dofs"]]) \
        <= BANDED_DENSE_RTOL
    for kind in ("modal", "buckling"):
        errs = []
        for run, args in ((j_io.run_shell_document, ()),
                          (t_io.run_shell_document, (CPU,))):
            with pytest.raises(ValueError) as err:
                run(small_doc(type=kind), *args)
            errs.append(str(err.value))
        assert errs[0] == errs[1]


REFUSALS = {
    "unknown-type": ({}, {"type": "fatigue"}),
    "plastic-sigma": ({}, {"type": "plastic"}),
    "plastic-layers": ({}, {"type": "plastic", "sigma_y": 1.0,
                            "n_layers": 3}),
    "amplitude": ({}, {"type": "transient", "dt": 0.1, "n_steps": 3,
                       "amplitude": {"type": "saw"}}),
    "transient-thermal": (dict(temperature=5.0, material={
        "young": 1e8, "poisson": 0.2, "thickness": 1.0, "alpha": 1e-5}),
        {"type": "transient", "dt": 0.1, "n_steps": 3}),
    "thermal-alpha": (dict(temperature=5.0), {"type": "static"}),
    "thickness": (dict(material={"young": 1e8}), {"type": "static"}),
    "mesh-type": (dict(mesh={"type": "torus"}), {"type": "static"}),
    "sine-load": (dict(sine_load=1.0), {"type": "static"}),
    "supports": (dict(supports=[{"nodes": "y_min", "dofs": [6]}]),
                 {"type": "static"}),
    "node-group": (dict(supports=[{"nodes": "w_min", "dofs": [0]}]),
                   {"type": "static"}),
    "no-supports": (dict(supports=None), {"type": "static"}),
    "deep": ({}, {"type": "nonlinear"}),
    "tension-buckling": ({}, {"type": "buckling",
                              "membrane_force": [1.0, 1.0, 0.0]}),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    """Each refusal with the JAX package's error type and message."""
    extra, analysis = REFUSALS[name]
    doc = dict(small_doc(**analysis), **extra)
    doc = {k: v for k, v in doc.items() if v is not None}
    errs = []
    for run, args in ((j_io.run_shell_document, ()),
                      (t_io.run_shell_document, (CPU,))):
        with pytest.raises(Exception) as err:
            run(json.loads(json.dumps(doc)), *args)
        errs.append((type(err.value), str(err.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kind, item", [
    ("identification", 23), ("reliability", 24), ("sizing", 24)])
def test_later_analysis_types_refused(kind, item):
    """Items 23 and 24 are ported: a bare identification, reliability or
    sizing block is refused in the JAX package's words and error type."""
    if item == 23:
        with pytest.raises(ValueError, match='needs "measured_dofs"'):
            t_io.run_shell_document(small_doc(type=kind), CPU)
        return
    errs = []
    for run, args in ((j_io.run_shell_document, ()),
                      (t_io.run_shell_document, (CPU,))):
        with pytest.raises(ValueError) as err:
            run(small_doc(type=kind), *args)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("call", [
    lambda p: TS.shell_matrices(p),
    lambda p: TS.solve_shell_static(p),
    lambda p: TS.shell_modal(p, 2),
    lambda p: TS.shell_geometric_stiffness(p, [-1.0, 0.0, 0.0]),
    lambda p: TS.shell_buckling(p),
    lambda p: TS.solve_shell_transient(p, 0.01, 3),
    lambda p: TS.shell_harmonic(p, [1.0]),
    lambda p: TS.solve_shell_static_banded(p),
    lambda p: t_plastic(p, sigma_y=1.0, n_steps=2),
    lambda p: t_red.reduce_model(p, [60]),
    lambda p: TCS.shell_fiber_stress_frf(p, [1.0], damping=(0.1, 0.0)),
    lambda p: TCS.continuum_response_spectrum(p, 1.0),
    lambda p: t_io.run_shell_analysis(p, {"type": "static"}),
], ids=["matrices", "static", "modal", "geometric", "buckling",
        "transient", "harmonic", "banded", "plastic", "reduction",
        "fiber_frf", "spectrum", "document"])
def test_entry_points_default_to_the_card(monkeypatch, shell, call):
    """With no device= a shell entry point runs on "cuda": without a card
    it raises, and nothing falls back to the CPU."""
    tp, _ = shell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        call(tp)
