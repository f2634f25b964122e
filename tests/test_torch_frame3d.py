"""The port's 3D space-frame family (models/frame3d.py, io/frame3d_io.py,
the space-frame branches of solvers/reduction.reduce_model and
io/_common._family_modal, and space-frame documents through the CLI)
against the JAX package, on the CPU.

Both packages get the same numpy arrays; the bounds are those of
tests/test_torch_frame.py: F64_RTOL for the float64 library and dense
analyses (shapes sign-aligned; degenerate pairs compared by subspace),
EIG_RTOL for eigenvalues, BANDED_RTOL / DENSE_RTOL for the banded statics
against the JAX package's banded and the float64 dense solves, MODAL_RTOL
for the banded modal, and the Jacobi counts within +-2 of the JAX
package's at tolerance 1e-6 on grid3d(6, 2, 3).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu.models.frame3d as JF3  # noqa: E402
from pinn_fem_tpu.io import frame3d_io as j_io  # noqa: E402
from pinn_fem_tpu.solvers import reduction as j_red  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.frame3d as TF3  # noqa: E402
from pinn_fem_tpu_torch import examples_grid  # noqa: E402
from pinn_fem_tpu_torch.io import _common as t_common  # noqa: E402
from pinn_fem_tpu_torch.io import frame3d_io as t_io  # noqa: E402
from pinn_fem_tpu_torch.solvers import reduction as t_red  # noqa: E402
from test_torch_frame import (BANDED_RTOL, CPU, DENSE_RTOL,  # noqa: E402
                              EIG_RTOL, F64_RTOL, MODAL_RTOL, aligned,
                              both_clis, rel_err, tree_gap)

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
E, G, A, IY, IZ, J, RHO = 200.0, 80.0, 1.0, 0.02, 0.05, 0.03, 1.2
L = 4.0


def both(build):
    kw = build()
    return TF3.SpaceFrameProblem(**kw), JF3.SpaceFrameProblem(**kw)


def cantilever(n=1, dof=1, value=-1.0, direction=(1.0, 0.0, 0.0), **extra):
    def build():
        d = np.asarray(direction, dtype=float)
        nodes = np.linspace(0.0, L, n + 1)[:, None] * d / np.linalg.norm(d)
        loads = np.zeros(6 * (n + 1))
        loads[6 * n + dof] = value
        return dict(nodes=nodes, elements=np.stack(
            [np.arange(n), np.arange(1, n + 1)], axis=1), young=E, area=A,
            inertia_y=IY, inertia_z=IZ, torsion_j=J, density=RHO,
            loads=loads, fixed_dofs=np.arange(6), shear_modulus=G, **extra)
    return build


def grillage():
    def build():
        loads = np.zeros(18)
        loads[14] = -1.0
        return dict(nodes=[[0.0, 0.0, 0.0], [3.0, 0.0, 0.0],
                           [3.0, 2.0, 0.0]], elements=[[0, 1], [1, 2]],
                    young=E, area=A, inertia_y=IY, inertia_z=IZ,
                    torsion_j=J, density=RHO, loads=loads,
                    fixed_dofs=np.arange(6), shear_modulus=G)
    return build


def heated(n=8, **thermal):
    """A member clamped at both ends under a thermal load case."""
    def build():
        nodes = np.linspace(0.0, L, n + 1)[:, None] * [1.0, 0.0, 0.0]
        return dict(nodes=nodes, elements=np.stack(
            [np.arange(n), np.arange(1, n + 1)], axis=1), young=E, area=A,
            inertia_y=IY, inertia_z=IZ, torsion_j=J, density=RHO,
            loads=np.zeros(6 * (n + 1)),
            fixed_dofs=np.concatenate([np.arange(6), 6 * n + np.arange(6)]),
            shear_modulus=G, alpha_cte=1.2e-5, **thermal)
    return build


def random_frame(seed=0, n=7):
    """An irregular space frame with every optional array (a vertical
    member, ref_vectors on some members, member loads, thermal case)."""
    def build():
        rng = np.random.default_rng(seed)
        nodes = rng.uniform(0.0, 4.0, (n, 3))
        nodes[1] = nodes[0] + [0.0, 0.0, 2.0]          # a vertical member
        el = np.array([[i, i + 1] for i in range(n - 1)] + [[0, n - 1],
                                                            [2, 5]])
        m = el.shape[0]
        rv = np.zeros((m, 3))
        rv[3] = [0.3, 1.0, 0.2]
        return dict(nodes=nodes, elements=el,
                    young=rng.uniform(100, 300, m),
                    area=rng.uniform(0.5, 2.0, m),
                    inertia_y=rng.uniform(0.01, 0.1, m),
                    inertia_z=rng.uniform(0.01, 0.1, m),
                    torsion_j=rng.uniform(0.01, 0.1, m),
                    density=rng.uniform(1.0, 2.0, m),
                    loads=rng.normal(size=6 * n),
                    fixed_dofs=np.arange(6), poisson=0.3,
                    point_masses=rng.uniform(0.0, 1.0, n), ref_vector=rv,
                    polar_inertia=rng.uniform(0.05, 0.2, m),
                    member_loads=rng.normal(size=(m, 3)), alpha_cte=1e-3,
                    temperature=rng.normal(size=m),
                    temperature_gradient_y=rng.normal(size=m),
                    temperature_gradient_z=rng.normal(size=m))
    return build


def no_thermal(build):
    def inner():
        kw = build()
        for k in ("alpha_cte", "temperature", "temperature_gradient_y",
                  "temperature_gradient_z"):
            kw.pop(k, None)
        return kw
    return inner


STATICS = {
    **{f"cantilever_{d}": cantilever(dof=d) for d in range(6)},
    "cantilever_oblique": cantilever(3, dof=2, direction=(1.0, 2.0, 0.5)),
    "vertical": cantilever(4, dof=0, direction=(0.0, 0.0, 1.0)),
    "vertical_ref": cantilever(2, dof=1, direction=(0.0, 0.0, 1.0),
                               ref_vector=[1.0, 1.0, 0.0]),
    "grillage": grillage(),
    "heated_dt": heated(2, temperature=40.0),
    "heated_gy": heated(2, temperature_gradient_y=3.0),
    "heated_gz": heated(2, temperature_gradient_z=5.0),
    "member_loads": cantilever(2, member_loads=[[0.1, -0.3, 0.2]] * 2),
    "random": random_frame(),
}


def test_element_library_matches_jax():
    """_geometry3d (the vertical fallback and ref_vector rules),
    _transformation3d, _k_local3d, _m_local3d, _kg_local3d and the member
    and thermal load vectors, in float64."""
    tp, jp = both(random_frame(5))
    length, r = TF3._geometry3d(tp)
    jl, jr = JF3._geometry3d(jp)
    gaps = {"length": rel_err(length, jl), "R": rel_err(r, jr),
            "T": rel_err(TF3._transformation3d(r),
                         JF3._transformation3d(jr)),
            "k_local": rel_err(TF3._section(tp, CPU)[2],
                               JF3._k_local3d(jp, jl)),
            "m_local": rel_err(TF3._m_local3d(tp, length),
                               JF3._m_local3d(jp, jl)),
            "kg_local": rel_err(TF3._kg_local3d(torch.as_tensor(jp.young),
                                                length),
                                JF3._kg_local3d(jp.young, jl))}
    for name, port, jax in (("member", TF3._member_load_vectors3,
                             JF3._member_load_vectors3),
                            ("thermal", TF3._thermal_member_vectors3,
                             JF3._thermal_member_vectors3)):
        f_t, loc_t = port(tp)
        f_j, loc_j = jax(jp)
        gaps[name] = max(rel_err(f_t, f_j), rel_err(loc_t, loc_j))
    assert max(gaps.values()) <= F64_RTOL, gaps


def test_matrices_and_lumped_mass_match_jax():
    tp, jp = both(random_frame(6))
    kt, mt = TF3.space_frame_matrices(tp, device=CPU)
    kj, mj = JF3.space_frame_matrices(jp)
    assert rel_err(kt, kj) <= F64_RTOL and rel_err(mt, mj) <= F64_RTOL
    assert rel_err(TF3.space_frame_lumped_mass_diag(tp, CPU),
                   JF3.space_frame_lumped_mass_diag(jp)) <= F64_RTOL


@pytest.mark.parametrize("name", sorted(STATICS))
def test_static_matches_jax(name):
    """solve_space_frame_static on the JAX tests' closed-form problems:
    every field within F64_RTOL (forces against at least the applied and
    fixed-end loads' scale)."""
    tp, jp = both(STATICS[name])
    got = TF3.solve_space_frame_static(tp, device=CPU)
    want = JF3.solve_space_frame_static(jp)
    loads = [jp.loads] + [v for fn in (JF3._member_load_vectors3,
                                       JF3._thermal_member_vectors3)
                          for v in fn(jp)]
    force = max(float(np.abs(v).max()) for v in loads)
    for field in ("displacements", "member_end_forces", "axial", "torque",
                  "moments_y", "moments_z", "reactions"):
        floor = 1e-20 if field == "displacements" else force
        assert rel_err(getattr(got, field), getattr(want, field),
                       floor) <= F64_RTOL, field


def test_closed_forms():
    """The grillage's w_C = -(P L1^3/3EIy + P L2^3/3EIy + P L2^2 L1/GJ)
    with two elements, and the tip of a one-element cantilever."""
    tp, _ = both(grillage())
    w = TF3.solve_space_frame_static(tp, device=CPU).displacements[14]
    np.testing.assert_allclose(w, -(27.0 / (3 * E * IY) + 8.0 / (3 * E * IY)
                                    + 12.0 / (G * J)), rtol=1e-12)
    tp, _ = both(cantilever())
    u = TF3.solve_space_frame_static(tp, device=CPU).displacements
    np.testing.assert_allclose(u[7], -L ** 3 / (3 * E * IZ), rtol=1e-12)


def test_end_forces_match_jax():
    tp, jp = both(random_frame(2))
    u = np.random.default_rng(1).normal(size=jp.ndof)
    assert rel_err(TF3.space_frame_end_forces(tp, u, device=CPU),
                   JF3.space_frame_end_forces(jp, u)) <= F64_RTOL


@pytest.mark.parametrize("call", [
    lambda p: TF3.space_frame_end_forces(p, np.zeros(p.ndof)),
    lambda p: TF3.space_frame_matrices(p),
    lambda p: TF3.solve_space_frame_static(p),
    lambda p: TF3.space_frame_modal(p, 2),
    lambda p: TF3.solve_space_frame_static_banded(p),
    lambda p: t_io.run_frame3d_analysis(p, {"type": "static"}),
], ids=["end_forces", "matrices", "static", "modal", "banded", "document"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """With no device= a space-frame entry point runs on "cuda": without
    a card it raises, and nothing falls back to the CPU."""
    tp, _ = both(cantilever())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        call(tp)


def subspace_gap(got_shapes, want_shapes, lam, mass) -> float:
    """Each got shape's distance from the span of want's shapes whose
    eigenvalues it shares (degenerate pairs), M-orthogonal projection."""
    gap = 0.0
    for i, lam_i in enumerate(lam):
        cluster = np.flatnonzero(np.abs(lam - lam_i) <= 1e-8 * abs(lam_i))
        basis = want_shapes[cluster].T
        proj = basis @ (basis.T @ (mass @ got_shapes[i]))
        gap = max(gap, rel_err(got_shapes[i], proj))
    return gap


@pytest.mark.parametrize("name", ["cantilever_oblique", "random",
                                  "square"])
def test_modal_matches_jax(name):
    """space_frame_modal: eigenvalues within EIG_RTOL; shapes by subspace
    (a square section's bending pairs are degenerate)."""
    if name == "square":
        tp, jp = both(lambda: dict(cantilever(6)(), inertia_y=IZ))
    else:
        tp, jp = both(no_thermal(STATICS[name]))
    got = TF3.space_frame_modal(tp, n_modes=6, device=CPU)
    want = JF3.space_frame_modal(jp, n_modes=6)
    assert rel_err(got.eigenvalues, want.eigenvalues) <= EIG_RTOL
    _, mass = JF3.space_frame_matrices(jp)
    assert subspace_gap(got.mode_shapes, want.mode_shapes,
                        want.eigenvalues, mass) <= F64_RTOL


def test_transient_and_harmonic_match_jax():
    tp, jp = both(no_thermal(random_frame(3)))
    kw = dict(damping=(0.01, 0.002), amplitude=np.cos(0.2 * np.arange(30)),
              probe_dofs=[6, 7, 8, 20], record_every=4)
    got = TF3.solve_space_frame_transient(tp, 0.05, 30, device=CPU, **kw)
    want = JF3.solve_space_frame_transient(jp, 0.05, 30, **kw)
    assert rel_err(got.times, want.times) <= F64_RTOL
    assert rel_err(got.displacements, want.displacements) <= F64_RTOL
    om = np.linspace(0.1, 4.0, 9)
    got = TF3.space_frame_harmonic(tp, om, damping=(0.02, 0.001),
                                   probe_dofs=[6, 20], device=CPU)
    want = JF3.space_frame_harmonic(jp, om, damping=(0.02, 0.001),
                                    probe_dofs=[6, 20])
    for field in ("amplitude", "real", "imag"):
        assert rel_err(getattr(got, field), getattr(want, field)) \
            <= F64_RTOL


@pytest.mark.parametrize("name", ["column", "heated"])
def test_buckling_matches_jax(name):
    """space_frame_buckling: a weak-axis Euler column and the heated
    clamped column (restraint compression), load factors within
    EIG_RTOL, unit-norm modes after sign alignment."""
    if name == "column":
        build = cantilever(8, dof=0, value=-1.0)
    else:
        build = heated(8, temperature=40.0)
    tp, jp = both(build)
    got = TF3.space_frame_buckling(tp, n_modes=2, device=CPU)
    want = JF3.space_frame_buckling(jp, n_modes=2)
    assert rel_err(got.load_factors, want.load_factors) <= EIG_RTOL
    assert rel_err(aligned(got.modes, want.modes), want.modes) <= F64_RTOL
    assert rel_err(got.axial, want.axial) <= F64_RTOL


@pytest.mark.parametrize("kw, match", [
    (dict(nodes=np.zeros((2, 2))), "nodes must be"),
    (dict(elements=[[0, 1, 1]]), "elements must be"),
    (dict(torsion_j=0.0), "torsion_j must be positive"),
    (dict(shear_modulus=None), "shear_modulus"),
    (dict(loads=np.zeros(5)), "loads must have"),
    (dict(temperature=1.0), "thermal expansion"),
    (dict(ref_vector=[[1.0, 0.0, 0.0]]), "parallel"),
    (dict(nodes=np.zeros((2, 3))), "zero-length"),
])
def test_validation_matches_jax(kw, match):
    base = dict(nodes=[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], elements=[[0, 1]],
                young=E, area=A, inertia_y=IY, inertia_z=IZ, torsion_j=J,
                density=RHO, loads=np.zeros(12), fixed_dofs=np.arange(6),
                shear_modulus=G)
    base.update(kw)
    msgs = []
    for cls in (JF3.SpaceFrameProblem, TF3.SpaceFrameProblem):
        with pytest.raises(ValueError, match=match) as err:
            cls(**base)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_dynamics_refuse_thermal():
    tp, jp = both(heated(2, temperature=40.0))
    for port, jax, args in (
            (TF3.solve_space_frame_transient,
             JF3.solve_space_frame_transient, (0.1, 3)),
            (TF3.space_frame_harmonic, JF3.space_frame_harmonic, ([1.0],))):
        with pytest.raises(ValueError) as want:
            jax(jp, *args)
        with pytest.raises(ValueError) as got:
            port(tp, *args, device=CPU)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ banded tier


def grid_pair(stories=6, gx=2, gy=3, **material):
    doc = examples_grid.space_frame_grid_document(stories, gx, gy)
    doc["material"].update(material)
    return (t_io.parse_frame3d_document(doc)[0],
            j_io.parse_frame3d_document(doc)[0])


def test_banded_static_matches_jax_and_dense():
    """grid3d(6, 2, 3): banded u within BANDED_RTOL of the JAX package's
    and DENSE_RTOL of float64 dense, the base shear balancing the wind, the
    counts within +-2 at tol 1e-6."""
    tp, jp = grid_pair()
    dense = JF3.solve_space_frame_static(jp)
    got, _, rel = TF3.solve_space_frame_static_banded(tp, tol=1e-8,
                                                      device=CPU)
    want, _, _ = JF3.solve_space_frame_static_banded(jp, tol=1e-8)
    assert rel < 1e-7
    assert rel_err(got.displacements, want.displacements) <= BANDED_RTOL
    assert rel_err(got.displacements, dense.displacements) <= DENSE_RTOL
    assert rel_err(got.member_end_forces, dense.member_end_forces) \
        <= DENSE_RTOL
    np.testing.assert_allclose(-got.reactions[1::6].sum(),
                               tp.loads[1::6].sum(), rtol=DENSE_RTOL)
    _, it_t, _ = TF3.solve_space_frame_static_banded(tp, tol=1e-6,
                                                     device=CPU)
    _, it_j, _ = JF3.solve_space_frame_static_banded(jp, tol=1e-6)
    assert abs(it_t - it_j) <= 2, (it_t, it_j)


def test_banded_modal_matches_jax():
    """space_frame_modal_banded against the JAX package's on the same
    lumped pencil (a well-scaled skeleton)."""
    tp, jp = grid_pair(4, 2, 2, young=1000.0, shear_modulus=400.0,
                       area=1.0, inertia_y=0.1, inertia_z=0.08,
                       torsion=0.1, density=1.0)
    got = TF3.space_frame_modal_banded(tp, n_modes=3, n_iter=8,
                                       cg_tol=1e-8, device=CPU)
    want = JF3.space_frame_modal_banded(jp, n_modes=3, n_iter=8,
                                        cg_tol=1e-8)
    assert rel_err(got.eigenvalues, want.eigenvalues) <= MODAL_RTOL
    assert got.mode_shapes.shape == (3, tp.ndof)


def test_banded_refuses_mesh():
    tp, _ = grid_pair(2, 2, 2)
    for fn in (TF3.solve_space_frame_static_banded,
               TF3.space_frame_modal_banded):
        with pytest.raises(NotImplementedError, match="item 15"):
            fn(tp, mesh=object(), device=CPU)


# ------------------------------------------------------------ documents


def test_corpus_document_matches_jax(tmp_path, monkeypatch):
    """dyn-frame3d (the grillage) through both CLIs: exit codes 0, the
    result within F64_RTOL, the summary line equal."""
    doc = json.loads((CORPUS / "dyn-frame3d.json").read_text())
    (rc_j, want, log_j), (rc_t, got, log_t) = both_clis(
        tmp_path, monkeypatch, "dyn-frame3d", doc)
    assert rc_j == rc_t == 0
    assert tree_gap(got, want) <= F64_RTOL
    summary = [ln.split("] ", 1)[1] for ln in log_j.splitlines()
               if "SUMMARY" in ln or "Max |u|" in ln]
    assert len(summary) == 2 and all(s in log_t for s in summary)


def test_banded_document_matches_jax(tmp_path, monkeypatch):
    """grid3d(12, 4, 8), 2,496 DOFs, through both CLIs: the JAX CLI exits
    1 on its summary line (KeyError 'max_displacement': ROADMAP fault
    3.27), the port's 0; the summaries within BANDED_RTOL.  The skeleton
    carries no torque (float64: 1.2e-11 of its 1,501 moment): both
    packages' max |torque| is float32 noise (~6e-4), held to BANDED_RTOL
    of the moment scale."""
    doc = examples_grid.space_frame_grid_document(12, 4, 8, tolerance=1e-6)
    (rc_j, want, log_j), (rc_t, got, log_t) = both_clis(
        tmp_path, monkeypatch, "grid", doc)
    assert rc_j == 1 and "KeyError: 'max_displacement'" in log_j
    assert rc_t == 0 and "[SUCCESS]" in log_t
    assert got["tier"] == want["tier"] == "banded"
    assert max(got["relative_residual"], want["relative_residual"]) < 1e-6
    for key in ("max_abs_displacement", "max_abs_axial", "max_abs_moment",
                "displacements"):
        assert rel_err(got[key], want[key]) <= BANDED_RTOL, key
    assert rel_err(got["max_abs_torque"], want["max_abs_torque"],
                   want["max_abs_moment"]) <= BANDED_RTOL


@pytest.mark.parametrize("analysis", [
    {"type": "modal", "n_modes": 4},
    {"type": "transient", "dt": 0.05, "n_steps": 12, "damping": [0.0, 0.01],
     "probe_nodes": [2], "record_every": 3},
    {"type": "harmonic", "omegas": {"start": 0.2, "stop": 2.0, "num": 5},
     "probe_dofs": [12, 14]},
    {"type": "buckling", "n_modes": 2},
    {"type": "frame3d"},
])
def test_document_analyses_match_jax(analysis):
    doc = json.loads((CORPUS / "dyn-frame3d.json").read_text())
    doc["analysis"] = analysis
    doc["ref_vectors"] = [[1, 0.0, 0.0, 1.0]]
    if analysis["type"] == "buckling":
        doc["loads"] = np.eye(18)[6].tolist()
        doc["loads"][6] = -1.0
    got = t_io.run_frame3d_document(doc, CPU)
    want = j_io.run_frame3d_document(doc)
    shapes = [k for k in ("mode_shapes", "buckling_modes") if k in want]
    for k in shapes:
        assert rel_err(aligned(got[k], want[k]), want[k]) <= F64_RTOL
    assert tree_gap(got, want, skip=shapes) <= F64_RTOL


@pytest.mark.parametrize("kind", ["spectrum", "random"])
def test_spectral_documents_match_jax(tmp_path, monkeypatch, kind):
    """dyn-frame3d.json as a "spectrum" and a "random" document, the
    analyses ported with solvers/continuum_spectrum.py, through both CLIs:
    exit codes 0 and the result JSON within F64_RTOL (participation by
    magnitude: it carries its mode's sign)."""
    doc = json.loads((CORPUS / "dyn-frame3d.json").read_text())
    doc["analysis"] = (
        {"type": "spectrum", "sa": {"omegas": [0.0, 50.0],
                                    "values": [3.0, 1.0]},
         "direction": [0.3, 1.0, 0.0], "n_modes": 4, "combination": "cqc"}
        if kind == "spectrum" else
        {"type": "random", "omegas": {"start": 0.5, "stop": 20.0,
                                      "num": 30},
         "psd": 1.0, "damping": [0.2, 0.001], "probe_nodes": [1, 2]})
    (rc_j, want, _), (rc_t, got, _) = both_clis(tmp_path, monkeypatch,
                                                kind, doc)
    assert rc_j == rc_t == 0
    if "participation" in want:
        for out in (got, want):
            out["participation"] = np.abs(out["participation"]).tolist()
    assert tree_gap(got, want) <= F64_RTOL


@pytest.mark.parametrize("method", ["guyan", "craig_bampton"])
def test_reduction_matches_jax(method):
    """reduce_model and the reduction document on a space frame, and
    _family_modal's space-frame branch."""
    tp, jp = both(no_thermal(random_frame(8)))
    masters = [12, 13, 24, 26]
    got = t_red.reduce_model(tp, masters, method=method, n_modes=3,
                             device=CPU)
    want = j_red.reduce_model(jp, masters, method=method, n_modes=3)
    sign = np.ones(got.k_red.shape[0])
    if method == "craig_bampton":
        sign[4:] = np.sign(np.sum(got.t[:, 4:] * want.t[:, 4:], axis=0))
    for a, b in ((got.k_red, want.k_red), (got.m_red, want.m_red)):
        assert rel_err(sign[:, None] * a * sign[None, :], b) <= F64_RTOL
    an = {"type": "reduction", "method": method, "master_nodes": [2, 4]}
    out_t = t_io.run_frame3d_analysis(tp, an, CPU)
    out_j = j_io.run_frame3d_analysis(jp, an)
    for key in ("reduced_omegas", "full_omegas", "frequency_rel_errors"):
        assert rel_err(out_t[key], out_j[key]) <= EIG_RTOL, key
    om, _ = t_common._family_modal(tp, 3, CPU)
    assert rel_err(om, JF3.space_frame_modal(jp, 3).omegas) <= EIG_RTOL
