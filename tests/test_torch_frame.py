"""The port's 2D frame family (models/frame.py, solvers/frame_plastic.py,
io/frame_io.py, the frame branches of solvers/reduction.reduce_model and
io/_common._family_modal, and frame documents through the CLI) against the
JAX package, on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * F64_RTOL: the float64 element library and dense analyses (statics,
    modal, buckling, Newmark, harmonic, the pushover, reduction, the corpus
    documents); eigenvector signs are aligned to the JAX package's first;
  * EIG_RTOL: eigenvalues (modal, buckling);
  * BANDED_RTOL: the banded statics against the JAX package's banded
    statics (benchmarks/scaling.py's coarse gate), DENSE_RTOL against the
    float64 dense solve;
  * MODAL_RTOL: the banded modal against the JAX package's on the same
    lumped pencil.

The banded Jacobi iteration count is held within +-2 of the JAX package's
at tolerance 1e-6.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu.models.frame as JF  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import frame_io as j_io  # noqa: E402
from pinn_fem_tpu.solvers import frame_plastic as j_plastic  # noqa: E402
from pinn_fem_tpu.solvers import reduction as j_red  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.frame as TF  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch import examples_grid  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import _common as t_common  # noqa: E402
from pinn_fem_tpu_torch.io import frame_io as t_io  # noqa: E402
from pinn_fem_tpu_torch.solvers import frame_plastic as t_plastic  # noqa: E402,E501
from pinn_fem_tpu_torch.solvers import reduction as t_red  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# The float64 library and dense analyses: measured up to 4e-14.
F64_RTOL = 1e-10
EIG_RTOL = 1e-9
# Banded (float32) against the JAX package's banded and against float64
# dense: benchmarks/scaling.py's coarse gate, and 1e-3.
BANDED_RTOL = 2e-3
DENSE_RTOL = 1e-3
MODAL_RTOL = 1e-3
CPU = "cpu"

E, A, I, RHO = 200.0, 1.0, 0.05, 1.2
L = 4.0


def rel_err(got, want, floor: float = 1e-300) -> float:
    """Largest |got - want| over the largest |want| (at least `floor`: a
    stress-free state's forces are rounding noise)."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), floor))


def aligned(got, want):
    """got's rows (modes) with the sign of want's rows."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    sign = np.sign(np.sum(got * want, axis=1, keepdims=True))
    return got * np.where(sign == 0, 1.0, sign)


def both(build):
    """(port problem, JAX problem) from one function of the keyword
    arrays."""
    kw = build()
    return TF.FrameProblem(**kw), JF.FrameProblem(**kw)


def line(n, along=(1.0, 0.0), length=L):
    d = np.asarray(along, dtype=float)
    nodes = np.linspace(0.0, length, n + 1)[:, None] * d[None, :]
    return nodes, np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)


def cantilever(n=1, dof=1, value=-1.0, **extra):
    def build():
        nodes, el = line(n)
        loads = np.zeros(3 * (n + 1))
        loads[3 * n + dof] = value
        return dict(nodes=nodes, elements=el, young=E, area=A, inertia=I,
                    density=RHO, loads=loads, fixed_dofs=[0, 1, 2], **extra)
    return build


def simply_supported(n=4):
    def build():
        nodes, el = line(n)
        loads = np.zeros(3 * (n + 1))
        loads[3 * (n // 2) + 1] = -1.0
        return dict(nodes=nodes, elements=el, young=E, area=A, inertia=I,
                    density=RHO, loads=loads, fixed_dofs=[0, 1, 3 * n + 1])
    return build


def portal(**extra):
    def build():
        h, w = 3.0, 4.0
        loads = np.zeros(12)
        loads[3] = 1.0
        return dict(nodes=[[0.0, 0.0], [0.0, h], [w, h], [w, 0.0]],
                    elements=[[0, 1], [1, 2], [2, 3]], young=E, area=A,
                    inertia=I, density=RHO, loads=loads,
                    fixed_dofs=[0, 1, 2, 9, 10, 11], **extra)
    return build


def column(n=8, fixed=(0, 1, 2), **extra):
    def build():
        nodes, el = line(n, along=(0.0, 1.0))
        loads = np.zeros(3 * (n + 1))
        loads[3 * n + 1] = -1.0
        return dict(nodes=nodes, elements=el, young=E, area=A, inertia=I,
                    density=RHO, loads=loads, fixed_dofs=list(fixed),
                    **extra)
    return build


def member_loaded(inclined=False, clamped=False):
    def build():
        nodes = [[0.0, 0.0], [3.0, 4.0] if inclined else [L, 0.0]]
        return dict(nodes=nodes, elements=[[0, 1]], young=E, area=A,
                    inertia=I, density=RHO, loads=np.zeros(6),
                    fixed_dofs=list(range(6 if clamped or inclined else 3)),
                    member_loads=[[0.0, -0.3]], section_modulus=0.02)
    return build


def thermal(gradient=True, clamped=True):
    def build():
        nodes, el = line(2, length=3.0)
        return dict(nodes=nodes, elements=el, young=200e9, area=0.01,
                    inertia=1e-5, density=7850.0, loads=np.zeros(9),
                    fixed_dofs=[0, 1, 2, 6, 7, 8] if clamped else [0, 1, 2],
                    alpha_cte=1.2e-5, temperature=40.0,
                    temperature_gradient=100.0 if gradient else None,
                    section_modulus=2e-4)
    return build


def random_frame(seed=0, n=6):
    """A small irregular frame with every optional array."""
    def build():
        rng = np.random.default_rng(seed)
        nodes = rng.uniform(0.0, 5.0, (n, 2))
        el = np.array([[i, i + 1] for i in range(n - 1)] + [[0, n - 1],
                                                            [1, 3]])
        m = el.shape[0]
        return dict(nodes=nodes, elements=el,
                    young=rng.uniform(100, 300, m),
                    area=rng.uniform(0.5, 2.0, m),
                    inertia=rng.uniform(0.01, 0.1, m),
                    density=rng.uniform(1.0, 2.0, m),
                    loads=rng.normal(size=3 * n), fixed_dofs=[0, 1, 2, 5],
                    point_masses=rng.uniform(0.0, 1.0, n),
                    member_loads=rng.normal(size=(m, 2)),
                    section_modulus=rng.uniform(0.1, 0.2, m),
                    alpha_cte=1e-3, temperature=rng.normal(size=m),
                    temperature_gradient=rng.normal(size=m))
    return build


STATICS = {
    "cantilever_v": cantilever(), "cantilever_u": cantilever(dof=0),
    "cantilever_m": cantilever(dof=2, value=2.0),
    "cantilever_8": cantilever(8), "simply_supported": simply_supported(),
    "portal": portal(), "euler_column": column(),
    "member_load": member_loaded(), "member_load_clamped":
    member_loaded(clamped=True), "member_load_inclined":
    member_loaded(inclined=True), "thermal_restraint": thermal(),
    "thermal_free_bow": thermal(clamped=False), "random": random_frame(),
}


# ------------------------------------------------------- element library


def test_element_library_matches_jax():
    """_geometry, _rotation, _k_local, _m_local, _kg_local and the member
    and thermal load vectors on an irregular frame with every optional
    array, in float64."""
    tp, jp = both(random_frame(3, 8))
    length, c, s = (x.numpy() for x in TF._geometry(tp))
    jl, jc, js = JF._geometry(jp)
    assert max(rel_err(length, jl), rel_err(c, jc), rel_err(s, js)) \
        <= F64_RTOL
    lt = torch.as_tensor(jl)
    gaps = {
        "rotation": rel_err(TF._rotation(torch.as_tensor(jc),
                                         torch.as_tensor(js)),
                            JF._rotation(jc, js)),
        "k_local": rel_err(TF._k_local(*(torch.as_tensor(v) for v in (
            jp.young, jp.area, jp.inertia)), lt),
            JF._k_local(jp.young, jp.area, jp.inertia, jl)),
        "m_local": rel_err(TF._m_local(torch.as_tensor(jp.density),
                                       torch.as_tensor(jp.area), lt),
                           JF._m_local(jp.density, jp.area, jl)),
        "kg_local": rel_err(TF._kg_local(torch.as_tensor(jp.young), lt),
                            JF._kg_local(jp.young, jl)),
    }
    for name, port, jax in (("member", TF._member_load_vectors,
                             JF._member_load_vectors),
                            ("thermal", TF._thermal_member_vectors,
                             JF._thermal_member_vectors)):
        f_t, loc_t = port(tp)
        f_j, loc_j = jax(jp)
        gaps[name] = max(rel_err(f_t, f_j), rel_err(loc_t, loc_j))
    assert max(gaps.values()) <= F64_RTOL, gaps


@pytest.mark.parametrize("with_mass", [False, True])
def test_frame_matrices_match_jax(with_mass):
    tp, jp = both(random_frame(1))
    kt, mt = TF.frame_matrices(tp, with_mass=with_mass, device=CPU)
    kj, mj = JF.frame_matrices(jp, with_mass=with_mass)
    assert rel_err(kt, kj) <= F64_RTOL
    assert (mt is None) == (mj is None)
    if with_mass:
        assert rel_err(mt, mj) <= F64_RTOL
        assert rel_err(TF.frame_lumped_mass_diag(tp, CPU),
                       JF.frame_lumped_mass_diag(jp)) <= F64_RTOL


# ------------------------------------------------------- dense analyses


@pytest.mark.parametrize("name", sorted(STATICS))
def test_static_matches_jax(name):
    """solve_frame_static on the JAX tests' closed-form problems: every
    field of the result within F64_RTOL (forces against at least the
    applied and fixed-end loads' scale)."""
    tp, jp = both(STATICS[name])
    got = TF.solve_frame_static(tp, device=CPU)
    want = JF.solve_frame_static(jp)
    loads = [jp.loads] + [v for fn in (JF._member_load_vectors,
                                       JF._thermal_member_vectors)
                          for v in fn(jp)]
    force = max(float(np.abs(v).max()) for v in loads)
    for field in ("displacements", "member_end_forces", "axial", "moments",
                  "reactions", "max_stress"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if b is not None:
            floor = 1e-20 if field == "displacements" else force
            if field == "max_stress":
                floor = force / jp.area.min()
            assert rel_err(a, b, floor) <= F64_RTOL, field


def test_static_closed_forms():
    """The anchors themselves: PL^3/3EI with one element, the clamped
    thermal restraint N = -EA alpha dT and |M| = EI alpha g exactly."""
    tp, _ = both(cantilever())
    st = TF.solve_frame_static(tp, device=CPU)
    np.testing.assert_allclose(st.displacements[4], -L ** 3 / (3 * E * I),
                               rtol=1e-12)
    tp, _ = both(thermal())
    st = TF.solve_frame_static(tp, device=CPU)
    np.testing.assert_allclose(st.axial, -200e9 * 0.01 * 1.2e-5 * 40.0,
                               rtol=1e-12)
    np.testing.assert_allclose(np.abs(st.moments),
                               200e9 * 1e-5 * 1.2e-5 * 100.0, rtol=1e-12)


@pytest.mark.parametrize("name", ["portal", "random", "euler_column"])
def test_geometric_stiffness_matches_jax(name):
    tp, jp = both(STATICS[name])
    u = JF.solve_frame_static(jp).displacements
    assert rel_err(TF.frame_geometric_stiffness(tp, u, device=CPU),
                   JF.frame_geometric_stiffness(jp, u)) <= F64_RTOL


@pytest.mark.parametrize("name, prestress", [
    ("cantilever_8", False), ("portal", False), ("random", False),
    ("euler_column", True), ("random", True)])
def test_modal_matches_jax(name, prestress):
    """frame_modal (with the P-Delta prestress of the static state):
    eigenvalues within EIG_RTOL, M-normalized shapes within F64_RTOL
    after sign alignment."""
    tp, jp = both(STATICS[name])
    if prestress and tp.temperature is not None:
        tp.temperature = jp.temperature = None
        tp.temperature_gradient = jp.temperature_gradient = None
    pres = JF.solve_frame_static(jp).displacements if prestress else None
    got = TF.frame_modal(tp, n_modes=4, prestress_u=pres, device=CPU)
    want = JF.frame_modal(jp, n_modes=4, prestress_u=pres)
    assert rel_err(got.eigenvalues, want.eigenvalues) <= EIG_RTOL
    assert rel_err(got.frequencies_hz, want.frequencies_hz) <= EIG_RTOL
    assert rel_err(aligned(got.mode_shapes, want.mode_shapes),
                   want.mode_shapes) <= F64_RTOL


@pytest.mark.parametrize("fixed", [(0, 1, 2), (0, 1, 24)])
def test_buckling_matches_jax(fixed):
    """Euler columns (clamped-free and pinned-pinned): load factors within
    EIG_RTOL of scipy's general eig, unit-norm modes after sign
    alignment, the axial forces within F64_RTOL."""
    tp, jp = both(column(8, fixed))
    got = TF.frame_buckling(tp, n_modes=3, device=CPU)
    want = JF.frame_buckling(jp, n_modes=3)
    assert rel_err(got.load_factors, want.load_factors) <= EIG_RTOL
    assert rel_err(aligned(got.modes, want.modes), want.modes) <= F64_RTOL
    assert rel_err(got.axial, want.axial) <= F64_RTOL
    k = 2.0 if fixed == (0, 1, 2) else 1.0
    np.testing.assert_allclose(got.load_factors[0],
                               np.pi ** 2 * E * I / (k * L) ** 2, rtol=1e-4)


@pytest.mark.parametrize("record_every", [1, 3])
def test_transient_matches_jax(record_every):
    tp, jp = both(portal(point_masses=0.5, member_loads=[[0.0, -0.1]] * 3))
    kw = dict(damping=(0.01, 0.002), amplitude=np.sin(0.3 * np.arange(40)),
              probe_dofs=[3, 4, 5, 7], record_every=record_every)
    got = TF.solve_frame_transient(tp, 0.05, 40, device=CPU, **kw)
    want = JF.solve_frame_transient(jp, 0.05, 40, **kw)
    assert rel_err(got.times, want.times) <= F64_RTOL
    assert rel_err(got.displacements, want.displacements) <= F64_RTOL
    assert (got.dt, got.n_steps) == (want.dt, want.n_steps)


def test_harmonic_matches_jax():
    tp, jp = both(portal(member_loads=[[0.1, -0.2]] * 3))
    om = np.linspace(0.1, 5.0, 12)
    got = TF.frame_harmonic(tp, om, damping=(0.02, 0.001),
                            probe_dofs=[3, 4, 7], device=CPU)
    want = JF.frame_harmonic(jp, om, damping=(0.02, 0.001),
                             probe_dofs=[3, 4, 7])
    for field in ("amplitude", "real", "imag"):
        assert rel_err(getattr(got, field), getattr(want, field)) \
            <= F64_RTOL


def test_dynamics_refuse_thermal():
    tp, jp = both(thermal())
    for port, jax, args in (
            (TF.solve_frame_transient, JF.solve_frame_transient, (0.1, 3)),
            (TF.frame_harmonic, JF.frame_harmonic, ([1.0],))):
        with pytest.raises(ValueError) as want:
            jax(jp, *args)
        with pytest.raises(ValueError) as got:
            port(tp, *args, device=CPU)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw, match", [
    (dict(nodes=np.zeros((2, 3))), "frame nodes must be"),
    (dict(loads=np.zeros(5)), "frame loads must be"),
    (dict(fixed_dofs=[7]), "fixed_dofs out of range"),
    (dict(section_modulus=-1.0), "section_modulus must be positive"),
    (dict(temperature=1.0), "thermal expansion"),
    (dict(nodes=np.zeros((2, 2))), "zero-length"),
])
def test_validation_matches_jax(kw, match):
    base = dict(nodes=[[0.0, 0.0], [1.0, 0.0]], elements=[[0, 1]], young=E,
                area=A, inertia=I, density=RHO, loads=np.zeros(6),
                fixed_dofs=[0, 1, 2])
    base.update(kw)
    msgs = []
    for cls in (JF.FrameProblem, TF.FrameProblem):
        with pytest.raises(ValueError, match=match) as err:
            cls(**base)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ pushover


def beam(fixed_right=True):
    def build():
        loads = np.zeros(9)
        loads[4] = -1.0
        return dict(nodes=[[0.0, 0.0], [2.0, 0.0], [4.0, 0.0]],
                    elements=[[0, 1], [1, 2]], young=200e9, area=0.01,
                    inertia=1e-4, density=1.0, loads=loads,
                    fixed_dofs=[0, 1, 2, 6, 7, 8] if fixed_right
                    else [0, 1, 2, 6, 7])
    return build


def multi_bay(bays=3, stories=2):
    def build():
        doc = examples_grid.frame_tower_document(stories, bays)
        p, _ = t_io.parse_frame_document(doc)
        loads = p.loads.copy()
        loads[1::3] -= 2000.0 * (p.nodes[:, 1] > 0)
        return dict(nodes=p.nodes, elements=p.elements, young=200e9,
                    area=0.01, inertia=1e-4, density=7850.0, loads=loads,
                    fixed_dofs=p.fixed_dofs)
    return build


@pytest.mark.parametrize("name, build, mp, extra", [
    ("fixed_fixed", beam(True), 500.0, {}),
    ("propped", beam(False), 500.0, dict(probe_dofs=[4])),
    ("portal", lambda: dict(portal()(), young=200e9, area=0.01,
                            inertia=1e-4), 500.0, dict(probe_dofs=[3])),
    ("multi_bay", multi_bay(), [3e4, 2e4, 2.5e4] * 6 + [1e4] * 12, {}),
    ("capped", beam(False), 500.0, dict(max_load_factor=900.0)),
    ("max_hinges", multi_bay(), 2e4, dict(max_hinges=2)),
])
def test_pushover_matches_jax(name, build, mp, extra):
    """frame_pushover against the JAX package's: the collapse factor and
    every float field within F64_RTOL, the hinge sequence (members, ends)
    equal; the fixed-fixed beam's four simultaneous hinges at 8 Mp / L."""
    tp, jp = both(build)
    mp = np.asarray(mp, dtype=float)[:tp.nelm] if np.ndim(mp) else mp
    got = t_plastic.frame_pushover(tp, mp, device=CPU, **extra)
    want = j_plastic.frame_pushover(jp, mp, **extra)
    assert got.mechanism == want.mechanism
    assert (got.collapse_factor is None) == (want.collapse_factor is None)
    if want.collapse_factor is not None:
        assert abs(got.collapse_factor - want.collapse_factor) \
            <= F64_RTOL * want.collapse_factor
    np.testing.assert_array_equal(got.hinge_members, want.hinge_members)
    np.testing.assert_array_equal(got.hinge_ends, want.hinge_ends)
    for field in ("hinge_factors", "load_factors", "displacements",
                  "end_moments", "axial", "u"):
        assert rel_err(getattr(got, field), getattr(want, field)) \
            <= F64_RTOL, field
    if name == "fixed_fixed":
        assert len(got.hinge_factors) == 4
        np.testing.assert_allclose(got.collapse_factor, 8 * 500.0 / 4.0,
                                   rtol=1e-12)


def test_condensed_local_matches_jax():
    tp, jp = both(random_frame(2))
    length, _, _ = JF._geometry(jp)
    kl = JF._k_local(jp.young, jp.area, jp.inertia, length)
    hinges = np.zeros((jp.nelm, 2), dtype=bool)
    hinges[0, 0] = hinges[1, 1] = hinges[2] = True
    assert rel_err(t_plastic._condensed_local(torch.as_tensor(kl),
                                              torch.as_tensor(hinges)),
                   j_plastic._condensed_local(kl, hinges)) <= F64_RTOL


@pytest.mark.parametrize("kw", [
    dict(plastic_moment=-1.0), dict(member_loads=[[0.0, -1.0]] * 2),
    dict(temperature=1.0, alpha_cte=1e-5), dict(loads=np.zeros(9)),
    dict(loads=np.eye(9)[3])])
def test_pushover_refusals_match_jax(kw):
    kw = dict(kw)
    mp = kw.pop("plastic_moment", 500.0)
    msgs = []
    for cls, fn, extra in ((JF.FrameProblem, j_plastic.frame_pushover, {}),
                           (TF.FrameProblem, t_plastic.frame_pushover,
                            {"device": CPU})):
        with pytest.raises(ValueError) as err:
            fn(cls(**dict(beam()(), **kw)), mp, **extra)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ banded tier


def tower_pair(stories=8, bays=4, **material):
    doc = examples_grid.frame_tower_document(stories, bays)
    doc["material"].update(material)
    return t_io.parse_frame_document(doc)[0], j_io.parse_frame_document(
        doc)[0]


def test_banded_static_matches_jax_and_dense():
    """tower(8, 4): banded u within BANDED_RTOL of the JAX package's
    banded solve and DENSE_RTOL of the float64 dense solve, the reactions
    balancing the wind, the Jacobi counts within +-2 at tol 1e-6."""
    tp, jp = tower_pair()
    dense = JF.solve_frame_static(jp)
    got, it_t, rel_t = TF.solve_frame_static_banded(tp, tol=1e-8,
                                                    device=CPU)
    want, _, _ = JF.solve_frame_static_banded(jp, tol=1e-8)
    assert rel_t < 1e-7
    assert rel_err(got.displacements, want.displacements) <= BANDED_RTOL
    assert rel_err(got.displacements, dense.displacements) <= DENSE_RTOL
    assert rel_err(got.axial, dense.axial) <= DENSE_RTOL
    np.testing.assert_allclose(-got.reactions[0::3].sum(),
                               tp.loads[0::3].sum(), rtol=DENSE_RTOL)
    _, it6_t, _ = TF.solve_frame_static_banded(tp, tol=1e-6, device=CPU)
    _, it6_j, _ = JF.solve_frame_static_banded(jp, tol=1e-6)
    assert abs(it6_t - it6_j) <= 2, (it6_t, it6_j)


def test_banded_static_member_loads_and_stress():
    tp, jp = tower_pair(4, 2)
    for p in (tp, jp):
        p.member_loads = np.tile([0.0, -500.0], (p.nelm, 1))
        p.section_modulus = np.full(p.nelm, 1e-3)
    dense = JF.solve_frame_static(jp)
    got, _, _ = TF.solve_frame_static_banded(tp, tol=1e-8, device=CPU)
    assert rel_err(got.max_stress, dense.max_stress) <= DENSE_RTOL
    assert rel_err(got.member_end_forces, dense.member_end_forces) \
        <= DENSE_RTOL


def test_banded_modal_matches_jax():
    """frame_modal_banded against the JAX package's on the same lumped
    pencil (a well-scaled 6-story frame), and against scipy's eigh of
    it."""
    import scipy.linalg

    tp, jp = tower_pair(6, 1, young=1000.0, area=1.0, inertia=0.1,
                        density=1.0)
    got = TF.frame_modal_banded(tp, n_modes=4, n_iter=10, cg_tol=1e-8,
                                device=CPU)
    want = JF.frame_modal_banded(jp, n_modes=4, n_iter=10, cg_tol=1e-8)
    assert rel_err(got.eigenvalues, want.eigenvalues) <= MODAL_RTOL
    k, _ = JF.frame_matrices(jp, with_mass=False)
    md = JF.frame_lumped_mass_diag(jp)
    free = tp.free_dofs()
    lam = scipy.linalg.eigh(k[np.ix_(free, free)], np.diag(md[free]),
                            eigvals_only=True)[:4]
    assert rel_err(got.eigenvalues, lam) <= MODAL_RTOL
    assert got.mode_shapes.shape == (4, tp.ndof)


def test_banded_refuses_mesh():
    tp, _ = tower_pair(2, 1)
    for fn in (TF.solve_frame_static_banded, TF.frame_modal_banded):
        with pytest.raises(NotImplementedError, match="item 15"):
            fn(tp, mesh=object(), device=CPU)


# ------------------------------------------------------------ documents


def run_cli(module, path: Path, monkeypatch, device=None):
    if device is not None:
        monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", device)
    rc = module.main([str(path)])
    for name in ("pinn_fem_tpu", "pinn_fem_tpu_torch"):
        for h in list(logging.getLogger(name).handlers):
            logging.getLogger(name).removeHandler(h)
            h.close()
    res = path.with_suffix(".res.json")
    log = path.with_suffix(".log")
    return (rc, json.loads(res.read_text()) if res.exists() else None,
            log.read_text())


def both_clis(tmp_path, monkeypatch, name: str, doc: dict):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    outs = []
    for sub, module, device in (("jax", jax_cli, None),
                                ("port", torch_cli, CPU)):
        path = tmp_path / sub / f"{name}.json"
        path.write_text(json.dumps(doc))
        outs.append(run_cli(module, path, monkeypatch, device))
    return outs


def tree_gap(got, want, skip=()):
    """Largest relative gap over the numeric leaves; non-numeric leaves
    must be equal."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        return max([tree_gap(got[k], want[k], skip) for k in want
                    if k not in skip] or [0.0])
    if isinstance(want, list) and want and isinstance(want[0], dict):
        return max(tree_gap(a, b, skip) for a, b in zip(got, want))
    if isinstance(want, (bool, str)) or want is None:
        assert got == want
        return 0.0
    return rel_err(got, want)


@pytest.mark.parametrize("name", ["dyn-frame", "dyn-frame-thermal",
                                  "dyn-frame-pushover"])
def test_corpus_documents_match_jax(tmp_path, monkeypatch, name):
    """The corpus frame documents through both CLIs: exit codes 0, the
    result JSON within F64_RTOL (mode shapes sign-aligned), the summary
    line of the log equal."""
    doc = json.loads((CORPUS / f"{name}.json").read_text())
    (rc_j, want, log_j), (rc_t, got, log_t) = both_clis(
        tmp_path, monkeypatch, name, doc)
    assert rc_j == rc_t == 0
    if "mode_shapes" in want:
        assert rel_err(aligned(got["mode_shapes"], want["mode_shapes"]),
                       want["mode_shapes"]) <= F64_RTOL
        assert rel_err(got["eigenvalues"], want["eigenvalues"]) <= EIG_RTOL
    assert tree_gap(got, want, skip=("mode_shapes",)) <= F64_RTOL
    summary = [ln.split("] ", 1)[1] for ln in log_j.splitlines()
               if "SUMMARY" in ln]
    assert summary and all(s in log_t for s in summary)


def test_identification_document_refused(tmp_path, monkeypatch):
    """dyn-frame-identify without its "synthetic" block: exit 1 with the
    JAX package's words, no result.  (The document itself runs since
    ROADMAP item 23: tests/test_torch_identification.py.)"""
    doc = json.loads((CORPUS / "dyn-frame-identify.json").read_text())
    doc["analysis"].pop("synthetic")
    path = tmp_path / "dyn-frame-identify.json"
    path.write_text(json.dumps(doc))
    rc, out, log = run_cli(torch_cli, path, monkeypatch, CPU)
    assert rc == 1 and out is None
    assert 'frame identification needs "measured_dofs"' in log


def test_banded_document_matches_jax(tmp_path, monkeypatch):
    """tower(12, 60), 2,379 DOFs: the "tier": "banded" branch in both
    CLIs.  The JAX CLI writes the result and then exits 1 on its summary
    line (KeyError 'end_moments': ROADMAP fault 3.27); the port's exits 0.
    The summaries within BANDED_RTOL.  The counts are not compared: at
    this tolerance the float32 Jacobi count of either package moves by
    about 50 when the load changes in its last bit (ROADMAP fault 3.28,
    test_float32_jacobi_count_fault)."""
    doc = examples_grid.frame_tower_document(12, 60, tolerance=1e-6)
    (rc_j, want, log_j), (rc_t, got, log_t) = both_clis(
        tmp_path, monkeypatch, "tower", doc)
    assert rc_j == 1 and "KeyError: 'end_moments'" in log_j
    assert rc_t == 0 and "[SUCCESS]" in log_t
    assert got["tier"] == want["tier"] == "banded"
    assert max(got["relative_residual"], want["relative_residual"]) < 1e-6
    assert got["max_abs_displacement_dof"] == want[
        "max_abs_displacement_dof"]
    for key in ("max_abs_displacement", "max_abs_axial", "max_abs_moment",
                "displacements"):
        assert rel_err(got[key], want[key]) <= BANDED_RTOL, key


SPECTRAL_DOCUMENTS = {
    "spectrum": {"type": "spectrum", "sa": 2.5, "direction": [1, 0],
                 "n_modes": 4, "combination": "cqc"},
    "random": {"type": "random", "omegas": {"start": 0.1, "stop": 30.0,
                                            "num": 40},
               "psd": 1.0, "damping": [0.3, 0.0], "probe_nodes": [1, 2],
               "fatigue": {"sn": {"exponent": 3.0, "coefficient": 1e8},
                           "method": "narrowband"}},
}


@pytest.mark.parametrize("kind", list(SPECTRAL_DOCUMENTS))
def test_spectral_documents_match_jax(tmp_path, monkeypatch, kind):
    """A frame "spectrum" and "random" (with fiber fatigue) document, the
    analyses ported with solvers/continuum_spectrum.py, through both CLIs:
    exit codes 0 and the result JSON within F64_RTOL (participation by
    magnitude: it carries its mode's sign)."""
    doc = {"element_type": "frame",
           "nodes": [[0, 0], [0, 3], [4, 3], [4, 0]],
           "elements": [[0, 1], [1, 2], [2, 3]],
           "material": {"young": E, "area": 0.4, "inertia": 0.05,
                        "density": RHO, "section_modulus": 0.2},
           "loads": [0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 0, 0, 0],
           "fixed_nodes": [0, 3], "analysis": SPECTRAL_DOCUMENTS[kind]}
    (rc_j, want, _), (rc_t, got, _) = both_clis(tmp_path, monkeypatch,
                                                kind, doc)
    assert rc_j == rc_t == 0
    if "participation" in want:
        for out in (got, want):
            out["participation"] = np.abs(out["participation"]).tolist()
    assert tree_gap(got, want) <= F64_RTOL


@pytest.mark.parametrize("kind, item", [
    ("identification", "23"), ("reliability", "24"), ("sizing", "24")])
def test_later_analysis_types_refused(kind, item):
    """Items 23 and 24 are ported: a bare identification, reliability or
    sizing block is refused in the JAX package's words and error type."""
    tp, jp = both(portal())
    if item == "23":
        with pytest.raises(ValueError, match='needs "measured_dofs"'):
            t_io.run_frame_analysis(tp, {"type": kind}, CPU)
        return
    with pytest.raises(ValueError) as want:
        j_io.run_frame_analysis(jp, {"type": kind})
    with pytest.raises(ValueError) as got:
        t_io.run_frame_analysis(tp, {"type": kind}, CPU)
    assert str(got.value) == str(want.value)


def test_unknown_analysis_type_matches_jax():
    tp, jp = both(portal())
    with pytest.raises(ValueError) as want:
        j_io.run_frame_analysis(jp, {"type": "fatigue"})
    with pytest.raises(ValueError) as got:
        t_io.run_frame_analysis(tp, {"type": "fatigue"}, CPU)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("analysis", [
    {"type": "modal", "n_modes": 3, "prestress": {"scale": 2.0}},
    {"type": "buckling", "n_modes": 2},
    {"type": "transient", "dt": 0.05, "n_steps": 30, "damping": [0.01, 0],
     "amplitude": {"type": "sine", "frequency_hz": 0.4},
     "probe_nodes": [1, 2], "record_every": 2},
    {"type": "harmonic", "omegas": {"start": 0.1, "stop": 3.0, "num": 7},
     "probe_nodes": [1]},
    {"type": "plastic", "plastic_moment": 0.3, "probe_nodes": [1]},
    {"type": "frame"},
])
def test_document_analyses_match_jax(analysis):
    """run_frame_analysis of each ported kind on the portal against the
    JAX package's (shapes sign-aligned)."""
    build = portal()
    doc = dict(build(), element_type="frame", analysis=analysis)
    doc = json.loads(json.dumps({k: (np.asarray(v).tolist()
                                     if isinstance(v, np.ndarray) else v)
                                 for k, v in doc.items()}))
    doc["material"] = {"young": doc.pop("young"), "area": doc.pop("area"),
                       "inertia": doc.pop("inertia"),
                       "density": doc.pop("density")}
    got = t_io.run_frame_document(doc, CPU)
    want = j_io.run_frame_document(doc)
    shapes = [k for k in ("mode_shapes", "buckling_modes") if k in want]
    for k in shapes:
        assert rel_err(aligned(got[k], want[k]), want[k]) <= F64_RTOL
    assert tree_gap(got, want, skip=shapes) <= F64_RTOL


@pytest.mark.parametrize("method", ["guyan", "craig_bampton"])
def test_reduction_matches_jax(method):
    """reduce_model and the reduction document on a frame (Craig-Bampton's
    modal columns sign-aligned), and _family_modal's frame branch."""
    tp, jp = both(random_frame(4, 8))
    masters = [9, 10, 18, 19]
    got = t_red.reduce_model(tp, masters, method=method, n_modes=3,
                             device=CPU)
    want = j_red.reduce_model(jp, masters, method=method, n_modes=3)
    n_m = len(masters)
    sign = np.ones(got.k_red.shape[0])
    if method == "craig_bampton":
        sign[n_m:] = np.sign(np.sum(got.t[:, n_m:] * want.t[:, n_m:],
                                    axis=0))
    assert rel_err(sign[:, None] * got.k_red * sign[None, :],
                   want.k_red) <= F64_RTOL
    assert rel_err(sign[:, None] * got.m_red * sign[None, :],
                   want.m_red) <= F64_RTOL
    out_t = t_io.run_frame_analysis(tp, {"type": "reduction",
                                         "method": method,
                                         "master_nodes": [3, 7]}, CPU)
    out_j = j_io.run_frame_analysis(jp, {"type": "reduction",
                                         "method": method,
                                         "master_nodes": [3, 7]})
    for key in ("reduced_omegas", "full_omegas", "frequency_rel_errors"):
        assert rel_err(out_t[key], out_j[key]) <= EIG_RTOL, key
    om, _ = t_common._family_modal(tp, 3, CPU)
    assert rel_err(om, JF.frame_modal(jp, 3).omegas) <= EIG_RTOL


def test_dense_limit_routes_the_banded_modal(monkeypatch):
    """Above DENSE_DOF_LIMIT a modal document takes the banded tier with
    lumped mass and probed shapes (the JAX runner's branch), its
    eigenvalues within MODAL_RTOL of the JAX package's lumped pencil."""
    import scipy.linalg

    monkeypatch.setattr(t_newton, "DENSE_DOF_LIMIT", 16)
    tp, jp = tower_pair(6, 1, young=1000.0, area=1.0, inertia=0.1,
                        density=1.0)
    got = t_io.run_frame_analysis(tp, {
        "type": "modal", "n_modes": 2, "probe_nodes": [6],
        "cg_tolerance": 1e-8, "n_iter": 6}, CPU)
    k, _ = JF.frame_matrices(jp, with_mass=False)
    md = JF.frame_lumped_mass_diag(jp)
    free = tp.free_dofs()
    lam = scipy.linalg.eigh(k[np.ix_(free, free)], np.diag(md[free]),
                            eigvals_only=True)[:2]
    assert got["tier"] == "banded" and got["mass"] == "lumped"
    assert rel_err(got["eigenvalues"], lam) <= MODAL_RTOL
    assert got["probe_nodes"] == [6]
    assert np.asarray(got["mode_shapes"]).shape == (2, 3)


def test_float32_jacobi_count_fault():
    """ROADMAP fault 3.28: on tower(12, 60) at tol 1e-6 the float32
    Jacobi-PCG count rides on the last bit of the load, in both packages.
    The tolerance lies at the float32 floor, where the recurrence
    residual stalls, so when it first crosses 1e-6 is rounding.  Under the
    document's load and the load scaled by 1 + 2^-23 in float32, the port
    takes 354 and 301 iterations and the JAX package's recurrence on the
    same float32 diagonals 302 and 355; the float64 recurrence takes 301
    under both.  Every solution is within DENSE_RTOL of float64."""
    import jax.numpy as jnp
    from pinn_fem_tpu.ops import dia as j_dia
    from pinn_fem_tpu_torch.ops.dia import dia_cg_solve

    tp, _ = tower_pair(12, 60)
    layout, diags, mask = TF._banded_operator(tp, torch.float32, CPU)
    u64 = TF.solve_frame_static(tp, device=CPU).displacements
    counts = {"port": [], "jax": [], "float64": []}
    for factor in (1.0, 1.0 + 2.0 ** -23):
        f = torch.as_tensor(tp.loads, dtype=torch.float32) * torch.tensor(
            factor, dtype=torch.float32)
        x_t, it_t, _ = dia_cg_solve(layout, diags, f, mask, tol=1e-6,
                                    max_iter=20000)
        x_j, it_j, _ = j_dia.dia_cg_solve(
            layout, jnp.asarray(diags.numpy()), jnp.asarray(f.numpy()),
            jnp.asarray(mask.numpy()), tol=1e-6, max_iter=20000)
        it_64 = dia_cg_solve(layout, diags.double(), f.double(),
                             mask.double(), tol=1e-6, max_iter=20000)[1]
        for key, it in (("port", it_t), ("jax", it_j), ("float64", it_64)):
            counts[key].append(int(it))
        assert rel_err(x_t.numpy(), factor * u64) <= DENSE_RTOL
        assert rel_err(np.asarray(x_j), factor * u64) <= DENSE_RTOL
    assert counts["float64"][0] == counts["float64"][1], counts
    for key in ("port", "jax"):
        assert abs(counts[key][0] - counts[key][1]) > 2, counts


def test_float32_banded_modal_fault():
    """ROADMAP fault 3.29: the float32 banded modal of a steel frame sits
    percents from the float64 pencil's eigenvalues while the float64 run
    of the same algorithm converges (tower(8, 2), 6 iterations: 3.5e-2 on
    mode 1 against 6e-11).  The JAX package's own test pins 5 % on such a
    frame (tests/test_frame.py::test_frame_modal_banded_steel_floor)."""
    import scipy.linalg

    tp, _ = tower_pair(8, 2)
    free = tp.free_dofs()
    k, _ = TF.frame_matrices(tp, with_mass=False, device=CPU)
    md = TF.frame_lumped_mass_diag(tp, CPU)
    lam = scipy.linalg.eigh(k.numpy()[np.ix_(free, free)],
                            np.diag(md[free]), eigvals_only=True)[:2]
    kw = dict(n_modes=2, n_iter=6, cg_tol=1e-8, device=CPU)
    f32 = TF.frame_modal_banded(tp, **kw)
    f64 = TF.frame_modal_banded(tp, dtype=torch.float64, **kw)
    assert abs(f32.eigenvalues[0] / lam[0] - 1.0) > 1e-2
    assert rel_err(f64.eigenvalues, lam) <= 1e-8
