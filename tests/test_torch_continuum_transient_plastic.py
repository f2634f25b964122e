"""The port's explicit elastoplastic transients of the continuum families
(solvers/continuum_transient_plastic.py, and transient documents with a
"plasticity" key through io/plane_io, io/solid_io and the CLI) against the
JAX package, on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * F64_RTOL: the float64 tier (host=True or the default below the dense
    limit) against the JAX host tier, the corpus documents included;
  * F32_RTOL: the working-dtype tier (host=False) against the JAX device
    tier: both in float32, the port's scatter summed in float64 (or by
    grid slices), beta K0 v by kernel 1's twin on the DIA diagonals where
    the JAX package multiplies its dense float32 K0; velocities, which
    difference float32 displacements, at F32_VEL_RTOL.

The JAX package builds dense float64 K and M for these runs; the port
forms m_diag, the Gershgorin step and beta K0 v from the element blocks,
and `test_no_dense_operator` shows it builds neither.  The corpus
documents' runs through both CLIs are in
tests/test_torch_continuum_plastic_documents.py.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu.models.plane as JP  # noqa: E402
import pinn_fem_tpu.models.solid as JS  # noqa: E402
import pinn_fem_tpu.solvers.continuum_transient_plastic as JC  # noqa: E402

import pinn_fem_tpu_torch.models.plane as TP  # noqa: E402
import pinn_fem_tpu_torch.models.solid as TS  # noqa: E402
import pinn_fem_tpu_torch.solvers.continuum_transient_plastic as TC  # noqa
from pinn_fem_tpu_torch.ops.kernels import dia_kernel  # noqa: E402

# The float64 tier: measured up to 4e-14.
F64_RTOL = 1e-10
# The float32 tier: measured up to 3.2e-6 (u) and 2.2e-5 (velocities).
F32_RTOL = 1e-4
F32_VEL_RTOL = 1e-3
CPU = "cpu"
FIELDS = ("displacements", "velocities", "kinetic_energy", "strain_energy",
          "plastic_work", "external_work", "von_mises_envelope",
          "final_displacement", "final_eq_plastic")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-300))


def solid_fields(nx=2, ny=2, nz=3, shuffle=False):
    """A 1 x 1 x 2 column on symmetry rollers under a top traction of 16
    (sigma_y 12 below: it yields), point masses on the top nodes."""
    nodes, el = JS.box_mesh(1.0, 1.0, 2.0, nx, ny, nz)
    if shuffle:
        el = el[np.random.default_rng(2).permutation(len(el))]
    p = JS.SolidProblem(nodes=nodes, elements=el, young=200.0, poisson=0.3,
                        density=2.0, loads=np.zeros(3 * len(nodes)),
                        fixed_dofs=[0])
    loads = JS.surface_load(nodes, JS.boundary_quads(p, 2, 1),
                            [0.5, 0.0, 16.0])
    fixed = np.concatenate([3 * np.flatnonzero(nodes[:, 2] == 0.0) + 2,
                            3 * np.flatnonzero(nodes[:, 0] == 0.0),
                            3 * np.flatnonzero(nodes[:, 1] == 0.0) + 1])
    pm = np.where(nodes[:, 2] == 2.0, 0.05, 0.0)
    return dict(nodes=nodes, elements=el, young=200.0, poisson=0.3,
                density=2.0, loads=loads, fixed_dofs=fixed,
                point_masses=pm)


def plane_fields(nen=4, plane_strain=False, nx=4, ny=2):
    nodes, el = JP.rect_mesh(4.0, 2.0, nx, ny,
                             "quad" if nen == 4 else "tri")
    right = np.flatnonzero(nodes[:, 0] == 4.0)
    loads = np.zeros(2 * len(nodes))
    loads[2 * right] = 16.0 * 0.5 * 2.0 / len(right)
    loads[2 * right + 1] = 0.4
    fixed = np.concatenate([2 * np.flatnonzero(nodes[:, 0] == 0.0),
                            2 * np.flatnonzero(nodes[:, 1] == 0.0) + 1])
    return dict(nodes=nodes, elements=el, young=200.0, poisson=0.3,
                thickness=0.5, density=2.0, loads=loads, fixed_dofs=fixed,
                plane_strain=plane_strain, point_masses=0.02)


def problems(family, **kw):
    if family == "solid":
        f = solid_fields(**kw)
        return JS.SolidProblem(**f), TS.SolidProblem(**f)
    f = plane_fields(**kw)
    return JP.PlaneProblem(**f), TP.PlaneProblem(**f)


SOLVERS = {"solid": (JC.solve_solid_transient_plastic,
                     TC.solve_solid_transient_plastic),
           "plane": (JC.solve_plane_transient_plastic,
                     TC.solve_plane_transient_plastic)}
RUN = dict(sigma_y=12.0, hardening_iso=20.0, hardening_kin=4.0, n_steps=200,
           record_every=20)


def amplitude(n):
    return np.minimum(np.arange(n) / (0.4 * n), 1.0) * np.where(
        np.arange(n) < 0.7 * n, 1.0, -0.5)


CASES = {
    "solid": ("solid", {}),
    "plane-stress-q4": ("plane", {}),
    "plane-strain-bbar": ("plane", {"plane_strain": True}),
    "plane-cst": ("plane", {"nen": 3}),
}


@pytest.mark.parametrize("beta", [0.0, 2e-3])
@pytest.mark.parametrize("case", list(CASES))
def test_float64_tier_matches_jax(case, beta):
    """host=True: every record of the float64 run (dt from the family's
    Gershgorin step with the damping, beta K0 from the element blocks)
    against the JAX host tier's dense K0 at F64_RTOL."""
    family, kw = CASES[case]
    j, t = problems(family, **kw)
    j_solve, t_solve = SOLVERS[family]
    args = dict(RUN, amplitude=amplitude(RUN["n_steps"]),
                damping=(0.5, beta), host=True)
    want = j_solve(j, **args)
    got = t_solve(t, **args)
    assert got.dt == pytest.approx(want.dt, rel=1e-12)
    assert rel_err(got.times, want.times) <= 1e-12
    assert np.max(want.final_eq_plastic) > 0.0
    for name in FIELDS:
        assert rel_err(getattr(got, name), getattr(want, name)) \
            <= F64_RTOL, name


@pytest.mark.parametrize("case, beta", [
    ("solid", 0.0), ("solid", 2e-3), ("plane-stress-q4", 2e-3),
    ("plane-strain-bbar", 2e-3)])
def test_float32_tier_matches_jax(case, beta, monkeypatch):
    """host=False: the float32 run on the structured grid slices, beta K0 v
    by kernel 1's twin on the family's DIA diagonals, exactly once a step
    (the JAX device tier multiplies its dense float32 K0)."""
    family, kw = CASES[case]
    j, t = problems(family, **kw)
    j_solve, t_solve = SOLVERS[family]
    calls = []
    plain = dia_kernel.dia_matvec

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(dia_kernel, "dia_matvec", counted)
    args = dict(RUN, amplitude=amplitude(RUN["n_steps"]),
                damping=(0.5, beta), host=False)
    want = j_solve(j, **args)
    got = t_solve(t, device=CPU, **args)
    assert len(calls) == (RUN["n_steps"] if beta else 0)
    for name in FIELDS:
        bound = F32_VEL_RTOL if name == "velocities" else F32_RTOL
        assert rel_err(getattr(got, name), getattr(want, name)) \
            <= bound, name


def test_general_gather_matches_structured():
    """A shuffled element table (no grid; the DOF numbering, and so the
    DIA diagonals of beta K0 v, unchanged) takes the general gather and
    the float64 scatter: the float32 run equals the structured one within
    float32 rounding, and the float64 run of the same mesh."""
    _, t = problems("solid")
    _, t_shuffled = problems("solid", shuffle=True)
    args = dict(RUN, amplitude=amplitude(RUN["n_steps"]),
                damping=(0.5, 2e-3), device=CPU)
    grid = TC.solve_solid_transient_plastic(t, host=False, **args)
    general = TC.solve_solid_transient_plastic(t_shuffled, host=False,
                                               **args)
    f64 = TC.solve_solid_transient_plastic(t, host=True, **args)
    for name in ("displacements", "final_displacement", "plastic_work"):
        assert rel_err(getattr(general, name), getattr(grid, name)) \
            <= F32_RTOL, name
        assert rel_err(getattr(general, name), getattr(f64, name)) \
            <= F32_RTOL, name


@pytest.mark.parametrize("host", [True, False])
def test_no_dense_operator(host, monkeypatch):
    """Neither tier, nor the damped Gershgorin step, assembles a dense K
    or M: the dense assemblers are made to raise."""
    def refuse(*a, **k):
        raise AssertionError("a dense ndof x ndof operator was built")

    monkeypatch.setattr(TS, "_matrices", refuse)
    monkeypatch.setattr(TP, "_matrices", refuse)
    for family in ("solid", "plane"):
        _, t = problems(family)
        res = SOLVERS[family][1](t, sigma_y=12.0, hardening_iso=20.0,
                                 n_steps=40, record_every=10,
                                 damping=(0.5, 2e-3), host=host, device=CPU)
        assert np.all(np.isfinite(res.displacements))


REFUSALS = {
    "record-every": (dict(n_steps=10, record_every=3), ValueError),
    "amplitude": (dict(n_steps=10, amplitude=np.ones(4)), ValueError),
    "mesh": (dict(n_steps=10, mesh=object()), NotImplementedError),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(name):
    """The JAX package's ValueErrors with its text; mesh= (element-parallel
    SPMD) raises NotImplementedError naming item 15."""
    extra, kind = REFUSALS[name]
    j, t = problems("solid")
    msgs = []
    calls = [(JC.solve_solid_transient_plastic, j, {}),
             (TC.solve_solid_transient_plastic, t, {"device": CPU})]
    if kind is NotImplementedError:
        calls = calls[1:]
    for solve, p, kw in calls:
        with pytest.raises(kind) as err:
            solve(p, sigma_y=12.0, **extra, **kw)
        msgs.append(str(err.value))
    if kind is NotImplementedError:
        assert "item 15" in msgs[0]
    else:
        assert msgs[0] == msgs[1]


def test_plane_refusals_match_jax():
    """B-bar on CST, and a prescribed nonzero support, refused with the JAX
    package's text."""
    for kw, extra in ((dict(nen=3, plane_strain=True), dict(bbar=True)),
                      ({}, {})):
        f = plane_fields(**kw)
        if not extra:
            f["prescribed"] = np.full(len(f["fixed_dofs"]), 0.01)
        msgs = []
        for solve, cls, dev in (
                (JC.solve_plane_transient_plastic, JP.PlaneProblem, {}),
                (TC.solve_plane_transient_plastic, TP.PlaneProblem,
                 {"device": CPU})):
            with pytest.raises(ValueError) as err:
                solve(cls(**f), sigma_y=12.0, n_steps=10, **extra, **dev)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
