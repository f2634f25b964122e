"""The port's 3D solid family (models/solid.py, ops/solid_plastic.py,
solvers/solid_plasticity.py, ops/structured.py, io/solid_io.py, the solid
branches of solvers/reduction.reduce_model and io/_common._family_modal,
and solid documents through the CLI) against the JAX package, on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * ELEM_RTOL: the element library (blocks, B, load vectors, lumped mass,
    the Gershgorin step, the structured scatter) in float64;
  * F64_RTOL: the float64 analyses (dense statics, modal, buckling,
    Newmark, harmonic, the plastic host tier, reduction, the corpus
    documents); eigenvector signs are aligned to the JAX package's first;
  * F32_RTOL: the float32 tiers (banded statics, modal and central
    transient, the plastic device tier) against the JAX package's float32
    tiers;
  * F64_BANDED_RTOL: the banded statics against a float64 scipy solve of
    the same system.

The banded Jacobi iteration count is held within +-2 of the JAX package's
recurrence on the same float32 diagonals at tolerance 1e-6.  The JAX
package's own banded solve assembles its diagonals in float32 inside its
compiled program, whose rounding moves the count: on the 4 x 4 x 12 box
at 1e-6 it takes 86 iterations where its recurrence on the port's
diagonals, the port, and a float64 recurrence take 75, 73 and 72.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import pinn_fem_tpu.models.solid as JS  # noqa: E402
import pinn_fem_tpu.ops.solid_plastic as JSP  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import solid_io as j_io  # noqa: E402
from pinn_fem_tpu.ops import dia as j_dia  # noqa: E402
from pinn_fem_tpu.ops import structured as JST  # noqa: E402
from pinn_fem_tpu.solvers import reduction as j_red  # noqa: E402
from pinn_fem_tpu.solvers.solid_plasticity import \
    solve_solid_plastic as j_plastic  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.solid as TS  # noqa: E402
import pinn_fem_tpu_torch.ops.solid_plastic as TSP  # noqa: E402
from pinn_fem_tpu_torch import examples_grid  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import _common as t_common  # noqa: E402
from pinn_fem_tpu_torch.io import solid_io as t_io  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as t_dia  # noqa: E402
from pinn_fem_tpu_torch.ops import structured as TST  # noqa: E402
from pinn_fem_tpu_torch.solvers import reduction as t_red  # noqa: E402
from pinn_fem_tpu_torch.solvers.solid_plasticity import \
    solve_solid_plastic as t_plastic  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# The element library in float64: measured up to 9e-16.
ELEM_RTOL = 1e-12
# The float64 analyses: measured up to 1.2e-13 (Newmark's velocities).
F64_RTOL = 1e-10
# Float32 tiers against the JAX float32 tiers: measured up to 6e-5
# (banded u, both at their float32 floors) and 3e-6 (plastic).
F32_RTOL = 3e-4
# The banded statics against float64 scipy: measured 7.8e-5 at 1e-6.
F64_BANDED_RTOL = 2e-4
CPU = "cpu"


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-300))


def aligned(got, want):
    """got's rows flipped to the signs of want's (eigenvector signs)."""
    got, want = np.asarray(got), np.asarray(want)
    s = np.sign(np.sum(got * want, axis=1))
    assert np.all(s != 0)
    return got * s[:, None]


def fields(nx=2, ny=2, nz=4, distort=0.0, clamp=True, **extra):
    """A 1 x 1.2 x 2 box clamped (or on rollers) at z = 0, loaded on its
    top nodes; `distort` moves the interior nodes by a seeded amount."""
    nodes, el = JS.box_mesh(1.0, 1.2, 2.0, nx, ny, nz)
    if distort:
        rng = np.random.default_rng(3)
        inner = np.all((nodes > 1e-9) & (nodes < np.array([1.0, 1.2, 2.0])
                                         - 1e-9), axis=1)
        nodes[inner] += distort * rng.uniform(-1, 1, (int(inner.sum()), 3))
    bottom = np.flatnonzero(nodes[:, 2] == 0.0)
    top = np.flatnonzero(nodes[:, 2] == 2.0)
    loads = np.zeros(3 * len(nodes))
    loads[3 * top] = 0.2
    loads[3 * top + 2] = -1.0
    fixed = ((3 * bottom[:, None] + np.arange(3)).ravel() if clamp
             else np.concatenate([3 * bottom + 2, [0, 1, 4]]))
    return dict(nodes=nodes, elements=el, young=100.0, poisson=0.3,
                density=2.0, loads=loads, fixed_dofs=fixed, **extra)


def pair(**kw):
    return JS.SolidProblem(**kw), TS.SolidProblem(**kw)


def test_element_library_matches_jax():
    """_dmat3, B and detJ at every Gauss point and the centroid, the
    stiffness and mass blocks, gp_geometry3 (with B-bar), the body-force
    and thermal load vectors, the dense K and M (with point masses), the
    lumped mass, the consistent M's row sums, the recovered stresses and
    the geometric stiffness, all at ELEM_RTOL, on a distorted mesh with
    per-element stiffness."""
    rng = np.random.default_rng(0)
    kw = fields(2, 3, 4, distort=0.06, body_force=[0.1, 0.2, -0.3],
                point_masses=rng.uniform(0.0, 0.2, 60), alpha_cte=1e-3,
                temperature=2.0)
    kw["young"] = 100.0 + rng.uniform(0.0, 5.0, 24)
    j, t = pair(**kw)
    c = j.coords()
    ct = torch.as_tensor(c)
    d = JS._dmat3(j.young, j.poisson)
    dt = TS._dmat3(torch.as_tensor(j.young), torch.as_tensor(j.poisson))
    assert rel_err(dt, d) <= ELEM_RTOL
    for point in JS._GP3 + [(0.0, 0.0, 0.0)]:
        for got, want in zip(TS._hex_point(ct, *point),
                             JS._hex_point(c, *point)):
            assert rel_err(got, want) <= ELEM_RTOL
    assert rel_err(TS._k_blocks3(ct, dt), JS._k_blocks3(c, d)) <= ELEM_RTOL
    assert rel_err(TS._m_blocks3(ct, torch.as_tensor(j.density)),
                   JS._m_blocks3(c, j.density)) <= ELEM_RTOL
    for geometry in ("gp_geometry3", "gp_geometry3_bbar"):
        for got, want in zip(getattr(TSP, geometry)(t),
                             getattr(JSP, geometry)(j)):
            assert rel_err(got, want) <= ELEM_RTOL
    assert rel_err(TS._body_force_vectors3(t), JS._body_force_vectors3(j)) \
        <= ELEM_RTOL
    assert rel_err(TS._thermal_load_vectors3(t),
                   JS._thermal_load_vectors3(j)) <= ELEM_RTOL
    k, m = JS.solid_matrices(j)
    for got, want in zip(TS.solid_matrices(t, device=CPU), (k, m)):
        assert rel_err(got, want) <= ELEM_RTOL
    assert rel_err(TS.solid_lumped_mass_diag(t, CPU),
                   JS.solid_lumped_mass_diag(j)) <= ELEM_RTOL
    assert rel_err(TS.mass_row_sums3(t, CPU), m.sum(axis=1)) <= ELEM_RTOL
    u = rng.standard_normal(t.ndof)
    for thermal in (False, True):
        for got, want in zip(TS.recover_stresses3(t, u, thermal),
                             JS.recover_stresses3(j, u, thermal)):
            assert rel_err(got, want) <= ELEM_RTOL
    assert rel_err(TS.solid_geometric_stiffness(t, u, device=CPU),
                   JS.solid_geometric_stiffness(j, u)) <= ELEM_RTOL


@pytest.mark.parametrize("damping", [(0.0, 0.0), (0.3, 2e-3)])
def test_stable_dt_and_row_sums_match_jax_dense_forms(damping):
    """solid_stable_dt's Gershgorin sums of |K| from the element blocks
    (plane.abs_row_sums) against the JAX package's dense K, and the step
    itself, at ELEM_RTOL; the plane family's plane_stable_dt too."""
    from pinn_fem_tpu.models import plane as JPm

    from pinn_fem_tpu_torch.models import plane as TPm

    j, t = pair(**fields(2, 3, 4, distort=0.06,
                         point_masses=np.full(60, 0.1)))
    k, _ = JS.solid_matrices(j)
    _, dm = TS._elements(t, CPU)
    assert rel_err(TPm.abs_row_sums(t.ndof, dm,
                                    TS._stiffness_blocks3(t, CPU)),
                   np.abs(k).sum(axis=1)) <= ELEM_RTOL
    want = JS.solid_stable_dt(j, damping=damping)
    assert abs(TS.solid_stable_dt(t, damping=damping, device=CPU) - want) \
        <= ELEM_RTOL * want
    nodes, el = JPm.rect_mesh(2.0, 1.0, 6, 3)
    pkw = dict(nodes=nodes, elements=el, young=100.0, poisson=0.3,
               thickness=0.2, density=2.0, loads=np.zeros(2 * len(nodes)),
               fixed_dofs=[0, 1], point_masses=0.3)
    want = JPm.plane_stable_dt(JPm.PlaneProblem(**pkw), damping=damping)
    assert abs(TPm.plane_stable_dt(TPm.PlaneProblem(**pkw), damping=damping,
                                   device=CPU) - want) <= ELEM_RTOL * want


def test_patch_test_and_uniaxial_closed_form():
    """A linear displacement field prescribed on the boundary of a
    distorted mesh is reproduced exactly inside (the 3D patch test), with
    constant stresses; the uniaxial column gives u_z = sigma z / E, u_x =
    -nu sigma x / E and von Mises = sigma."""
    kw = fields(3, 3, 3, distort=0.08)
    nodes = kw["nodes"]
    a = np.array([[1e-3, 2e-3, -1e-3], [0.5e-3, -1e-3, 2e-3],
                  [-2e-3, 1e-3, 1.5e-3]])
    exact = (nodes @ a.T).reshape(-1)
    boundary = np.flatnonzero(np.any(
        (np.abs(nodes) < 1e-9) | (np.abs(nodes - [1.0, 1.2, 2.0]) < 1e-9),
        axis=1))
    fixed = (3 * boundary[:, None] + np.arange(3)).ravel()
    t = TS.SolidProblem(**dict(kw, loads=np.zeros(3 * len(nodes)),
                               fixed_dofs=fixed, prescribed=exact[fixed]))
    res = TS.solve_solid_static(t, device=CPU)
    assert np.abs(res.displacements - exact).max() <= 1e-12
    assert np.ptp(res.stresses, axis=0).max() <= 1e-10

    t, _ = t_io.parse_solid_document(examples_grid.solid_column_document(
        2, 2, 6, length=2.0))
    res = TS.solve_solid_static(t, device=CPU)
    u, x = res.displacements, t.nodes
    assert np.abs(u[2::3] - 5.0 * x[:, 2] / 200.0).max() <= 1e-12
    assert np.abs(u[0::3] + 0.3 * 5.0 * x[:, 0] / 200.0).max() <= 1e-12
    assert np.abs(res.von_mises - 5.0).max() <= 1e-10


STATIC_CASES = {
    "clamped": {},
    "prescribed": {"prescribed": "lift"},
    "thermal-body": {"alpha_cte": 1e-2, "temperature": 3.0,
                     "body_force": [0.0, 0.0, -1.0]},
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_dense_static_matches_jax(case):
    extra = dict(STATIC_CASES[case])
    kw = fields(2, 2, 4, distort=0.05)
    if extra.pop("prescribed", None):
        extra["prescribed"] = np.linspace(0.0, 0.01, kw["fixed_dofs"].size)
    j, t = pair(**kw, **extra)
    want = JS.solve_solid_static(j)
    got = TS.solve_solid_static(t, device=CPU)
    for name in ("displacements", "stresses", "von_mises", "principal",
                 "strains", "reactions"):
        assert rel_err(getattr(got, name), getattr(want, name)) \
            <= F64_RTOL, name


@pytest.mark.parametrize("prestress", [None, 20.0, -5.0])
def test_modal_matches_jax(prestress):
    j, t = pair(**fields(2, 2, 4, distort=0.05))
    pres = None
    if prestress is not None:
        pres = prestress * JS.solve_solid_static(j).displacements
    want = JS.solid_modal(j, 5, prestress_u=pres)
    got = TS.solid_modal(t, 5, prestress_u=pres, device=CPU)
    assert rel_err(got.eigenvalues, want.eigenvalues) <= F64_RTOL
    assert rel_err(got.frequencies_hz, want.frequencies_hz) <= F64_RTOL
    assert rel_err(aligned(got.mode_shapes, want.mode_shapes),
                   want.mode_shapes) <= 1e-8


def test_buckling_matches_jax():
    """A slender column under a compressive top load: the load factors and
    modes (sign-aligned) of the symmetric pencil."""
    kw = fields(1, 1, 8, clamp=True)
    kw["loads"] = np.zeros_like(kw["loads"])
    top = np.flatnonzero(kw["nodes"][:, 2] == 2.0)
    kw["loads"][3 * top + 2] = -1.0
    j, t = pair(**kw)
    want = JS.solid_buckling(j, 3)
    got = TS.solid_buckling(t, 3, device=CPU)
    assert rel_err(got.load_factors, want.load_factors) <= F64_RTOL
    assert rel_err(got.von_mises, want.von_mises) <= F64_RTOL
    # The square section's double lowest pair: compare the subspaces'
    # load factors only beyond it, the third mode's shape up to sign.
    assert rel_err(aligned(got.modes[2:], want.modes[2:]),
                   want.modes[2:]) <= 1e-7


def test_newmark_and_harmonic_match_jax():
    j, t = pair(**fields(2, 2, 4, distort=0.05, point_masses=np.full(45,
                                                                     0.1)))
    amp = np.sin(0.3 * np.arange(60))
    want = JS.solve_solid_transient(j, 0.05, 60, damping=(0.1, 1e-3),
                                    amplitude=amp, record_every=3)
    got = TS.solve_solid_transient(t, 0.05, 60, damping=(0.1, 1e-3),
                                   amplitude=amp, record_every=3,
                                   device=CPU)
    assert rel_err(got.times, want.times) <= F64_RTOL
    assert rel_err(got.displacements, want.displacements) <= F64_RTOL
    assert rel_err(got.velocities, want.velocities) <= F64_RTOL
    om = [0.5, 2.0, 7.0, 20.0]
    want = JS.solid_harmonic(j, om, damping=(0.1, 1e-3), probe_dofs=[50, 80])
    got = TS.solid_harmonic(t, om, damping=(0.1, 1e-3), probe_dofs=[50, 80],
                            device=CPU)
    for name in ("amplitude", "real", "imag"):
        assert rel_err(getattr(got, name), getattr(want, name)) <= F64_RTOL


@pytest.fixture(scope="module")
def column():
    """The 4 x 4 x 12 column under a skewed top traction (975 DOFs, 99
    diagonals, bandwidth 95), as both packages' problems."""
    doc = examples_grid.solid_column_document(4, 4, 12, length=3.0)
    doc["surface_loads"][0]["traction"] = [0.3, 0.1, 5.0]
    doc["fixed_nodes"] = "z_min"
    return j_io.parse_solid_document(doc)[0], \
        t_io.parse_solid_document(doc)[0]


def test_banded_matches_jax_and_float64(column):
    """solve_solid_static_banded at 1e-6: the layout (99 diagonals), u
    against the JAX package's float32 tier (F32_RTOL) and a float64 scipy
    solve (F64_BANDED_RTOL), the iteration count within +-2 of the JAX
    recurrence on the same float32 diagonals, the reactions."""
    j, t = column
    layout = TS.solid_dia_layout(t)
    assert (layout.n_diags, layout.bandwidth) == (99, 95)
    want, _, _ = JS.solve_solid_static_banded(j, tol=1e-6)
    got, iters, rel = TS.solve_solid_static_banded(t, tol=1e-6, device=CPU)
    assert rel <= 1e-6
    assert rel_err(got.displacements, want.displacements) <= F32_RTOL
    k, _ = examples_grid.solid_sparse_matrices(t)
    free = t.free_dofs()
    import scipy.sparse.linalg as spl

    u64 = np.zeros(t.ndof)
    u64[free] = spl.spsolve(k[free][:, free].tocsc(), t.loads[free])
    assert rel_err(got.displacements, u64) <= F64_BANDED_RTOL
    react = (k @ u64 - t.loads) * (1.0 - t.free_mask())
    assert rel_err(got.reactions, react) <= F64_BANDED_RTOL
    diags = t_dia.assemble_dia_blocks(
        layout, TS._stiffness_blocks3(t, CPU)).float()
    jl = j_dia.dia_layout(j.dof_map(), j.ndof, max_diags=160)
    _, j_iters, _ = j_dia.dia_cg_solve(
        jl, jnp.asarray(diags.numpy()),
        jnp.asarray(t.loads, jnp.float32),
        jnp.asarray(t.free_mask(), jnp.float32), tol=1e-6, max_iter=10000,
        components=3)
    assert abs(iters - int(j_iters)) <= 2


def test_banded_central_matches_jax(column):
    """solve_solid_transient_banded on the 4 x 4 x 12 column (200 steps at
    solid_stable_dt, damped, probes recorded every 20) against the JAX
    package's float32 tier at F32_RTOL (velocities at 1e-3: differences
    of float32 displacements)."""
    j, t = column
    dt = JS.solid_stable_dt(j)
    probe = [t.ndof - 1, t.ndof - 3]
    want = JS.solve_solid_transient_banded(
        j, dt, 200, record_every=20, damping=(0.1, 1e-4), probe_dofs=probe)
    got = TS.solve_solid_transient_banded(
        t, dt, 200, record_every=20, damping=(0.1, 1e-4), probe_dofs=probe,
        device=CPU)
    assert rel_err(got.displacements, want.displacements) <= F32_RTOL
    assert rel_err(got.velocities, want.velocities) <= 1e-3
    assert rel_err(got.times, want.times) <= F64_RTOL


def test_banded_central_launch_formula(column, monkeypatch):
    """Kernel 1 (its twin on the CPU) runs 1 + n + 2 n / r times a central
    run with beta = 0, 2 + 2n + 3 n / r with beta != 0."""
    from pinn_fem_tpu_torch.ops.kernels import dia_kernel

    _, t = column
    calls = []
    plain = dia_kernel.dia_matvec

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(dia_kernel, "dia_matvec", counted)
    dt = TS.solid_stable_dt(t, device=CPU)
    for beta, want in ((0.0, 1 + 40 + 2 * 4), (1e-4, 2 + 80 + 3 * 4)):
        calls.clear()
        TS.solve_solid_transient_banded(t, dt, 40, record_every=10,
                                        damping=(0.0, beta), device=CPU)
        assert len(calls) == want


GRIDS = {"plane": ((5, 3), 4), "solid": ((3, 2, 4), 8)}


@pytest.mark.parametrize("family", list(GRIDS))
def test_structured_ops_match_jax_and_general_form(family):
    """The grid gather and slice-add scatter against the JAX package's and
    against the general gather / float64 scatter; a renumbered mesh is no
    grid."""
    from pinn_fem_tpu.models.plane import rect_mesh

    shape, nen = GRIDS[family]
    rng = np.random.default_rng(1)
    if family == "plane":
        nodes, el = rect_mesh(2.0, 1.0, *shape)
        detect, ops = TST.rect_grid_of, TST.make_plane_grid_ops
        j_detect, j_ops = JST.rect_grid_of, JST.make_plane_grid_ops
        dpn = 2
    else:
        nodes, el = JS.box_mesh(1.0, 1.0, 1.0, *shape)
        detect, ops = TST.box_grid_of, TST.make_solid_grid_ops
        j_detect, j_ops = JST.box_grid_of, JST.make_solid_grid_ops
        dpn = 3
    assert detect(el, len(nodes)) == j_detect(el, len(nodes)) == shape
    assert detect(el[::-1], len(nodes)) is None
    gather, scatter = ops(*shape)
    j_gather, j_scatter = j_ops(*shape)
    dm = (dpn * el[:, :, None] + np.arange(dpn)).reshape(len(el), -1)
    u = rng.standard_normal(dpn * len(nodes))
    fe = rng.standard_normal((len(el), dpn * nen))
    assert np.array_equal(gather(torch.as_tensor(u)).numpy(), u[dm])
    u32 = u.astype(np.float32)
    assert np.array_equal(gather(torch.as_tensor(u32)).numpy(),
                          np.asarray(j_gather(jnp.asarray(u32))))
    general = np.zeros(u.size)
    np.add.at(general, dm, fe)
    got = scatter(torch.as_tensor(fe)).numpy()
    assert rel_err(got, general) <= ELEM_RTOL
    got32 = scatter(torch.as_tensor(fe, dtype=torch.float32)).numpy()
    assert np.array_equal(got32, np.asarray(j_scatter(jnp.asarray(
        fe, jnp.float32))))


def test_return_maps_and_blocks_match_jax():
    """vm_return_map_6 (stress, tangent, state) and its force-only form on
    a random strain batch through yield, with kinematic hardening, in
    float64 and float32; solid_plastic_blocks / solid_plastic_force and
    von_mises_6 at ELEM_RTOL (float64)."""
    rng = np.random.default_rng(5)
    eps = rng.standard_normal((7, 8, 6)) * 0.02
    ep = rng.standard_normal((7, 8, 6)) * 0.002
    al = np.abs(rng.standard_normal((7, 8))) * 0.01
    bk = rng.standard_normal((7, 8, 6)) * 0.05
    mu, lam = np.full((7, 1), 38.0), np.full((7, 1), 57.0)
    sy, hi, hk = np.full((7, 1), 0.8), np.full((7, 1), 2.0), \
        np.full((7, 1), 1.0)
    want = JSP.vm_return_map_6(eps, ep, al, bk, mu, lam, sy, hi, hk)
    for dtype, tol in ((torch.float64, ELEM_RTOL), (torch.float32, 1e-5)):
        args = [torch.as_tensor(a, dtype=dtype)
                for a in (eps, ep, al, bk, mu, lam, sy, hi, hk)]
        got = TSP.vm_return_map_6(*args)
        for g, w in zip(got, want):
            assert rel_err(g, w) <= tol
        force = TSP.vm_return_map_6_force(*args)
        for g, w in zip(force, (want[0],) + tuple(want[2:])):
            assert rel_err(g, w) <= tol
    j, t = pair(**fields(2, 2, 2, distort=0.05))
    b, wdet = JSP.gp_geometry3_bbar(j)
    u_e = rng.standard_normal((8, 24)) * 0.05
    st = JSP.initial_solid_state(8)
    mats = [np.full(8, v) for v in (100.0, 0.3, 0.5, 2.0, 1.0)]
    want = JSP.solid_plastic_blocks(b, wdet, u_e, st, *mats)
    tt = [torch.as_tensor(a) for a in (b, wdet, u_e)]
    tst = TSP.initial_solid_state(8)
    tm = [torch.as_tensor(a) for a in mats]
    got = TSP.solid_plastic_blocks(*tt, tst, *tm)
    for g, w in zip(got[:3], want[:3]):
        assert rel_err(g, w) <= ELEM_RTOL
    for g, w in zip(got[3], want[3]):
        assert rel_err(g, w) <= ELEM_RTOL
    fe, sig6, _ = TSP.solid_plastic_force(*tt, tst, *tm)
    assert rel_err(fe, want[1]) <= ELEM_RTOL
    assert rel_err(TSP.von_mises_6(sig6), JSP.von_mises_6(want[2])) \
        <= ELEM_RTOL


PLASTIC = dict(sigma_y=1.0, hardening_iso=20.0, hardening_kin=5.0,
               load_factors=[0.4, 0.8, 1.0, 0.5, -0.3])


@pytest.mark.parametrize("bbar", [True, False])
def test_plastic_host_tier_matches_jax(bbar):
    """The corpus plastic column with a load reversal (isotropic and
    kinematic hardening): every record of the float64 tier at F64_RTOL,
    iterations and yielded counts equal."""
    doc = json.loads((CORPUS / "dyn-solid-plastic.json").read_text())
    j, _ = j_io.parse_solid_document(doc)
    t, _ = t_io.parse_solid_document(doc)
    want = j_plastic(j, host=True, bbar=bbar, tol=1e-10, **PLASTIC)
    got = t_plastic(t, host=True, bbar=bbar, tol=1e-10, device=CPU,
                    **PLASTIC)
    assert got.converged and want.converged
    assert np.array_equal(got.iterations, want.iterations)
    assert np.array_equal(got.n_plastic, want.n_plastic)
    for name in ("displacements", "stresses", "von_mises", "eq_plastic"):
        assert rel_err(getattr(got, name), getattr(want, name)) \
            <= F64_RTOL, name


def test_plastic_float32_tier_matches_jax():
    """host=False: the JAX device program's algorithm in float32 (tol
    floored at 1e-5), against the JAX package's float32 device tier."""
    doc = json.loads((CORPUS / "dyn-solid-plastic.json").read_text())
    j, _ = j_io.parse_solid_document(doc)
    t, _ = t_io.parse_solid_document(doc)
    want = j_plastic(j, host=False, **PLASTIC)
    got = t_plastic(t, host=False, device=CPU, **PLASTIC)
    assert got.converged and want.converged
    assert np.array_equal(got.n_plastic, want.n_plastic)
    assert np.abs(got.iterations - want.iterations).max() <= 1
    for name in ("displacements", "stresses", "eq_plastic"):
        assert rel_err(getattr(got, name), getattr(want, name)) \
            <= F32_RTOL, name


@pytest.mark.parametrize("method", ["guyan", "craig_bampton"])
def test_reduction_matches_jax(method):
    """reduce_model's solid branch (the consistent dense K, M) and a
    reduction document with compare_full (the solid branch of
    _family_modal) at F64_RTOL; Craig-Bampton's modal columns aligned in
    sign."""
    j, t = pair(**fields(2, 2, 4))
    top = np.flatnonzero(j.nodes[:, 2] == 2.0)[:2]
    masters = (3 * top[:, None] + np.arange(3)).ravel()
    want = j_red.reduce_model(j, masters, method=method, n_modes=3)
    got = t_red.reduce_model(t, masters, method=method, n_modes=3,
                             device=CPU)
    n_m = masters.size
    k_got, m_got = np.array(got.k_red), np.array(got.m_red)
    if method == "craig_bampton":
        s = np.sign(np.sum(got.t * want.t, axis=0))
        k_got *= np.outer(s, s)[:, :]
        m_got *= np.outer(s, s)[:, :]
    assert rel_err(k_got[:n_m, :n_m], want.k_red[:n_m, :n_m]) <= F64_RTOL
    assert rel_err(k_got, want.k_red) <= F64_RTOL
    assert rel_err(m_got, want.m_red) <= F64_RTOL
    doc = {"element_type": "solid",
           "mesh": {"type": "box", "lx": 1.0, "ly": 1.2, "lz": 2.0,
                    "nx": 2, "ny": 2, "nz": 4},
           "material": {"young": 100.0, "poisson": 0.3, "density": 2.0},
           "fixed_nodes": "z_min",
           "analysis": {"type": "reduction", "method": method,
                        "master_nodes": top.tolist(), "n_modes": 3}}
    want = j_io.run_solid_document(json.loads(json.dumps(doc)))
    got = t_io.run_solid_document(json.loads(json.dumps(doc)), CPU)
    for key in ("reduced_omegas", "full_omegas", "frequency_rel_errors"):
        assert rel_err(got[key], want[key]) <= 1e-8, key
    om, shapes = t_common._family_modal(t, 4, CPU)
    assert rel_err(om, JS.solid_modal(j, 4).omegas) <= F64_RTOL


def corpus_gaps(got, want, path=""):
    """{path: relative gap} over two result trees (absolute for residual
    norms, which sit near zero in both)."""
    out = {}
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            out.update(corpus_gaps(got[key], want[key], f"{path}/{key}"))
    elif isinstance(want, (list, float, int)) and not isinstance(want, bool):
        g, w = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
        assert g.shape == w.shape, path
        if w.size:
            scale = (1.0 if "residual" in path
                     else max(np.abs(w).max(), 1e-300))
            out[path] = float(np.abs(g - w).max() / scale)
    else:
        assert got == want, path
    return out


@pytest.mark.parametrize("name", ["dyn-solid.json", "dyn-solid-plastic.json"])
def test_corpus_solid_documents_through_both_clis(name, tmp_path,
                                                   monkeypatch):
    """The corpus solid documents through both CLIs: the same keys and
    values (dyn-solid: the banded float32 tier at F32_RTOL, its iteration
    count within +-2; dyn-solid-plastic: the float64 tier at F64_RTOL),
    the closed forms, and the SOLID ANALYSIS SUMMARY lines."""
    doc = (CORPUS / name).read_text()
    outs, logs = [], []
    for cli, sub in ((jax_cli, "jax"), (torch_cli, "torch")):
        d = tmp_path / sub
        d.mkdir()
        (d / name).write_text(doc)
        monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", CPU)
        assert cli.main([str(d / name)]) == 0
        outs.append(json.loads((d / name.replace(".json", ".res.json"))
                               .read_text()))
        logs.append((d / name.replace(".json", ".log")).read_text())
        logging.getLogger("pinn_fem_tpu").handlers.clear()
    want, got = outs
    if name == "dyn-solid.json":
        assert abs(got.pop("iterations") - want.pop("iterations")) <= 2
        got.pop("relative_residual")
        assert want.pop("relative_residual") <= 1e-9
        gaps = corpus_gaps(got, want)
        assert max(gaps.values()) <= F32_RTOL, gaps
        assert got["method"] == "banded"
        assert abs(got["max_displacement"] - 5.0 * 4.0 / 200.0) <= 2e-3 * 0.1
        assert abs(got["max_von_mises"] - 5.0) <= 2e-3 * 5.0
    else:
        gaps = corpus_gaps(got, want)
        assert max(gaps.values()) <= F64_RTOL, gaps
        assert got["success"]
        assert abs(got["final"]["displacements"][-1] - 0.065) <= 1e-9
    for log in logs:
        assert "SOLID ANALYSIS SUMMARY" in log


DOCUMENTS = {
    "static-dense": {"type": "static"},
    "modal-prestress": {"type": "modal", "n_modes": 4, "prestress": True},
    # solid_modal_banded: 4 iterations of the subspace at cg_tol 1e-5
    # (the float32 block solves run to their cap much below it); the
    # square section's first two modes are one double eigenvalue, whose
    # shapes are any basis of it.
    "modal-banded": {"type": "modal", "n_modes": 2, "banded": True,
                     "n_iter": 4, "cg_tol": 1e-5, "include_shapes": False},
    "transient-newmark": {"type": "transient", "dt": 0.05, "n_steps": 20,
                          "damping": [0.1, 0.0], "probe_nodes": "z_max",
                          "amplitude": {"type": "sine",
                                        "frequency_hz": 0.5}},
    "transient-banded": {"type": "transient", "dt": "auto", "n_steps": 40,
                         "banded": True, "record_every": 10,
                         "probe_nodes": "z_max"},
    "buckling": {"type": "buckling", "n_modes": 2},
    "harmonic": {"type": "harmonic", "omegas": {"start": 0.5, "stop": 8.0,
                                                "num": 4},
                 "damping": [0.1, 0.001], "probe_nodes": [20]},
}


def small_doc(**analysis):
    return {"element_type": "solid",
            "mesh": {"type": "box", "lx": 1.0, "ly": 1.0, "lz": 3.0,
                     "nx": 2, "ny": 2, "nz": 6},
            "material": {"young": 100.0, "poisson": 0.3, "density": 2.0},
            "fixed_nodes": "z_min",
            "surface_loads": [{"face": "z_max",
                               "traction": [0.1, 0.0, -1.0]}],
            "analysis": analysis}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_solid_documents_match_jax(name):
    """Each analysis type through run_solid_document in both packages:
    float64 documents at F64_RTOL (shapes sign-aligned), the banded tiers
    at F32_RTOL."""
    doc = small_doc(**DOCUMENTS[name])
    want = json.loads(json.dumps(j_io.run_solid_document(
        json.loads(json.dumps(doc)))))
    got = json.loads(json.dumps(t_io.run_solid_document(
        json.loads(json.dumps(doc)), CPU)))
    for key in ("mode_shapes", "buckling_modes"):
        if key in want:
            got[key] = aligned(got[key], want[key]).tolist()
    gaps = corpus_gaps(got, want)
    bound = F32_RTOL if "banded" in name else F64_RTOL
    if name == "transient-banded":
        gaps.pop("/velocities")
    assert max(gaps.values()) <= bound, gaps


SPECTRAL = {
    "spectrum": {"type": "spectrum", "sa": 2.0, "direction": [1.0, 0.5, 0.0],
                 "n_modes": 4, "combination": "cqc"},
    "random": {"type": "random", "omegas": {"start": 0.2, "stop": 6.0,
                                            "num": 16},
               "damping": [0.1, 0.002], "probe_nodes": "z_max",
               "fatigue": {"method": "narrowband"}, "probe_elements": [0, 5]},
}


@pytest.mark.parametrize("kind", list(SPECTRAL))
def test_spectral_documents_match_jax(kind):
    """The solid "spectrum" and "random" (with fatigue statistics)
    analyses, ported with solvers/continuum_spectrum.py
    (tests/test_torch_continuum_spectrum.py), through run_solid_document
    in both packages within F64_RTOL (participation by magnitude: it
    carries its mode's sign).  The column's section is made 1 x 1.4: a
    square one has degenerate bending pairs, whose modal participations
    depend on the eigensolver's basis."""
    doc = small_doc(**SPECTRAL[kind])
    doc["mesh"]["ly"] = 1.4
    want = j_io.run_solid_document(json.loads(json.dumps(doc)))
    got = t_io.run_solid_document(json.loads(json.dumps(doc)), CPU)
    if "participation" in want:
        for out in (got, want):
            out["participation"] = np.abs(out["participation"]).tolist()
    gaps = corpus_gaps(got, want)
    assert max(gaps.values()) <= F64_RTOL, gaps


@pytest.mark.parametrize("kind, item", [
    ("identification", 23), ("reliability", 24)])
def test_later_analysis_types_refused(kind, item):
    """The solid analysis types of ROADMAP items 23 and 24 are ported:
    identification refuses a block without a measurement, reliability one
    without variables, in the JAX package's words and error type."""
    if item == 23:
        with pytest.raises(ValueError, match='needs "measured_dofs"'):
            t_io.run_solid_document(small_doc(type=kind), CPU)
        return
    errs = []
    for run, args in ((j_io.run_solid_document, ()),
                      (t_io.run_solid_document, (CPU,))):
        with pytest.raises(ValueError) as err:
            run(small_doc(type=kind), *args)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


BIG = {"mesh": {"type": "box", "lx": 1.0, "ly": 1.0, "lz": 4.0, "nx": 12,
                "ny": 12, "nz": 16}}
REFUSALS = {
    "budget-buckling": (BIG, {"type": "buckling"}),
    "budget-harmonic": (BIG, {"type": "harmonic", "omegas": [1.0]}),
    "budget-plastic": (BIG, {"type": "plastic", "sigma_y": 1.0}),
    "budget-reduction": (BIG, {"type": "reduction"}),
    "budget-before-later-item": (BIG, {"type": "random"}),
    "budget-reliability": (BIG, {"type": "reliability"}),
    "unknown-type": ({}, {"type": "fatigue"}),
    "sizing": ({}, {"type": "sizing"}),
    "transient-dt": ({}, {"type": "transient"}),
    "transient-auto-dense": ({}, {"type": "transient", "dt": "auto",
                                  "n_steps": 3}),
    "transient-thermal": (dict(temperature=1.0,
                               material={"young": 1.0, "poisson": 0.3,
                                         "alpha": 1e-3}),
                          {"type": "transient", "dt": 0.1, "n_steps": 3}),
    "plasticity-banded": ({}, {"type": "transient", "n_steps": 4,
                               "banded": True,
                               "plasticity": {"sigma_y": 1.0}}),
    "plasticity-steps": ({}, {"type": "transient",
                              "plasticity": {"sigma_y": 1.0}}),
    "plasticity-spec": ({}, {"type": "transient", "n_steps": 4,
                             "plasticity": {"hardening": 1.0}}),
    "harmonic-omegas": ({}, {"type": "harmonic"}),
    "plastic-sigma": ({}, {"type": "plastic"}),
    "banded-prescribed": (dict(prescribed=[[2, 0.01]]),
                          {"type": "static", "banded": True}),
    "prestress-banded": ({}, {"type": "modal", "banded": True,
                              "prestress": True}),
    "prestress-u": ({}, {"type": "modal", "prestress": {"u": [1.0]}}),
    "reduction-masters": ({}, {"type": "reduction"}),
    "poisson": (dict(material={"young": 1.0}), {"type": "static"}),
    "mesh-type": (dict(mesh={"type": "cylinder"}), {"type": "static"}),
    "face": (dict(fixed_nodes="z_top"), {"type": "static"}),
    "supports": (dict(fixed_nodes=None), {"type": "static"}),
    "surface-spec": (dict(surface_loads=[{"face": "z_max"}]),
                     {"type": "static"}),
    "orientation": (dict(mesh=None, nodes=[[0, 0, 0], [1, 0, 0], [1, 1, 0],
                                           [0, 1, 0], [0, 0, 1], [1, 0, 1],
                                           [1, 1, 1], [0, 1, 1]],
                         elements=[[4, 5, 6, 7, 0, 1, 2, 3]],
                         surface_loads=[], fixed_nodes=[0]),
                    {"type": "static"}),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    """Documents each package refuses with the same ValueError text, the
    8192-DOF budget first (before a later item's refusal)."""
    extra, analysis = REFUSALS[name]
    doc = dict(small_doc(**analysis), **extra)
    for key in ("mesh", "fixed_nodes"):
        if key in doc and doc[key] is None:
            doc.pop(key)
    msgs = []
    for run, kw in ((j_io.run_solid_document, {}),
                    (t_io.run_solid_document, {"device": CPU})):
        with pytest.raises(ValueError) as err:
            run(json.loads(json.dumps(doc)), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_mesh_argument_refused():
    """mesh= on the banded statics and modal (ROADMAP item 15's
    multi-device row) raises before any work."""
    _, t = pair(**fields(2, 2, 2))
    for call in (lambda: TS.solve_solid_static_banded(t, mesh=object(),
                                                      device=CPU),
                 lambda: TS.solid_modal_banded(t, mesh=object(),
                                               device=CPU)):
        with pytest.raises(NotImplementedError, match="item 15"):
            call()


@pytest.mark.parametrize("bad", [
    dict(poisson=0.5), dict(young=-1.0), dict(loads=np.zeros(5)),
    dict(fixed_dofs=[-1]), dict(elements=np.zeros((1, 4), int)),
    dict(temperature=1.0), dict(prescribed=[0.1])])
def test_problem_validation_matches_jax(bad):
    kw = dict(fields(1, 1, 1), **bad)
    msgs = []
    for cls in (JS.SolidProblem, TS.SolidProblem):
        with pytest.raises(ValueError) as err:
            cls(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_meshes_and_surface_loads_match_jax():
    """box_mesh, boundary_quads on every face, surface_load and
    extrude_mesh: identical arrays."""
    from pinn_fem_tpu.models.plane import rect_mesh

    nodes, el = TS.box_mesh(1.0, 2.0, 3.0, 2, 3, 4)
    j_nodes, j_el = JS.box_mesh(1.0, 2.0, 3.0, 2, 3, 4)
    assert np.array_equal(el, j_el) and np.array_equal(nodes, j_nodes)
    j, t = pair(**fields(2, 3, 4))
    for axis in range(3):
        for side in (-1, 1):
            quads = TS.boundary_quads(t, axis, side)
            assert np.array_equal(quads, JS.boundary_quads(j, axis, side))
            assert np.array_equal(
                TS.surface_load(t.nodes, quads, [0.1, -0.2, 0.3]),
                JS.surface_load(j.nodes, quads, [0.1, -0.2, 0.3]))
    n2, q2 = rect_mesh(2.0, 1.0, 3, 2)
    for got, want in zip(TS.extrude_mesh(n2, q2, 0.5, 3),
                         JS.extrude_mesh(n2, q2, 0.5, 3)):
        assert np.array_equal(got, want)
