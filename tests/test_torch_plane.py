"""The port's plane continuum family (models/plane.py, ops/plane_plastic.py,
solvers/plane_plasticity.py, io/plane_io.py, the plane branch of
solvers/reduction.reduce_model, and plane documents through the CLI)
against the JAX package, on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * ELEM_RTOL: the element library (blocks, B, load vectors) in float64;
  * F64_RTOL: the float64 analyses (dense statics, modal, buckling,
    Newmark, harmonic, the plastic host tier, reduction, the corpus
    documents); eigenvector signs are aligned to the JAX package's first;
  * F32_RTOL: the float32 tiers (banded statics, the plastic device tier)
    against the JAX package's float32 tiers;
  * F64_BANDED_RTOL: the banded tier (Jacobi and multigrid) against a
    float64 scipy solve of the same system.

The banded Jacobi iteration counts are held within +-2 at tolerance 1e-6.
At 1e-7 the JAX package's float32 recurrence takes 267 iterations on the
16 x 64 strip where the port takes 233 (its own diagonals in the port's
recurrence take 234): 1e-7 sits at the JAX recurrence's float32 floor
(ROADMAP fault 3.21), so that solve is held to float64 instead.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu.models.plane as JP  # noqa: E402
import pinn_fem_tpu.ops.plane_plastic as JPP  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import plane_io as j_io  # noqa: E402
from pinn_fem_tpu.solvers.plane_plasticity import \
    solve_plane_plastic as j_plastic  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.plane as TP  # noqa: E402
import pinn_fem_tpu_torch.ops.plane_plastic as TPP  # noqa: E402
from pinn_fem_tpu_torch import examples_grid  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import plane_io as t_io  # noqa: E402
from pinn_fem_tpu_torch.solvers.plane_plasticity import \
    solve_plane_plastic as t_plastic  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# The element library in float64: measured up to 6e-16.
ELEM_RTOL = 1e-12
# The float64 analyses: measured up to 6e-13 (Newmark's 200 steps).
F64_RTOL = 1e-10
# Float32 tiers against the JAX float32 tiers: measured up to 1e-4 (the
# banded strip's u, both at their float32 floors) and 8e-6 (plastic).
F32_RTOL = 3e-4
# The banded tier against float64 scipy: measured 2.9e-5 (Jacobi) and
# 3.2e-5 (multigrid).
F64_BANDED_RTOL = 1e-4
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


def fields(nen=4, plane_strain=False, nx=6, ny=3, **extra):
    """A cantilever plate clamped on the left, loaded on the right."""
    nodes, el = JP.rect_mesh(2.0, 1.0, nx, ny, "quad" if nen == 4 else "tri")
    left = np.flatnonzero(nodes[:, 0] == 0.0)
    right = np.flatnonzero(nodes[:, 0] == 2.0)
    loads = np.zeros(2 * len(nodes))
    loads[2 * right] = 0.3
    loads[2 * right + 1] = -1.0
    return dict(nodes=nodes, elements=el, young=100.0, poisson=0.3,
                thickness=0.2, density=2.0, loads=loads,
                fixed_dofs=np.concatenate([2 * left, 2 * left + 1]),
                plane_strain=plane_strain, **extra)


def pair(**kw):
    return JP.PlaneProblem(**kw), TP.PlaneProblem(**kw)


FAMILIES = [(3, False), (3, True), (4, False), (4, True)]


@pytest.mark.parametrize("nen, plane_strain", FAMILIES)
def test_element_library_matches_jax(nen, plane_strain):
    """_dmat, B (CST and Q4 at every Gauss point, detJ), the stiffness and
    mass blocks, gp_geometry, the body-force and thermal load vectors and
    the dense K, M (with point masses) at ELEM_RTOL."""
    j, t = pair(**fields(nen, plane_strain, body_force=[0.1, -0.5],
                         alpha_cte=1e-2, temperature=3.0,
                         point_masses=0.25))
    c = j.coords()
    ct = torch.as_tensor(c)
    d = JP._dmat(j.young, j.poisson, plane_strain)
    dt = TP._dmat(torch.as_tensor(j.young), torch.as_tensor(j.poisson),
                  plane_strain)
    assert rel_err(dt, d) <= ELEM_RTOL
    if nen == 3:
        assert rel_err(TP._cst_b(ct)[0], JP._cst_b(c)[0]) <= ELEM_RTOL
    else:
        for xi, eta in JP._GP:
            b, det = TP._q4_point(ct, xi, eta)
            bj, detj = JP._q4_point(c, xi, eta)
            assert rel_err(b, bj) <= ELEM_RTOL
            assert rel_err(det, detj) <= ELEM_RTOL
        assert rel_err(TP._q4_detj(ct), JP._q4_detj(c)) <= ELEM_RTOL
    th = torch.as_tensor(j.thickness)
    assert rel_err(TP._k_blocks(ct, dt, th, nen),
                   JP._k_blocks(c, d, j.thickness, nen)) <= ELEM_RTOL
    assert rel_err(TP._m_blocks(ct, torch.as_tensor(j.density), th, nen),
                   JP._m_blocks(c, j.density, j.thickness, nen)) \
        <= ELEM_RTOL
    for got, want in zip(TPP.gp_geometry(t), JPP.gp_geometry(j)):
        assert rel_err(got, want) <= ELEM_RTOL
    assert rel_err(TP._body_force_vectors(t), JP._body_force_vectors(j)) \
        <= ELEM_RTOL
    assert rel_err(TP._thermal_load_vectors(t),
                   JP._thermal_load_vectors(j)) <= ELEM_RTOL
    for got, want in zip(TP.plane_matrices(t, device=CPU),
                         JP.plane_matrices(j)):
        assert rel_err(got, want) <= ELEM_RTOL


STATIC_CASES = {
    "prescribed": dict(prescribed=None),
    "gravity": dict(body_force=[0.0, -2.0]),
    "thermal": dict(alpha_cte=1e-2, temperature=np.linspace(-2, 3, 18)),
    "thermal-strain": dict(alpha_cte=1e-2, temperature=2.0,
                           plane_strain=True),
    "cst-gravity": dict(body_force=[0.5, -1.0], nen=3),
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_dense_static_matches_jax(case):
    """solve_plane_static (every field of the result) with a prescribed
    field (the inhomogeneous-Dirichlet lift), gravity and thermal load
    cases, at F64_RTOL."""
    extra = dict(STATIC_CASES[case])
    nen = extra.pop("nen", 4)
    strain = extra.pop("plane_strain", False)
    kw = fields(nen, strain, **extra)
    if case == "prescribed":
        kw["prescribed"] = np.linspace(-0.01, 0.02, kw["fixed_dofs"].size)
    j, t = pair(**kw)
    want = JP.solve_plane_static(j)
    got = TP.solve_plane_static(t, device=CPU)
    for key in ("displacements", "stresses", "von_mises", "principal",
                "strains", "reactions"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL, \
            key
    sig, vm, pr = TP.recover_stresses(t, want.displacements)
    sj, vmj, prj = JP.recover_stresses(j, want.displacements)
    for a, b in ((sig, sj), (vm, vmj), (pr, prj)):
        assert rel_err(a, b) <= F64_RTOL


@pytest.mark.parametrize("prestress", [None, 20.0, -5.0])
def test_modal_matches_jax(prestress):
    """plane_modal, unstressed and prestressed by a scaled static state
    (tension stiffens, compression softens): eigenvalues, frequencies
    and sign-aligned mode shapes at F64_RTOL."""
    j, t = pair(**fields(4, False))
    u0 = (None if prestress is None
          else prestress * JP.solve_plane_static(j).displacements)
    want = JP.plane_modal(j, 5, prestress_u=u0)
    got = TP.plane_modal(t, 5, prestress_u=u0, device=CPU)
    for key in ("eigenvalues", "omegas", "frequencies_hz"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    assert rel_err(aligned(got.mode_shapes, want.mode_shapes),
                   want.mode_shapes) <= F64_RTOL


@pytest.mark.parametrize("nen", [3, 4])
def test_buckling_matches_jax(nen):
    """plane_buckling of a strip compressed along its axis: load factors,
    sign-aligned modes and the base von Mises at F64_RTOL; the geometric
    stiffness itself too."""
    nodes, el = JP.rect_mesh(4.0, 0.4, 10, 2, "quad" if nen == 4 else "tri")
    left = np.flatnonzero(nodes[:, 0] == 0.0)
    right = np.flatnonzero(nodes[:, 0] == 4.0)
    loads = np.zeros(2 * len(nodes))
    loads[2 * right] = -1.0
    j, t = pair(nodes=nodes, elements=el, young=1000.0, poisson=0.3,
                thickness=0.1, density=1.0, loads=loads,
                fixed_dofs=np.concatenate([2 * left, 2 * left + 1]))
    want = JP.plane_buckling(j, 3)
    got = TP.plane_buckling(t, 3, device=CPU)
    assert got.load_factors.size == want.load_factors.size == 3
    assert rel_err(got.load_factors, want.load_factors) <= F64_RTOL
    assert rel_err(aligned(got.modes, want.modes), want.modes) <= F64_RTOL
    assert rel_err(got.von_mises, want.von_mises) <= F64_RTOL
    u = JP.solve_plane_static(j).displacements
    assert rel_err(TP.plane_geometric_stiffness(t, u, device=CPU),
                   JP.plane_geometric_stiffness(j, u)) <= F64_RTOL


def test_newmark_matches_jax():
    """solve_plane_transient with Rayleigh damping, a sine amplitude,
    probes and record_every 3 (200 steps) at F64_RTOL, and the damped
    stable step."""
    j, t = pair(**fields(4, False, body_force=[0.0, -0.5]))
    kw = dict(damping=(0.1, 0.001), amplitude=np.sin(0.05 * np.arange(200)),
              probe_dofs=[5, 7, 40], record_every=3)
    want = JP.solve_plane_transient(j, 0.01, 200, **kw)
    got = TP.solve_plane_transient(t, 0.01, 200, device=CPU, **kw)
    for key in ("times", "displacements", "velocities"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    assert (got.dt, got.n_steps) == (want.dt, want.n_steps)
    assert abs(TP.plane_stable_dt(t, damping=(0.1, 0.01), device=CPU)
               - JP.plane_stable_dt(j, damping=(0.1, 0.01))) \
        <= F64_RTOL * JP.plane_stable_dt(j, damping=(0.1, 0.01))


def test_harmonic_matches_jax():
    """plane_harmonic over 15 frequencies with Rayleigh damping at
    F64_RTOL (amplitude, real and imaginary parts), in chunks of 4 too."""
    j, t = pair(**fields(3, True))
    om = np.linspace(0.1, 20.0, 15)
    want = JP.plane_harmonic(j, om, damping=(0.1, 0.01), probe_dofs=[9, 40])
    got = TP.plane_harmonic(t, om, damping=(0.1, 0.01), probe_dofs=[9, 40],
                            device=CPU)
    for key in ("omegas", "amplitude", "real", "imag"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    n = t.free_dofs().size
    small = TP._HARMONIC_CHUNK_BYTES
    try:
        TP._HARMONIC_CHUNK_BYTES = 4 * 16 * n * n
        chunked = TP.plane_harmonic(t, om, damping=(0.1, 0.01),
                                    probe_dofs=[9, 40], device=CPU)
    finally:
        TP._HARMONIC_CHUNK_BYTES = small
    assert rel_err(chunked.amplitude, want.amplitude) <= F64_RTOL


def strip_pair():
    doc = examples_grid.plane_strip_document(16, 64)
    doc["body_force"] = [0.0, -0.3]
    return j_io.parse_plane_document(doc)[0], t_io.parse_plane_document(
        doc)[0]


def float64_strip(problem):
    import scipy.sparse.linalg as spl

    k, _ = examples_grid.plane_sparse_matrices(problem)
    free = np.setdiff1d(np.arange(problem.ndof), problem.fixed_dofs)
    f = problem.loads + JP._body_force_vectors(problem)
    u = np.zeros(problem.ndof)
    u[free] = spl.spsolve(k[free][:, free].tocsc(), f[free])
    return u


@pytest.fixture(scope="module")
def strip():
    j, t = strip_pair()
    return j, t, float64_strip(j)


def test_banded_matches_jax_and_float64(strip):
    """solve_plane_static_banded on the 16 x 64 strip (2,210 DOFs, 21
    diagonals) with gravity: at tol 1e-6 the Jacobi iterations within +-2
    of the JAX package's and u, reactions and von Mises within F32_RTOL of
    its; at tol 1e-7 u within F64_BANDED_RTOL of float64 scipy."""
    j, t, u64 = strip
    want, it_j, rel_j = JP.solve_plane_static_banded(j, tol=1e-6)
    got, it_t, rel_t = TP.solve_plane_static_banded(t, tol=1e-6, device=CPU)
    layout = TP.plane_dia_layout(t)
    # Three node rows of seven DOF offsets: 21 diagonals (the JAX
    # docstring's 27 is a bound), bandwidth 2 (nx + 2) + 1.
    assert (layout.n_diags, layout.bandwidth) == (21, 37)
    assert abs(it_t - it_j) <= 2 and rel_t <= 1e-6 and rel_j <= 1e-6
    for key in ("displacements", "reactions", "von_mises", "stresses"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F32_RTOL
    got, _, rel_t = TP.solve_plane_static_banded(t, tol=1e-7, device=CPU)
    assert rel_t <= 1e-7 and rel_err(got.displacements, u64) \
        <= F64_BANDED_RTOL


def test_banded_multigrid_matches_float64(strip):
    """precond="mg" (components=2) on the strip, held to float64 scipy
    only (the JAX package's multigrid core compiles for minutes on the
    CPU); the layout is made once per problem."""
    _, t, u64 = strip
    layout = TP.plane_dia_layout(t)
    got, iters, rel = TP.solve_plane_static_banded(t, tol=1e-7,
                                                   precond="mg", device=CPU)
    assert TP.plane_dia_layout(t) is layout
    assert iters < 60 and rel <= 1e-7
    assert rel_err(got.displacements, u64) <= F64_BANDED_RTOL


def test_return_maps_match_jax():
    """vm_return_map_4 (full and force-only), plane_return_map and its
    force-only form in plane stress and strain, von_mises_4 and the
    B-bar geometry, on random strains past yield, at ELEM_RTOL."""
    rng = np.random.default_rng(3)
    m, g = 5, 4
    eps3 = rng.normal(scale=0.02, size=(m, g, 3))
    young = np.full(m, 100.0)
    nu, sy = np.full(m, 0.3), np.full(m, 1.0)
    hi, hk = np.full(m, 5.0), np.full(m, 2.0)
    st_j = JPP.PlanePlasticState(eps_p=rng.normal(scale=1e-3, size=(m, g, 4)),
                                 alpha=np.abs(rng.normal(scale=1e-3,
                                                         size=(m, g))),
                                 back=rng.normal(scale=0.1, size=(m, g, 4)))
    st_t = TPP.PlanePlasticState(*(torch.as_tensor(a) for a in st_j))
    tt = [torch.as_tensor(a) for a in (eps3, young, nu, sy, hi, hk)]
    for strain in (False, True):
        want = JPP.plane_return_map(eps3, st_j, young, nu, sy, hi, hk,
                                    strain)
        got = TPP.plane_return_map(tt[0], st_t, *tt[1:], strain)
        for a, b in zip(list(got[:3]) + list(got[3]),
                        list(want[:3]) + list(want[3])):
            assert rel_err(a, b) <= ELEM_RTOL
        forced = TPP.plane_return_map_force(tt[0], st_t, *tt[1:], strain)
        assert rel_err(forced[0], want[0]) <= ELEM_RTOL
        assert rel_err(TPP.von_mises_4(got[0], got[2]),
                       JPP.von_mises_4(want[0], want[2])) <= ELEM_RTOL
    j, t = pair(**fields(4, True))
    for a, b in zip(TPP.gp_geometry_bbar(t), JPP.gp_geometry_bbar(j)):
        assert rel_err(a, b) <= ELEM_RTOL


@pytest.mark.parametrize("bbar", [False, True])
def test_plastic_element_blocks_match_jax(bbar):
    """plane_plastic_blocks (plane stress) / plane_plastic_blocks_bbar and
    their force-only forms on a displacement past yield from a random
    committed state, at ELEM_RTOL."""
    rng = np.random.default_rng(11)
    j, t = pair(**fields(4, bbar))
    m, ngp = j.nelm, 4
    u_e = rng.normal(scale=0.03, size=(m, 8))
    st_j = JPP.PlanePlasticState(eps_p=rng.normal(scale=1e-3, size=(m, ngp,
                                                                     4)),
                                 alpha=np.abs(rng.normal(scale=1e-3,
                                                         size=(m, ngp))),
                                 back=rng.normal(scale=0.1, size=(m, ngp,
                                                                  4)))
    st_t = TPP.PlanePlasticState(*(torch.as_tensor(a) for a in st_j))
    mat = [np.full(m, v) for v in (100.0, 0.3, 0.2, 1.0, 5.0, 2.0)]
    tmat = [torch.as_tensor(a) for a in mat]
    young, nu, thick, sy, hi, hk = mat
    if bbar:
        b, w = JPP.gp_geometry_bbar(j)
        want = JPP.plane_plastic_blocks_bbar(b, w, thick, u_e, st_j, young,
                                             nu, sy, hi, hk)
        want_f = JPP.plane_plastic_force_bbar(b, w, thick, u_e, st_j, young,
                                              nu, sy, hi, hk)
        bt, wt = TPP.gp_geometry_bbar(t)
        got = TPP.plane_plastic_blocks_bbar(bt, wt, tmat[2],
                                            torch.as_tensor(u_e), st_t,
                                            *tmat[:2], *tmat[3:])
        got_f = TPP.plane_plastic_force_bbar(bt, wt, tmat[2],
                                             torch.as_tensor(u_e), st_t,
                                             *tmat[:2], *tmat[3:])
    else:
        b, w = JPP.gp_geometry(j)
        want = JPP.plane_plastic_blocks(b, w, thick, u_e, st_j, young, nu,
                                        sy, hi, hk, False)
        want_f = JPP.plane_plastic_force(b, w, thick, u_e, st_j, young, nu,
                                         sy, hi, hk, False)
        bt, wt = TPP.gp_geometry(t)
        got = TPP.plane_plastic_blocks(bt, wt, tmat[2], torch.as_tensor(u_e),
                                       st_t, *tmat[:2], *tmat[3:], False)
        got_f = TPP.plane_plastic_force(bt, wt, tmat[2],
                                        torch.as_tensor(u_e), st_t,
                                        *tmat[:2], *tmat[3:], False)
    # sigma_zz (exactly 0 in plane stress, rounding in both) and the
    # state against their own scale or the stresses'.
    scale = np.abs(want[2]).max()
    for a, b_ in zip(list(got) + list(got[4]) + list(got_f) + list(got_f[3]),
                     list(want) + list(want[4]) + list(want_f)
                     + list(want_f[3])):
        if isinstance(b_, tuple):
            continue
        b_ = np.asarray(b_)
        assert np.abs(np.asarray(a) - b_).max() \
            <= ELEM_RTOL * max(np.abs(b_).max(), scale * (b_.ndim == 2))


def plastic_case(name):
    """(JAX problem, port problem, solve kwargs) of each plastic case."""
    if name == "cylinder":
        doc = json.loads((CORPUS / "dyn-plane-plastic.json").read_text())
        j, an = j_io.parse_plane_document(doc)
        return j, t_io.parse_plane_document(doc)[0], dict(
            sigma_y=1.0, load_factors=an["load_factors"], tol=1e-8,
            max_iter=40)
    nen, strain, bbar = {"stress-q4": (4, False, None),
                         "strain-q4-nobbar": (4, True, False),
                         "stress-cst": (3, False, None)}[name]
    nodes, el = JP.rect_mesh(4.0, 1.0, 8, 2, "quad" if nen == 4 else "tri")
    left = np.flatnonzero(nodes[:, 0] == 0.0)
    loads = np.zeros(2 * len(nodes))
    loads[2 * np.flatnonzero(nodes[:, 0] == 4.0)] = 1.0
    j, t = pair(nodes=nodes, elements=el, young=100.0, poisson=0.3,
                thickness=1.0, density=1.0, loads=loads,
                fixed_dofs=np.concatenate([2 * left, [1]]),
                plane_strain=strain)
    # tol 1e-12: both float64 runs end at the float64 floor, not within
    # the default 1e-9 of it (which leaves 3e-10 between them).
    return j, t, dict(sigma_y=1.0, hardening_iso=5.0, hardening_kin=3.0,
                      load_factors=[0.5, 1.0, 1.2, 1.4, 0.5, -0.5, -1.3],
                      bbar=bbar, tol=1e-12)


@pytest.mark.parametrize("case", ["cylinder", "stress-q4",
                                  "strain-q4-nobbar", "stress-cst"])
def test_plastic_host_tier_matches_jax(case):
    """The float64 tier (host=True) against the JAX host tier: the
    thick-wall cylinder (B-bar) and cyclic load / unload histories with
    combined hardening in plane stress (Q4, CST) and plane strain without
    B-bar; every field at F64_RTOL (sigma_zz relative to the stress
    scale), iterations within one (a residual at the tolerance)."""
    j, t, kw = plastic_case(case)
    want = j_plastic(j, host=True, **kw)
    got = t_plastic(t, host=True, **kw)
    assert got.converged == want.converged
    assert np.abs(got.iterations - want.iterations).max() <= 1
    for key in ("displacements", "stresses", "von_mises", "eq_plastic"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    scale = np.abs(want.stresses).max()
    assert np.abs(got.sigma_zz - want.sigma_zz).max() <= F64_RTOL * scale
    np.testing.assert_array_equal(got.n_plastic, want.n_plastic)


@pytest.mark.parametrize("case", ["cylinder", "stress-q4"])
def test_plastic_float32_tier_matches_jax(case):
    """The float32 tier (host=False) against the JAX device tier: both
    converge at the 1e-5 floor, u, stresses and alpha within F32_RTOL,
    the same yielding counts.  The Newton counts are not compared: near
    the floor the stall stop fires on float32 noise (measured 4-9 against
    4-6 on the cyclic strip's unloading steps)."""
    j, t, kw = plastic_case(case)
    want = j_plastic(j, host=False, **kw)
    got = t_plastic(t, host=False, device=CPU, **kw)
    assert got.converged and want.converged
    assert got.residuals.max() <= 1e-5
    for key in ("displacements", "stresses", "von_mises", "eq_plastic"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F32_RTOL
    np.testing.assert_array_equal(got.n_plastic, want.n_plastic)


def test_plastic_refusals_match_jax():
    """B-bar on CST, an empty schedule and a negative yield stress: the
    JAX package's ValueError texts."""
    j, t = pair(**fields(3, True))
    for kw in (dict(sigma_y=1.0, bbar=True), dict(sigma_y=1.0,
                                                  load_factors=[]),
               dict(sigma_y=-1.0)):
        msgs = []
        for solve, p, extra in ((j_plastic, j, {}),
                                (t_plastic, t, {"device": CPU})):
            with pytest.raises(ValueError) as err:
                solve(p, **kw, **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def reduction_doc(method):
    doc = json.loads((CORPUS / "dyn-plane.json").read_text())
    doc["analysis"] = {"type": "reduction", "method": method,
                       "master_nodes": [16, 33, 50], "n_modes": 3,
                       "n_compare": 3}
    return doc


@pytest.mark.parametrize("method", ["guyan", "craig_bampton"])
def test_reduction_document_matches_jax(method):
    """A plane "reduction" document (masters at the strip's free end):
    reduced and full frequencies, errors and masters at F64_RTOL, k_red
    and m_red under the sign rule of Craig-Bampton's modal rows and
    columns."""
    doc = reduction_doc(method)
    want = j_io.run_plane_document(doc)
    got = t_io.run_plane_document(doc, CPU)
    assert set(got) == set(want)
    assert got["master_dofs"] == want["master_dofs"]
    assert got["n_reduced_dofs"] == want["n_reduced_dofs"]
    for key in ("reduced_omegas", "full_omegas", "frequency_rel_errors"):
        assert rel_err(got[key], want[key]) <= F64_RTOL, key
    n_m = len(want["master_dofs"])
    mg, mw = np.asarray(got["m_red"]), np.asarray(want["m_red"])
    s = np.ones(mw.shape[0])
    s[n_m:] = np.sign(np.sum(mg[:n_m, n_m:] * mw[:n_m, n_m:], axis=0))
    for key in ("k_red", "m_red"):
        a = np.asarray(got[key])
        assert rel_err(s[:, None] * a * s[None, :], want[key]) <= F64_RTOL


def run_cli(module, tmp_path, name, text, env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    path = tmp_path / name
    path.write_text(text)
    rc = module.main([str(path)])
    out = json.loads((tmp_path / name.replace(".json", ".res.json"))
                     .read_text())
    log = (tmp_path / name.replace(".json", ".log")).read_text()
    summary = [line.split("] ", 1)[1] for line in log.splitlines()
               if "[INFO]   " in line or "SUMMARY" in line]
    return rc, out, summary


# Leaves at the float64 noise floor (a residual; sigma_zz, exactly 0 in
# plane stress and of order 1 here in plane strain), compared absolutely.
ABSOLUTE = ("max_residual", "sigma_zz")


def tree_gap(got, want, path=""):
    """The largest relative gap over the numeric leaves (absolute for
    ABSOLUTE keys); other leaves must be equal."""
    if path.endswith(ABSOLUTE):
        return float(np.abs(np.asarray(got) - np.asarray(want)).max())
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return max((tree_gap(got[k], want[k], f"{path}.{k}") for k in want),
                   default=0.0)
    if isinstance(want, list) and want and not isinstance(want[0], str):
        return rel_err(got, want)
    if isinstance(want, float):
        return rel_err([got], [want])
    assert got == want, path
    return 0.0


@pytest.mark.parametrize("name", ["dyn-plane.json", "dyn-plane-plastic.json"])
def test_corpus_plane_documents_through_both_clis(name, tmp_path,
                                                  monkeypatch):
    """The corpus plane documents through both CLIs: exit code 0, the
    same PLANE ANALYSIS SUMMARY lines, the .res.json within F64_RTOL
    (mode shapes sign-aligned)."""
    text = (CORPUS / name).read_text()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    rc_j, want, log_j = run_cli(jax_cli, jdir, name, text, {}, monkeypatch)
    rc_t, got, log_t = run_cli(torch_cli, tdir, name, text,
                               {"PINN_FEM_TORCH_DEVICE": CPU}, monkeypatch)
    logging.getLogger("pinn_fem_tpu_torch").handlers.clear()
    assert rc_j == rc_t == 0
    assert log_t[-4:] == log_j[-4:]
    if "mode_shapes" in want:
        got["mode_shapes"] = aligned(got["mode_shapes"],
                                     want["mode_shapes"]).tolist()
    assert tree_gap(got, want) <= F64_RTOL


def small_doc(**analysis):
    return {"element_type": "plane",
            "mesh": {"type": "rect", "width": 2.0, "height": 1.0, "nx": 4,
                     "ny": 2},
            "material": {"young": 100.0, "poisson": 0.3},
            "fixed_nodes": "left",
            "edge_loads": [{"nodes": "right", "traction": [0.0, -1.0]}],
            "analysis": analysis}


DOCUMENTS = {
    "static": {"type": "static"},
    "plane": {"type": "plane"},
    "modal-prestress": {"type": "modal", "n_modes": 4, "prestress": True},
    "modal-prestress-u": {"type": "modal", "n_modes": 3,
                          "include_shapes": False,
                          "prestress": {"scale": 2.0}},
    "buckling": {"type": "buckling", "n_modes": 2},
    "transient-sine": {"type": "transient", "dt": 0.02, "n_steps": 60,
                       "record_every": 5, "damping": [0.1, 0.001],
                       "amplitude": {"type": "sine", "frequency_hz": 2.0},
                       "probe_nodes": "right"},
    "harmonic": {"type": "harmonic", "omegas": {"start": 0.5, "stop": 30.0,
                                                "num": 12},
                 "damping": [0.05, 0.001], "probe_nodes": [14]},
    "plastic-ramp": {"type": "plastic", "sigma_y": 0.5, "target": 1.0,
                     "n_steps": 4, "hardening": 2.0, "include_history": True},
}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_plane_documents_match_jax(name):
    """A small plane document of each analysis type through both packages'
    run_plane_document: keys and values within F64_RTOL (shapes
    sign-aligned)."""
    doc = small_doc(**DOCUMENTS[name])
    if name.startswith("buckling"):
        doc["edge_loads"] = [{"nodes": "right", "traction": [-1.0, 0.0]}]
    want = j_io.run_plane_document(json.loads(json.dumps(doc)))
    got = t_io.run_plane_document(json.loads(json.dumps(doc)), CPU)
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    for key in ("mode_shapes", "buckling_modes"):
        if key in want:
            got[key] = aligned(got[key], want[key]).tolist()
    assert tree_gap(got, want) <= F64_RTOL


def test_banded_document_matches_jax(monkeypatch):
    """A static document above the dense limit (patched to 128 in both
    packages) takes the banded tier: the payload's keys, probes and
    summaries within F32_RTOL of the JAX package's, at tolerance 1e-6
    (iterations within 2)."""
    import pinn_fem_tpu.solvers.newton as j_newton
    import pinn_fem_tpu_torch.solvers.newton as t_newton

    monkeypatch.setattr(j_newton, "DENSE_DOF_LIMIT", 128)
    monkeypatch.setattr(t_newton, "DENSE_DOF_LIMIT", 128)
    doc = examples_grid.plane_strip_document(8, 24, tolerance=1e-6)
    want = j_io.run_plane_document(json.loads(json.dumps(doc)))
    got = t_io.run_plane_document(json.loads(json.dumps(doc)), CPU)
    assert set(got) == set(want) and got["tier"] == "banded"
    assert abs(got["iterations"] - want["iterations"]) <= 2
    assert got["probe_dofs"] == want["probe_dofs"]
    assert got["relative_residual"] <= 1e-6
    for key in ("displacements", "principal_range", "max_von_mises",
                "max_abs_displacement"):
        assert rel_err(got[key], want[key]) <= F32_RTOL, key


SPECTRAL = {
    "spectrum": {"type": "spectrum", "sa": 2.0, "direction": [0.0, 1.0],
                 "n_modes": 4, "combination": "srss"},
    "random": {"type": "random", "omegas": {"start": 0.5, "stop": 30.0,
                                            "num": 20},
               "damping": [0.3, 0.001], "probe_nodes": "right",
               "fatigue": {"sn": {"exponent": 3.0, "coefficient": 1e6},
                           "duration": 100.0}},
}


@pytest.mark.parametrize("kind", list(SPECTRAL))
def test_spectral_documents_match_jax(kind):
    """The plane "spectrum" and "random" (with fatigue) analyses, ported
    with solvers/continuum_spectrum.py (tests/test_torch_continuum_
    spectrum.py), through run_plane_document in both packages within
    F64_RTOL (participation by magnitude: it carries its mode's sign)."""
    doc = small_doc(**SPECTRAL[kind])
    want = j_io.run_plane_document(json.loads(json.dumps(doc)))
    got = t_io.run_plane_document(json.loads(json.dumps(doc)), CPU)
    if "participation" in want:
        for out in (got, want):
            out["participation"] = np.abs(out["participation"]).tolist()
    assert tree_gap(got, want) <= F64_RTOL


@pytest.mark.parametrize("kind, item", [
    ("identification", 23), ("sizing", 24), ("reliability", 24)])
def test_later_analysis_types_refused(kind, item):
    """The plane analysis types of ROADMAP items 23 and 24 are ported
    (identification; thickness sizing and reliability: tests/
    test_torch_sizing.py, test_torch_reliability.py): a block without its
    keys is refused in the JAX package's words, with its error type."""
    if item == 23:
        with pytest.raises(ValueError, match='needs "measured_dofs"'):
            t_io.run_plane_document(small_doc(type=kind), CPU)
        return
    errs = []
    for run, args in ((j_io.run_plane_document, ()),
                      (t_io.run_plane_document, (CPU,))):
        with pytest.raises(ValueError) as err:
            run(small_doc(type=kind), *args)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


REFUSALS = {
    "budget": (dict(mesh={"type": "rect", "width": 2.0, "height": 1.0,
                          "nx": 64, "ny": 64}), {"type": "modal"}),
    "budget-before-later-item": (dict(mesh={"type": "rect", "width": 2.0,
                                            "height": 1.0, "nx": 64,
                                            "ny": 64}), {"type": "random"}),
    "unknown-type": ({}, {"type": "fatigue"}),
    "transient-dt": ({}, {"type": "transient"}),
    "transient-thermal": (dict(temperature=1.0,
                               material={"young": 1.0, "poisson": 0.3,
                                         "alpha": 1e-3}),
                          {"type": "transient", "dt": 0.1, "n_steps": 3}),
    "harmonic-omegas": ({}, {"type": "harmonic"}),
    "plastic-sigma": ({}, {"type": "plastic"}),
    "amplitude": ({}, {"type": "transient", "dt": 0.1, "n_steps": 3,
                       "amplitude": {"type": "saw"}}),
    "prestress-u": ({}, {"type": "modal", "prestress": {"u": [1.0]}}),
    "reduction-masters": ({}, {"type": "reduction"}),
    "poisson": (dict(material={"young": 1.0}), {"type": "static"}),
    "mesh-type": (dict(mesh={"type": "disk"}), {"type": "static"}),
    "selector": (dict(fixed_nodes="middle"), {"type": "static"}),
    "edge-both": (dict(edge_loads=[{"nodes": [0, 1], "pressure": 1.0,
                                    "traction": [1.0, 0.0]}]),
                  {"type": "static"}),
    "thermal-both": (dict(thermal={"delta_t": 1.0}, temperature=1.0),
                     {"type": "static"}),
    "quad-orientation": (dict(mesh=None, nodes=[[0, 0], [1, 0], [1, 1],
                                                [0, 1]],
                              elements=[[0, 3, 2, 1]]), {"type": "static"}),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    """Documents each package refuses with the same ValueError text, the
    8192-DOF budget first (before a later item's refusal)."""
    extra, analysis = REFUSALS[name]
    doc = dict(small_doc(**analysis), **extra)
    if doc.get("mesh") is None:
        doc.pop("mesh")
    msgs = []
    for run, kw in ((j_io.run_plane_document, {}),
                    (t_io.run_plane_document, {"device": CPU})):
        with pytest.raises(ValueError) as err:
            run(json.loads(json.dumps(doc)), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_banded_refusals():
    """The banded tier refuses a prescribed field (the JAX text) and a
    device mesh (ROADMAP item 15's multi-device row)."""
    kw = fields(4, False)
    kw["prescribed"] = np.full(kw["fixed_dofs"].size, 0.01)
    j, t = pair(**kw)
    with pytest.raises(ValueError) as want:
        JP.solve_plane_static_banded(j)
    with pytest.raises(ValueError, match=str(want.value)[:40]):
        TP.solve_plane_static_banded(t, device=CPU)
    _, t = pair(**fields(4, False))
    with pytest.raises(NotImplementedError, match="item 15"):
        TP.solve_plane_static_banded(t, mesh=object(), device=CPU)


@pytest.mark.parametrize("mesh", ["quad", "tri", "annulus"])
def test_meshes_and_edge_loads_match_jax(mesh):
    """rect_mesh (quad, tri) and annulus_mesh give the JAX numbering; the
    traction and pressure loads along a named edge are equal."""
    if mesh == "annulus":
        want, got = (pkg.annulus_mesh(1.0, 2.0, 5, 7) for pkg in (JP, TP))
    else:
        want, got = (pkg.rect_mesh(3.0, 2.0, 5, 4, mesh) for pkg in (JP, TP))
    np.testing.assert_array_equal(got[1], want[1])
    assert rel_err(got[0], want[0]) <= ELEM_RTOL
    ids = t_io._named_nodes(got[0], "top")
    np.testing.assert_array_equal(ids, j_io._named_nodes(want[0], "top"))
    for fn, arg in (("edge_load", [0.3, -1.0]), ("pressure_load", 2.0)):
        assert rel_err(getattr(TP, fn)(got[0], ids, arg, 0.5),
                       getattr(JP, fn)(want[0], ids, arg, 0.5)) <= ELEM_RTOL


@pytest.mark.parametrize("bad", [
    dict(nodes=np.zeros((3, 3))), dict(elements=np.zeros((2, 5), int)),
    dict(young=-1.0), dict(poisson=0.5), dict(loads=np.zeros(3)),
    dict(fixed_dofs=[1000]), dict(prescribed=[1.0]),
    dict(temperature=1.0), dict(elements=[[0, 1, 1000, 2]])])
def test_problem_validation_matches_jax(bad):
    """PlaneProblem refuses malformed inputs with the JAX ValueError
    texts."""
    kw = dict(fields(4, True), **bad)
    msgs = []
    for cls in (JP.PlaneProblem, TP.PlaneProblem):
        with pytest.raises(ValueError) as err:
            cls(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_strip_and_annulus_documents():
    """examples_grid's strip document is the JAX benchmark's problem
    (benchmarks/scaling.py's plane_section: fixed DOFs and loads), and its
    annulus document at 6 x 8 the corpus cylinder."""
    p, an = t_io.parse_plane_document(examples_grid.plane_strip_document(8,
                                                                         32))
    nodes, _ = JP.rect_mesh(1.0, 4.0, 8, 32)
    left = np.flatnonzero(nodes[:, 0] == 0.0)
    bottom = np.flatnonzero(nodes[:, 1] == 0.0)
    right = np.flatnonzero(nodes[:, 0] == 1.0)
    order = right[np.argsort(nodes[right, 1])]
    np.testing.assert_array_equal(
        p.fixed_dofs, np.unique(np.concatenate([2 * left, 2 * bottom + 1])))
    assert rel_err(p.loads, JP.edge_load(nodes, order, [10.0, 0.0], 0.1)) \
        <= ELEM_RTOL
    assert an["type"] == "static" and an["tolerance"] == 1e-7
    corpus = json.loads((CORPUS / "dyn-plane-plastic.json").read_text())
    a, an_a = t_io.parse_plane_document(
        examples_grid.plane_annulus_document(6, 8))
    b, an_b = t_io.parse_plane_document(corpus)
    np.testing.assert_array_equal(a.fixed_dofs, b.fixed_dofs)
    assert rel_err(a.loads, b.loads) <= ELEM_RTOL
    assert rel_err(an_a["load_factors"], an_b["load_factors"]) <= 1e-5
