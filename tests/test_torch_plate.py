"""The port's Mindlin plate family (models/plate.py, ops/plate_plastic.py,
solvers/plate_plasticity.py, io/plate_io.py, the plate branches of
solvers/reduction.reduce_model and io/_common._family_modal, and plate
documents through the CLI) against the JAX package, on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * ELEM_RTOL: the MITC4 element library (blocks, B, load vectors);
  * F64_RTOL: the float64 analyses (dense statics, modal with a membrane
    prestress, buckling, Newmark, harmonic, reduction, the plastic host
    tier, the corpus documents); a rectangular plate keeps the modes
    apart, and the signs are aligned to the JAX package's;
  * the banded tier: u within BANDED_DENSE_RTOL of the dense float64
    solve (the JAX package's own floor is 4e-3: its diagonals are summed
    in float32), the Jacobi count within +-2 of the JAX recurrence on the
    same float32 diagonals at tolerance 1e-5 on a t = 0.05 plate, above
    the float32 floor (at t = 0.01 the float32 counts of both packages
    triple past tolerance 1e-4: ROADMAP fault 3.31);
  * the float32 plastic device tier against the float64 host tier at the
    JAX package's own mirror bounds (tests/test_plate_plastic.py), and
    beside the JAX device tier on dyn-plate-plastic, where both stall
    (ROADMAP fault 3.30).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import pinn_fem_tpu.models.plate as JP  # noqa: E402
from pinn_fem_tpu.io import plate_io as j_io  # noqa: E402
from pinn_fem_tpu.ops import dia as j_dia  # noqa: E402
from pinn_fem_tpu.solvers import reduction as j_red  # noqa: E402
from pinn_fem_tpu.solvers.plate_plasticity import \
    solve_plate_plastic as j_plastic  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.plate as TP  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import _common as t_common  # noqa: E402
from pinn_fem_tpu_torch.io import plate_io as t_io  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as t_dia  # noqa: E402
from pinn_fem_tpu_torch.solvers import reduction as t_red  # noqa: E402
from pinn_fem_tpu_torch.solvers.plate_plasticity import \
    solve_plate_plastic as t_plastic  # noqa: E402
from test_torch_frame import aligned, both_clis, run_cli  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# The element library: measured up to 1.1e-15.
ELEM_RTOL = 1e-12
# The float64 analyses: measured up to 3.6e-13 (Newmark), 1.9e-11 (the
# plastic host tier's eq_plastic).
F64_RTOL = 1e-10
# The reactions of the thin corpus plate (t/a = 0.01), K u - f: measured
# 1.2e-10 (the solve's rounding amplified by the w / rotation scales).
THIN_REACTION_RTOL = 1e-9
# The banded tier against dense float64 at t = 0.01: measured 2.1e-5 (the
# port) and 1.8e-3 (the JAX package, tests/test_plate.py's 4e-3 bound).
BANDED_DENSE_RTOL = 1e-3
JAX_BANDED_DENSE_RTOL = 4e-3
CPU = "cpu"
E, NU, RHO, Q = 2.0e11, 0.3, 7850.0, -1000.0


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def both(**kw):
    return TP.PlateProblem(**kw), JP.PlateProblem(**kw)


def skewed(nx=5, ny=4, t=0.05, **extra):
    """A 1.0 x 0.7 plate on a perturbed grid, clamped on the left and
    simply supported on the bottom, with random nodal loads, per-element
    E, pressure and point masses."""
    rng = np.random.default_rng(3)
    nodes, el = JP.rect_mesh(1.0, 0.7, nx, ny)
    inner = (nodes[:, 0] > 0) & (nodes[:, 0] < 1.0) & (nodes[:, 1] > 0) \
        & (nodes[:, 1] < 0.7)
    nodes = nodes + 0.02 * rng.standard_normal(nodes.shape) * inner[:, None]
    fixed = np.union1d(JP.plate_supports(nodes, "left", "clamped"),
                       JP.plate_supports(nodes, "bottom",
                                         "simply_supported"))
    kw = dict(nodes=nodes, elements=el,
              young=E * rng.uniform(0.8, 1.2, el.shape[0]), poisson=NU,
              thickness=t, density=RHO,
              loads=1e2 * rng.standard_normal(3 * nodes.shape[0]),
              fixed_dofs=fixed, pressure=Q, point_masses=0.5)
    kw.update(extra)
    return both(**kw)


def ss_square(t, n):
    nodes, el = JP.rect_mesh(1.0, 1.0, n, n)
    fixed = JP.plate_supports(nodes, ["left", "right", "bottom", "top"],
                              "simply_supported")
    return both(nodes=nodes, elements=el, young=E, poisson=NU, thickness=t,
                density=RHO, loads=np.zeros(3 * nodes.shape[0]),
                fixed_dofs=fixed, pressure=Q)


@pytest.fixture(scope="module")
def plate():
    return skewed()


def test_element_library_matches_jax(plate):
    tp, jp = plate
    c = jp.coords()
    ct = torch.as_tensor(c)
    mat = [torch.as_tensor(getattr(jp, n)) for n in
           ("young", "poisson", "thickness", "density")]
    assert rel_err(TP._k_blocks_plate(ct, *mat[:3]).numpy(),
                   JP._k_blocks_plate(c, jp.young, jp.poisson,
                                      jp.thickness)) <= ELEM_RTOL
    assert rel_err(TP._m_blocks_plate(ct, mat[3], mat[2]).numpy(),
                   JP._m_blocks_plate(c, jp.density,
                                      jp.thickness)) <= ELEM_RTOL
    for (xi, eta) in ((0.0, 0.0), (0.3, -0.7)):
        got = TP._shape_grads(ct, xi, eta)
        want = JP._shape_grads(c, xi, eta)
        assert np.array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            assert rel_err(g.numpy(), w) <= ELEM_RTOL
        n, dx, dy, _ = want
        assert rel_err(TP._bend_b(got[1], got[2]).numpy(),
                       JP._bend_b(dx, dy)) <= ELEM_RTOL
        assert rel_err(TP._shear_b(n, got[1], got[2]).numpy(),
                       JP._shear_b(n, dx, dy)) <= ELEM_RTOL
        bs, det = TP._shear_b_mitc(ct, TP._mitc_rows(ct), xi, eta)
        bs_j, det_j = JP._shear_b_mitc(c, JP._mitc_rows(c), xi, eta)
        assert rel_err(bs.numpy(), bs_j) <= ELEM_RTOL
        assert rel_err(det.numpy(), det_j) <= ELEM_RTOL
    for a, b in zip(TP._dmats(*mat[:3]), JP._dmats(jp.young, jp.poisson,
                                                   jp.thickness)):
        assert rel_err(a.numpy(), b) <= ELEM_RTOL
    assert rel_err(TP._pressure_vectors(tp).numpy(),
                   JP._pressure_vectors(jp)) <= ELEM_RTOL


def test_thermal_loads_and_statics_match_jax():
    tp, jp = skewed(alpha_cte=1e-5, temperature=np.linspace(5, 20, 20))
    assert rel_err(TP._thermal_load_vectors(tp).numpy(),
                   JP._thermal_load_vectors(jp)) <= ELEM_RTOL
    got = TP.solve_plate_static(tp, device=CPU)
    want = JP.solve_plate_static(jp)
    for key in ("displacements", "moments", "shear_forces", "von_mises",
                "reactions"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    u = np.random.default_rng(0).normal(size=jp.ndof)
    for a, b in zip(TP.recover_moments(tp, u), JP.recover_moments(jp, u)):
        assert rel_err(a, b) <= F64_RTOL


def test_dense_analyses_match_jax(plate):
    """Statics, modal with and without a membrane prestress, buckling,
    Newmark and harmonic on the skewed plate, and the matrices."""
    tp, jp = plate
    k_t, m_t = TP.plate_matrices(tp, device=CPU)
    k_j, m_j = JP.plate_matrices(jp)
    assert rel_err(k_t.numpy(), k_j) <= ELEM_RTOL
    assert rel_err(m_t.numpy(), m_j) <= ELEM_RTOL
    got, want = TP.solve_plate_static(tp, device=CPU), \
        JP.solve_plate_static(jp)
    for key in ("displacements", "moments", "shear_forces", "von_mises",
                "reactions"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    for nf in (None, [-2e4, 5e3, 1e3]):
        got = TP.plate_modal(tp, 5, membrane_force=nf, device=CPU)
        want = JP.plate_modal(jp, 5, membrane_force=nf)
        assert rel_err(got.eigenvalues, want.eigenvalues) <= F64_RTOL
        assert rel_err(aligned(got.mode_shapes, want.mode_shapes),
                       want.mode_shapes) <= F64_RTOL
    kg = TP.plate_geometric_stiffness(tp, [-1.0, 0.5, 0.2], device=CPU)
    assert rel_err(kg.numpy(), JP.plate_geometric_stiffness(
        jp, [-1.0, 0.5, 0.2])) <= ELEM_RTOL
    got = TP.plate_buckling(tp, [-1.0, -0.2, 0.1], n_modes=3, device=CPU)
    want = JP.plate_buckling(jp, [-1.0, -0.2, 0.1], n_modes=3)
    assert rel_err(got.load_factors, want.load_factors) <= F64_RTOL
    assert rel_err(aligned(got.modes, want.modes), want.modes) <= F64_RTOL
    w1 = want_w1 = JP.plate_modal(jp, 1).omegas[0]
    kw = dict(damping=(0.02 * w1, 1e-5), amplitude=np.cos(
        np.arange(40) * 0.3), probe_dofs=[30, 31, 45], record_every=4)
    got = TP.solve_plate_transient(tp, 0.5 / want_w1, 40, device=CPU, **kw)
    want = JP.solve_plate_transient(jp, 0.5 / want_w1, 40, **kw)
    for key in ("times", "displacements", "velocities"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    om = np.linspace(0.5, 2.0, 5) * w1
    got = TP.plate_harmonic(tp, om, damping=(0.02 * w1, 1e-5), device=CPU)
    want = JP.plate_harmonic(jp, om, damping=(0.02 * w1, 1e-5))
    for key in ("amplitude", "real", "imag"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL


@pytest.mark.parametrize("method", ["guyan", "craig_bampton"])
def test_reduction_matches_jax(plate, method):
    """reduce_model's plate branch and the reduction document
    (Craig-Bampton's modal columns sign-aligned), and _family_modal."""
    tp, jp = plate
    masters = [30, 45, 60]
    got = t_red.reduce_model(tp, masters, method=method, n_modes=3,
                             device=CPU)
    want = j_red.reduce_model(jp, masters, method=method, n_modes=3)
    sign = np.ones(got.k_red.shape[0])
    if method == "craig_bampton":
        sign[3:] = np.sign(np.sum(got.t[:, 3:] * want.t[:, 3:], axis=0))
    for a, b in ((got.k_red, want.k_red), (got.m_red, want.m_red)):
        assert rel_err(sign[:, None] * a * sign[None, :], b) <= F64_RTOL
    an = {"type": "reduction", "method": method, "master_nodes": [10, 20]}
    out_t = t_io.run_plate_analysis(tp, an, CPU)
    out_j = j_io.run_plate_analysis(jp, an)
    for key in ("reduced_omegas", "full_omegas"):
        assert rel_err(out_t[key], out_j[key]) <= F64_RTOL, key
    # Ratios of nearly equal frequencies: held absolutely.
    assert np.abs(np.subtract(out_t["frequency_rel_errors"],
                              out_j["frequency_rel_errors"])).max() \
        <= F64_RTOL
    om, _ = t_common._family_modal(tp, 3, CPU)
    assert rel_err(om, JP.plate_modal(jp, 3).omegas) <= F64_RTOL


def test_closed_forms_and_the_fem():
    """mindlin_navier_w and mindlin_ss_buckling_nx equal the JAX package's,
    and the 16 x 16 MITC4 plate lands within 2e-3 of the Navier centre
    deflection at t = 0.01 (tests/test_plate.py's anchor)."""
    args = (1.0, 0.8, 0.4, 0.3, Q, E, NU, 0.02)
    assert TP.mindlin_navier_w(*args) == JP.mindlin_navier_w(*args)
    args = (1.0, 0.8, E, NU, 0.03)
    assert TP.mindlin_ss_buckling_nx(*args) == \
        JP.mindlin_ss_buckling_nx(*args)
    tp, _ = ss_square(0.01, 16)
    w = TP.solve_plate_static(tp, device=CPU).displacements[0::3].min()
    w_ex = TP.mindlin_navier_w(1.0, 1.0, 0.5, 0.5, Q, E, NU, 0.01)
    assert abs(w - w_ex) <= 2e-3 * abs(w_ex)
    nodes, _ = TP.rect_mesh(1.0, 1.0, 3, 3)
    for edges, kind in ((["left", "top"], "simply_supported"),
                        ("right", "clamped"), ("bottom", "free")):
        assert np.array_equal(TP.plate_supports(nodes, edges, kind),
                              JP.plate_supports(nodes, edges, kind))


def test_buckling_matches_the_mindlin_closed_form():
    """The port's 12 x 12 simply supported square under uniaxial
    compression within 1e-2 of the exact Mindlin critical load."""
    tp, _ = ss_square(0.05, 12)
    lam = TP.plate_buckling(tp, [-1.0, 0.0, 0.0], n_modes=1,
                            device=CPU).load_factors[0]
    exact = TP.mindlin_ss_buckling_nx(1.0, 1.0, E, NU, 0.05)
    assert abs(lam - exact) <= 1e-2 * exact


def test_banded_statics_matches_jax_and_float64():
    """solve_plate_static_banded on the 16 x 16 square at t = 0.01: the
    layout (33 diagonals, bandwidth 3 nx + 8 = 56), u against the dense
    float64 solve (the port within BANDED_DENSE_RTOL, the JAX package
    within its own 4e-3), the moments, and the reactions within 4e-3 (a
    float32 matvec less f: measured 1.5e-3).  The Jacobi count of the t =
    0.05 square within +-2 of the JAX recurrence on the port's float32
    diagonals at tol 1e-5 (at t = 0.01 the float32 recurrences of both
    take ~510 iterations there, the float64 one 165: fault 3.31)."""
    tp, jp = ss_square(0.01, 16)
    layout = TP.plate_dia_layout(tp)
    assert (layout.n_diags, layout.bandwidth) == (33, 56)
    dense = JP.solve_plate_static(jp)
    got, iters, rel = TP.solve_plate_static_banded(tp, tol=1e-9, device=CPU)
    want, _, _ = JP.solve_plate_static_banded(jp, tol=1e-9)
    assert rel <= 1e-9
    assert rel_err(got.displacements, dense.displacements) \
        <= BANDED_DENSE_RTOL
    assert rel_err(want.displacements, dense.displacements) \
        <= JAX_BANDED_DENSE_RTOL
    assert rel_err(got.moments, dense.moments) <= BANDED_DENSE_RTOL
    assert rel_err(got.reactions, dense.reactions) <= JAX_BANDED_DENSE_RTOL
    tp, jp = ss_square(0.05, 16)
    diags = t_dia.assemble_dia_blocks(
        TP.plate_dia_layout(tp), TP._stiffness_blocks(tp, CPU)).float()
    f = TP._pressure_vectors(tp).float()
    _, iters5, _ = TP.solve_plate_static_banded(tp, tol=1e-5, device=CPU)
    jl = j_dia.dia_layout(jp.dof_map(), jp.ndof)
    _, j_iters, _ = j_dia.dia_cg_solve(
        jl, jnp.asarray(diags.numpy()), jnp.asarray(f.numpy()),
        jnp.asarray(jp.free_mask(), jnp.float32), tol=1e-5,
        max_iter=50000, components=3)
    assert abs(iters5 - int(j_iters)) <= 2


def test_thin_plate_float32_count_fault():
    """ROADMAP fault 3.31: on the 16 x 16 square at t = 0.01 the float32
    Jacobi recurrence stalls past tolerance 1e-4 (the w / rotation scales
    differ by (a/t)^2) and takes about three times the float64 count to
    reach 1e-5, in the port (the twins) and in the JAX recurrence on the
    same float32 diagonals alike; u stays within BANDED_DENSE_RTOL of
    the dense float64 solve."""
    tp, jp = ss_square(0.01, 16)
    layout = TP.plate_dia_layout(tp)
    diags = t_dia.assemble_dia_blocks(layout,
                                      TP._stiffness_blocks(tp, CPU))
    f = TP._pressure_vectors(tp)
    mask = torch.as_tensor(tp.free_mask())
    _, it64, _ = t_dia.dia_cg_solve_reference(layout, diags, f, mask,
                                              1e-5, 50000)
    res, it32, _ = TP.solve_plate_static_banded(tp, tol=1e-5, device=CPU)
    jl = j_dia.dia_layout(jp.dof_map(), jp.ndof)
    _, j_it, _ = j_dia.dia_cg_solve(
        jl, jnp.asarray(diags.float().numpy()),
        jnp.asarray(f.float().numpy()),
        jnp.asarray(jp.free_mask(), jnp.float32), tol=1e-5,
        max_iter=50000, components=3)
    assert it32 > 2 * int(it64) and int(j_it) > 2 * int(it64)
    dense = JP.solve_plate_static(jp).displacements
    assert rel_err(res.displacements, dense) <= BANDED_DENSE_RTOL


def test_banded_refusals():
    tp, _ = ss_square(0.05, 2)
    with pytest.raises(NotImplementedError, match="item 15"):
        TP.solve_plate_static_banded(tp, mesh=object(), device=CPU)


def mirror_plate():
    """tests/test_plate_plastic.py's host / device mirror: a 2 x 1 plate
    clamped on the left under pressure, a load / unload history."""
    nodes, el = JP.rect_mesh(2.0, 1.0, 2, 1)
    kw = dict(nodes=nodes, elements=el, young=200.0, poisson=0.3,
              thickness=0.5, density=1.0, loads=np.zeros(3 * len(nodes)),
              fixed_dofs=JP.plate_supports(nodes, "left", "clamped"),
              pressure=0.6)
    return both(**kw), dict(sigma_y=1.0, hardening_iso=20.0,
                            hardening_kin=5.0, n_layers=4,
                            load_factors=[0.6, 1.0, 0.2])


PLASTIC_KEYS = ("displacements", "moments", "von_mises", "eq_plastic")


def test_plastic_host_tier_matches_jax():
    """The float64 tier on dyn-plate-plastic.json's strip and on the
    mirror plate's load / unload history, against the JAX host tier."""
    doc = json.loads((CORPUS / "dyn-plate-plastic.json").read_text())
    an = doc["analysis"]
    cases = [((t_io.parse_plate_document(doc)[0],
               j_io.parse_plate_document(doc)[0]),
              dict(sigma_y=an["sigma_y"], n_layers=an["n_layers"],
                   load_factors=an["load_factors"])), mirror_plate()]
    for (tp, jp), kw in cases:
        got = t_plastic(tp, host=True, **kw)
        want = j_plastic(jp, host=True, **kw)
        assert got.converged and want.converged
        for key in PLASTIC_KEYS:
            assert rel_err(getattr(got, key), getattr(want, key)) \
                <= F64_RTOL, key
        assert np.array_equal(got.iterations, want.iterations)
        assert np.array_equal(got.n_plastic, want.n_plastic)
        assert got.residuals.max() <= 1e-9


def test_plastic_device_tier_matches_jax():
    """The float32 device tier on the mirror plate against the float64
    host tier at the JAX package's mirror bounds (rtol 2e-4, atol 2e-5;
    eq_plastic rtol 2e-3, atol 2e-7), and against the JAX device tier at
    the same bounds.  Both tiers stop at the float32 floor of the
    tolerance (floored at 1e-5): measured |r|/|f| up to 1.2e-5 in the port
    and 8e-6 in the JAX package, so the converged flag rides on rounding
    (ROADMAP fault 3.22) and the residuals are held to 2e-5 instead."""
    (tp, jp), kw = mirror_plate()
    host = t_plastic(tp, host=True, **kw)
    got = t_plastic(tp, host=False, device=CPU, **kw)
    want = j_plastic(jp, host=False, **kw)
    assert max(got.residuals.max(), want.residuals.max()) <= 2e-5
    for ref in (host, want):
        np.testing.assert_allclose(got.displacements, ref.displacements,
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got.von_mises, ref.von_mises, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(got.eq_plastic, ref.eq_plastic,
                                   rtol=2e-3, atol=2e-7)


def test_plastic_device_tier_fault_in_both_packages(monkeypatch):
    """ROADMAP fault 3.30 on dyn-plate-plastic's strip: over its elastic
    steps (load factors 0.2-0.6) the float32 device tier of either package
    stalls at |r|/|f| 1.4e-3 to 4.4e-3 (measured), far above its 1e-5
    floor, so neither converges, and both lie ~5e-3 from the float64
    tier: step by step the two residuals agree within a factor of two.
    The port's device program run in float64 (PINN_FEM_TPU_X64) converges
    on the whole ramp to the float64 tier, so the floor is the working
    dtype's, not the program's."""
    doc = json.loads((CORPUS / "dyn-plate-plastic.json").read_text())
    an = doc["analysis"]
    tp, jp = (t_io.parse_plate_document(doc)[0],
              j_io.parse_plate_document(doc)[0])
    kw = dict(sigma_y=an["sigma_y"], n_layers=an["n_layers"])
    host = t_plastic(tp, host=True, load_factors=an["load_factors"], **kw)
    elastic = an["load_factors"][:3]
    got = t_plastic(tp, host=False, device=CPU, load_factors=elastic, **kw)
    want = j_plastic(jp, host=False, load_factors=elastic, **kw)
    for res in (got, want):
        assert not res.converged
        assert np.all(res.residuals >= 1e-3) and res.residuals.max() <= 1e-2
        assert 1e-3 <= rel_err(res.displacements, host.displacements[:3]) \
            <= 1e-2
    assert np.all(np.abs(np.log2(got.residuals / want.residuals)) <= 1.0)
    monkeypatch.setenv("PINN_FEM_TPU_X64", "1")
    x64 = t_plastic(tp, host=False, device=CPU,
                    load_factors=an["load_factors"], **kw)
    assert x64.converged and x64.residuals.max() <= 1e-9
    assert rel_err(x64.displacements, host.displacements) <= 1e-9


def test_plastic_guards_match_jax():
    (tp, jp), kw = mirror_plate()
    for bad in (dict(kw, n_layers=3),
                dict(kw, load_factors=[])):
        msgs = []
        for fn, p, extra in ((t_plastic, tp, {"device": CPU}),
                             (j_plastic, jp, {})):
            with pytest.raises(ValueError) as err:
                fn(p, host=True, **bad, **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    tp, jp = skewed(alpha_cte=1e-5, temperature=1.0)
    with pytest.raises(ValueError, match="temperature-gradient"):
        t_plastic(tp, sigma_y=1.0, device=CPU)


def tree_gaps(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        out = {}
        for k in want:
            out.update(tree_gaps(got[k], want[k], f"{path}/{k}"))
        return out
    if isinstance(want, (bool, str)) or want is None:
        assert got == want, path
        return {}
    return {path: rel_err(got, want)}


@pytest.mark.parametrize("name", ["dyn-plate", "dyn-plate-plastic"])
def test_corpus_documents_match_jax(tmp_path, monkeypatch, name):
    """dyn-plate.json (dense statics) and dyn-plate-plastic.json (the
    float64 plastic tier) through both CLIs: exit codes 0, the result JSON
    within F64_RTOL (the thin plate's reactions within THIN_REACTION_RTOL,
    the plastic residual, rounding noise, within 1e-9), the summary lines
    equal.  The square's symmetric elements tie for the
    largest von Mises: the port's pick holds that largest value."""
    doc = json.loads((CORPUS / f"{name}.json").read_text())
    (rc_j, want, log_j), (rc_t, got, log_t) = both_clis(
        tmp_path, monkeypatch, name, doc)
    assert rc_j == rc_t == 0
    if "max_residual" in want:
        assert max(got.pop("max_residual"), want.pop("max_residual")) \
            <= 1e-9
    if "reactions" in want:
        assert rel_err(got.pop("reactions"), want.pop("reactions")) \
            <= THIN_REACTION_RTOL
    worst = {}
    if "max_von_mises_element" in want:
        worst = {"port": got.pop("max_von_mises_element"),
                 "jax": want.pop("max_von_mises_element")}
        assert abs(want["von_mises"][worst["port"]]
                   - want["max_von_mises"]) <= F64_RTOL * want[
                       "max_von_mises"]
    gaps = tree_gaps(got, want)
    assert max(gaps.values()) <= F64_RTOL, gaps
    lines = log_j.splitlines()
    at = next(i for i, ln in enumerate(lines) if "SUMMARY" in ln)
    for ln in lines[at:at + 2]:
        ln = ln.split("] ", 1)[1]
        if worst:
            ln = ln.replace(f"(element {worst['jax']})",
                            f"(element {worst['port']})")
        assert ln in log_t


def test_identification_document_refused(tmp_path, monkeypatch):
    """dyn-plate-identify.json with "banded": false beside its zones: exit
    1 with the JAX package's words, no result.  (The document itself runs
    since ROADMAP item 23: tests/test_torch_identification.py.)"""
    doc = json.loads((CORPUS / "dyn-plate-identify.json").read_text())
    doc["analysis"]["banded"] = False
    path = tmp_path / "dyn-plate-identify.json"
    path.write_text(json.dumps(doc))
    rc, out, log = run_cli(torch_cli, path, monkeypatch, CPU)
    assert rc == 1 and out is None and '"zones" rides the banded tier' in log


def small_doc(**analysis):
    return {"element_type": "plate",
            "mesh": {"type": "rect", "width": 1.0, "height": 0.6, "nx": 5,
                     "ny": 3},
            "material": {"young": 200.0, "poisson": 0.3, "thickness": 0.05,
                         "density": 2.0},
            "pressure": -1.0, "point_masses": [[7, 0.2]],
            "supports": {"clamped": ["left"],
                         "simply_supported": ["right"]},
            "analysis": analysis}


DOCUMENTS = {
    "static": {"type": "static"},
    "plate": {"type": "plate"},
    "modal-membrane": {"type": "modal", "n_modes": 4,
                       "membrane_force": [-5.0, 0.0, 0.0],
                       "include_shapes": True},
    "buckling": {"type": "buckling", "membrane_force": [-1.0, 0.0, 0.0],
                 "n_modes": 2},
    "transient-sine": {"type": "transient", "dt": 0.01, "n_steps": 30,
                       "damping": [0.1, 1e-4], "record_every": 3,
                       "amplitude": {"type": "sine", "omega": 20.0},
                       "probe_nodes": [8, 9]},
    "harmonic": {"type": "harmonic", "damping": [0.1, 1e-4],
                 "omegas": {"start": 1.0, "stop": 40.0, "num": 6},
                 "probe_nodes": [9]},
    "plastic-ramp": {"type": "plastic", "sigma_y": 0.3, "target": 2.0,
                     "n_steps": 4, "n_layers": 4, "hardening": 10.0,
                     "probe_nodes": [9], "include_history": True},
}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_document_analyses_match_jax(name):
    doc = small_doc(**DOCUMENTS[name])
    want = json.loads(json.dumps(j_io.run_plate_document(
        json.loads(json.dumps(doc)))))
    got = json.loads(json.dumps(t_io.run_plate_document(
        json.loads(json.dumps(doc)), CPU)))
    for key in ("mode_shapes", "buckling_modes"):
        if key in want:
            got[key] = aligned(got[key], want[key]).tolist()
    if "max_residual" in want:
        assert max(got.pop("max_residual"), want.pop("max_residual")) \
            <= 1e-9
    gaps = tree_gaps(got, want)
    assert max(gaps.values()) <= F64_RTOL, gaps


def test_banded_document_matches_jax(monkeypatch):
    """Above DENSE_DOF_LIMIT (patched to 128 in both packages) the static
    document takes the banded tier with probes: the centre deflection
    within BANDED_DENSE_RTOL of the dense float64 solve in the port, the
    JAX package's within its 4e-3."""
    from pinn_fem_tpu.solvers import newton as j_newton
    from pinn_fem_tpu_torch.solvers import newton as t_newton

    monkeypatch.setattr(j_newton, "DENSE_DOF_LIMIT", 128)
    monkeypatch.setattr(t_newton, "DENSE_DOF_LIMIT", 128)
    doc = json.loads((CORPUS / "dyn-plate.json").read_text())
    centre = 8 * 17 + 8
    doc["analysis"] = {"type": "static", "tolerance": 1e-9,
                       "probe_nodes": [centre]}
    want = j_io.run_plate_document(json.loads(json.dumps(doc)))
    got = t_io.run_plate_document(json.loads(json.dumps(doc)), CPU)
    assert set(got) == set(want) and got["tier"] == "banded"
    assert got["probe_dofs"] == want["probe_dofs"] == [3 * centre]
    assert got["relative_residual"] <= 1e-9
    tp = t_io.parse_plate_document(doc)[0]
    w = TP.solve_plate_static(tp, device=CPU).displacements[3 * centre]
    assert rel_err(got["displacements"], [w]) <= BANDED_DENSE_RTOL
    assert rel_err(want["displacements"], [w]) <= JAX_BANDED_DENSE_RTOL


REFUSALS = {
    "budget-modal": (dict(mesh={"type": "rect", "width": 1.0, "height": 1.0,
                                "nx": 60, "ny": 60}), {"type": "modal"}),
    "budget-sizing": (dict(mesh={"type": "rect", "width": 1.0,
                                 "height": 1.0, "nx": 60, "ny": 60}),
                      {"type": "sizing"}),
    "budget-reliability": (dict(mesh={"type": "rect", "width": 1.0,
                                      "height": 1.0, "nx": 60, "ny": 60}),
                           {"type": "reliability"}),
    "unknown-type": ({}, {"type": "fatigue"}),
    "buckling-membrane": ({}, {"type": "buckling"}),
    "buckling-tension": ({}, {"type": "buckling",
                              "membrane_force": [1.0, 1.0, 0.0]}),
    "membrane-shape": ({}, {"type": "modal", "membrane_force": [1.0, 2.0]}),
    "harmonic-omegas": ({}, {"type": "harmonic"}),
    "plastic-sigma": ({}, {"type": "plastic"}),
    "amplitude": ({}, {"type": "transient", "dt": 0.1, "n_steps": 3,
                       "amplitude": {"type": "saw"}}),
    "transient-thermal": (dict(thermal={"alpha": 1e-5, "delta_t": 5.0}),
                          {"type": "transient", "dt": 0.1, "n_steps": 3}),
    "thickness": (dict(material={"poisson": 0.3}), {"type": "static"}),
    "mesh-type": (dict(mesh={"type": "disk"}), {"type": "static"}),
    "supports": (dict(supports={"free": ["left"]}), {"type": "static"}),
    "edge": (dict(supports={"clamped": ["middle"]}), {"type": "static"}),
    "support-kind": (dict(supports={"pinned": ["left"]}),
                     {"type": "static"}),
    "quads": (dict(mesh=None, nodes=[[0, 0], [1, 0], [1, 1]],
                   elements=[[0, 1, 2]]), {"type": "static"}),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    """Each refusal with the JAX package's error type and message."""
    extra, analysis = REFUSALS[name]
    doc = dict(small_doc(**analysis), **extra)
    doc = {k: v for k, v in doc.items() if v is not None}
    errs = []
    for run, args in ((j_io.run_plate_document, ()),
                      (t_io.run_plate_document, (CPU,))):
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
            t_io.run_plate_document(small_doc(type=kind), CPU)
        return
    errs = []
    for run, args in ((j_io.run_plate_document, ()),
                      (t_io.run_plate_document, (CPU,))):
        with pytest.raises(ValueError) as err:
            run(small_doc(type=kind), *args)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("call", [
    lambda p: TP.plate_matrices(p),
    lambda p: TP.solve_plate_static(p),
    lambda p: TP.plate_modal(p, 2),
    lambda p: TP.plate_geometric_stiffness(p, [-1.0, 0.0, 0.0]),
    lambda p: TP.plate_buckling(p, [-1.0, 0.0, 0.0]),
    lambda p: TP.solve_plate_transient(p, 0.01, 3),
    lambda p: TP.plate_harmonic(p, [1.0]),
    lambda p: TP.solve_plate_static_banded(p),
    lambda p: t_plastic(p, sigma_y=1.0, n_steps=2),
    lambda p: t_red.reduce_model(p, [30]),
    lambda p: t_io.run_plate_analysis(p, {"type": "static"}),
], ids=["matrices", "static", "modal", "geometric", "buckling",
        "transient", "harmonic", "banded", "plastic", "reduction",
        "document"])
def test_entry_points_default_to_the_card(monkeypatch, plate, call):
    """With no device= a plate entry point runs on "cuda": without a card
    it raises, and nothing falls back to the CPU."""
    tp, _ = plate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        call(tp)
