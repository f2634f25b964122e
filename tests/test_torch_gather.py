"""The port's gather-based PCG (meshes without a banded layout) and its
RCM mesh ordering against the JAX package, on the CPU.

Meshes are the cross-braced grid documents of
pinn_fem_tpu_torch/examples_grid.py with their nodes renumbered by a seeded
random permutation (`shuffled_document`, as tests/test_reorder.py shuffles
its grid): the same mesh, whose numbering gives no banded layout.  Each
case gives the same inputs to both packages.  The bounds are the gaps that
`tests/measure_torch_agreement.py gather` prints, times the margin stated
beside each.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.ops import cg as j_cg  # noqa: E402
from pinn_fem_tpu.ops import reorder as j_reorder  # noqa: E402
from pinn_fem_tpu.ops import scatter as j_scatter  # noqa: E402
from pinn_fem_tpu.solvers import newton as j_newton  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops import cg as t_cg  # noqa: E402
from pinn_fem_tpu_torch.ops import reorder as t_reorder  # noqa: E402
from pinn_fem_tpu_torch.ops import scatter as t_scatter  # noqa: E402
from pinn_fem_tpu_torch.solvers import newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch.utils import native  # noqa: E402

# segment_sum_dofs: the port sums each DOF's terms in float64 and rounds
# once (ROADMAP fault 3.4), the JAX package sums them in float32 in the
# map's order.  Measured gap on 60 random meshes (1D-3D): up to 1.3e-7 of
# the largest sum, about one float32 ulp; bound 1e-6 (margin 7).
SEGMENT_RTOL = 1e-6
# K u and diag(K) on the shuffled 10 x 16 grid: measured 9.2e-8 / 7.1e-8
# of the largest entry; bound 1e-6 (margin 11).
OPERATOR_RTOL = 1e-6
# The PCG solution on that grid (101 iterations in both packages):
# measured 1.4e-6 of max |x|; bound 1e-5 (margin 7).
PCG_RTOL = 1e-5
# solve_nr(linear_solver="cg") on the shuffled 12 x 24 grid, port vs JAX
# (the same Newton counts: 2, 2, 4): measured up to 3.0e-7 of max |u|
# (plain, thermal, settlement) and 5.0e-7 of max |reaction|; bound 5e-6
# (margin 10).
NEWTON_RTOL = 5e-6
# The shuffled 24 x 48 document through both CLIs: the port against
# float64 (scipy) at the 1e-4 that tests/test_torch_slice.py holds the
# banded grid to (measured 8.7e-8; the RCM-reordered banded solve of the
# shuffled grid 4.6e-6), the port against JAX's u at 1e-5 (measured
# 1.6e-7, margin 64).  At tol 1e-5 the Newton counts ride on rounding
# (ROADMAP fault 3.5: JAX 6, the port 5 there), so they are not compared.
GRID_F64_RTOL = 1e-4
GRID_JAX_RTOL = 1e-5


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def shuffled(rows, cols, kind="plain", seed=0, **config):
    """A shuffled grid document: plain, thermal or settlement."""
    make = {"plain": eg.grid_document, "thermal": eg.thermal_grid_document,
            "settlement": eg.settlement_grid_document}[kind]
    return eg.shuffled_document(make(rows, cols, **config), seed=seed)[0]


def parsed_both(doc):
    return j_parse(doc), parse_problem_dict(doc)


def dof_map_of(elements, dim):
    el = np.asarray(elements, dtype=np.int64)
    return np.concatenate([dim * el[:, k:k + 1] + c for k in (0, 1)
                           for c in range(dim)], axis=1)


def random_mesh(dim, seed, nnode=80, extra=150):
    """A chain plus random bracing (valences 1 to ~10)."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(nnode - 1), np.arange(1, nnode)], 1)
    a = rng.integers(0, nnode, extra)
    b = (a + rng.integers(1, 9, extra)) % nnode
    return np.concatenate([chain, np.stack([a, b], 1)]), nnode * dim


# --- ops/scatter.py ---------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_gather_map_bit_equal_to_jax(dim):
    elements, ndof = random_mesh(dim, seed=dim)
    dof_map = dof_map_of(elements, dim)
    got = t_scatter.build_gather_map(dof_map, ndof)
    want = j_scatter.build_gather_map(dof_map, ndof)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(dim)
    fe = rng.standard_normal(dof_map.shape).astype(np.float32)
    ours = t_scatter.segment_sum_dofs(torch.from_numpy(fe),
                                      torch.from_numpy(got)).numpy()
    exact = np.zeros(ndof)
    np.add.at(exact, dof_map.reshape(-1), fe.reshape(-1).astype(float))
    np.testing.assert_array_equal(ours, exact.astype(np.float32))
    theirs = np.asarray(j_scatter.segment_sum_dofs(
        jnp.asarray(fe), jnp.asarray(want), jnp.asarray(dof_map)))
    assert rel_err(ours, theirs) <= SEGMENT_RTOL


def test_gather_operator_and_pcg_match_jax():
    doc = shuffled(10, 16)
    jpp, tpp = parsed_both(doc)
    jd, td = jpp.problem.to_device(), tpp.problem.to_device("cpu")
    rng = np.random.default_rng(0)
    u = rng.standard_normal(tpp.problem.ndof).astype(np.float32)
    s = rng.uniform(0.5, 2.0, tpp.problem.nelm).astype(np.float32)
    ku_t = t_cg.apply_stiffness(td, torch.from_numpy(s), torch.from_numpy(u))
    ku_j = j_cg.apply_stiffness(jd, jnp.asarray(s), jnp.asarray(u))
    assert rel_err(ku_t, ku_j) <= OPERATOR_RTOL
    d_t = t_cg.stiffness_diagonal(td, torch.from_numpy(s))
    d_j = j_cg.stiffness_diagonal(jd, jnp.asarray(s))
    assert rel_err(d_t, d_j) <= OPERATOR_RTOL
    b = np.asarray(doc["loads"], np.float32)
    x_t, it_t, res_t = t_cg.cg_solve(td, torch.from_numpy(s),
                                     torch.from_numpy(b), tol=1e-6,
                                     max_iter=5000)
    x_j, it_j, res_j = j_cg.cg_solve(jd, jnp.asarray(s), jnp.asarray(b),
                                     tol=1e-6, max_iter=5000)
    assert int(it_t) == int(it_j) > 10
    assert rel_err(x_t, x_j) <= PCG_RTOL
    assert float(res_t) <= 1e-6 and float(res_j) <= 1e-6
    assert np.all(x_t.numpy()[jpp.problem.fixed_dofs] == 0.0)


@pytest.mark.parametrize("case", ["tol", "breakdown", "max_iter", "x0"])
def test_device_flag_loop_equals_plain_loop(case):
    """cg_solve_flagged (the CUDA form: flag on the device, read every
    CHECK_EVERY iterations, state frozen after the stop) gives the plain
    loop's iterations, x and residual bit for bit, run here on the CPU."""
    doc = shuffled(10, 16, seed=1)
    _, tpp = parsed_both(doc)
    data = tpp.problem.to_device("cpu")
    s = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 2.0, tpp.problem.nelm).astype(np.float32))
    b = torch.tensor(doc["loads"], dtype=torch.float32)
    kw = {"tol": {"tol": 1e-6, "max_iter": 5000},
          "breakdown": {"tol": 0.0, "max_iter": 5000},
          "max_iter": {"tol": 1e-6, "max_iter": 45},
          "x0": {"tol": 1e-5, "max_iter": 5000, "x0": b * 0.1}}[case]
    plain = t_cg.cg_solve_reference(data, s, b, **kw)
    flagged = t_cg.cg_solve_flagged(data, s, b, **kw)
    assert int(plain[1]) == int(flagged[1]) > 0
    if case == "max_iter":
        assert int(plain[1]) == 45
    assert torch.equal(plain[0], flagged[0])
    assert torch.equal(plain[2], flagged[2])


# --- solvers/newton.py ------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "thermal", "settlement"])
def test_gather_newton_matches_jax(kind):
    doc = shuffled(12, 24, kind, seed=2)
    jpp, tpp = parsed_both(doc)
    jprob, tprob = jpp.problem, tpp.problem
    assert j_newton._dia_layout_of(jprob, jprob.to_device()) is None
    data = tprob.to_device("cpu")
    assert t_newton._dia_layout_of(tprob, data) is None
    cfg_j = jp.SolverConfig(tolerance=1e-5)
    cfg_t = tp.SolverConfig(tolerance=1e-5)
    r_j = jp.solve_nr(jprob, cfg_j, 1.0, linear_solver="cg",
                      prescribed_u=jpp.prescribed)
    r_t = t_newton.solve_nr(tprob, cfg_t, 1.0, linear_solver="cg",
                            prescribed_u=tpp.prescribed, data=data)
    assert data.gather_map is not None          # the gather path ran
    assert r_t.converged == r_j.converged is True
    assert r_t.history[0]["iterations"] == r_j.history[0]["iterations"]
    assert rel_err(r_t.displacements, r_j.displacements) <= NEWTON_RTOL
    assert rel_err(r_t.reactions, r_j.reactions) <= NEWTON_RTOL
    if kind == "settlement":
        pd = doc["prescribed_displacements"]
        u = r_t.displacements.reshape(-1)
        np.testing.assert_array_equal(u[pd["dofs"]],
                                      np.float32(pd["values"][0]))


def test_shuffled_grid_document_through_both_clis(tmp_path, monkeypatch):
    """A 24 x 48 grid (2,304 DOFs, above the dense limit) renumbered so
    that no banded layout exists: exit 0 in both CLIs, the same
    convergence, u within GRID_JAX_RTOL of JAX's and GRID_F64_RTOL of
    float64."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    doc = shuffled(24, 48, tolerance=1e-5, n_increments=2)
    outs = []
    for tag, cli in (("jax", jax_cli), ("torch", torch_cli)):
        d = tmp_path / tag
        d.mkdir()
        path = d / "shuffled.json"
        path.write_text(json.dumps(doc))
        assert cli.main([str(path)]) == 0
        for lg in (logging.getLogger("pinn_fem_tpu"),
                   logging.getLogger("pinn_fem_tpu_torch")):
            for h in lg.handlers:
                h.flush()
        outs.append(json.loads((d / "shuffled.res.json").read_text()))
    j, t = outs
    assert len(doc["loads"]) == 2304
    assert t["converged"] == j["converged"] is True
    u64 = eg.float64_solution(doc["nodes"], doc["elements"],
                              np.asarray(doc["loads"], float),
                              doc["fixed_dofs"])
    u_t = np.asarray(t["displacements"], float).reshape(-1)
    u_j = np.asarray(j["displacements"], float).reshape(-1)
    assert rel_err(u_t, u64) <= GRID_F64_RTOL
    assert rel_err(u_t, u_j) <= GRID_JAX_RTOL


def test_banded_solve_never_builds_the_gather_map():
    data_problem = eg.grid_problem(4, 8)
    data = data_problem.to_device("cpu")
    res = t_newton.solve_nr(data_problem, linear_solver="cg", data=data)
    assert res.converged and data.gather_map is None


# --- ops/reorder.py and utils/native.py --------------------------------------


def _rcm_cases():
    two_chains = np.array([[0, 1], [1, 2], [3, 4], [4, 5]])
    islands = np.array([[0, 1], [1, 2], [3, 4], [4, 5], [7, 8]])
    grid = shuffled(24, 48, seed=3)
    return {"two-chains": (two_chains, 6),
            "isolated-nodes": (islands, 10),
            "shuffled-8x12": (np.asarray(shuffled(8, 12)["elements"]), 96),
            "shuffled-24x48": (np.asarray(grid["elements"]), 1152),
            "random-bracing": (random_mesh(1, seed=5)[0], 80)}


@pytest.mark.parametrize("case", list(_rcm_cases()))
def test_rcm_orders_bit_identical_to_jax(case):
    elements, nnode = _rcm_cases()[case]
    got = t_reorder.rcm_permutation_numpy(elements, nnode)
    want = j_reorder.rcm_permutation_numpy(elements, nnode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(nnode))
    np.testing.assert_array_equal(t_reorder.rcm_permutation(elements, nnode),
                                  want)


def test_reorder_problem_and_restore_field_match_jax():
    jpp, tpp = parsed_both(shuffled(10, 16, seed=4))
    r_j, o_j = j_reorder.reorder_problem(jpp.problem)
    r_t, o_t = t_reorder.reorder_problem(tpp.problem)
    np.testing.assert_array_equal(o_t, o_j)
    for key in ("nodes", "elements", "loads", "fixed_dofs"):
        np.testing.assert_array_equal(getattr(r_t, key), getattr(r_j, key))
    perm = t_reorder.dof_permutation(o_t, 2)
    np.testing.assert_array_equal(perm, j_reorder.dof_permutation(o_j, 2))
    field = np.random.default_rng(4).standard_normal(perm.size)
    np.testing.assert_array_equal(
        t_reorder.restore_field(field[perm], o_t, 2), field)
    np.testing.assert_array_equal(t_reorder.restore_field(field, o_t, 2),
                                  j_reorder.restore_field(field, o_j, 2))


def test_reordered_solve_matches_original_dense():
    """tests/test_reorder.py's reordered solve, on the port."""
    _, tpp = parsed_both(shuffled(6, 9, seed=5))
    cfg = tp.SolverConfig(tolerance=1e-8)
    ref = t_newton.solve_nr(tpp.problem, cfg, 1.0, linear_solver="dense",
                            device="cpu")
    p2, order = t_reorder.reorder_problem(tpp.problem)
    r2 = t_newton.solve_nr(p2, cfg, 1.0, linear_solver="dense", device="cpu")
    np.testing.assert_allclose(
        t_reorder.restore_field(r2.displacements.reshape(-1), order, 2),
        ref.displacements.reshape(-1), atol=1e-5)
    np.testing.assert_allclose(
        t_reorder.restore_field(r2.reactions.reshape(-1), order, 2),
        ref.reactions.reshape(-1), atol=1e-4)


def test_rcm_puts_a_shuffled_grid_back_on_the_banded_operator():
    """The shuffled 24 x 48 grid has no banded layout; after RCM it has one
    (191 diagonals, inside the 192 budget), the Newton solve takes the
    banded operator (the fused PCG's twins here, kernels 1-3 on a card),
    and its u mapped back equals the gather solve's and float64's."""
    doc = shuffled(24, 48, seed=6)
    _, tpp = parsed_both(doc)
    problem = tpp.problem
    data = problem.to_device("cpu")
    assert t_newton._dia_layout_of(problem, data) is None
    cfg = tp.SolverConfig(tolerance=1e-5)
    gather = t_newton.solve_nr(problem, cfg, 1.0, data=data)
    p2, order = t_reorder.reorder_problem(problem)
    d2 = p2.to_device("cpu")
    layout = t_newton._dia_layout_of(p2, d2)
    assert layout is not None and layout.n_diags <= 192
    banded = t_newton.solve_nr(p2, cfg, 1.0, data=d2)
    assert d2.gather_map is None and banded.converged and gather.converged
    u_b = t_reorder.restore_field(banded.displacements.reshape(-1), order, 2)
    u64 = eg.float64_solution(doc["nodes"], doc["elements"],
                              np.asarray(doc["loads"], float),
                              doc["fixed_dofs"])
    assert rel_err(u_b, u64) <= GRID_F64_RTOL
    assert rel_err(u_b, gather.displacements.reshape(-1)) <= GRID_F64_RTOL


def test_native_library_matches_numpy_when_present():
    """The library is used only where it equals the numpy paths; it is
    never built here (tests/test_native.py builds it in place)."""
    if not native.available():
        pytest.skip("native/libmeshprep.so is not built")
    elements = np.asarray(shuffled(24, 48, seed=7)["elements"])
    np.testing.assert_array_equal(
        native.rcm_order_native(elements, 1152),
        t_reorder.rcm_permutation_numpy(elements, 1152))
    dof_map = dof_map_of(elements, 2)
    np.testing.assert_array_equal(
        native.build_gather_map_native(dof_map, 2304),
        t_scatter.build_gather_map(dof_map, 2304))
