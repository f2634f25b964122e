"""The port's banded multigrid (pinn_fem_tpu_torch/ops/mg.py), its
multigrid-preconditioned PCG and Newton, against the JAX package's
(pinn_fem_tpu/ops/mg.py), on the CPU.

Each case gives both packages the same numpy inputs, made from a seed or
assembled once by the JAX package.  On the same input the port's
hierarchy equals the JAX package's bit for bit on the grids measured here
(both add in the same order); each bound below stands beside its measured
gap (tests/measure_torch_agreement.py mg).  The JAX hierarchy of the
20 x 40 grid is built once for the module (an eager JAX build takes about
13 s).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
from pinn_fem_tpu.ops import dia as j_dia  # noqa: E402
from pinn_fem_tpu.ops import mg as j_mg  # noqa: E402
from pinn_fem_tpu.ops.cg import stiffness_coefficients as j_coeffs  # noqa: E402
from pinn_fem_tpu.solvers import newton as j_newton  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as t_dia  # noqa: E402
from pinn_fem_tpu_torch.ops import mg as t_mg  # noqa: E402
from pinn_fem_tpu_torch.solvers import newton as t_newton  # noqa: E402

# Building blocks on random bands: offsets exact, values within 1e-6 of
# the largest entry (measured: 0, the same adds in the same order).
BLOCK_RTOL = 1e-6
# Level operators within 1e-5 of the level's largest entry (measured 0 on
# the grid and the chain); the coarsest Cholesky factor within 1e-4 of its
# largest entry (measured 3.0e-7 on the grid, 0 on the chain).
LEVEL_RTOL = 1e-5
CHOL_RTOL = 1e-4
# One V-cycle on a seeded rhs within 1e-5 of the largest entry (measured
# 1.2e-6 on the grid: the Cholesky factor's and solve's rounding).
CYCLE_RTOL = 1e-5
# The MG-PCG on the 20 x 40 grid at tol 1e-6: iterations within one of
# JAX's (10 in both), x within 1e-4 of max |x| (measured 2.5e-5: the dots'
# summation orders differ, amplified by the operator's condition).
PCG_RTOL = 1e-4
# solve_nr(cg_precond="mg") on the 16 x 32 grid, each package assembling
# its own operator: u within 1e-4 of max |u|.
NEWTON_RTOL = 1e-4

OFFSETS = (-6, -5, -1, 0, 1, 5, 6)
N = 24


def random_dia(rng, symmetric=False, spd_shift=0.0):
    """A (7, 24) float32 band with zeros outside the matrix (as
    tests/test_mg.py builds it)."""
    d = np.zeros((len(OFFSETS), N), np.float32)
    for k, o in enumerate(OFFSETS):
        lo, hi = max(0, -o), min(N, N - o)
        d[k, lo:hi] = rng.normal(size=hi - lo)
    if symmetric:
        for k, o in enumerate(OFFSETS):
            if o > 0:
                ki = OFFSETS.index(-o)
                d[ki, o:] = d[k, :N - o]
        k0 = OFFSETS.index(0)
        d[k0] = np.abs(d[k0]) + spd_shift
    return d


def assert_dia_close(got_offsets, got, want_offsets, want, rtol):
    assert tuple(got_offsets) == tuple(want_offsets)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=rtol * np.abs(want).max(), rtol=0)


def test_dia_mul_matches_jax():
    rng = np.random.default_rng(0)
    da, db = random_dia(rng), random_dia(rng)
    want = j_mg.dia_mul(OFFSETS, jnp.asarray(da), OFFSETS, jnp.asarray(db), N)
    got = t_mg.dia_mul(OFFSETS, torch.as_tensor(da), OFFSETS,
                       torch.as_tensor(db), N)
    assert_dia_close(*got, *want, BLOCK_RTOL)


@pytest.mark.parametrize("components", [1, 2])
def test_coarsen_matches_jax(components):
    rng = np.random.default_rng(1)
    d = random_dia(rng)
    off_j, d_j, n_j = j_mg.coarsen(OFFSETS, jnp.asarray(d), N,
                                   components=components)
    off_t, d_t, n_t = t_mg.coarsen(OFFSETS, torch.as_tensor(d), N,
                                   components=components)
    assert n_t == n_j
    assert_dia_close(off_t, d_t, off_j, d_j, BLOCK_RTOL)


def test_smoothed_operator_matches_jax():
    rng = np.random.default_rng(2)
    d = random_dia(rng, symmetric=True, spd_shift=5.0)
    want = j_mg.smoothed_operator(OFFSETS, jnp.asarray(d), N)
    got = t_mg.smoothed_operator(OFFSETS, torch.as_tensor(d), N)
    assert_dia_close(*got, *want, BLOCK_RTOL)


def test_mask_dia_matches_jax():
    rng = np.random.default_rng(3)
    d = random_dia(rng)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    want = j_mg.mask_dia(OFFSETS, jnp.asarray(d), jnp.asarray(mask))
    got = t_mg.mask_dia(OFFSETS, torch.as_tensor(d), torch.as_tensor(mask))
    assert_dia_close(OFFSETS, got, OFFSETS, want, BLOCK_RTOL)
    # Fixed rows are identity rows.
    fixed = mask == 0
    assert np.all(got.numpy()[OFFSETS.index(0), fixed] == 1.0)


def grid_problems(rows, cols):
    nodes, elements, loads, fixed = eg.grid_arrays(rows, cols)
    kw = dict(nodes=nodes, elements=elements, loads=loads, fixed_dofs=fixed,
              dimension=2)
    return (jp.TrussProblem(material=jp.Material(young=1.0, area=1.0,
                                                 density=1.0), **kw),
            tp.TrussProblem(material=tp.Material(young=1.0, area=1.0,
                                                 density=1.0), **kw))


def chain_operator(n_nodes=45, seed=4):
    """A 1D bar chain of `n_nodes` nodes (an odd count, so aggregation pads
    two levels), node 0 fixed, seeded positive stiffnesses: (offsets,
    float32 diagonals, free mask)."""
    k = np.random.default_rng(seed).uniform(0.5, 2.0, n_nodes - 1)
    d = np.zeros((3, n_nodes))
    d[1, :-1] += k
    d[1, 1:] += k
    d[0, 1:] = -k
    d[2, :-1] = -k
    mask = np.ones(n_nodes, np.float32)
    mask[0] = 0.0
    return (-1, 0, 1), d.astype(np.float32), mask


def make_operators():
    """The same inputs for both packages: the 20 x 40 grid's operator as
    the JAX package assembles it (1,600 DOFs; components 2, 3 levels: two
    smoothed, the coarsest 400 DOFs / 361 diagonals) and the 45-node chain
    (components 1, coarsest 4: 45, 23, 12, 6, 3 DOFs: two smoothed levels,
    two plain ones, two padded coarsenings)."""
    jprob, _ = grid_problems(20, 40)
    data = jprob.to_device()
    j_layout = j_dia.dia_layout(np.asarray(data.dof_map), jprob.ndof)
    diags = np.asarray(j_dia.assemble_dia(
        j_layout, j_coeffs(data, jprob.material, 1.0), data.gvec))
    t_layout = t_dia.dia_layout(np.asarray(data.dof_map), jprob.ndof)
    grid = dict(j_layout=j_layout, t_layout=t_layout, diags=diags,
                mask=np.asarray(data.free_mask), loads=np.asarray(data.loads),
                components=2, coarsest=512)

    offsets, d, mask = chain_operator()
    lay = dict(offsets=np.asarray(offsets, np.int64), entry_slot=None,
               ndof=d.shape[1], bandwidth=1)
    chain = dict(j_layout=j_dia.DiaLayout(**lay),
                 t_layout=t_dia.DiaLayout(**lay), diags=d, mask=mask,
                 components=1, coarsest=4)
    return {"grid20x40": grid, "chain45": chain}


@pytest.fixture(scope="module")
def operators():
    return make_operators()


def t_args(op, *names):
    return tuple(torch.from_numpy(op[n].copy()) for n in names)


def jax_grid_solve(operators):
    """The JAX package's dia_cg_solve(precond="mg") on the grid (tol 1e-6,
    components 2) and the hierarchy it built (its build runs eagerly, so it
    is read on the way; one JAX build for the module)."""
    op = operators["grid20x40"]
    built = []

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    build = j_mg.build_hierarchy
    j_mg.build_hierarchy = spy
    try:
        out = j_dia.dia_cg_solve(
            op["j_layout"], jnp.asarray(op["diags"]), jnp.asarray(op["loads"]),
            jnp.asarray(op["mask"]), tol=1e-6, max_iter=20000, precond="mg",
            components=2)
    finally:
        j_mg.build_hierarchy = build
    assert len(built) == 1
    return built[0], out


@pytest.fixture(scope="module")
def jax_grid_pcg(operators):
    return jax_grid_solve(operators)


def make_hierarchies(operators, jax_grid_pcg):
    """(JAX, port) hierarchy of each operator."""
    op = operators["chain45"]
    chain_j = j_mg.build_hierarchy(op["j_layout"], jnp.asarray(op["diags"]),
                                   jnp.asarray(op["mask"]), coarsest=4,
                                   components=1)
    out = {"grid20x40": jax_grid_pcg[0], "chain45": chain_j}
    for name, op in operators.items():
        out[name] = (out[name], t_mg.build_hierarchy(
            op["t_layout"], *t_args(op, "diags", "mask"),
            coarsest=op["coarsest"], components=op["components"]))
    return out


@pytest.fixture(scope="module")
def hierarchies(operators, jax_grid_pcg):
    return make_hierarchies(operators, jax_grid_pcg)


@pytest.mark.parametrize("name", ["grid20x40", "chain45"])
def test_build_hierarchy_matches_jax(hierarchies, name):
    jh, th = hierarchies[name]
    assert len(th.levels) == len(jh.levels)
    assert th.components == jh.components and th.smooth == jh.smooth
    for jl, tl in zip(jh.levels, th.levels):
        assert (tl.offsets, tl.ndof, tl.smoothed) == (
            tuple(jl.offsets), jl.ndof, jl.smoothed)
        assert_dia_close(tl.offsets, tl.diags, jl.offsets, jl.diags,
                         LEVEL_RTOL)
        np.testing.assert_allclose(tl.inv_diag.numpy(),
                                   np.asarray(jl.inv_diag), rtol=LEVEL_RTOL)
        assert tl.layout.ndof == tl.ndof
        assert tuple(tl.layout.offsets.tolist()) == tl.offsets
    smoothed = [lvl.smoothed for lvl in th.levels]
    if name == "chain45":
        # Smoothed, plain non-coarsest and padded levels all occur.
        assert smoothed[:2] == [True, True] and not any(smoothed[2:])
        assert [lvl.ndof for lvl in th.levels] == [45, 23, 12, 6, 3]
    else:
        assert [lvl.ndof for lvl in th.levels] == [1600, 800, 400]
        assert [len(lvl.offsets) for lvl in th.levels] == [21, 77, 361]
    want = np.tril(np.asarray(jh.chol))
    np.testing.assert_allclose(th.chol.numpy(), want,
                               atol=CHOL_RTOL * np.abs(want).max(), rtol=0)


def test_v_cycle_matches_jax(hierarchies):
    jh, th = hierarchies["grid20x40"]
    b = np.random.default_rng(5).normal(size=th.levels[0].ndof)
    b = b.astype(np.float32)
    want = np.asarray(j_mg.v_cycle(jh, jnp.asarray(b)))
    got = t_mg.v_cycle(th, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=CYCLE_RTOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", ["grid20x40", "chain45"])
def test_v_cycle_level_matvecs(hierarchies, name, monkeypatch):
    """A cycle runs 2 level matvecs a non-coarsest level and 2 more a
    smoothed one, all through dia_matvec; the plain cycle is the same
    function (on the CPU both run the twin)."""
    th = hierarchies[name][1]
    b = torch.from_numpy(np.random.default_rng(6).normal(
        size=th.levels[0].ndof).astype(np.float32))
    got = t_mg.v_cycle(th, b)
    assert torch.equal(t_mg.v_cycle_reference(th, b), got)
    assert bool(torch.isfinite(got).all())
    calls = []
    orig = t_mg.dia_matvec
    monkeypatch.setattr(t_mg, "dia_matvec",
                        lambda *a: calls.append(a[0].ndof) or orig(*a))
    t_mg.v_cycle(th, b)
    assert len(calls) == t_mg.cycle_matvecs(th) == (
        2 * (len(th.levels) - 1)
        + 2 * sum(lvl.smoothed for lvl in th.levels[:-1]))
    assert set(calls) == {lvl.ndof for lvl in th.levels[:-1]}


def test_level_layouts_are_made_once(operators):
    """A second build of the same operator reuses every level's layout, so
    kernel 1's plan and device offsets, cached on the layout, are made
    once."""
    op = operators["grid20x40"]
    args = (op["t_layout"], *t_args(op, "diags", "mask"))
    first = t_mg.build_hierarchy(*args, components=2)
    second = t_mg.build_hierarchy(*args, components=2)
    assert all(a.layout is b.layout
               for a, b in zip(first.levels, second.levels))
    assert all(lvl.layout.entry_slot is None for lvl in first.levels)
    with pytest.raises(ValueError, match="scatter map"):
        first.levels[0].layout.entry_slot_on("cpu")


def test_mg_pcg_matches_jax(operators, jax_grid_pcg):
    op = operators["grid20x40"]
    x_j, it_j, _ = jax_grid_pcg[1]
    args = (op["t_layout"], *t_args(op, "diags", "loads", "mask"))
    kw = dict(tol=1e-6, max_iter=20000, components=2)
    x_t, it_t, res_t = t_dia.dia_cg_solve(*args, precond="mg", **kw)
    _, it_jac, _ = t_dia.dia_cg_solve(*args, precond="jacobi", **kw)
    assert abs(int(it_t) - int(it_j)) <= 1, (int(it_t), int(it_j))
    assert float(res_t) <= 1e-6
    x_j = np.asarray(x_j)
    np.testing.assert_allclose(x_t.numpy(), x_j,
                               atol=PCG_RTOL * np.abs(x_j).max(), rtol=0)
    # JAX's own gate (tests/test_mg.py): an order of magnitude fewer
    # iterations than Jacobi.
    assert int(it_t) * 8 < int(it_jac), (int(it_t), int(it_jac))
    # Fixed DOFs stay zero.
    assert np.all(x_t.numpy()[op["mask"] == 0] == 0.0)


def test_mg_newton_matches_jax():
    """solve_nr(cg_precond="mg") on the 16 x 32 grid in both packages, at
    tol 1e-5 (JAX's tests/test_mg.py setting) and 1e-4.  At 1e-5 both stop
    at their float32 floors (ROADMAP fault 3.5): the JAX package reaches
    9.8e-6 after 2 Newton iterations, the port stalls at 1.28e-5 and stops
    after 4 (the step that fails to lower the residual counts); the port
    run on JAX-assembled diagonals stalls at 1.24e-5 too, so the floor is
    the float32 K u of the residual, not the operator or the multigrid.
    There converged and u are compared; the counts are compared at 1e-4,
    above both floors."""
    for tol in (1e-5, 1e-4):
        jprob, tprob = grid_problems(16, 32)
        kw = dict(linear_solver="cg-dia", cg_precond="mg")
        want = j_newton.solve_nr(jprob, jp.SolverConfig(max_iterations=20,
                                                        tolerance=tol), 1.0,
                                 **kw)
        got = t_newton.solve_nr(tprob, tp.SolverConfig(max_iterations=20,
                                                       tolerance=tol), 1.0,
                                device="cpu", **kw)
        assert got.converged == want.converged is True
        if tol == 1e-4:
            assert (got.history[0]["iterations"]
                    == want.history[0]["iterations"])
        u_j = np.asarray(want.displacements)
        np.testing.assert_allclose(got.displacements, u_j,
                                   atol=NEWTON_RTOL * np.abs(u_j).max(),
                                   rtol=0)


def test_mg_newton_counts_its_pcg_solves(monkeypatch):
    """Each banded Newton iteration runs one MG-PCG solve through
    dia_cg_solve with the problem's dimension as components, and the Jacobi
    default keeps the fused PCG."""
    calls = []
    solve = t_dia.dia_cg_solve

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return solve(*args, **kwargs)

    monkeypatch.setattr(t_dia, "dia_cg_solve", spy)
    _, tprob = grid_problems(8, 16)
    res = t_newton.solve_nr(tprob, linear_solver="cg-dia", cg_precond="mg",
                            device="cpu")
    assert res.converged and len(calls) == res.history[0]["iterations"]
    assert all(c["precond"] == "mg" and c["components"] == 2 for c in calls)
    calls.clear()
    t_newton.solve_nr(tprob, linear_solver="cg-dia", device="cpu")
    assert not calls


def test_mg_float64_on_cpu(monkeypatch):
    """PINN_FEM_TPU_X64=1: the multigrid Newton runs in float64 on the CPU
    and lands on the float64 sparse solution."""
    monkeypatch.setenv("PINN_FEM_TPU_X64", "1")
    nodes, elements, loads, fixed = eg.grid_arrays(16, 32)
    _, tprob = grid_problems(16, 32)
    data = tprob.to_device("cpu")
    assert data.loads.dtype == torch.float64
    res = t_newton.solve_nr(tprob, data=data, linear_solver="cg-dia",
                            cg_precond="mg")
    assert res.converged
    u_ref = eg.float64_solution(nodes, elements, loads, fixed)
    u = res.displacements.reshape(-1)
    assert np.abs(u - u_ref).max() <= 1e-5 * np.abs(u_ref).max()
