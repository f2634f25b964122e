"""The port's kernel modules against the JAX package, on the CPU.

Each case gives the same inputs, made with numpy from a seed, to a JAX
function and to its counterpart in pinn_fem_tpu_torch: the kernels' plain
twins (which the port's wrappers run on CPU tensors) against the JAX XLA
functions and the Pallas kernels in interpret mode, the fused PCG
recurrence against both JAX PCG forms, and the material fields and problem
arrays.  The kernels themselves run on the card only: see
tests/test_torch_cuda.py and chip_smoke.py.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
import pinn_fem_tpu_torch as T  # noqa: E402
from pinn_fem_tpu.ops.cg import stiffness_coefficients as j_coeffs  # noqa: E402
from pinn_fem_tpu.ops.dia import assemble_dia as j_assemble_dia  # noqa: E402
from pinn_fem_tpu.ops.dia import dia_cg_solve as j_dia_cg_solve  # noqa: E402
from pinn_fem_tpu.ops.dia import dia_layout as j_dia_layout  # noqa: E402
from pinn_fem_tpu.ops.dia import dia_matvec as j_dia_matvec  # noqa: E402
from pinn_fem_tpu_torch.examples_grid import grid_arrays  # noqa: E402
from pinn_fem_tpu_torch.ops import kernels  # noqa: E402
from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as tdia  # noqa: E402
from pinn_fem_tpu_torch.ops.dia import (  # noqa: E402
    assemble_dia,
    dia_cg_solve,
    dia_layout,
)
from pinn_fem_tpu_torch.ops.kernels import _build, cg_kernel, dia_kernel  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, as its own
    tests do (tests/test_pallas_cg.py)."""
    import pinn_fem_tpu.ops.pallas.cg_kernel as ck
    import pinn_fem_tpu.ops.pallas.dia_kernel as dk

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(dk.pl, "pallas_call", patched)
    return dk, ck


def chain_arrays(n):
    nodes = np.stack([np.arange(n, dtype=float), np.zeros(n)], 1)
    elements = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loads = np.zeros(2 * n)
    loads[-2] = 1.0
    fixed = np.concatenate([[0], np.arange(1, 2 * n, 2)])  # x of node 0 + all y
    return nodes, elements, loads, fixed


MESHES = {
    "chain777": lambda: chain_arrays(777),
    "chain3000": lambda: chain_arrays(3000),
    "grid16x72": lambda: grid_arrays(16, 72),
}


def both_systems(mesh, young=2.0, area=0.5):
    """(JAX data, layout, diags) and (port data, layout, diags) of a mesh."""
    nodes, elements, loads, fixed = MESHES[mesh]()
    jp = J.TrussProblem(nodes, elements,
                        J.Material(young=young, area=area, density=1.0),
                        loads, fixed, 2)
    jd = jp.to_device(use_native=False)
    jl = j_dia_layout(np.asarray(jd.dof_map), jp.ndof)
    jdiags = j_assemble_dia(jl, j_coeffs(jd, jp.material, 1.0), jd.gvec)
    tp = T.TrussProblem(nodes, elements,
                        T.Material(young=young, area=area, density=1.0),
                        loads, fixed, 2)
    td = tp.to_device(CPU)
    tl = dia_layout(td.dof_map.numpy(), tp.ndof)
    tdiags = assemble_dia(tl, stiffness_coefficients(td, tp.material, 1.0),
                          td.gvec)
    return (jd, jl, jdiags), (td, tl, tdiags)


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("mesh", ["chain777", "chain3000", "grid16x72"])
def test_stencil_twin_matches_jax(interpret_pallas, mesh):
    dk, _ = interpret_pallas
    (jd, jl, jdiags), (td, tl, tdiags) = both_systems(mesh)
    # Same layout, same assembled diagonals (the scatter order may differ).
    np.testing.assert_array_equal(tl.offsets, jl.offsets)
    np.testing.assert_array_equal(tl.entry_slot, jl.entry_slot)
    assert tl.entry_slot.dtype == np.int64
    np.testing.assert_allclose(tdiags.numpy(), np.asarray(jdiags), rtol=1e-6,
                               atol=0)
    if mesh == "grid16x72":
        # 2,304 DOFs, 21 diagonals, bandwidth 147 (the JAX package's layout).
        assert (tl.ndof, tl.n_diags, tl.bandwidth) == (2304, 21, 147)

    u = np.random.default_rng(0).normal(size=tl.ndof).astype(np.float32)
    d = np.asarray(jdiags)
    before = kernels.launch_counts()
    y = kernels.dia_matvec(tl, t32(d), t32(u)).numpy()  # CPU: the twin
    assert kernels.launch_counts() == before
    # XLA may contract multiply-add into FMA, hence not bit-exact.
    y_xla = np.asarray(j_dia_matvec(jl, jnp.asarray(d), jnp.asarray(u)))
    y_pallas = np.asarray(dk.dia_matvec_pallas(jl, jnp.asarray(d),
                                               jnp.asarray(u)))
    scale = np.abs(y_xla).max()
    np.testing.assert_allclose(y, y_xla, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(y, y_pallas, rtol=0, atol=1e-6 * scale)


def wide_band_layout(ndof=100_000, step=1290):
    """A layout at dia_layout's widest: 63 diagonals (offsets 0 and
    +-step * j, j = 1..31), a band of about 40,000 rows, far wider than a
    block's shared memory holds."""
    dof_map = np.array([[0, step * j] for j in range(1, 32)], np.int64)
    return dia_layout(dof_map, ndof)


def emulate_stencil(plan, layout, diags, u):
    """stencil_kernel of csrc/dia_cg.cu, block by block in numpy: the
    staged window with its zero fill, the shifted int32 offsets, the rows
    of each tile; asserts that every window read lies inside the window."""
    n = layout.ndof
    shift = plan.halo_lo if plan.staged else 0
    offsets = (layout.offsets + shift).astype(np.int32)
    y = np.empty(n, np.float32)
    for b in range(plan.blocks):
        t0 = b * plan.tile
        rows = np.arange(t0, min(t0 + plan.tile, n))
        acc = np.zeros(rows.size, np.float32)
        if plan.staged:
            g = np.arange(t0 - plan.halo_lo, t0 - plan.halo_lo + plan.window)
            win = np.where((g >= 0) & (g < n), u[np.clip(g, 0, n - 1)],
                           np.float32(0))
        for k, o in enumerate(offsets):
            if plan.staged:
                idx = rows - t0 + o
                assert idx.min() >= 0 and idx.max() < plan.window
                uv = win[idx]
            else:
                j = rows + o
                uv = np.where((j >= 0) & (j < n), u[np.clip(j, 0, n - 1)],
                              np.float32(0))
            acc = acc + diags[k, rows] * uv
        y[rows] = acc
    return y


def grid_layout(rows, cols):
    from pinn_fem_tpu_torch.examples_grid import grid_problem

    p = grid_problem(rows, cols)
    return dia_layout(p.to_device(CPU).dof_map.numpy(), p.ndof)


STENCIL_LAYOUTS = {
    "chain3000": lambda: both_systems("chain3000")[1][1],
    "grid24x48": lambda: grid_layout(24, 48),
    "grid100x200": lambda: grid_layout(100, 200),
    "wide_band": wide_band_layout,
}


@pytest.mark.parametrize("name", sorted(STENCIL_LAYOUTS))
def test_stencil_plan(name):
    """Each plan's halo covers the offsets, its shared memory fits a block,
    its grid fills the card where the rows allow; the staged window and
    the wide path, emulated block by block, give the twin's bits."""
    layout = STENCIL_LAYOUTS[name]()
    plan = dia_kernel.stencil_plan(layout)
    assert plan.halo_lo >= -int(layout.offsets.min())
    assert plan.halo_hi >= int(layout.offsets.max())
    assert plan.halo_lo % 4 == 0 and plan.halo_hi % 4 == 0
    assert plan.shared_bytes <= 232_448
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.tile % (dia_kernel.ROWS_PER_THREAD * plan.threads) == 0
    assert plan.staged == (name != "wide_band")
    if plan.staged:
        assert plan.window == plan.tile + plan.halo_lo + plan.halo_hi
    if layout.ndof >= 4 * 32 * dia_kernel.SMS:
        assert plan.blocks >= dia_kernel.SMS
    if name == "grid100x200":  # the Newton path's 40k grid: 157 tiles of 256
        assert (layout.bandwidth, plan.threads, plan.tile, plan.blocks) == (
            403, 64, 256, 157)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(layout.n_diags, layout.ndof)).astype(np.float32)
    u = rng.normal(size=layout.ndof).astype(np.float32)
    want = dia_kernel.dia_matvec_reference(layout, t32(d), t32(u)).numpy()
    np.testing.assert_array_equal(emulate_stencil(plan, layout, d, u), want)


def packed_operands(jl, jdiags):
    from pinn_fem_tpu.ops.pallas.dia_kernel import pack_dia_interleaved

    packed = pack_dia_interleaved(jl, jdiags)
    return packed, tuple(int(o) for o in jl.offsets)


@pytest.mark.parametrize("mesh", ["chain3000", "grid16x72"])
def test_dir_matvec_twin_matches_jax(interpret_pallas, mesh):
    _, ck = interpret_pallas
    (jd, jl, jdiags), (td, tl, tdiags) = both_systems(mesh)
    rng = np.random.default_rng(1)
    z, p = (rng.normal(size=tl.ndof).astype(np.float32) for _ in range(2))
    mask = np.asarray(jd.free_mask)
    beta = np.float32(0.37)
    d = np.asarray(jdiags)

    packed, offsets = packed_operands(jl, jdiags)
    n = packed.n_rows
    pn2, ap2, parts = ck._dir_matvec(
        beta, ck.pack_vec(jnp.asarray(z), n), ck.pack_vec(jnp.asarray(p), n),
        packed.data, ck.pack_vec(jnp.asarray(mask), n), offsets, n,
        packed.halo_rows, packed.rows)
    j_pn = np.asarray(ck.unpack_vec(pn2, tl.ndof))
    j_ap = np.asarray(ck.unpack_vec(ap2, tl.ndof))

    before = kernels.launch_counts()
    pn, ap, t_parts = kernels.dia_dir_matvec(
        torch.tensor(beta), t32(z), t32(p), tl, t32(d), t32(mask))
    assert kernels.launch_counts() == before
    assert t_parts.shape == (cg_kernel.n_direction_partials(tl),)
    np.testing.assert_allclose(pn.numpy(), j_pn, rtol=0,
                               atol=1e-6 * np.abs(j_pn).max())
    np.testing.assert_allclose(ap.numpy(), j_ap, rtol=0,
                               atol=1e-6 * np.abs(j_ap).max())
    # Partial sums are per block on both sides, with other block sizes:
    # compare the totals.
    np.testing.assert_allclose(float(t_parts.sum()), float(jnp.sum(parts)),
                               rtol=1e-5)


@pytest.mark.parametrize("mesh", ["chain3000", "grid16x72"])
def test_update_twin_matches_jax(interpret_pallas, mesh):
    """The update twin against JAX's `_update` in interpret mode followed
    by the scalar recurrence of its while_loop body (alpha from the summed
    direction partials, rz, rn2 and beta from the summed update
    partials)."""
    _, ck = interpret_pallas
    (jd, jl, jdiags), (td, tl, tdiags) = both_systems(mesh)
    rng = np.random.default_rng(2)
    x, r, p, ap = (rng.normal(size=tl.ndof).astype(np.float32)
                   for _ in range(4))
    inv_diag = rng.uniform(0.1, 1.0, size=tl.ndof).astype(np.float32)
    nb2 = cg_kernel.n_direction_partials(tl)
    pap_parts = rng.uniform(0.5, 1.5, size=nb2).astype(np.float32)
    rz = np.float32(np.dot(r, inv_diag * r))
    rn2 = np.float32(np.dot(r, r))

    packed, _ = packed_operands(jl, jdiags)
    n = packed.n_rows
    pk = lambda v: ck.pack_vec(jnp.asarray(v), n)  # noqa: E731
    alpha = rz / jnp.sum(jnp.asarray(pap_parts))
    x2, r2, z2, red = ck._update(alpha, pk(x), pk(r), pk(p), pk(ap),
                                 pk(inv_diag), n, packed.rows)
    rz_j = float(jnp.sum(red[:, 0]))
    rn2_j = float(jnp.sum(red[:, 1]))

    tx, tr, tz = t32(x), t32(r), torch.empty(tl.ndof)
    state = cg_kernel.new_state(torch.tensor(rz), torch.tensor(rn2),
                                torch.tensor(1e-9), max_iter=100)
    before = kernels.launch_counts()
    t_parts = kernels.cg_update(t32(pap_parts), tx, tr, t32(p), t32(ap),
                                t32(inv_diag), tz, state, 100)
    assert kernels.launch_counts() == before
    assert t_parts.shape == (cg_kernel.UPDATE_BLOCKS, 2)
    for got, want in ((tx, x2), (tr, r2), (tz, z2)):
        want = np.asarray(ck.unpack_vec(want, tl.ndof))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    f, i, stop, ticket = cg_kernel.state_views(state)
    np.testing.assert_allclose(f[1:3].numpy(), [rz_j, rn2_j], rtol=1e-5)
    np.testing.assert_allclose(float(f[0]), rz_j / float(rz), rtol=1e-5)
    assert i.tolist() == [1, 1] and not bool(stop) and int(ticket) == 0


def epilogue_case(case, n=1000):
    """Hand-made operands of one update step that hit one guard of the
    epilogue: (pap_parts, x, r, p, ap, inv_diag, z, state, max_iter)."""
    g = torch.Generator().manual_seed(7)
    x, r, p, ap = (torch.randn(n, generator=g) for _ in range(4))
    inv_diag = torch.rand(n, generator=g) + 0.1
    pap = torch.rand(-(-n // cg_kernel.THREADS), generator=g) + 0.5
    rz, it, max_iter = torch.tensor(3.0), 0, 100
    if case == "pap_zero":
        pap.zero_()
    elif case == "rz_zero":
        rz = torch.tensor(0.0)
    elif case == "rz_new_negative":
        inv_diag = -inv_diag
    elif case == "rz_new_not_finite":
        inv_diag[5] = float("inf")
    elif case == "max_iter":
        it, max_iter = 36, 37
    state = cg_kernel.new_state(rz, torch.tensor(2.0), torch.tensor(1e-9),
                                max_iter)
    f, i, stop, _ = cg_kernel.state_views(state)
    i[0] = it
    if case == "rz_zero":  # a live state with rz = 0 (never reached in PCG)
        i[1], stop[0] = 1, False
    return pap, x, r, p, ap, inv_diag, torch.empty(n), state, max_iter


@pytest.mark.parametrize("case", ["live", "pap_zero", "rz_zero",
                                  "rz_new_negative", "rz_new_not_finite",
                                  "max_iter"])
def test_update_epilogue_guards(case):
    """The guards of the update's epilogue on hand-made partials: alpha and
    beta divide by 1e-30 where pAp or the old rz is 0; the loop stops on a
    non-positive or non-finite r.z and when `it` reaches max_iter (37, not
    a multiple of CHECK_EVERY); a stopped state changes nothing."""
    pap, x, r, p, ap, inv_diag, z, state, max_iter = epilogue_case(case)
    x0, r0, rz0 = x.clone(), r.clone(), cg_kernel.state_views(state)[0][1]
    rz0 = float(rz0)
    pap_sum = cg_kernel.fixed_sum(pap)
    alpha = torch.tensor(rz0) / (pap_sum if float(pap_sum) != 0
                                 else torch.tensor(1e-30))
    kernels.cg_update(pap, x, r, p, ap, inv_diag, z, state, max_iter)
    f, i, stop, ticket = cg_kernel.state_views(state)
    assert torch.equal(x, x0 + alpha * p) and torch.equal(r, r0 - alpha * ap)
    assert torch.equal(z, inv_diag * r)
    rz_new = float(f[1])
    assert rz_new == float(cg_kernel.fixed_sum(cg_kernel.update_partials(
        r.double() * z.double())).float())
    exact = float(r.double() @ z.double())
    if abs(exact) < 3e38:  # representable in float32: rounded once
        np.testing.assert_allclose(rz_new, exact, rtol=1e-6)
    want_beta = torch.tensor(rz_new) / torch.tensor(rz0 if rz0 else 1e-30)
    assert float(f[0]) == float(want_beta)
    live = {"live": True, "pap_zero": False, "rz_zero": True,
            "rz_new_negative": False, "rz_new_not_finite": False,
            "max_iter": False}[case]
    assert int(i[0]) == (37 if case == "max_iter" else 1)
    assert bool(i[1]) == live and bool(stop) == (not live)
    assert int(ticket) == 0
    # Stopped: a further update writes nothing, state included.
    if not live:
        frozen = [t.clone() for t in (x, r, z, state)]
        kernels.cg_update(pap, x, r, p, ap, inv_diag, z, state, max_iter)
        assert all(torch.equal(a, b) for a, b in zip(frozen, (x, r, z, state)))


def test_update_partition_and_trees():
    """thread_sums follows the kernel's grid-stride partition (chunks of
    four rows, UPDATE_BLOCKS x THREADS threads); the trees sum what they
    are given."""
    g, t = cg_kernel.UPDATE_BLOCKS, cg_kernel.THREADS
    n = 4 * g * t * 2 + 6                  # two strides and a ragged end
    v = torch.zeros(n)
    # row -> (block, thread): chunk c = row // 4 = b * t + th + j * g * t
    for row, (b, th) in ((4 * (3 * t + 5) + 2, (3, 5)),
                         (4 * (g * t + 7) + 1, (0, 7)),
                         (n - 1, (0, 1))):
        v.zero_()
        v[row] = 1.0
        sums = cg_kernel.thread_sums(v)
        assert float(sums[b, th]) == 1.0 and float(sums.sum()) == 1.0
    w = torch.as_tensor(np.random.default_rng(3).normal(size=700),
                        dtype=torch.float32)
    np.testing.assert_allclose(float(cg_kernel.fixed_sum(w)), float(w.sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(
        cg_kernel.block_tree(w[:512].reshape(2, t)).numpy(),
        [w[:256].sum(), w[256:512].sum()], rtol=1e-5)


def test_pcg_makes_two_operation_calls_per_iteration():
    """One PCG iteration is one direction call and one update call, with
    no other operation between them (on the card: two launches); the
    steps are bound once per solve, for each of the two p buffers."""
    _, (td, tl, tdiags) = both_systems("chain777")
    calls = []

    def counted(name, bind):
        def counting_bind(*args, **kwargs):
            calls.append("bind")
            launch, out = bind(*args, **kwargs)

            def counting_launch():
                calls.append(name)
                return launch()
            return counting_launch, out
        return counting_bind

    x, it, _ = cg_kernel._pcg(
        dia_kernel.dia_matvec_reference,
        counted("dir", cg_kernel.bind_dir_matvec),
        counted("update", cg_kernel.bind_cg_update),
        tl, tdiags, td.loads, td.free_mask, 1e-6, 5000, None)
    rounds = -(-int(it) // cg_kernel.CHECK_EVERY) * cg_kernel.CHECK_EVERY
    assert int(it) > 0
    assert calls == ["bind"] * 4 + ["dir", "update"] * rounds
    x_ref, it_ref, _ = kernels.fused_cg_solve_reference(
        tl, tdiags, td.loads, td.free_mask, tol=1e-6, max_iter=5000)
    assert int(it_ref) == int(it) and torch.equal(x_ref, x)


@pytest.mark.parametrize("mesh,tol", [("chain777", 1e-6), ("grid16x72", 1e-5)])
def test_fused_cg_twins_match_jax(interpret_pallas, mesh, tol):
    """Equal iteration counts with both JAX PCG forms and with the port's
    plain recurrence; x within float32 reduction-order rounding; fixed DOFs
    exactly zero (tests/test_pallas_cg.py:75-89).  tol is one float32 can
    reach on each mesh: at an unreachable one every solver stops at its
    own breakdown point."""
    _, ck = interpret_pallas
    (jd, jl, jdiags), (td, tl, tdiags) = both_systems(mesh)
    d, b, m = (np.asarray(a) for a in (jdiags, jd.loads, jd.free_mask))

    x_xla, it_xla, _ = j_dia_cg_solve(jl, jdiags, jd.loads, jd.free_mask,
                                      tol=tol, max_iter=5000)
    x_pal, it_pal, _ = ck.fused_cg_solve(jl, jdiags, jd.loads, jd.free_mask,
                                         tol=tol, max_iter=5000)
    x, it, res = kernels.fused_cg_solve(tl, t32(d), t32(b), t32(m), tol=tol,
                                        max_iter=5000)
    x_plain, it_plain, _ = dia_cg_solve(tl, t32(d), t32(b), t32(m), tol=tol,
                                        max_iter=5000)
    assert int(it) == int(it_xla) == int(it_pal) == int(it_plain)
    assert float(res) <= tol
    scale = float(np.abs(np.asarray(x_xla)).max())
    for other in (x_xla, x_pal, x_plain):
        np.testing.assert_allclose(x.numpy(), np.asarray(other), rtol=0,
                                   atol=1e-5 * scale)
    assert float(torch.max(torch.abs(x * td.fixed_mask))) == 0.0
    # On the CPU the kernel path is its twin recurrence, bit for bit.
    x_ref, it_ref, _ = kernels.fused_cg_solve_reference(
        tl, t32(d), t32(b), t32(m), tol=tol, max_iter=5000)
    assert int(it_ref) == int(it) and torch.equal(x_ref, x)


def test_fused_cg_warm_start():
    """A warm start at the solution takes no iteration
    (tests/test_pallas_cg.py:115-124)."""
    _, (td, tl, tdiags) = both_systems("chain777")
    x_ref, _, _ = dia_cg_solve(tl, tdiags, td.loads, td.free_mask, tol=1e-6,
                               max_iter=5000)
    x, it, _ = kernels.fused_cg_solve(tl, tdiags, td.loads, td.free_mask,
                                      tol=1e-6, max_iter=5000, x0=x_ref)
    assert int(it) == 0
    assert torch.equal(x, x_ref)


def test_fused_cg_stop_flag_freezes_state(monkeypatch):
    """Past the stop test the kernels' twins leave x, r, z and the state
    untouched, so checking the flag only every CHECK_EVERY iterations
    changes nothing: 37 iterations (not a multiple of 32) equal those of a
    loop that reads the flag after every iteration."""
    _, (td, tl, tdiags) = both_systems("chain777")
    x_a, it_a, res_a = kernels.fused_cg_solve(tl, tdiags, td.loads,
                                              td.free_mask, tol=1e-6,
                                              max_iter=37)
    assert int(it_a) == 37 and 37 % cg_kernel.CHECK_EVERY != 0
    monkeypatch.setattr(cg_kernel, "CHECK_EVERY", 1)
    x_b, it_b, res_b = kernels.fused_cg_solve(tl, tdiags, td.loads,
                                              td.free_mask, tol=1e-6,
                                              max_iter=37)
    assert int(it_b) == 37
    assert torch.equal(x_a, x_b) and torch.equal(res_a, res_b)
    x = torch.zeros(tl.ndof)
    r, z = x + 1.0, x + 2.0
    state = cg_kernel.new_state(torch.tensor(1.0), torch.tensor(1.0),
                                torch.tensor(0.0), max_iter=0)
    assert bool(cg_kernel.state_views(state)[2])
    before = state.clone()
    kernels.cg_update(torch.ones(4), x, r, r, r, r, z, state, 0)
    assert torch.equal(x, torch.zeros(tl.ndof))
    assert torch.equal(r, torch.ones(tl.ndof))
    assert torch.equal(z, torch.full((tl.ndof,), 2.0))
    assert torch.equal(state, before)


def test_launch_structs_mirror_the_c_layouts():
    """DirectionArgs (128 bytes, the plan's ints ahead of ndof) and
    UpdateArgs (104 bytes), each with the stream last, as csrc/dia_cg.cu's
    static_assert holds its structs."""
    import ctypes

    for struct, size in ((cg_kernel.DirectionArgs, 128),
                         (cg_kernel.UpdateArgs, 104)):
        assert ctypes.sizeof(struct) == size
        assert struct.stream.offset == size - 8
    assert cg_kernel.DirectionArgs.ndof.offset == 32
    assert "sizeof(DirectionArgs) == 128 && sizeof(UpdateArgs) == 104" in (
        _build.CSRC / "dia_cg.cu").read_text()


def test_block_sums_follow_the_kernel_tree():
    """direction_partials follows the direction kernel's partition: thread
    t of block b owns rows b * tile + R t + j R T + e; each block's
    partial is the sum of its tile's rows."""
    plan = dia_kernel.DirectionPlan(threads=64, tile=256, halo_lo=0,
                                    halo_hi=0, window=256, staged=True,
                                    n_diags=1, ndof=700, rows=2)
    assert plan.blocks == 3
    v = torch.as_tensor(np.random.default_rng(3).normal(size=700),
                        dtype=torch.float32)
    parts = cg_kernel.direction_partials(v, plan)
    assert parts.shape == (3,)
    np.testing.assert_allclose(parts.numpy(),
                               [v[:256].sum(), v[256:512].sum(),
                                v[512:].sum()], rtol=1e-5)
    # Rows 2 t + e (pass 0) and 128 + 2 t + e (pass 1) of a block are
    # thread t's: with ones on thread 5's rows of block 1 only, its sum
    # is 4, whatever the tree.
    one_thread = torch.zeros(700)
    for row in (256 + 10, 256 + 11, 256 + 138, 256 + 139):
        one_thread[row] = 1.0
    assert cg_kernel.direction_partials(one_thread, plan).tolist() == [
        0.0, 4.0, 0.0]


def shuffle_tree(v):
    """The kernels' block_tree, step by step as the card runs it: lane l
    adds lane l + s of its warp (its own value where l + s passes the
    warp), s = 16..1; then warp 0 does the same over the warps' sums
    (lanes past the last warp hold 0).  v: (T,) -> float32."""
    def warp(x):
        lane = np.arange(32)
        for s in (16, 8, 4, 2, 1):
            x = x + np.where(lane + s < 32, x[np.minimum(lane + s, 31)], x)
        return x[0]

    sums = np.array([warp(w) for w in v.reshape(-1, 32)], np.float32)
    nw = sums.size
    x = np.zeros(32, np.float32)
    x[:nw] = sums
    lane, s = np.arange(32), nw // 2
    while s:
        x = x + np.where(lane + s < 32, x[np.minimum(lane + s, 31)], x)
        s //= 2
    return x[0]


def emulate_direction(plan, layout, diags, z, p, beta, mask):
    """dia_dir_matvec_kernel of csrc/dia_cg.cu, block by block in numpy:
    the staged z and p windows, p_new formed once per window element (zero
    outside [0, ndof)), the shifted int32 offsets, R rows a thread; the
    unstaged path rebuilds p_new at each neighbour.  Each thread sums its
    own rows' p_new * ap in row order, then shuffle_tree.  Asserts that
    every window read lies inside the window."""
    n, t, r = layout.ndof, plan.threads, plan.rows
    offsets = layout.offsets + (plan.halo_lo if plan.staged else 0)
    offsets = offsets.astype(np.int32)
    p_new = np.empty(n, np.float32)
    ap = np.empty(n, np.float32)
    partials = np.empty(plan.blocks, np.float32)

    def form(g):
        inside = (g >= 0) & (g < n)
        gc = np.clip(g, 0, n - 1)
        return np.where(inside, z[gc] + beta * p[gc], np.float32(0))

    for b in range(plan.blocks):
        t0 = b * plan.tile
        li = np.arange(plan.tile)
        rows = t0 + li
        valid = rows < n
        rv = np.clip(rows, 0, n - 1)
        if plan.staged:
            win = form(np.arange(t0 - plan.halo_lo,
                                 t0 - plan.halo_lo + plan.window))
            pn = win[plan.halo_lo + li]
        else:
            pn = form(rows)
        acc = np.zeros(plan.tile, np.float32)
        for k, o in enumerate(offsets):
            if plan.staged:
                idx = li + o
                assert idx.min() >= 0 and idx.max() < plan.window
                uv = win[idx]
            else:
                uv = form(rows + o)
            acc = acc + np.where(valid, diags[k, rv], np.float32(0)) * uv
        apb = acc * np.where(valid, mask[rv], np.float32(0))
        p_new[rows[valid]] = pn[valid]
        ap[rows[valid]] = apb[valid]
        sums = np.zeros(t, np.float32)
        for th in range(t):
            for j in range(plan.tile // (r * t)):
                for e in range(r):
                    row = r * th + j * r * t + e
                    if valid[row]:
                        sums[th] = sums[th] + pn[row] * apb[row]
        partials[b] = shuffle_tree(sums)
    return p_new, ap, partials


def chain_2m_layout():
    """The 2,000,002-DOF chain's layout (chip_smoke.py's 2M PCG cell):
    offsets -3..3, as a chain of any length has them."""
    from pinn_fem_tpu_torch.ops.dia import DiaLayout

    offs = np.arange(-3, 4, dtype=np.int64)
    return DiaLayout(offsets=offs, entry_slot=np.zeros((0, 4, 4), np.int64),
                     ndof=2_000_002, bandwidth=3)


DIRECTION_PLANS = {  # (threads, rows, tile, blocks, staged)
    "grid100x200": (grid_layout, (100, 200), (128, 1, 128, 313, True)),
    "chain_2M": (chain_2m_layout, (), (128, 4, 512, 3907, True)),
    "wide_band": (wide_band_layout, (1_000_001,),
                  (128, 4, 512, 1954, False)),
}


@pytest.mark.parametrize("name", sorted(DIRECTION_PLANS))
def test_direction_plan_is_pinned(name):
    """direction_plan's partition at the shapes chip_smoke.py measures:
    the 40k Newton grid takes 313 blocks of 128 threads, one row a thread
    (about 9.5 warps an SM; four rows a thread would leave 2.4), the 2M
    chain four rows a thread, and the 63-diagonal band the unstaged
    path."""
    make, args, want = DIRECTION_PLANS[name]
    layout = make(*args)
    plan = dia_kernel.direction_plan(layout)
    assert (plan.threads, plan.rows, plan.tile, plan.blocks,
            plan.staged) == want
    assert plan.shared_bytes <= dia_kernel.SHARED_BYTES or not plan.staged
    warps_per_sm = plan.blocks * plan.threads / 32 / dia_kernel.SMS
    assert warps_per_sm >= dia_kernel.DIRECTION_MIN_WARPS
    if name == "chain_2M":
        assert np.array_equal(
            both_systems("chain3000")[1][1].offsets, layout.offsets)


def forced_plan(layout, rows, threads, passes, staged):
    """The layout's halos under another partition."""
    plan = dia_kernel.direction_plan(layout)
    tile = rows * threads * passes
    return dia_kernel.DirectionPlan(
        threads=threads, tile=tile, halo_lo=plan.halo_lo,
        halo_hi=plan.halo_hi,
        window=tile + plan.halo_lo + plan.halo_hi if staged else 0,
        staged=staged, n_diags=layout.n_diags, ndof=layout.ndof, rows=rows)


DIRECTION_CASES = {
    "chain3000": lambda: both_systems("chain3000")[1][1],
    "grid24x48": lambda: grid_layout(24, 48),
    "wide_band": lambda: wide_band_layout(ndof=20_003, step=500),
}


@pytest.mark.parametrize("form", [(1, 32, 1), (1, 64, 2), (2, 32, 1),
                                  (2, 64, 2), (4, 32, 1), (4, 32, 3)])
@pytest.mark.parametrize("name", sorted(DIRECTION_CASES))
def test_direction_kernel_emulation(name, form):
    """The direction kernel, emulated block by block in each rows-a-thread
    form (rows, threads, passes), on the staged and the unstaged path:
    p_new and ap bit for bit equal to dir_matvec_reference, the partials
    to direction_partials under the same plan; on the layout's own plan,
    the whole twin.  Ragged ends: 4,608 and 6,000 DOFs are no multiple of
    the tiles, and 20,003 of 4."""
    layout = DIRECTION_CASES[name]()
    rng = np.random.default_rng(6)
    n, nd = layout.ndof, layout.n_diags
    d = rng.normal(size=(nd, n)).astype(np.float32)
    z, p, mask = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    mask = (mask > -0.5).astype(np.float32)
    beta = np.float32(0.37)
    want = cg_kernel.dir_matvec_reference(torch.tensor(beta), t32(z), t32(p),
                                          layout, t32(d), t32(mask))
    staged_fits = dia_kernel.direction_plan(layout).staged
    assert staged_fits == (name != "wide_band")
    for staged in ((True, False) if staged_fits else (False,)):
        plan = forced_plan(layout, *form, staged)
        assert plan.shared_bytes <= dia_kernel.SHARED_BYTES or not staged
        got = emulate_direction(plan, layout, d, z, p, beta, mask)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        np.testing.assert_array_equal(
            got[2], cg_kernel.direction_partials(want[0] * want[1],
                                                 plan).numpy())
    plan = dia_kernel.direction_plan(layout)
    got = emulate_direction(plan, layout, d, z, p, beta, mask)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def jax_mlp_leaves(field):
    return {"layers": [(np.asarray(w), np.asarray(b)) for w, b in field.layers],
            "scale": np.asarray(field.scale), "input_dim": field.input_dim,
            "enforce_positive": field.enforce_positive}


@pytest.mark.parametrize("hidden,input_dim", [(1, 1), (2, 1), (1, 3), (2, 3)])
def test_material_from_numpy_matches_jax(hidden, input_dim):
    import jax

    from pinn_fem_tpu.models.fields import assembly_inputs as j_inputs
    from pinn_fem_tpu_torch.models.fields import assembly_inputs

    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    young = J.make_mlp_field(keys[0], hidden_layers=hidden,
                             neurons_per_layer=12, input_dim=input_dim,
                             scale=3.0)
    area = J.make_mlp_field(keys[1], hidden_layers=hidden,
                            neurons_per_layer=8, input_dim=input_dim,
                            scale=0.5)
    jmat = J.Material(young=young, area=area, density=1.0)
    tmat = T.material_from_numpy(jax_mlp_leaves(young), jax_mlp_leaves(area),
                                 1.0)

    nodes, elements, loads, fixed = grid_arrays(4, 6)
    jp = J.TrussProblem(nodes, elements, jmat, loads, fixed, 2)
    tp = T.TrussProblem(nodes, elements, tmat, loads, fixed, 2)
    jd = jp.to_device(use_native=False)
    td = tp.to_device(CPU)
    for name in ("gvec", "inv_len", "mid", "loads", "free_mask",
                 "fixed_mask"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), name)
    np.testing.assert_array_equal(td.dof_map.numpy(), np.asarray(jd.dof_map))
    assert td.dof_map.dtype == torch.int64 and td.gather_map is None

    lf = 0.6
    xj = j_inputs(jd.mid, 2, jnp.asarray(lf, jnp.float32))
    xt = assembly_inputs(td.mid, 2, lf)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    for name in ("young", "area"):
        np.testing.assert_allclose(
            getattr(tmat, name).eval_batch(xt).numpy(),
            np.asarray(getattr(jmat, name).eval_batch(xj)), rtol=1e-6)
    np.testing.assert_allclose(stiffness_coefficients(td, tmat, lf).numpy(),
                               np.asarray(j_coeffs(jd, jmat, lf)), rtol=1e-6)


def test_make_mlp_field_init_contract():
    g = torch.Generator().manual_seed(0)
    f = T.make_mlp_field(g, hidden_layers=2, neurons_per_layer=10,
                         input_dim=3, scale=2.0)
    shapes = [(tuple(w.shape), tuple(b.shape)) for w, b in f.layers]
    assert shapes == [((3, 10), (10,)), ((10, 10), (10,)), ((10, 1), (1,))]
    w0, b0 = f.layers[0]
    assert float(w0.abs().max()) <= 1 / np.sqrt(3)
    assert float(b0.abs().max()) <= 1 / np.sqrt(3)
    assert torch.all(f.layers[-1][0] == 0.1) and torch.all(f.layers[-1][1] == 1)
    g2 = torch.Generator().manual_seed(0)
    again = T.make_mlp_field(g2, hidden_layers=2, neurons_per_layer=10,
                             input_dim=3, scale=2.0)
    assert all(torch.equal(a, b) for la, lb in zip(f.layers, again.layers)
               for a, b in zip(la, lb))


def test_kernel_operand_checks():
    v = torch.zeros(8)
    with pytest.raises(TypeError, match="float32"):
        dia_kernel.check_operands(8, vectors=(v.double(),))
    with pytest.raises(ValueError, match="vectors"):
        dia_kernel.check_operands(8, vectors=(torch.zeros(7),))
    with pytest.raises(ValueError, match="contiguous"):
        dia_kernel.check_operands(8, vectors=(torch.zeros(16)[::2],))
    with pytest.raises(ValueError, match="diagonals"):
        dia_kernel.check_operands(8, vectors=(v,), diags=torch.zeros(3, 7),
                                  nd=3)
    # Neither CPU nor CUDA: no twin, no kernel.
    _, (td, tl, tdiags) = both_systems("chain777")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.dia_matvec(tl, tdiags.to("meta"), td.loads.to("meta"))


def test_ops_dia_matvec_is_the_kernel_wrapper():
    """ops.dia.dia_matvec, the name the JAX package's callers import, is the
    dispatching wrapper: the twin on CPU tensors, no twin elsewhere."""
    assert tdia.dia_matvec is kernels.dia_matvec
    _, (td, tl, tdiags) = both_systems("chain777")
    u = torch.as_tensor(np.random.default_rng(4).normal(size=tl.ndof),
                        dtype=torch.float32)
    assert torch.equal(tdia.dia_matvec(tl, tdiags, u),
                       tdia.dia_matvec_reference(tl, tdiags, u))
    with pytest.raises(ValueError, match="no kernel"):
        tdia.dia_matvec(tl, tdiags.to("meta"), u.to("meta"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ops_dia_cg_solve_dispatch(monkeypatch, device):
    """CPU tensors run the plain recurrence; any other device goes to the
    fused kernel entry point, never to the plain recurrence."""
    _, (td, tl, tdiags) = both_systems("chain777")
    seen = []
    monkeypatch.setattr(kernels, "fused_cg_solve",
                        lambda *a, **k: seen.append("fused") or "fused")
    monkeypatch.setattr(tdia, "dia_cg_solve_reference",
                        lambda *a, **k: seen.append("plain") or "plain")
    args = [t.to(device) for t in (tdiags, td.loads, td.free_mask)]
    out = dia_cg_solve(tl, *args, tol=1e-6, max_iter=10)
    assert seen == [out] == (["plain"] if device == "cpu" else ["fused"])


@pytest.mark.parametrize("where", ["checkout", "installed", "edited"])
def test_kernel_build_dir(monkeypatch, tmp_path, where):
    """A source checkout builds into its build/ directory; an installed
    package into the user's cache, never beside the interpreter.  Every
    csrc/*.cu goes into the one library, whose name changes when any of
    them is edited."""
    repo = Path(__file__).resolve().parents[1]
    if where == "checkout":
        assert _build.build_dir() == repo / "build" / "pinn_fem_tpu_torch"
        assert [s.name for s in _build.sources()] == ["dia_cg.cu",
                                                      "material.cu"]
        return
    if where == "edited":
        import shutil

        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        names = {_build.library_path().name}
        for src in _build.sources():
            src.write_text(src.read_text() + "\n// edited\n")
            names.add(_build.library_path().name)
        assert len(names) == 1 + len(_build.sources())
        return
    site = tmp_path / "lib" / "site-packages"
    fake = site / "pinn_fem_tpu_torch" / "ops" / "kernels" / "_build.py"
    monkeypatch.setattr(_build, "__file__", str(fake))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == tmp_path / "cache" / "pinn_fem_tpu_torch"
    assert _build.library_path().parent == _build.build_dir()
