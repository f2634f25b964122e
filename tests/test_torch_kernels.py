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
    assert t_parts.shape == (-(-tl.ndof // cg_kernel.THREADS),)
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
    _, ck = interpret_pallas
    (jd, jl, jdiags), (td, tl, tdiags) = both_systems(mesh)
    rng = np.random.default_rng(2)
    x, r, p, ap = (rng.normal(size=tl.ndof).astype(np.float32)
                   for _ in range(4))
    inv_diag = rng.uniform(0.1, 1.0, size=tl.ndof).astype(np.float32)
    alpha = np.float32(0.21)

    packed, _ = packed_operands(jl, jdiags)
    n = packed.n_rows
    pk = lambda v: ck.pack_vec(jnp.asarray(v), n)  # noqa: E731
    x2, r2, z2, red = ck._update(alpha, pk(x), pk(r), pk(p), pk(ap),
                                 pk(inv_diag), n, packed.rows)

    tx, tr, tz = t32(x), t32(r), torch.empty(tl.ndof)
    before = kernels.launch_counts()
    t_parts = kernels.cg_update(torch.tensor(alpha), tx, tr, t32(p), t32(ap),
                                t32(inv_diag), tz)
    assert kernels.launch_counts() == before
    for got, want in ((tx, x2), (tr, r2), (tz, z2)):
        want = np.asarray(ck.unpack_vec(want, tl.ndof))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(t_parts.sum(0).numpy(),
                               np.asarray(jnp.sum(red, axis=0)), rtol=1e-5)


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


def test_fused_cg_stop_flag_freezes_state():
    """Past the stop test the kernels' twins leave x, r and z untouched, so
    checking the flag only every CHECK_EVERY iterations changes nothing."""
    _, (td, tl, tdiags) = both_systems("chain777")
    x_a, it_a, _ = kernels.fused_cg_solve(tl, tdiags, td.loads, td.free_mask,
                                          tol=1e-6, max_iter=37)
    assert int(it_a) == 37 and 37 % cg_kernel.CHECK_EVERY != 0
    x = torch.zeros(tl.ndof)
    r, z = x + 1.0, x + 2.0
    kernels.cg_update(torch.tensor(0.5), x, r, r, r, r, z,
                      stop=torch.tensor(True))
    assert torch.equal(x, torch.zeros(tl.ndof))
    assert torch.equal(r, torch.ones(tl.ndof))
    assert torch.equal(z, torch.full((tl.ndof,), 2.0))


def test_block_sums_follow_the_kernel_tree():
    v = torch.as_tensor(np.random.default_rng(3).normal(size=700),
                        dtype=torch.float32)
    parts = cg_kernel.block_sums(v)
    assert parts.shape == (3,)
    np.testing.assert_allclose(parts.numpy(),
                               [v[:256].sum(), v[256:512].sum(),
                                v[512:].sum()], rtol=1e-5)


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
