"""The port's banded adjoint (ops/dia.dia_solve_diff), its identification
loop (solvers/banded_inverse.py) and the families' identification
functions (models/plane, solid, plate, shell, frame) against the JAX
package, on the CPU.

Both packages get the same numpy inputs: meshes, measured displacements
and seeds.  Bounds:

  * the adjoint: the serial-spring closed form and jax.grad through the
    JAX package's assemble_dia / dia_solve_diff within ADJOINT_RTOL (the
    JAX test's bound, tests/test_dia.py);
  * the identification loops in float64 (PINN_FEM_TPU_X64=1 in the port,
    jax.enable_x64 in the JAX package): the first N_ROWS loss rows and
    the parameters after them within F64_RTOL of the JAX values, for the
    three parameterizations (zones, field, per-element), and the first
    N_FAMILY_ROWS for every family function (meshes of 10^2 DOFs: each
    case costs a JAX compile and a CPU PCG loop);
  * in float32, zones on the plane strip: the zone moduli within
    F32_ZONE_RTOL, the loss rows within F32_LOSS_RTOL.  The JAX package
    scatters its diagonals in float32 in XLA's order, the port in float64
    rounded once (ops/assembly.scatter_add); on this strip that moves
    the first loss row by 9.6e-4 and the rows after it by up to 1.9e-3
    (measured), while the float64 runs agree to 1e-11.  Per-element log-E
    in float32 is not compared: ADAM's first steps normalize gradients
    whose small entries are float32 noise of either package.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pinn_fem_tpu.io import plate_io as j_plate_io  # noqa: E402
from pinn_fem_tpu.io import shell_io as j_shell_io  # noqa: E402
from pinn_fem_tpu.io import solid_io as j_solid_io  # noqa: E402
from pinn_fem_tpu.models import frame as JF  # noqa: E402
from pinn_fem_tpu.models import plane as JP  # noqa: E402
from pinn_fem_tpu.models import plate as JPl  # noqa: E402
from pinn_fem_tpu.models import shell as JS  # noqa: E402
from pinn_fem_tpu.models import solid as JSo  # noqa: E402
from pinn_fem_tpu.ops import dia as j_dia  # noqa: E402
import torch  # noqa: E402

from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.io import plate_io as t_plate_io  # noqa: E402
from pinn_fem_tpu_torch.io import shell_io as t_shell_io  # noqa: E402
from pinn_fem_tpu_torch.io import solid_io as t_solid_io  # noqa: E402
from pinn_fem_tpu_torch.models import frame as TF  # noqa: E402
from pinn_fem_tpu_torch.models import plane as TP  # noqa: E402
from pinn_fem_tpu_torch.models import plate as TPl  # noqa: E402
from pinn_fem_tpu_torch.models import shell as TS  # noqa: E402
from pinn_fem_tpu_torch.models import solid as TSo  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as t_dia  # noqa: E402
from pinn_fem_tpu_torch.utils.runtime import X64_VARIABLE  # noqa: E402

ADJOINT_RTOL = 1e-4
# Float64 loops: measured up to 3.6e-11 (loss rows) and 1.5e-8 (the
# per-element moduli of the plane strip, whose weakest elements move by
# float64 noise in ADAM's normalization).
F64_RTOL = 1e-6
# Float32 zones on the plane strip (see the module docstring): measured
# 9.0e-6 on the zone moduli, 1.9e-3 on the loss rows.
F32_ZONE_RTOL = 1e-4
F32_LOSS_RTOL = 5e-3
N_ROWS = 10
# The family functions: fewer rows (each JAX compile and each CPU PCG
# loop costs seconds).
N_FAMILY_ROWS = 3


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


@pytest.fixture()
def x64(monkeypatch):
    monkeypatch.setenv(X64_VARIABLE, "1")
    with jax.enable_x64(True):
        yield


# --- ops/dia.dia_solve_diff --------------------------------------------------


def chain(n: int = 6):
    dof_map = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    g = np.tile(np.array([-1.0, 1.0]), (n - 1, 1))
    mask = (np.arange(n) > 0).astype(float)
    rhs = np.r_[np.zeros(n - 1), 1.0]
    return dof_map, g, mask, rhs


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def test_dia_solve_diff_forward_equals_cg_solve():
    """The forward value is dia_cg_solve's, bit for bit."""
    dof_map, g, mask, rhs = chain(40)
    lay = t_dia.dia_layout(dof_map, 40)
    s = t32(np.linspace(1.0, 3.0, 39))
    diags = t_dia.assemble_dia(lay, s, t32(g))
    u = t_dia.dia_solve_diff(lay, diags, t32(rhs), t32(mask), tol=1e-8)
    x, _, _ = t_dia.dia_cg_solve(lay, diags, t32(rhs), t32(mask), tol=1e-8,
                                 max_iter=20000)
    assert torch.equal(u, x)


def test_dia_solve_diff_serial_spring_closed_form():
    """Serial springs under a unit tip load: u_i = i / k, so dL/dk_j =
    -(2 / k^2) sum_{i >= j} u_i for L = sum u^2 (tests/test_dia.py)."""
    n, k = 6, 2.0
    dof_map, g, mask, rhs = chain(n)
    lay = t_dia.dia_layout(dof_map, n)
    s = torch.full((n - 1,), k, requires_grad=True)
    u = t_dia.dia_solve_diff(lay, t_dia.assemble_dia(lay, s, t32(g)),
                             t32(rhs), t32(mask), tol=1e-12)
    torch.sum(u ** 2).backward()
    uu = np.arange(1, n) / k
    expect = np.array([-(2.0 / k ** 2) * uu[j:].sum() for j in range(n - 1)])
    np.testing.assert_allclose(s.grad.numpy(), expect, rtol=ADJOINT_RTOL)


def test_dia_solve_diff_matches_jax_grad():
    """A weighted functional of u on a non-uniform chain with a full rhs:
    the gradients in the element coefficients and the rhs equal jax.grad
    through the JAX package's assemble_dia / dia_solve_diff."""
    n = 24
    dof_map, g, mask, _ = chain(n)
    rng = np.random.default_rng(3)
    s0 = rng.uniform(0.5, 2.0, n - 1)
    rhs0 = rng.uniform(-1.0, 1.0, n)
    w = rng.uniform(0.0, 1.0, n)

    j_lay = j_dia.dia_layout(dof_map, n)

    def j_loss(s, rhs):
        u = j_dia.dia_solve_diff(j_lay, j_dia.assemble_dia(
            j_lay, s, jnp.asarray(g, jnp.float32)), rhs,
            jnp.asarray(mask, jnp.float32), tol=1e-10)
        return jnp.sum(jnp.asarray(w, jnp.float32) * u ** 2)

    gs, gr = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(s0, jnp.float32), jnp.asarray(rhs0, jnp.float32))

    lay = t_dia.dia_layout(dof_map, n)
    s = t32(s0).requires_grad_()
    r = t32(rhs0).requires_grad_()
    u = t_dia.dia_solve_diff(lay, t_dia.assemble_dia(lay, s, t32(g)), r,
                             t32(mask), tol=1e-10)
    torch.sum(t32(w) * u ** 2).backward()
    assert rel_err(np.asarray(gs), s.grad.numpy()) < ADJOINT_RTOL
    assert rel_err(np.asarray(gr), r.grad.numpy()) < ADJOINT_RTOL


def test_dia_diags_grad_is_one_gather():
    """g[k, i] = m_i lam_i m_{i+off_k} u_{i+off_k}, zero outside the band,
    against a loop over the diagonals in float64."""
    rng = np.random.default_rng(5)
    nodes, elems = TP.rect_mesh(1.0, 1.0, 3, 4, "quad")
    p = TP.PlaneProblem(nodes=nodes, elements=elems, young=1.0,
                        poisson=0.3, thickness=1.0, density=1.0,
                        loads=np.zeros(2 * len(nodes)),
                        fixed_dofs=np.arange(4))
    lay = TP.plane_dia_layout(p)
    n = p.ndof
    lam = torch.as_tensor(rng.standard_normal(n))
    u = torch.as_tensor(rng.standard_normal(n))
    mask = torch.as_tensor(p.free_mask())
    got = t_dia.dia_diags_grad(lay, lam, u, mask).numpy()
    want = np.zeros((lay.n_diags, n))
    mu = (u * mask).numpy()
    for k, off in enumerate(lay.offsets):
        for i in range(n):
            if 0 <= i + off < n:
                want[k, i] = mask[i] * lam[i] * mu[i + off]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


# --- solvers/banded_inverse.identify_young_banded on the plane strip --------


def strip(nx: int = 6, ny: int = 24):
    """(numpy inputs, zones, probes, measurement) of a Q4 strip under
    uniaxial tension with a two-zone, x-modulated true E: the
    test_plane.py case at 350 DOFs."""
    nodes, elems = JP.rect_mesh(1.0, 4.0, nx, ny, "quad")
    bottom = np.flatnonzero(nodes[:, 1] == 0.0)
    top = np.flatnonzero(nodes[:, 1] == 4.0)
    loads = JP.edge_load(nodes, top[np.argsort(nodes[top, 0])], [0.0, 5.0],
                         0.1)
    cent = nodes[elems].mean(axis=1)
    zones = [np.flatnonzero(cent[:, 1] < 2.0).tolist(),
             np.flatnonzero(cent[:, 1] >= 2.0).tolist()]
    true_young = (np.where(cent[:, 1] < 2.0, 800.0, 1400.0)
                  * (1.0 + 0.1 * np.sin(3.0 * cent[:, 0])))
    kw = dict(nodes=nodes, elements=elems, poisson=0.3, thickness=0.1,
              density=1.0, loads=loads,
              fixed_dofs=np.concatenate([2 * bottom, 2 * bottom + 1]))
    r, _, _ = JP.solve_plane_static_banded(
        JP.PlaneProblem(young=true_young, **kw), tol=1e-9)
    probe = np.arange(len(loads))[np.abs(r.displacements) > 1e-12][::5]
    return kw, zones, probe, r.displacements[probe]


@pytest.fixture(scope="module")
def plane_strip():
    return strip()


MODES = {"zones": lambda z: dict(zones=z),
         "field": lambda z: dict(field=True), "per_element": lambda z: {}}


def both_banded(case, mode, **kw):
    base, zones, probe, meas = case
    opts = dict(n_iter=N_ROWS, learning_rate=0.2, tol=1e-8,
                **MODES[mode](zones), **kw)
    yj, hj, _ = JP.identify_plane_young_banded(
        JP.PlaneProblem(young=1000.0, **base), probe, meas, **opts)
    yt, ht, fld = TP.identify_plane_young_banded(
        TP.PlaneProblem(young=1000.0, **base), probe, meas, device="cpu",
        **opts)
    return (yj, np.asarray(hj)), (yt, ht), fld


@pytest.mark.parametrize("mode", sorted(MODES))
def test_identify_young_banded_matches_jax_float64(plane_strip, x64, mode):
    (yj, hj), (yt, ht), fld = both_banded(plane_strip, mode)
    assert ht.dtype == np.float64 and ht.shape == (N_ROWS,)
    assert rel_err(hj, ht) < F64_RTOL
    assert rel_err(yj, yt) < F64_RTOL
    assert (fld is not None) == (mode == "field")


def test_identify_young_banded_zones_float32(plane_strip):
    (yj, hj), (yt, ht), _ = both_banded(plane_strip, "zones")
    zones = plane_strip[1]
    for z in zones:
        assert rel_err(yj[z].mean(), yt[z].mean()) < F32_ZONE_RTOL
    assert rel_err(hj, ht) < F32_LOSS_RTOL


@pytest.mark.parametrize("bad, match", [
    (dict(field=True), "mutually exclusive"),
    (dict(overlap=True), "overlaps"),
    (dict(outside=True), "outside"),
])
def test_identify_young_banded_refusals_equal_jax(plane_strip, bad, match):
    base, zones, probe, meas = plane_strip
    if "overlap" in bad:
        opts = dict(zones=[zones[0], zones[0]])
    elif "outside" in bad:
        opts = dict(zones=[[0, 10 ** 6]])
    else:
        opts = dict(zones=zones, field=True)
    msgs = []
    for mod, where in ((JP, {}), (TP, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as err:
            mod.identify_plane_young_banded(
                mod.PlaneProblem(young=1000.0, **base), probe, meas,
                n_iter=1, **opts, **where)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --- the family functions, float64, against the JAX package ----------------


@pytest.mark.parametrize("field", [False, True])
def test_identify_plane_young_dense_matches_jax(x64, field):
    base, _, probe, meas = strip(4, 8)
    opts = dict(n_iter=N_FAMILY_ROWS, learning_rate=0.2, field=field)
    yj, hj, _ = JP.identify_plane_young(
        JP.PlaneProblem(young=1000.0, **base), probe, meas, **opts)
    yt, ht, _ = TP.identify_plane_young(
        TP.PlaneProblem(young=1000.0, **base), probe, meas, device="cpu",
        **opts)
    assert rel_err(hj, ht) < F64_RTOL
    assert rel_err(yj, yt) < F64_RTOL


def parsed(j_io, t_io, parse: str, doc):
    return (getattr(j_io, parse)(doc)[0], getattr(t_io, parse)(doc)[0])


def twin(problem_j, young, solve, dofs):
    """The JAX package's float64 displacements of problem_j with the
    moduli `young`, at `dofs`."""
    import dataclasses

    return solve(dataclasses.replace(problem_j, young=young)
                 ).displacements[dofs]


def test_identify_solid_young_banded_matches_jax(x64):
    doc = eg.solid_column_document(2, 2, 4)
    pj, pt = parsed(j_solid_io, t_solid_io, "parse_solid_document", doc)
    cent = pj.coords().mean(axis=1)
    zones = [np.flatnonzero(cent[:, 2] < 2.0),
             np.flatnonzero(cent[:, 2] >= 2.0)]
    true = np.where(cent[:, 2] < 2.0, 160.0, 240.0)
    probe = np.arange(pj.ndof)[2::3][6:]
    meas = twin(pj, true, lambda p: JSo.solve_solid_static_banded(
        p, tol=1e-10)[0], probe)
    opts = dict(n_iter=N_FAMILY_ROWS, learning_rate=0.2, tol=1e-9,
                zones=zones)
    yj, hj, _ = JSo.identify_solid_young_banded(pj, probe, meas, **opts)
    yt, ht, _ = TSo.identify_solid_young_banded(pt, probe, meas,
                                                device="cpu", **opts)
    assert rel_err(hj, ht) < F64_RTOL
    assert rel_err(yj, yt) < F64_RTOL


def plate_doc():
    doc = {"element_type": "plate",
           "mesh": {"type": "rect", "width": 1.0, "height": 1.0, "nx": 6,
                    "ny": 6},
           "material": {"young": 200.0, "poisson": 0.3, "thickness": 0.1,
                        "density": 1.0},
           "supports": {"simply_supported": ["left", "right", "bottom",
                                             "top"]},
           "pressure": -1.0}
    return parsed(j_plate_io, t_plate_io, "parse_plate_document", doc)


@pytest.mark.parametrize("tier", ["dense", "banded"])
def test_identify_plate_young_matches_jax(x64, tier):
    pj, pt = plate_doc()
    cent = pj.coords().mean(axis=1)
    zones = [np.flatnonzero(cent[:, 0] < 0.5),
             np.flatnonzero(cent[:, 0] >= 0.5)]
    true = np.where(cent[:, 0] < 0.5, 150.0, 260.0)
    probe = np.arange(0, pj.ndof, 3)[5::3]
    meas = twin(pj, true, JPl.solve_plate_static, probe)
    if tier == "dense":
        opts = dict(n_iter=N_FAMILY_ROWS, learning_rate=0.2)
        yj, hj, _ = JPl.identify_plate_young(pj, probe, meas, **opts)
        yt, ht, _ = TPl.identify_plate_young(pt, probe, meas, device="cpu",
                                             **opts)
    else:
        opts = dict(n_iter=N_FAMILY_ROWS, learning_rate=0.2, tol=1e-10,
                    zones=zones)
        yj, hj, _ = JPl.identify_plate_young_banded(pj, probe, meas, **opts)
        yt, ht, _ = TPl.identify_plate_young_banded(pt, probe, meas,
                                                    device="cpu", **opts)
    assert rel_err(hj, ht) < F64_RTOL
    assert rel_err(yj, yt) < F64_RTOL


def shell_doc():
    import json
    from pathlib import Path

    doc = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "json" / "dyn-shell.json").read_text())
    doc["mesh"].update(nx=4, ny=4)
    return parsed(j_shell_io, t_shell_io, "parse_shell_document", doc)


@pytest.mark.parametrize("tier", ["dense", "banded"])
def test_identify_shell_young_matches_jax(x64, tier):
    pj, pt = shell_doc()
    cent = pj.nodes[pj.elements].mean(axis=1)
    zones = [np.flatnonzero(cent[:, 1] < 25.0),
             np.flatnonzero(cent[:, 1] >= 25.0)]
    true = np.where(cent[:, 1] < 25.0, 3.6e8, 5.2e8)
    probe = np.arange(pj.ndof).reshape(-1, 6)[:, :3].reshape(-1)[::2]
    meas = twin(pj, true, JS.solve_shell_static, probe)
    if tier == "dense":
        opts = dict(n_iter=N_FAMILY_ROWS, learning_rate=0.2)
        yj, hj, _ = JS.identify_shell_young(pj, probe, meas, **opts)
        yt, ht, _ = TS.identify_shell_young(pt, probe, meas, device="cpu",
                                            **opts)
    else:
        opts = dict(n_iter=N_FAMILY_ROWS, learning_rate=0.2, tol=1e-8,
                    zones=zones)
        yj, hj, _ = JS.identify_shell_young_banded(pj, probe, meas, **opts)
        yt, ht, _ = TS.identify_shell_young_banded(pt, probe, meas,
                                                   device="cpu", **opts)
    assert rel_err(hj, ht) < F64_RTOL
    assert rel_err(yj, yt) < F64_RTOL


@pytest.mark.parametrize("param", ["inertia", "young"])
def test_identify_frame_properties_matches_jax(x64, param):
    nodes = np.stack([np.linspace(0.0, 4.0, 9), np.zeros(9)], axis=1)
    elems = np.stack([np.arange(8), np.arange(1, 9)], axis=1)
    loads = np.zeros(27)
    loads[25] = -1000.0
    kw = dict(nodes=nodes, elements=elems, young=2e11, area=0.01,
              inertia=1e-5, density=7850.0, loads=loads,
              fixed_dofs=np.arange(3))
    pj, pt = JF.FrameProblem(**kw), TF.FrameProblem(**kw)
    true = np.linspace(1.5, 1.0625, 8) * (1e-5 if param == "inertia"
                                          else 2e11)
    dofs = np.arange(4, 27)
    meas = JF.solve_frame_static(JF.FrameProblem(
        **dict(kw, **{param: true}))).displacements[dofs]
    yj, hj = JF.identify_frame_properties(pj, dofs, meas, param=param,
                                          n_iter=N_FAMILY_ROWS)
    yt, ht = TF.identify_frame_properties(pt, dofs, meas, param=param,
                                          n_iter=N_FAMILY_ROWS, device="cpu")
    assert rel_err(hj, ht) < F64_RTOL
    assert rel_err(yj, yt) < F64_RTOL


def floor_loss_at_truth(dtype) -> tuple:
    """(loss, max |u - u_twin| / max |u_twin|) of the two-zone strip's
    model at the true moduli against its twin data, both on the
    identification path in `dtype` (tools/measure_identification_floor.py
    at 32 x 128)."""
    import dataclasses

    from pinn_fem_tpu_torch.examples_grid import plane_strip_document
    from pinn_fem_tpu_torch.io.plane_io import parse_plane_document
    from pinn_fem_tpu_torch.solvers import banded_inverse as BI

    problem = parse_plane_document(plane_strip_document(32, 128))[0]
    cent = problem.coords().mean(axis=1)
    zones = [np.flatnonzero(cent[:, 1] < 2.0),
             np.flatnonzero(cent[:, 1] >= 2.0)]
    twin, _, _ = TP.solve_plane_static_banded(dataclasses.replace(
        problem, young=np.where(cent[:, 1] < 2.0, 800.0, 1400.0)),
        tol=1e-10, dtype=dtype, device="cpu")
    u_twin = twin.displacements
    probe = np.arange(u_twin.size)[np.abs(u_twin) > 1e-12][::11]
    idx, meas, scale = BI.measurement(probe, u_twin[probe], dtype, "cpu")
    _, young_of, _ = BI.young_parameterization(
        problem.young, cent, zones, dtype=dtype, device="cpu")
    diags = t_dia.assemble_dia_blocks(
        TP.plane_dia_layout(problem), TP._young_blocks_of(problem, "cpu")(
            young_of([torch.log(torch.tensor([800.0, 1400.0],
                                             dtype=dtype))])))
    u = t_dia.dia_solve_diff(
        TP.plane_dia_layout(problem), diags.to(dtype),
        torch.as_tensor(TP._identification_loads(problem), dtype=dtype),
        torch.as_tensor(problem.free_mask(), dtype=dtype), tol=1e-10)
    loss = float(torch.mean((u[idx] - meas) ** 2) / scale)
    gap = float(np.abs(u.double().numpy() - u_twin).max()
                / np.abs(u_twin).max())
    return loss, gap


def test_float32_identification_floor_fault():
    """ROADMAP fault 3.38: in float32 the strip's model at the true zone
    moduli (rounded through float32 exp(log)) misses its own twin data,
    PCG tolerance 1e-10 both, by u 7.9e-4 of max |u| and loss 5.8e-7
    (measured): the float32 PCG ends at the same iterate for tolerances
    1e-8 to 1e-10 (tools/measure_identification_floor.py), and the
    identified zones cannot land closer than that floor allows (1.8e-2
    on the 128 x 512 strip on the card).  In float64 the two solves agree
    and the loss vanishes."""
    loss32, gap32 = floor_loss_at_truth(torch.float32)
    loss64, gap64 = floor_loss_at_truth(torch.float64)
    assert loss32 > 1e-7 and gap32 > 1e-4
    assert loss64 < 1e-20 and gap64 < 1e-12
