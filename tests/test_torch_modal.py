"""The port's modal analysis (solvers/modal.py), modal-superposition
transients (solve_transient(method="modal")), the main path's public
helpers (item 26: models/problem.py, ops/assembly.py) and "modal"
documents against the JAX package, on the CPU.

Each case gives the same inputs, made by numpy, to both packages.  The
dense float64 path (the default below DENSE_DOF_LIMIT) is held to the JAX
host tier at 1e-10 relative; the float32 paths (host=False, the banded
subspace iteration with DENSE_DOF_LIMIT patched below the mesh in both
packages' Newton modules, as tests/test_modal.py does) at the gaps
measured here times a margin, never tighter than the JAX package's own
floors.  Eigenvector signs are arbitrary: shapes are compared by MAC or
by |phi|.
"""

import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu.solvers.newton as j_newton  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.models import problem as j_problem  # noqa: E402
from pinn_fem_tpu.ops import assembly as j_assembly  # noqa: E402
from pinn_fem_tpu.solvers import dynamics as j_dyn  # noqa: E402
from pinn_fem_tpu.solvers import modal as j_modal  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.solvers import modal as t_modal  # noqa: E402
from pinn_fem_tpu_torch.utils import prng  # noqa: E402
from pinn_fem_tpu_torch.utils.runtime import X64_VARIABLE  # noqa: E402

CPU = torch.device("cpu")
CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"

# Item 26's helpers on corpus documents: float32 noise of another
# summation order (measured up to 2.4e-7 of the largest entry), bound
# 1e-5; float64 measured up to 2.2e-16, bound 1e-12.
HELPER_RTOL = {"float32": 1e-5, "float64": 1e-12}
# The dense float64 path against the JAX host tier (numpy / LAPACK):
# eigenvalues measured up to 3.2e-14 relative, MAC 1 - 5.6e-16; residuals
# are float64 check noise, measured below 3e-14 in both.
F64_RTOL = 1e-10
MAC_FLOOR = 1.0 - 1e-8
F64_RESIDUAL = 1e-12
# Float32 dense paths (modal_eigenpairs, host=False): eigenvalues
# measured up to 4.1e-6 relative (float32 eigh of the lowest mode), bound
# 4e-5; the density gradient measured 1.0e-7 of its largest entry, bound
# 1e-5.
F32_RTOL = 4e-5
GRAD_RTOL = 1e-5
# The banded subspace iteration, port against JAX from the same start
# vectors (utils/prng.normal, within 6e-6 of jax.random.normal): after
# BANDED_JAX_ITERS iterations eigenvalues measured 2.3e-6 relative, bound
# 6e-3, the JAX package's float32 floor (0.6 % of the dense value at 2.5k
# DOFs, pinn_fem_tpu/solvers/modal.py:29-31); banded against dense after
# 25 iterations held to tests/test_modal.py's 1e-3 (measured 7.2e-7).
BANDED_JAX_ITERS = 4
BANDED_RTOL = 6e-3
BANDED_VS_DENSE_RTOL = 1e-3
# Modal transients, each history against the largest JAX value: measured
# up to 8.4e-6 (damped, 800 steps) and 7.3e-5 (undamped, 3,000 steps,
# the JAX package's per-step float32 recurrence), bound 5e-4.
TRANSIENT_RTOL = 5e-4


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@contextlib.contextmanager
def dense_limit(limit):
    """DENSE_DOF_LIMIT of both packages' Newton modules set to `limit`."""
    saved = (j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT)
    j_newton.DENSE_DOF_LIMIT = t_newton.DENSE_DOF_LIMIT = limit
    try:
        yield
    finally:
        j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT = saved


def chain(pkg, n_elm=12, young=3.0, area=0.7, density=2.0, material=None):
    """The fixed-fixed 1D chain of tests/test_modal.py."""
    n = n_elm + 1
    return pkg.TrussProblem(
        np.arange(n, dtype=float), np.stack([np.arange(n - 1),
                                             np.arange(1, n)], 1),
        material or pkg.Material(young=young, area=area, density=density),
        np.zeros(n), np.array([0, n - 1]), 1)


def exact_lambdas(n_elm, young, density, lumped, k):
    theta = np.pi * np.arange(1, n_elm) / n_elm
    if lumped:
        lam = (young / density) * (2.0 - 2.0 * np.cos(theta))
    else:
        lam = (young / density) * 6.0 * (1.0 - np.cos(theta)) \
            / (2.0 + np.cos(theta))
    return np.sort(lam)[:k]


def tower(pkg, stories=4, top_load=(0.0, -1.0)):
    """Cross-braced 2-chord tower (tests/test_buckling.py), loaded at the
    two top nodes."""
    nodes, elements = [], []
    for s in range(stories + 1):
        nodes += [[0.0, float(s)], [1.0, float(s)]]
    for s in range(stories):
        a, b, c, d = 2 * s, 2 * s + 1, 2 * s + 2, 2 * s + 3
        elements += [[a, c], [b, d], [c, d], [a, d], [b, c]]
    loads = np.zeros(2 * len(nodes))
    for node in (2 * stories, 2 * stories + 1):
        loads[2 * node: 2 * node + 2] = top_load
    return pkg.TrussProblem(np.array(nodes), np.array(elements),
                            pkg.Material(young=1000.0, area=1.0, density=1.0),
                            loads, np.array([0, 1, 2, 3]), 2)


def min_mac(a, b) -> float:
    return float(np.min(np.diag(t_modal.mac(a, b))))


# ------------------------------------------------- item 26: the helpers

def helper_gaps(name: str, dtype: str) -> dict:
    doc = json.loads((CORPUS / name).read_text())
    jparsed, tparsed = j_parse(doc), parse_problem_dict(doc)
    jprob, tprob = jparsed.problem, tparsed.problem
    jd = jprob.to_device(use_native=False)
    td = tprob.to_device(CPU, getattr(torch, dtype))
    free = tprob.free_fixed()[0]
    rng = np.random.default_rng(4)
    u = rng.normal(size=tprob.ndof) * 0.05
    f = rng.normal(size=tprob.ndof)
    ju, jf = jnp.asarray(u, jd.loads.dtype), jnp.asarray(f, jd.loads.dtype)
    tu = torch.as_tensor(u, dtype=td.loads.dtype)
    tf = torch.as_tensor(f, dtype=td.loads.dtype)
    @jax.jit
    def jax_helpers(d, u_, f_):
        # One program: the JAX ops eagerly would compile one each.
        return (j_assembly.compute_residual_and_jacobian(
                    d, jprob.material, u_, f_, jnp.asarray(free)),
                [j_assembly.element_strain_stress(d, jprob.material, u_, e)
                 for e in (True, False)])

    (jr, jk), jes = jax_helpers(jd, ju, jf)
    tr, tk = tp.compute_residual_and_jacobian(td, tprob.material, tu, tf,
                                              free)
    gaps = {"R": rel_err(tr, jr), "K": rel_err(tk, jk)}
    for eng, (je, js) in zip((True, False), jes):
        te, ts = tp.element_strain_stress(td, tprob.material, tu, eng)
        gaps[f"eps{int(eng)}"] = rel_err(te, je)
        gaps[f"sigma{int(eng)}"] = rel_err(ts, js)
    assert tr.dtype == td.loads.dtype and tk.shape == (free.size,) * 2
    # The numpy helpers, exactly.
    nodes2 = tprob.node_coords_2d
    for i, j in tprob.elements[:3]:
        assert np.array_equal(tp.element_dofs(i, j),
                              j_problem.element_dofs(i, j))
        for a, b in zip(tp.split_element_data(nodes2, u, i, j),
                        j_problem.split_element_data(nodes2, u, i, j)):
            assert np.array_equal(a, b)
    for a, b in zip(tp.free_and_fixed_dofs(tprob.ndof, tprob.fixed_dofs),
                    j_problem.free_and_fixed_dofs(jprob.ndof,
                                                  jprob.fixed_dofs)):
        assert np.array_equal(a, b)
    return gaps


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["example1.json", "example7-P.json"])
def test_item26_helpers_match_jax(monkeypatch, name, dtype):
    """example1 (scalar material) and example7-P (three MLP fields: kernel
    4's twin in the port), in float32 and float64."""
    if dtype == "float64":
        monkeypatch.setenv(X64_VARIABLE, "1")
        with jax.enable_x64(True):
            gaps = helper_gaps(name, dtype)
    else:
        monkeypatch.delenv(X64_VARIABLE, raising=False)
        gaps = helper_gaps(name, dtype)
    for key, gap in gaps.items():
        assert gap <= HELPER_RTOL[dtype], (key, gap)


def test_facade_exports_the_slice():
    names = ("element_dofs", "free_and_fixed_dofs", "split_element_data",
             "compute_residual_and_jacobian", "element_strain_stress",
             "assemble_system", "internal_force_and_strain", "ModalResult",
             "modal_analysis", "modal_eigenvalues", "modal_eigenpairs",
             "rayleigh_coefficients", "mac", "BucklingResult",
             "buckling_analysis", "buckling_eigenvalues")
    for name in names:
        assert name in tp.__all__ and callable(getattr(tp, name)), name


# ------------------------------------------------------ dense, float64

@pytest.mark.parametrize("lumped", [True, False])
def test_dense_modal_matches_jax_host_tier(lumped):
    """The chain, lumped and consistent: JAX's host tier to float64
    rounding, and the closed-form discrete spectrum."""
    j = j_modal.modal_analysis(chain(jp), n_modes=5, lumped=lumped)
    t = tp.modal_analysis(chain(tp), n_modes=5, lumped=lumped, device="cpu")
    assert t.eigenvalues.dtype == np.float64
    np.testing.assert_allclose(t.eigenvalues, j.eigenvalues, rtol=F64_RTOL)
    np.testing.assert_allclose(t.omegas, j.omegas, rtol=F64_RTOL)
    np.testing.assert_allclose(t.frequencies, j.frequencies, rtol=F64_RTOL)
    np.testing.assert_allclose(
        t.eigenvalues, exact_lambdas(12, 3.0, 2.0, lumped, 5), rtol=F64_RTOL)
    assert min_mac(t.shapes, j.shapes) >= MAC_FLOOR
    assert t.ok and j.ok
    assert np.all(t.residuals < F64_RESIDUAL)
    assert np.all(t.shapes[[0, -1]] == 0.0)
    # host=True: the same computation on the CPU.
    h = tp.modal_analysis(chain(tp), n_modes=5, lumped=lumped, host=True)
    np.testing.assert_allclose(h.eigenvalues, j.eigenvalues, rtol=F64_RTOL)


def test_dense_prestressed_modal_matches_jax():
    """prestress_u: K + K_g(u0) on a compressed tower (the frequencies
    fall toward the buckling point)."""
    from pinn_fem_tpu.ops.host import host_static_solve

    u0 = 0.5 * host_static_solve(tower(jp))
    j = j_modal.modal_analysis(tower(jp), n_modes=4, prestress_u=u0)
    t = tp.modal_analysis(tower(tp), n_modes=4, prestress_u=u0, device="cpu")
    free = tp.modal_analysis(tower(tp), n_modes=4, device="cpu")
    np.testing.assert_allclose(t.eigenvalues, j.eigenvalues, rtol=F64_RTOL)
    assert min_mac(t.shapes, j.shapes) >= MAC_FLOOR
    assert t.eigenvalues[0] < free.eigenvalues[0]


# ------------------------------------------------------ dense, float32

def test_modal_eigenpairs_float32_matches_jax():
    jprob = chain(jp)
    wj, pj = jax.device_get(jax.jit(lambda d: j_modal.modal_eigenpairs(
        jprob, n_modes=4, data=d))(jprob.to_device()))
    wt, pt = tp.modal_eigenpairs(chain(tp), n_modes=4, device="cpu")
    assert wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), wj, rtol=F32_RTOL)
    assert min_mac(pt.numpy(), pj) >= MAC_FLOOR
    gram = pt.numpy().T @ (np.asarray(jax.device_get(
        jp.lumped_mass(chain(jp).to_device(), chain(jp).material)))[:, None]
        * pt.numpy())
    np.testing.assert_allclose(gram, np.eye(4), atol=1e-4)


@pytest.mark.parametrize("lumped", [True, False])
def test_host_false_matches_jax(lumped):
    j = j_modal.modal_analysis(chain(jp), n_modes=4, lumped=lumped,
                               host=False)
    t = tp.modal_analysis(chain(tp), n_modes=4, lumped=lumped, host=False,
                          device="cpu")
    assert t.eigenvalues.dtype == np.float32
    np.testing.assert_allclose(t.eigenvalues, j.eigenvalues, rtol=F32_RTOL)
    assert t.ok == j.ok and min_mac(t.shapes, j.shapes) >= MAC_FLOOR


def test_density_gradient_matches_jax():
    """d sum(omega^2) / d theta of an MLP density (tests/test_modal.py:77),
    from the same initial weights (utils/prng)."""
    from pinn_fem_tpu.models.fields import make_mlp_field
    from pinn_fem_tpu.solvers.gd import get_theta, set_theta

    kw = dict(hidden_layers=2, neurons_per_layer=8, input_dim=1, scale=2.0)
    jmat = jp.Material(young=3.0, area=0.7,
                       density=make_mlp_field(jax.random.PRNGKey(1), **kw))
    jprob = chain(jp, material=jmat)
    data = jprob.to_device()

    def loss(theta):
        return jnp.sum(j_modal.modal_eigenvalues(
            jprob, n_modes=3, data=data, material=set_theta(jmat, theta)))

    g_jax = np.concatenate([np.asarray(leaf).ravel() for leaf in
                            jax.tree_util.tree_leaves(
                                jax.jit(jax.grad(loss))(get_theta(jmat)))])
    tmat = tp.Material(young=3.0, area=0.7, density=tp.make_mlp_field(
        prng.PRNGKey(1), device="cpu", **kw))
    params = tmat.trainable_params()
    for q in params:
        q.requires_grad_(True)
    tp.modal_eigenvalues(chain(tp, material=tmat), n_modes=3,
                         device="cpu").sum().backward()
    g_port = np.concatenate([q.grad.numpy().ravel() for q in params])
    assert np.abs(g_port).max() > 0
    assert rel_err(g_port, g_jax) <= GRAD_RTOL


# --------------------------------------------------------------- banded

def test_banded_modal_matches_jax_and_dense():
    """The 40-element chain on the banded path (DENSE_DOF_LIMIT 16 in both
    packages): port against JAX after BANDED_JAX_ITERS subspace
    iterations from the same start vectors, and the port's 25 iterations
    against its dense float64 path."""
    dense = tp.modal_analysis(chain(tp, 40), n_modes=3, device="cpu")
    with dense_limit(16):
        j = j_modal.modal_analysis(chain(jp, 40), n_modes=3,
                                   n_iter=BANDED_JAX_ITERS)
        t = tp.modal_analysis(chain(tp, 40), n_modes=3,
                              n_iter=BANDED_JAX_ITERS, device="cpu")
        full = tp.modal_analysis(chain(tp, 40), n_modes=3, device="cpu")
    np.testing.assert_allclose(t.eigenvalues, j.eigenvalues,
                               rtol=BANDED_RTOL)
    assert min_mac(t.shapes, j.shapes) >= 0.999
    np.testing.assert_allclose(full.eigenvalues, dense.eigenvalues,
                               rtol=BANDED_VS_DENSE_RTOL)
    assert full.ok and np.all(full.residuals < 1e-2)
    assert min_mac(full.shapes, dense.shapes) >= 0.999


def test_start_vectors_are_jax_normal():
    """utils/prng.normal against jax.random.normal, float32 and
    float64."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (500, 16),
                                        jnp.float32))
    got = prng.normal(prng.PRNGKey(3), (500, 16))
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want) / np.abs(want)) <= 6e-6
    assert np.mean(got == want) > 0.8
    with jax.enable_x64(True):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (50, 4),
                                            jnp.float64))
    got = prng.normal(prng.PRNGKey(3), (50, 4), np.float64)
    assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-13


# ------------------------------------------------------- the documents

def prestressed_modal_document() -> dict:
    doc = json.loads((CORPUS / "dyn-modal.json").read_text())
    ref = np.random.default_rng(9).normal(size=(2, 12))
    doc["analysis"] = {
        "type": "modal", "n_modes": 4, "include_shapes": True,
        "prestress": {"scale": 2.0},
        "damping_calibration": {"zeta": [0.02, 0.05], "modes": [1, 3]},
        "compare_shapes": ref.tolist()}
    return doc


def transient_modal_document() -> dict:
    doc = json.loads((CORPUS / "dyn-transient.json").read_text())
    doc["analysis"] = dict(doc["analysis"], method="modal", n_modes=8,
                           dt=0.05)
    return doc


DOCS = {
    "dyn-modal": lambda: json.loads((CORPUS / "dyn-modal.json").read_text()),
    "prestressed": prestressed_modal_document,
    "transient-modal": transient_modal_document,
}


def cli_pair(tmp_path, doc, name):
    """(JAX result, port result) of one document through both CLIs, each
    exiting 0."""
    for pkg, cli in (("jax", jax_cli), ("port", torch_cli)):
        path = tmp_path / f"{name}-{pkg}.json"
        path.write_text(json.dumps(doc))
        assert cli.main([str(path)]) == 0, pkg
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    return [json.loads((tmp_path / f"{name}-{pkg}.res.json").read_text())
            for pkg in ("jax", "port")]


@pytest.mark.parametrize("name", list(DOCS))
def test_modal_documents_through_both_clis(tmp_path, monkeypatch, name):
    """dyn-modal.json; the same tower prestressed at twice its loads, with
    a damping calibration and a MAC against two seeded rows; and
    dyn-transient.json with method "modal": equal keys and flags, numbers
    within F64_RTOL (the transient: TRANSIENT_RTOL)."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    j, t = cli_pair(tmp_path, DOCS[name](), name)
    assert list(t) == list(j)
    if name == "transient-modal":
        assert t["method"] == j["method"] == "modal"
        for key in ("displacements", "velocities", "kinetic_energy",
                    "strain_energy", "u_final"):
            assert rel_err(t[key], j[key]) <= TRANSIENT_RTOL, key
        return
    for key in ("analysis", "n_modes", "lumped", "prestressed", "ok"):
        assert t[key] == j[key], key
    for key in ("eigenvalues", "omegas", "frequencies_hz"):
        np.testing.assert_allclose(t[key], j[key], rtol=F64_RTOL)
    assert max(t["residuals"]) < F64_RESIDUAL
    np.testing.assert_allclose(np.abs(t["mode_shapes"]),
                               np.abs(j["mode_shapes"]), atol=1e-8)
    if name == "prestressed":
        assert t["prestressed"] is True
        rd, jd = t["rayleigh_damping"], j["rayleigh_damping"]
        for key in ("alpha", "beta"):
            assert rd[key] == pytest.approx(jd[key], rel=F64_RTOL)
        np.testing.assert_allclose(t["mac"], j["mac"], atol=1e-10)


# ------------------------------------------------- modal transients

def bar(pkg, n=6):
    """The 1D bar of tests/test_dynamics.py (fixed at 0, tip load)."""
    loads = np.zeros(n)
    loads[-1] = 1.0
    return pkg.TrussProblem(np.arange(n, dtype=float),
                            np.stack([np.arange(n - 1), np.arange(1, n)], 1),
                            pkg.Material(young=4.0, area=0.5, density=2.0),
                            loads, np.array([0]), 1)


@pytest.mark.parametrize("n_steps, every, damping, factor", [
    (800, 80, (0.2, 0.01), 0.05),     # test_modal_matches_central_all_modes
    (3000, 10, (0.0, 0.0), 0.05),     # undamped, long
    (40, 1, (0.0, 0.0), 20.0),        # far beyond the explicit limit
    (200, 10, (50.0, 0.0), 1.0),      # overdamped low modes
])
def test_modal_transient_matches_jax(n_steps, every, damping, factor):
    dt = factor * j_dyn.stable_dt(bar(jp))
    kw = dict(method="modal", record_every=every, damping=damping,
              n_modes=5)
    j = j_dyn.solve_transient(bar(jp), dt, n_steps, **kw)
    t = tp.solve_transient(bar(tp), dt, n_steps, device="cpu", **kw)
    np.testing.assert_array_equal(t.times, j.times)
    for key in ("displacements", "velocities", "kinetic_energy",
                "strain_energy", "u_final", "v_final"):
        assert rel_err(getattr(t, key), getattr(j, key)) <= TRANSIENT_RTOL, \
            key


def test_modal_transient_against_central_and_closed_form():
    """All modes retained: modal == central to the JAX test's bounds
    (tests/test_dynamics.py:380); a quarter period a step on the 2-node
    bar: the SDOF closed form (tests/test_dynamics.py:367)."""
    p = bar(tp)
    dt = 0.05 * tp.stable_dt(p)
    kw = dict(record_every=80, damping=(0.2, 0.01), device="cpu")
    rc = tp.solve_transient(p, dt, 800, method="central", **kw)
    rm = tp.solve_transient(p, dt, 800, method="modal", n_modes=5, **kw)
    scale = np.abs(rc.displacements).max()
    np.testing.assert_allclose(rm.displacements, rc.displacements,
                               atol=2e-3 * scale)
    np.testing.assert_allclose(rm.kinetic_energy, rc.kinetic_energy,
                               atol=0.01 * rc.kinetic_energy.max())
    k, m = 2.0, 0.5
    om = np.sqrt(k / m)
    r = tp.solve_transient(bar(tp, 2), (2 * np.pi / om) / 4.0, 40,
                           method="modal", device="cpu")
    np.testing.assert_allclose(r.displacements[:, 1],
                               (1.0 / k) * (1.0 - np.cos(om * r.times)),
                               atol=1e-5 * (2.0 / k))


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("call, match", [
    (lambda pkg: pkg.solve_transient(bar(pkg), 0.01, 10, method="modal",
                                     geometric_nonlinear=True),
     "geometric_nonlinear"),
    (lambda pkg: pkg.modal_analysis(chain(pkg), n_modes=20),
     "n_modes exceeds"),
])
def test_jax_value_errors_kept(call, match):
    """The ValueErrors of the JAX contract, raised by both packages."""
    with pytest.raises(ValueError, match=match):
        call(jp)
    with pytest.raises(ValueError, match=match):
        call(tp)


def test_banded_modal_refusals():
    """Consistent mass on the banded path (both packages' ValueError);
    host=True above the dense limit; mesh= (ROADMAP item 15's
    multi-device row)."""
    with dense_limit(16):
        with pytest.raises(ValueError, match="lumped mass"):
            j_modal.modal_analysis(chain(jp, 40), n_modes=2, lumped=False)
        with pytest.raises(ValueError, match="lumped mass"):
            tp.modal_analysis(chain(tp, 40), n_modes=2, lumped=False,
                              device="cpu")
        with pytest.raises(ValueError, match="dense-only"):
            tp.modal_analysis(chain(tp, 40), n_modes=2, host=True)
    for fn in (tp.modal_analysis, tp.buckling_analysis):
        with pytest.raises(NotImplementedError, match="item 15"):
            fn(chain(tp), n_modes=2, mesh=object(), device="cpu")
