"""The port's batched solving (parallel/batched.py, cli/api_batch.py and the
ensemble transients of io/transient_io.py) against the JAX package's
(pinn_fem_tpu/parallel/batched.py), on the CPU.

Both packages get the same numpy inputs and the same weights (the JAX
package's draw, handed to the port with material_from_numpy, or stacked
as thetas through numpy).  The meshes are a 5-node chain (8 free DOFs of
10), a 3 x 4 PINN grid (three MLP fields: kernel 4's twin route) and a
4 x 6 grid for the transients.  Iteration counts and converged flags must
be equal, member by member, with members that stop at different
iterations; the values are held to the measured gaps (written beside
each bound) times a margin.  "Member b of a batch equals a batch of
member b alone" is held bit for bit on the CPU, which catches a member's
forces, moments or parameters leaking into another's.
"""

import json
import logging

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
from pinn_fem_tpu.cli import api_batch as j_api_batch  # noqa: E402
from pinn_fem_tpu.cli import generic as j_cli  # noqa: E402
from pinn_fem_tpu.io.analysis import run_analysis as j_run_analysis  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.parallel import batched as jb  # noqa: E402
import pinn_fem_tpu_torch as T  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.cli import api_batch as t_api_batch  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as t_cli  # noqa: E402
from pinn_fem_tpu_torch.io.analysis import run_analysis  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import material_kernel  # noqa: E402
from pinn_fem_tpu_torch.parallel import batched as tb  # noqa: E402
from test_torch_gd import jax_leaves, parse_both  # noqa: E402

CPU = "cpu"
# Every gap is relative to the largest JAX value of the quantity.
# u of the batched Newton (dense, 2 iterations): measured 0 (shared
# tangent) and 6.4e-8 (per-member tangents); bound 1e-6.
NR_U_RTOL = 1e-6
# GD (the chain's torch form, the PINN grid's twin route, the incremental
# GD and the requests): u, reactions and theta measured up to 4.6e-7
# (the incremental run's reactions), residual_norm up to 1.4e-6; bounds
# 3e-6 and 1e-5.
GD_RTOL = 3e-6
GD_RNORM_RTOL = 1e-5
# Transients on the 4 x 6 grid (dense K), 60-120 central steps at 0.8 of
# the stable step: records, u_final, v_final and envelope measured up to
# 1.8e-6 (v_final, linear damped); the ensemble and envelope documents
# at dt "auto" up to 1.2e-6; bound 1e-5 (two float32 integrators drift
# apart linearly in time; the dynamics tests allow 5e-4 at 200 steps).
TRANSIENT_RTOL = 1e-5
# The Green-Lagrange ensemble document at dt "auto" (the stable step
# itself): measured 3.6e-5 (records) and 3.2e-5 (envelope); bound 2e-4.
# The port sums the element forces in float64, the JAX package in
# float32 (ROADMAP fault 3.4), and near the stability limit the
# difference grows faster.
GL_DOCUMENT_RTOL = 2e-4


def to_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_err(a, b) -> float:
    a, b = to_np(a).astype(float), to_np(b).astype(float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def chain(pkg, material, n_nodes=5):
    """A straight 2D chain pulled at its free end, lateral DOFs held (the
    JAX package's tests/test_parallel.py chain, one node longer)."""
    nodes = np.stack([np.arange(n_nodes, dtype=float), np.zeros(n_nodes)],
                     axis=1)
    elements = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], 1)
    loads = np.zeros(2 * n_nodes)
    loads[2 * (n_nodes - 1)] = 1.0
    fixed = [0, 1] + [2 * i + 1 for i in range(1, n_nodes)]
    return pkg.TrussProblem(nodes, elements, material, loads,
                            np.array(fixed), 2)


def scalar_chains():
    return (chain(J, J.Material(young=1.0, area=1.0, density=1.0)),
            chain(T, T.Material(young=1.0, area=1.0, density=1.0)))


def mlp_chains():
    """The chain with E an MLP of (lf, x, y) (8 wide, one hidden layer,
    jax.random key 0) in both packages, the same weights."""
    jf = J.make_mlp_field(jax.random.PRNGKey(0), 1, 8, input_dim=3,
                          scale=1.0)
    jm = J.Material(young=jf, area=J.to_field(1.0), density=J.to_field(1.0))
    tm = T.material_from_numpy(jax_leaves(jf), np.asarray(1.0),
                               np.asarray(1.0))
    return chain(J, jm), chain(T, tm)


# ----------------------------------------------------------- Newton

@pytest.mark.parametrize("case", ["shared", "per_member", "mlp_per_member"])
def test_nr_batched_matches_jax(case):
    """B = 8 load scales of the chain: one shared tangent (equal load
    factors), each member's own (distinct load factors), and each
    member's own with E an MLP of the load factor (tangents that do
    differ)."""
    jp, tp = mlp_chains() if case == "mlp_per_member" else scalar_chains()
    scales = np.array([0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0])
    loads = scales[:, None] * jp.loads[None]
    lfs = None if case == "shared" else np.linspace(0.4, 1.1, 8)
    jo = jb.solve_nr_batched(jp, loads, J.SolverConfig(), load_factors=lfs)
    to = tb.solve_nr_batched(tp, loads, T.SolverConfig(), load_factors=lfs,
                             device=CPU)
    assert set(to) == set(jo) == {"u", "iterations", "converged"}
    assert to_np(to["iterations"]).tolist() == \
        to_np(jo["iterations"]).tolist()
    assert to_np(to["converged"]).tolist() == [True] * 8
    assert to_np(jo["converged"]).tolist() == [True] * 8
    assert rel_err(to["u"], jo["u"]) <= NR_U_RTOL
    if case == "shared":
        u = to_np(to["u"])
        for i, s in enumerate(scales):
            np.testing.assert_allclose(u[i, [2, 4, 6, 8]],
                                       s * np.arange(1.0, 5.0), rtol=1e-5)


def test_nr_batched_tangent_that_does_not_factor():
    """E = 0 makes the tangent singular: the port ends each member with u
    all NaN, converged false and max_iter iterations, as JAX's NaN factor
    does, and raises nothing."""
    nodes = np.stack([np.arange(5.0), np.zeros(5)], axis=1)
    elements = np.stack([np.arange(4), np.arange(1, 5)], 1)
    fixed = np.array([0, 1] + [2 * i + 1 for i in range(1, 5)])
    loads = np.zeros(10)
    loads[8] = 1.0
    jp = J.TrussProblem(nodes, elements, J.Material(0.0, 1.0, 1.0), loads,
                        fixed, 2)
    tp = T.TrussProblem(nodes, elements, T.Material(0.0, 1.0, 1.0), loads,
                        fixed, 2)
    config = J.SolverConfig(max_iterations=7)
    lb = np.stack([loads, 2 * loads])
    jo = jb.solve_nr_batched(jp, lb, config)
    to = tb.solve_nr_batched(tp, lb, T.SolverConfig(max_iterations=7),
                             device=CPU)
    assert to_np(jo["iterations"]).tolist() == [7, 7]
    assert to_np(to["iterations"]).tolist() == [7, 7]
    assert to_np(to["converged"]).tolist() == [False, False]
    assert np.isnan(to_np(jo["u"])).all() and np.isnan(to_np(to["u"])).all()


# ------------------------------------------------------------------- GD

GD_CHAIN_CONFIG = dict(max_iterations=100, learning_rate_u=0.1,
                       learning_rate_theta=1e-3, tolerance=5e-3)
GD_CHAIN_SCALES = (0.05, 0.3, 1.0)


def gd_chain_runs(scales=GD_CHAIN_SCALES, thetas=None):
    jp, tp = mlp_chains()
    loads = np.stack([s * jp.loads for s in scales])
    jo = jb.solve_gd_batched(jp, loads, J.SolverConfig(**GD_CHAIN_CONFIG),
                             thetas=thetas)
    to = tb.solve_gd_batched(tp, loads, T.SolverConfig(**GD_CHAIN_CONFIG),
                             thetas=thetas, device=CPU)
    return jo, to


def theta_leaves(theta):
    return [to_np(t) for net in theta for layer in net for t in layer]


def assert_gd_close(jo, to, rtol, rnorm_rtol):
    assert set(to) == set(jo)
    for key in ("iterations", "converged"):
        assert to_np(to[key]).tolist() == to_np(jo[key]).tolist(), key
    assert rel_err(to["u"], jo["u"]) <= rtol
    assert rel_err(to["reactions"], jo["reactions"]) <= rtol
    assert rel_err(to["residual_norm"], jo["residual_norm"]) <= rnorm_rtol
    jt, tt = theta_leaves(jo["theta"]), theta_leaves(to["theta"])
    assert [t.shape for t in tt] == [t.shape for t in jt]
    assert max(rel_err(a, b) for a, b in zip(tt, jt)) <= rtol


def test_gd_batched_chain_members_stop_apart():
    """B = 3 load scales of the MLP chain (the torch form of the field):
    the members converge after 21 and 65 iterations and the third runs
    to the cap of 100, in both packages; after its stop a member's u,
    theta and residual norm stay."""
    jo, to = gd_chain_runs()
    iters = to_np(to["iterations"]).tolist()
    assert iters == [21, 65, 100]
    assert to_np(to["converged"]).tolist() == [True, True, False]
    assert_gd_close(jo, to, GD_RTOL, GD_RNORM_RTOL)


def test_gd_batched_member_alone_equals_batch():
    """Member 1 of the batch against a batch of member 1 alone, and the
    batch with distinct thetas against each member alone: bit for bit on
    the CPU (no leak between members)."""
    jp, tp = mlp_chains()
    key = jax.random.split(jax.random.PRNGKey(3), 3)
    thetas = [[J.make_mlp_field(k, 1, 8, input_dim=3, scale=1.0).layers]
              for k in key]
    thetas = [[[tuple(np.asarray(t) for t in layer) for layer in net]
               for net in th] for th in thetas]
    loads = np.stack([s * tp.loads for s in GD_CHAIN_SCALES])
    config = T.SolverConfig(**GD_CHAIN_CONFIG)
    batch = tb.solve_gd_batched(tp, loads, config, thetas=thetas,
                                device=CPU)
    for b in range(3):
        alone = tb.solve_gd_batched(tp, loads[b:b + 1], config,
                                    thetas=thetas[b:b + 1], device=CPU)
        for key in ("u", "reactions", "iterations", "converged",
                    "residual_norm"):
            assert torch.equal(alone[key][0], batch[key][b]), (b, key)
        for x, y in zip(theta_leaves(alone["theta"]),
                        theta_leaves(batch["theta"])):
            assert np.array_equal(x[0], y[b])
    jo = jb.solve_gd_batched(jp, loads, J.SolverConfig(**GD_CHAIN_CONFIG),
                             thetas=thetas)
    assert_gd_close(jo, batch, GD_RTOL, GD_RNORM_RTOL)


def grid_pair(rows=3, cols=4):
    doc = eg.pinn_grid_document(rows, cols, max_iterations=40,
                                tolerance=2e-3)
    return parse_both(doc)


def test_gd_batched_pinn_grid_kernel_route(monkeypatch):
    """B = 3 members of the 3 x 4 PINN grid (three MLP fields: the batched
    twin of kernels 4 and 4b) with their own load scales, measurements and
    load factors: one batched material evaluation an iteration for all
    members plus one for the reactions; iterations, converged and values
    as JAX's, members stopping apart."""
    jpp, tpp = grid_pair()
    assert material_kernel.fused_coefficients_supported(
        tpp.problem.material, 2)
    scales = np.array([0.02, 0.3, 1.0])
    loads = scales[:, None] * tpp.problem.loads[None]
    meas = scales[:, None] * tpp.measured_disp[None]
    lfs = np.array([1.0, 0.8, 0.6])
    calls = []
    real = material_kernel.material_coefficients_batched_reference

    def counting(*args):
        calls.append(args[3].shape[0])
        return real(*args)

    monkeypatch.setattr(material_kernel,
                        "material_coefficients_batched_reference", counting)
    to = tb.solve_gd_batched(tpp.problem, loads, tpp.config,
                             measured_batch=meas,
                             measured_dofs=tpp.measured_dofs,
                             load_factors=lfs, device=CPU)
    jo = jb.solve_gd_batched(jpp.problem, loads, jpp.config,
                             measured_batch=meas,
                             measured_dofs=jpp.measured_dofs,
                             load_factors=lfs)
    iters = to_np(to["iterations"]).tolist()
    assert calls == [3] * (max(iters) + 1)
    assert len(set(iters)) > 1
    assert_gd_close(jo, to, GD_RTOL, GD_RNORM_RTOL)


def test_gd_batched_incremental_with_a_failing_member():
    """Two increments of the MLP chain, at most 60 iterations each: member
    2 (load scale 1.0) fails increment 1 and freezes there (60 iterations
    in all, its increment-1 state and residual norm), member 1 converges
    in increment 1 and fails increment 2, member 0 converges in both.
    Against the JAX scan."""
    jp, tp = mlp_chains()
    cfg = dict(GD_CHAIN_CONFIG, max_iterations=60, n_increments=2)
    loads = np.stack([s * jp.loads for s in GD_CHAIN_SCALES])
    jo = jb.solve_gd_batched_incremental(jp, loads, J.SolverConfig(**cfg))
    to = tb.solve_gd_batched_incremental(tp, loads, T.SolverConfig(**cfg),
                                         device=CPU)
    assert set(to) == set(jo)
    assert to_np(to["converged"]).tolist() == \
        to_np(jo["converged"]).tolist() == [True, False, False]
    total = to_np(to["total_iterations"]).tolist()
    assert total == to_np(jo["total_iterations"]).tolist()
    assert total[2] == 60 and total[1] > 60
    assert rel_err(to["u"], jo["u"]) <= GD_RTOL
    assert rel_err(to["reactions"], jo["reactions"]) <= GD_RTOL
    assert rel_err(to["residual_norm"], jo["residual_norm"]) <= GD_RNORM_RTOL
    assert max(rel_err(a, b) for a, b in zip(
        theta_leaves(to["theta"]), theta_leaves(jo["theta"]))) <= GD_RTOL


def test_incremental_member_equals_driver_solve():
    """Member 0 of the batched incremental GD against the port's own
    driver.solve(method="gd") of the same row (no preconditioning):
    the same increments, iterations and u."""
    from pinn_fem_tpu_torch.solvers.driver import solve

    _, tp = mlp_chains()
    cfg = dict(GD_CHAIN_CONFIG, max_iterations=60, n_increments=2,
               method="gd", preconditioning=False)
    loads = np.stack([s * tp.loads for s in GD_CHAIN_SCALES[:2]])
    out = tb.solve_gd_batched_incremental(tp, loads, T.SolverConfig(**cfg),
                                          device=CPU)
    single = chain(T, tp.material)
    single.loads = loads[0]
    res = solve(single, T.SolverConfig(**cfg), verbose=False, device=CPU)
    assert res.converged
    np.testing.assert_allclose(to_np(out["u"])[0],
                               res.displacements.reshape(-1), rtol=0,
                               atol=1e-6 * np.abs(res.displacements).max())


# ------------------------------------------------------------ transients

def transient_pair(load_scale=1.0):
    doc = eg.grid_document(4, 6)
    args = (np.asarray(doc["nodes"], float), np.asarray(doc["elements"]),
            load_scale * np.asarray(doc["loads"], float),
            np.asarray(doc["fixed_dofs"]))
    return tuple(pkg.TrussProblem(args[0], args[1],
                                  pkg.Material(1.0, 1.0, 1.0), args[2],
                                  args[3], 2) for pkg in (J, T))


@pytest.mark.parametrize("case", ["linear_damped", "green_lagrange"])
def test_transient_batched_matches_jax(case):
    """B = 3 seeded amplitude histories on the 4 x 6 grid, 120 central
    steps recorded every 20 at 4 probe DOFs: linear with Rayleigh (0.05,
    1e-3) damping, and Green-Lagrange (load scale 0.3, strains of ~10 %,
    beta damping through K0)."""
    nl = case == "green_lagrange"
    jp, tp = transient_pair(0.3 if nl else 1.0)
    n_steps, b = 120, 3
    amps = np.random.default_rng(4).uniform(0.0, 1.5, (b, n_steps))
    dt = 0.8 * J.stable_dt(jp, damping=(0.05, 1e-3))
    kw = dict(amplitudes=amps, damping=(0.05, 1e-3), record_every=20,
              probe_dofs=np.array([40, 41, 46, 47]), geometric_nonlinear=nl)
    jo = jb.solve_transient_batched(jp, dt, n_steps, **kw)
    to = tb.solve_transient_batched(tp, dt, n_steps, device=CPU, **kw)
    assert set(to) == set(jo)
    for key in to:
        assert to[key].shape == tuple(np.shape(jo[key])), key
        assert rel_err(to[key], jo[key]) <= TRANSIENT_RTOL, key
    assert float(to["max_stress"].min()) >= 0.0


def test_transient_batched_rows_equal_unbatched_port():
    """Each row of the port's ensemble against the port's own
    solve_transient on that amplitude (dense K): records within 1e-5 of
    their largest value (other association of the damping terms)."""
    _, tp = transient_pair()
    amps = np.random.default_rng(6).uniform(0.0, 1.5, (2, 60))
    dt = 0.8 * T.stable_dt(tp, damping=(0.05, 0.0), device=CPU)
    probe = np.array([40, 41, 46, 47])
    out = tb.solve_transient_batched(tp, dt, 60, amplitudes=amps,
                                     damping=(0.05, 0.0), record_every=10,
                                     probe_dofs=probe, device=CPU)
    for b in range(2):
        res = T.solve_transient(tp, dt, 60, amplitude=amps[b],
                                damping=(0.05, 0.0), record_every=10,
                                probe_dofs=probe, device=CPU)
        assert rel_err(out["displacements"][b], res.displacements) <= 1e-5


# ------------------------------------------------- requests and the CLIs

def batch_payload(kind):
    """The three routes of solve_batch_request and its error."""
    if kind == "nr":
        doc = eg.grid_document(3, 4)
        loads = np.asarray(doc["loads"])
        return {"problem": doc,
                "loads_batch": [(s * loads).tolist() for s in (0.5, 1, 2)]}
    doc = eg.pinn_grid_document(3, 4, max_iterations=30, tolerance=2e-3)
    loads = np.asarray(doc["loads"])
    meas = np.asarray(doc["measured_displacements"]["measured_u"])
    body = {"problem": doc,
            "loads_batch": [(s * loads).tolist() for s in (0.3, 1.0)],
            "measured_batch": [(0.3 * meas).tolist(), meas.tolist()]}
    if kind == "incremental":
        body["incremental"] = True
        body["problem"] = dict(doc, solver_config={"n_increments": 2})
    if kind == "unresolvable":
        body["problem"] = dict(doc, solver_type="fem")
    return body


@pytest.mark.parametrize("kind", ["nr", "gd", "incremental"])
def test_solve_batch_request_routes(kind):
    body = batch_payload(kind)
    jo = jb.solve_batch_request(body)
    to = tb.solve_batch_request(body, device=CPU)
    assert list(to) == list(jo) == ["batch", "converged", "iterations",
                                     "displacements"]
    assert to["batch"] == jo["batch"]
    assert to["converged"] == jo["converged"]
    assert to["iterations"] == jo["iterations"]
    assert rel_err(to["displacements"], jo["displacements"]) <= GD_RTOL


def test_solve_batch_request_unresolvable_measurements():
    body = batch_payload("unresolvable")
    with pytest.raises(ValueError) as j_err:
        jb.solve_batch_request(body)
    with pytest.raises(ValueError) as t_err:
        tb.solve_batch_request(body, device=CPU)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kind", ["nr", "gd", "unresolvable"])
def test_api_batch_through_both_clis(tmp_path, monkeypatch, kind):
    """python -m ...cli.api_batch in.json out.json of both packages:
    exit 0 and the four keys, or exit 1 and the same {error, type}."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", CPU)
    src = tmp_path / "in.json"
    src.write_text(json.dumps(batch_payload(kind)))
    outs = {}
    for tag, cli in (("jax", j_api_batch), ("port", t_api_batch)):
        rc = cli.main([str(src), str(tmp_path / f"{tag}.json")])
        outs[tag] = (rc, json.loads((tmp_path / f"{tag}.json").read_text()))
    (j_rc, j), (t_rc, t) = outs["jax"], outs["port"]
    assert t_rc == j_rc == (1 if kind == "unresolvable" else 0)
    assert list(t) == list(j)
    if kind == "unresolvable":
        assert t == j
    else:
        assert t["iterations"] == j["iterations"]
        assert t["converged"] == j["converged"]
        assert rel_err(t["displacements"], j["displacements"]) <= GD_RTOL
    assert t_api_batch.main([]) == 1


def ensemble_document(**analysis):
    doc = eg.transient_grid_document(4, 6, **analysis)
    doc["analysis"].pop("amplitude", None)
    return doc


ENSEMBLE_DOCS = {
    "ensemble": lambda: ensemble_document(
        n_steps=120, record_every=20, amplitudes=np.random.default_rng(8)
        .uniform(0.0, 1.5, (4, 120)).tolist()),
    "ensemble_green_lagrange": lambda: ensemble_document(
        n_steps=120, record_every=20, geometric_nonlinear=True,
        damping=[0.05, 1e-3], amplitudes=np.random.default_rng(9)
        .uniform(0.0, 0.3, (2, 120)).tolist()),
    "envelope": lambda: eg.transient_grid_document(
        4, 6, n_steps=120, record_every=20, include_stress_envelope=True),
}


@pytest.mark.parametrize("name", list(ENSEMBLE_DOCS))
def test_ensemble_and_envelope_documents_through_both_clis(tmp_path,
                                                           monkeypatch,
                                                           name):
    """Transient documents with "amplitudes" (the ensemble, linear and
    Green-Lagrange) and "include_stress_envelope" through both packages'
    cli.generic: the same keys, equal metadata, values within
    TRANSIENT_RTOL (GL_DOCUMENT_RTOL for Green-Lagrange).  The JAX CLI
    writes an ensemble's result and then exits 1 on its summary line
    (KeyError "method", ROADMAP fault 3.16); the port's exits 0."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", CPU)
    doc = ENSEMBLE_DOCS[name]()
    outs = []
    for tag, cli in (("jax", j_cli), ("port", t_cli)):
        path = tmp_path / f"{name}-{tag}.json"
        path.write_text(json.dumps(doc))
        rc = cli.main([str(path)])
        assert rc == (1 if tag == "jax" and name != "envelope" else 0)
        outs.append(json.loads((tmp_path / f"{name}-{tag}.res.json")
                               .read_text()))
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    j, t = outs
    assert list(t) == list(j)
    for key, value in j.items():
        if isinstance(value, (bool, str, int)) or value is None:
            assert t[key] == value, key
    bound = GL_DOCUMENT_RTOL if "green" in name else TRANSIENT_RTOL
    for key in ("displacements", "max_stress", "times"):
        assert rel_err(t[key], j[key]) <= bound, key


GUARDS = {
    "newmark": dict(method="newmark", dt=0.1, amplitudes=[[1.0] * 10]),
    "shape": dict(amplitudes=[[1.0] * 9]),
    "prestress": dict(prestress=True, amplitudes=[[1.0] * 10]),
    "checkpoint": dict(checkpoint={"dir": "x", "every": 5},
                       amplitudes=[[1.0] * 10]),
    "envelope_newmark": dict(method="newmark", dt=0.1,
                             include_stress_envelope=True),
    "envelope_prestress": dict(prestress=True,
                               include_stress_envelope=True),
    "serialization": dict(amplitudes=[[1.0] * 10] * 200,
                          probe_dofs=list(range(48))),
    "probe_elements": dict(probe_elements=[0], amplitudes=[[1.0] * 10]),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_ensemble_guards_raise_jax_messages(name):
    """Each guard of the ensemble and the envelope raises the JAX
    package's ValueError, word for word."""
    doc = eg.transient_grid_document(4, 6)
    analysis = dict(doc["analysis"], n_steps=10, record_every=1)
    analysis.update(GUARDS[name])
    msgs = []
    for parse, run, kw in ((j_parse, j_run_analysis, {}),
                           (parse_problem_dict, run_analysis,
                            {"device": CPU})):
        problem = parse(doc).problem
        with pytest.raises(ValueError) as err:
            run(problem, analysis, **kw)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("fn", ["solve_nr_batched", "solve_gd_batched",
                                "solve_gd_batched_incremental",
                                "solve_transient_batched"])
def test_mesh_refused(fn):
    _, tp = scalar_chains()
    args = ((tp, 0.1, 10) if fn == "solve_transient_batched"
            else (tp, tp.loads[None]))
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        getattr(tb, fn)(*args, mesh=object(), device=CPU)


def test_stack_thetas_takes_both_packages_leaves():
    """stack_thetas over B thetas of numpy (the JAX package's) or torch
    leaves: the theta's structure with a leading B axis."""
    jf = J.make_mlp_field(jax.random.PRNGKey(1), 2, 5, input_dim=3)
    th = [[tuple(np.asarray(t) for t in layer) for layer in jf.layers]]
    stacked = tb.stack_thetas([th, th, th])
    assert [[tuple(t.shape) for t in layer] for layer in stacked[0]] == \
        [[(3,) + np.shape(t) for t in layer] for layer in th[0]]
    again = tb.stack_thetas([[[tuple(torch.from_numpy(np.array(t))
                                     for t in layer)
                               for layer in net] for net in th]] * 2)
    assert torch.equal(again[0][0][0][1], stacked[0][0][0][0])
