"""The port's second-order methods against the JAX package, on the CPU:
full-NR with NN fields (corpus example9 and example10) and Gauss-Newton.

Both CLIs run the same documents; the port draws the same initial weights
as the JAX CLI (utils/prng.py), so nothing is handed over.  The bounds
are the measured differences times a margin (PERF.md lists both;
tests/measure_torch_agreement.py second_order prints them).  On the CPU
the value route (kernel 4's twin) and the torch form are the same torch
ops, so these tests hold the port's arithmetic; test_value_route_never_
transformed holds the rule that keeps kernel 4 out of torch.func on a
card.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import pinn_fem_tpu.solvers.driver as j_driver  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.ops.assembly import (  # noqa: E402
    internal_force_and_strain as j_internal_force)
from pinn_fem_tpu.solvers.driver import solve as j_solve  # noqa: E402
from pinn_fem_tpu.solvers.gd import (  # noqa: E402
    get_theta as j_get_theta, set_theta as j_set_theta)
from pinn_fem_tpu.utils.progress import (  # noqa: E402
    log_gd_progress as j_log_progress)
import pinn_fem_tpu_torch.solvers.driver as t_driver  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.examples_grid import pinn_grid_document  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops import assembly  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import material_kernel  # noqa: E402
from pinn_fem_tpu_torch.solvers import phases  # noqa: E402
from pinn_fem_tpu_torch.solvers.driver import solve  # noqa: E402
from pinn_fem_tpu_torch.solvers.full_newton import (  # noqa: E402
    initial_state, measurements_on)
from pinn_fem_tpu_torch.solvers.gd import get_theta, set_theta  # noqa: E402
from pinn_fem_tpu_torch.utils.progress import log_gd_progress  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"

# Full-NR, port vs JAX through both CLIs (measured on the CPU, example9 /
# example10): u 3.5e-7 / 7.2e-6 of max |u|; nn_parameters 2.2e-7 / 2.6e-6
# of their largest entry; the last row's columns 4.0e-6 / 5.9e-6 of the
# column's largest value in that increment (the last rows sit at the
# float32 floor, loss 1e-10 to 1e-8: relative to themselves they differ
# by up to 2.6e-2).
FNR_U_RTOL = 1e-4
FNR_NN_RTOL = 1e-4
FNR_ROW_RTOL = 1e-4
# The 4 x 8 PINN grid, 5 full-NR rows: 1.5e-5 of each entry (measured).
GRID_ROW_RTOL = 1e-4
# H and g at one z of example10 against jax.jacfwd(jax.grad(...)), of
# their largest entry (measured: 1.1e-7 and 6.6e-8).
HESS_RTOL = 1e-4
# Gauss-Newton u, as tests/test_fused.py:71-87 bounds it.
GN_U_ATOL = 5e-5
GN_KEYS = {"iteration", "r_physics", "r_data", "r_total", "relative_error",
           "step_size"}


def record_histories(monkeypatch, module, name):
    """Each increment's history, from the solver the driver calls."""
    histories = []
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        result = inner(*args, **kwargs)
        histories.append(result.history)
        return result

    monkeypatch.setattr(module, name, wrapped)
    return histories


def both_clis(tmp_path, name, doc):
    outs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir()
        path = d / name
        path.write_text(json.dumps(doc))
        outs.append(jax_cli.run(str(path)) if tag == "jax"
                    else torch_cli.run(str(path), device="cpu"))
    return outs


def flat_parameters(out):
    return np.concatenate([np.ravel(out["nn_parameters"][f"param_{i}"])
                           for i in range(len(out["nn_parameters"]))])


def free_residual_norm(doc, out, load_factor=1.0):
    """The port's ||(f_int - lf f)_free|| at the exported material and
    displacements."""
    parsed = parse_problem_dict(doc)
    problem = parsed.problem
    theta = get_theta(problem.material)
    flat = iter(torch.as_tensor(np.asarray(p, np.float32))
                for p in (out["nn_parameters"][f"param_{i}"]
                          for i in range(len(out["nn_parameters"]))))
    trained = [[(next(flat).T.contiguous(), next(flat)) for _ in layers]
               for layers in theta]
    material = set_theta(problem.material, trained)
    data = problem.to_device("cpu")
    u = torch.as_tensor(out["displacements"], dtype=torch.float32)
    f_int, _ = assembly.internal_force_and_strain(data, material, u,
                                                  load_factor)
    r = (f_int - load_factor * data.loads) * data.free_mask
    return float(torch.linalg.vector_norm(r))


@pytest.mark.parametrize("name,last_rows", [("example9.json", 4),
                                            ("example10.json", 3)])
def test_full_nr_corpus_through_both_clis(tmp_path, monkeypatch, name,
                                          last_rows):
    doc = json.loads((CORPUS / name).read_text())
    j_hists = record_histories(monkeypatch, j_driver, "solve_full_nr")
    t_hists = record_histories(monkeypatch, t_driver, "solve_full_nr")
    j, t = both_clis(tmp_path, name, doc)
    assert t["converged"] is j["converged"] is True
    assert free_residual_norm(doc, t) < 1e-5
    t_lengths = [len(h) for h in t_hists]
    assert t_lengths == [len(h) for h in j_hists] and len(t_lengths) == 10
    assert t_lengths[-1] == last_rows == t["iterations"] == j["iterations"]
    assert [set(e) for e in t["history"]] == [set(e) for e in j["history"]]
    uj, ut = np.asarray(j["displacements"]), np.asarray(t["displacements"])
    np.testing.assert_allclose(ut, uj, rtol=0,
                               atol=FNR_U_RTOL * np.abs(uj).max())
    for key in t["history"][-1]:
        col = np.abs([e[key] for e in j["history"]]).max()
        assert abs(t["history"][-1][key] - j["history"][-1][key]) \
            <= FNR_ROW_RTOL * col, key
    pj, pt = flat_parameters(j), flat_parameters(t)
    np.testing.assert_allclose(pt, pj, rtol=0,
                               atol=FNR_NN_RTOL * np.abs(pj).max())
    assert "identified_properties" in t


def test_full_nr_cold_start_matches_jax(monkeypatch):
    """example9 with nr_warm_start off: every increment starts from u = 0,
    as the JAX driver passes no warm start then.  An increment may take
    one row more or fewer than JAX's only where the extra row's ||R_free||
    lies within twice the tolerance: the stop at tol = 1e-6 then rests on
    float32 rounding (measured: the last increment, whose fourth row has
    ||R_free|| = 1.37e-6 in the port; JAX stopped before it)."""
    doc = json.loads((CORPUS / "example9.json").read_text())
    jp, tp = j_parse(doc), parse_problem_dict(doc)
    for p in (jp, tp):
        p.config.nr_warm_start = False
    starts = []
    inner = t_driver.solve_full_nr

    def wrapped(*args, **kwargs):
        starts.append(kwargs.get("u_initial"))
        return inner(*args, **kwargs)

    monkeypatch.setattr(t_driver, "solve_full_nr", wrapped)
    j_hists = record_histories(monkeypatch, j_driver, "solve_full_nr")
    t_hists = record_histories(monkeypatch, t_driver, "solve_full_nr")
    jr = j_solve(jp.problem, jp.config, jp.measured_disp, jp.measured_dofs,
                 verbose=False)
    tr = solve(tp.problem, tp.config, tp.measured_disp, tp.measured_dofs,
               verbose=False, device="cpu")
    assert starts == [None] * 10
    assert tr.converged is jr.converged is True
    assert len(t_hists) == len(j_hists) == 10
    for hj, ht in zip(j_hists, t_hists):
        longer = max(hj, ht, key=len)
        assert len(ht) == len(hj) or (
            abs(len(ht) - len(hj)) == 1
            and (2.0 * longer[-1]["loss_physics"]) ** 0.5 < 2 * 1e-6)
    np.testing.assert_allclose(
        tr.displacements, jr.displacements, rtol=0,
        atol=FNR_U_RTOL * np.abs(jr.displacements).max())


def example10_z(load_factor):
    """Both packages' parse of example10 and one z = [u_free, theta] (u
    from a seeded draw)."""
    doc = json.loads((CORPUS / "example10.json").read_text())
    jp, tp = j_parse(doc), parse_problem_dict(doc)
    free, _ = tp.problem.free_fixed()
    u_free = np.random.default_rng(3).uniform(0.0, 0.5, free.size)
    theta_flat, unravel = ravel_pytree(j_get_theta(jp.problem.material))
    z = np.concatenate([u_free, np.asarray(theta_flat)]).astype(np.float32)
    return jp, tp, free, z, unravel


def hessian_gaps(lf=0.1):
    """max |H - H_jax| / max |H_jax| and the same for g, at one z of
    example10, H_jax from jax.jacfwd(jax.grad(...)) of the loss built
    from the JAX package's public functions."""
    jp, tp, free, z, unravel = example10_z(lf)
    n_free = free.size
    data = jp.problem.to_device()

    def loss(zz):
        u = jnp.zeros(data.ndof, zz.dtype).at[free].set(zz[:n_free])
        mat = j_set_theta(jp.problem.material, unravel(zz[n_free:]))
        f_int, _ = j_internal_force(data, mat, u, lf)
        r = (f_int - lf * data.loads) * data.free_mask
        return 0.5 * jnp.sum(r * r)

    hj = np.asarray(jax.jacfwd(jax.grad(loss))(jnp.asarray(z)))
    gj = np.asarray(jax.grad(loss)(jnp.asarray(z)))

    tdata = tp.problem.to_device("cpu")
    space = phases.ZSpace(tdata, tp.problem.material, set_theta,
                          get_theta(tp.problem.material),
                          torch.as_tensor(free))
    objective = phases.FullNRLoss(space, lf, None, None, False)
    h, g = objective.hessian_and_gradient(torch.as_tensor(z))
    assert h.shape == (z.size, z.size) == (1001, 1001)
    return (float(np.abs(h.numpy() - hj).max() / np.abs(hj).max()),
            float(np.abs(g.numpy() - gj).max() / np.abs(gj).max()))


def test_hessian_and_gradient_match_jax():
    h_gap, g_gap = hessian_gaps()
    assert h_gap <= HESS_RTOL and g_gap <= HESS_RTOL


def lm_rule(z, g, h, loss0, loss_fn, lr):
    """JAX's full-NR LM step (pinn_fem_tpu/solvers/phases.py newton_step)
    in numpy float32: cho_factor(lower=True) reads the lower triangle and
    gives NaN where the factorization fails."""
    f32 = np.float32
    n = z.size
    lam0 = max(f32(1e-6) * f32(np.trace(h)) / f32(n), f32(1e-12))
    limit = f32(lam0 * f32(10.0 ** 16))
    lam, tries = f32(lam0), 0
    while lam < limit:
        a = np.tril(h + lam * np.eye(n, dtype=f32))
        try:
            chol = np.linalg.cholesky(a + np.tril(a, -1).T)
            dz = -np.linalg.solve(chol.T, np.linalg.solve(chol, g))
        except np.linalg.LinAlgError:
            dz = np.full(n, np.nan, f32)
        z_new = (z + dz).astype(f32)
        tries += 1
        if np.all(np.isfinite(z_new)) and loss_fn(z_new) < loss0:
            return z_new, tries
        lam = f32(lam * f32(10.0))
    return (z - lr * g).astype(f32), tries


@pytest.mark.parametrize("case", ["escalates", "falls_back"])
def test_lm_step_matches_jax_rule(case):
    """One LM step on an indefinite H whose upper triangle disagrees with
    its lower one: the Cholesky fails until lambda passes the negative
    eigenvalue; with a loss no step lowers, the gradient step."""
    rng = np.random.default_rng(11)
    n = 6
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    h = (q @ np.diag([-2.0, 0.5, 1.0, 3.0, 4.0, 8.0]) @ q.T).astype(np.float32)
    h += np.triu(rng.normal(size=(n, n)), 1).astype(np.float32)  # ignored
    z = rng.normal(size=n).astype(np.float32)
    lr = np.full(n, 0.01, np.float32)
    if case == "escalates":
        g = z.copy()   # the gradient of the loss below

        def loss_np(v):
            return float(0.5 * np.sum(v.astype(np.float64) ** 2))

        def loss_t(v):
            return (0.5 * torch.sum(v.double() ** 2)).float()
    else:
        g = rng.normal(size=n).astype(np.float32)

        def loss_np(v):
            return float(1.0 + np.sum((v.astype(np.float64) - z) ** 2))

        def loss_t(v):
            return (1.0 + torch.sum((v.double() - torch.as_tensor(z)) ** 2)
                    ).float()
    loss0 = np.float32(loss_np(z))
    want, want_tries = lm_rule(z, g, h, loss0, loss_np, lr)
    got, tries, accepted = phases.lm_step(torch.as_tensor(z), torch.as_tensor(g),
                                torch.as_tensor(h),
                                torch.as_tensor(loss0), loss_t,
                                torch.as_tensor(lr))
    assert tries == want_tries
    assert accepted == (tries < 16) == (case == "escalates")
    if case == "escalates":
        assert tries > 1   # the first tries fail to factor
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["example2.json", "example3.json",
                                  "example7.json"])
def test_gn_through_both_clis(tmp_path, name):
    """method gn with max_iterations 100 (tests/test_fused.py:71-87):
    example2 has a scalar material (theta empty), example3 one NN field,
    example7 three (kernel 4's fields)."""
    doc = json.loads((CORPUS / name).read_text())
    doc.setdefault("solver_config", {})["method"] = "gn"
    doc["pinn_config"]["max_iterations"] = 100
    j, t = both_clis(tmp_path, name, doc)
    assert t["converged"] is j["converged"] is True
    assert t["iterations"] == j["iterations"]
    assert set(t["history"][0]) == GN_KEYS
    assert [e["iteration"] for e in t["history"]] == \
        [float(k) for k in range(1, len(t["history"]) + 1)]
    np.testing.assert_allclose(t["displacements"], j["displacements"],
                               rtol=0, atol=GN_U_ATOL)
    assert ("nn_parameters" in t) == ("nn_parameters" in j) \
        == (name != "example2.json")


def test_pinn_grid_full_nr_rows_match_jax(tmp_path):
    doc = pinn_grid_document(4, 8, max_iterations=5)
    doc["solver_config"]["method"] = "full-nr"
    j, t = both_clis(tmp_path, "grid.json", doc)
    assert t["converged"] is j["converged"] is False
    assert len(t["history"]) == len(j["history"]) == 5
    keys = list(j["history"][0])
    hj = np.array([[e[k] for k in keys] for e in j["history"]])
    ht = np.array([[e[k] for k in keys] for e in t["history"]])
    np.testing.assert_allclose(ht, hj, rtol=GRID_ROW_RTOL, atol=1e-12)
    loss = hj[:, keys.index("loss_total")]
    assert np.all(np.diff(loss) < 0)


def test_full_nr_progress_table_equals_jax(caplog):
    rows = [{"iteration": k, "loss_total": 0.5 / (k + 1),
             "loss_physics": 0.25 / (k + 1), "loss_data": 0.25 / (k + 1),
             "grad_norm_u": 2.0 ** -k, "grad_norm_theta": 3.0 ** -k}
            for k in range(13)]
    with caplog.at_level(logging.INFO):
        j_log_progress(rows, 5)
        log_gd_progress(rows, 5)
    j_lines = [r.getMessage() for r in caplog.records
               if r.name.startswith("pinn_fem_tpu.")]
    t_lines = [r.getMessage() for r in caplog.records
               if r.name.startswith("pinn_fem_tpu_torch.")]
    assert len(t_lines) == 2 + 5   # header, rule; 0, 1, 5, 10, 12
    assert t_lines == j_lines


@pytest.mark.parametrize("name,method", [("example10.json", "full-nr"),
                                         ("example7.json", "gn")])
def test_value_route_never_transformed(monkeypatch, name, method):
    """Kernel 4's entry (its twin here) takes every value-only evaluation
    and is never called under torch.func, where the card's
    MaterialCoefficients would be refused."""
    calls = []
    inner = assembly.fused_material_coefficients

    def spy(data, material, load_factor):
        w = material.young.layers[0][0]
        calls.append(torch._C._functorch.is_functorch_wrapped_tensor(w))
        return inner(data, material, load_factor)

    monkeypatch.setattr(assembly, "fused_material_coefficients", spy)
    doc = json.loads((CORPUS / name).read_text())
    doc.setdefault("solver_config", {})["method"] = method
    doc.setdefault("pinn_config", {})["max_iterations"] = 100
    doc["solver_config"]["n_increments"] = 1
    tp = parse_problem_dict(doc)
    result = solve(tp.problem, tp.config, tp.measured_disp, tp.measured_dofs,
                   verbose=False, device="cpu")
    assert result.converged
    assert calls and not any(calls)


def test_kernel_autograd_function_is_refused_by_torch_func():
    """Why the second-order methods take the torch form: torch.func
    refuses MaterialCoefficients (no setup_context, jvp or vmap rule)
    before its forward runs, so the refusal shows on the CPU too."""
    doc = json.loads((CORPUS / "example10.json").read_text())
    problem = parse_problem_dict(doc).problem
    data = problem.to_device("cpu")
    fields = [getattr(problem.material, n) for n in material_kernel.FIELDS]
    params = torch.cat([p.reshape(-1) for f in fields
                        for p in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])
    widths = material_kernel._widths(problem.material)

    def s_sum(p):
        return material_kernel.MaterialCoefficients.apply(
            data.mid, data.inv_len, p, scales, 1.0, widths)[3].sum()

    with pytest.raises(RuntimeError, match="setup_context"):
        torch.func.grad(s_sum)(params)


def test_second_order_start_state():
    """z's unknowns: the free DOFs in ascending order (fixed DOFs of the
    warm start dropped), then theta in parameter order."""
    doc = json.loads((CORPUS / "example10.json").read_text())
    tp = parse_problem_dict(doc)
    data = tp.problem.to_device("cpu")
    u_in = np.arange(tp.problem.ndof, dtype=float) + 1.0
    free, u0 = initial_state(tp.problem, data, u_in)
    fixed = np.setdiff1d(np.arange(tp.problem.ndof), free.numpy())
    np.testing.assert_array_equal(free.numpy(), [2, 4, 6])
    assert np.all(u0.numpy()[fixed] == 0.0)
    np.testing.assert_array_equal(u0.numpy()[free.numpy()], u_in[[2, 4, 6]])
    space = phases.ZSpace(data, tp.problem.material, set_theta,
                          get_theta(tp.problem.material), free)
    z = space.pack(u0)
    assert z.numel() == 3 + 998
    theta_flat, _ = ravel_pytree(j_get_theta(j_parse(doc).problem.material))
    np.testing.assert_array_equal(z[3:].numpy(), np.asarray(theta_flat))
    assert measurements_on(data, None, None) == (False, None, None)


def test_full_nr_clock_sees_each_part():
    """The measurement hook chip_smoke.py uses: one call per part of each
    iteration, none on the converging one's LM part."""
    doc = json.loads((CORPUS / "example10.json").read_text())
    tp = parse_problem_dict(doc)
    data = tp.problem.to_device("cpu")
    free, u0 = initial_state(tp.problem, data, None)
    parts = []
    out = phases.full_nr_phase(
        data, tp.problem.material, set_theta, u0,
        get_theta(tp.problem.material), free, 0.1, None, None, False, 2,
        tp.config.tolerance, tp.config.full_nr_data_tolerance,
        tp.config.learning_rate_u, tp.config.learning_rate_theta,
        clock=parts.append)
    assert parts == ["loss", "gradient_and_hessian", "lm"] * 2
    assert len(out.hist) == len(out.accepted) == 2 and not out.converged
    assert out.host_syncs >= 2 + 2   # a row and at least one try each
