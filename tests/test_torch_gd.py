"""The port's GD and hybrid solvers against the JAX package, on the CPU.

Scalar documents go through both CLIs' `run()` and must give the pinned
history lengths of tests/test_examples_e2e.py:45-60.  NN documents run at
the solver level with the weights JAX drew (handed over through
material_from_numpy); their bounds are the measured differences times a
margin (PERF.md lists both).  tests/test_torch_prng.py holds the port's
own draw, and both CLIs with no weights passed, against JAX.
A small PINN grid runs kernel 4's dispatch (on the CPU: its twin) through
100 GD iterations beside the JAX solver.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.results import result_to_output_dict as j_output  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu.solvers.driver import solve as j_solve  # noqa: E402
from pinn_fem_tpu.solvers.gd import solve_gd as j_solve_gd  # noqa: E402
import pinn_fem_tpu_torch as T  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.examples_grid import pinn_grid_document  # noqa: E402
from pinn_fem_tpu_torch.io.results import result_to_output_dict  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import material_kernel  # noqa: E402
from pinn_fem_tpu_torch.solvers.driver import solve  # noqa: E402
from pinn_fem_tpu_torch.solvers.gd import solve_gd  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"

# tests/test_examples_e2e.py:29-36, 45-60.
ANALYTIC = {"example2.json": 4e-3, "example2-P.json": 4e-3,
            "example2-2.json": 4e-3, "example5.json": 2e-5,
            "example5-P.json": 2e-5, "example3.json": 2e-4,
            "example3-P.json": 2e-4, "example4.json": 2e-4,
            "example4-P.json": 2e-4, "example6-P.json": 2e-4,
            "example7.json": 2e-4, "example7-P.json": 2e-4}
PINNED = {"example2.json": 141, "example2-2.json": 33, "example2-P.json": 129,
          "example5.json": 1, "example5-P.json": 86,
          "example3.json": 139, "example3-P.json": 86, "example4.json": 114,
          "example4-P.json": 96, "example6-P.json": 86, "example7.json": 114,
          "example7-P.json": 96}

# Port against JAX on the same weights (measured on the CPU, max over the
# eight NN documents, PERF.md): u 3.6e-7 and reactions 4.8e-7 (absolute);
# final-row losses and residual norm 3.8e-3 relative (the losses sit near
# 1e-6, where float32 rounding of the last steps shows), u_norm 6.4e-8 and
# theta_norm 4.3e-7 relative; nn_parameters 1.3e-5 and identified
# properties 2.8e-7 of their largest entry.
U_ATOL = 2e-6
ROW_RTOL = {"loss_total": 2e-2, "loss_physics": 2e-2, "loss_data": 2e-2,
            "residual_norm": 2e-2, "u_norm": 1e-6, "theta_norm": 2e-6}
NN_RTOL, PROPS_RTOL = 1e-4, 2e-6


def analytic_ok(name, u):
    ux = np.asarray(u).reshape(-1, 2)[:, 0]
    expected = np.arange(len(ux), dtype=float)
    np.testing.assert_allclose(ux, expected,
                               atol=ANALYTIC[name] * max(1.0, expected[-1]))


@pytest.mark.parametrize("name", ["example2.json", "example2-2.json",
                                  "example2-P.json", "example5.json",
                                  "example5-P.json"])
def test_scalar_gd_and_hybrid_through_both_clis(tmp_path, name):
    outs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir()
        shutil.copy(CORPUS / name, d / name)
        outs.append(jax_cli.run(str(d / name)) if tag == "jax"
                    else torch_cli.run(str(d / name), device="cpu"))
    j, t = outs
    assert t["converged"] is True and j["converged"] is True
    assert t["iterations"] == j["iterations"] == PINNED[name]
    assert len(t["history"]) == PINNED[name]
    analytic_ok(name, t["displacements"])
    np.testing.assert_allclose(t["displacements"], j["displacements"],
                               rtol=0, atol=U_ATOL)
    np.testing.assert_allclose(t["reactions"], j["reactions"], rtol=0,
                               atol=U_ATOL)
    assert "nn_parameters" not in t and "identified_properties" not in t
    assert [set(e) for e in t["history"]] == [set(e) for e in j["history"]]
    for tj, tt in zip(j["history"], t["history"]):
        assert tt.get("iteration") == tj.get("iteration")


def jax_leaves(field):
    if isinstance(field, J.ScalarField):
        return np.asarray(field.value)
    return {"layers": [(np.asarray(w), np.asarray(b)) for w, b in field.layers],
            "scale": np.asarray(field.scale), "input_dim": field.input_dim,
            "enforce_positive": field.enforce_positive}


def parse_both(doc):
    """Both packages' parse of a document, the port's material replaced by
    the weights JAX drew."""
    jp, tp = j_parse(doc), parse_problem_dict(doc)
    m = jp.problem.material
    tp.problem.material = T.material_from_numpy(
        jax_leaves(m.young), jax_leaves(m.area), jax_leaves(m.density))
    return jp, tp


def numbers(tree):
    """Every number of a nested dict/list, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in numbers(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in numbers(v)]
    return [float(tree)] if isinstance(tree, (int, float)) else []


@pytest.mark.parametrize("name", ["example3.json", "example3-P.json",
                                  "example4.json", "example4-P.json",
                                  "example6.json", "example6-P.json",
                                  "example7.json", "example7-P.json"])
def test_nn_documents_match_jax_on_jax_weights(name):
    doc = json.loads((CORPUS / name).read_text())
    jp, tp = parse_both(doc)
    jr = j_solve(jp.problem, jp.config, jp.measured_disp, jp.measured_dofs,
                 verbose=False)
    tr = solve(tp.problem, tp.config, tp.measured_disp, tp.measured_dofs,
               verbose=False, device="cpu")
    # example6 (hybrid + NN, no preconditioning) fails in both, as in the
    # reference (tests/test_examples_e2e.py:37).
    assert tr.converged == jr.converged == (name != "example6.json")
    assert len(tr.history) == len(jr.history)
    if name in PINNED:
        assert len(tr.history) == PINNED[name]
        analytic_ok(name, tr.displacements)
    np.testing.assert_allclose(tr.displacements, jr.displacements, rtol=0,
                               atol=U_ATOL)
    np.testing.assert_allclose(tr.reactions, jr.reactions, rtol=0,
                               atol=U_ATOL)
    hj, ht = jr.history[-1], tr.history[-1]
    assert set(ht) == set(hj) and ht["iteration"] == hj["iteration"]
    for key, rtol in ROW_RTOL.items():
        np.testing.assert_allclose(ht[key], hj[key], rtol=rtol, err_msg=key)

    oj, ot = j_output(jr, jp.problem), result_to_output_dict(tr, tp.problem)
    assert list(ot["nn_parameters"]) == list(oj["nn_parameters"])
    for k, v in oj["nn_parameters"].items():
        assert np.shape(ot["nn_parameters"][k]) == np.shape(v), k
    pj = np.asarray(numbers(oj["nn_parameters"]))
    np.testing.assert_allclose(numbers(ot["nn_parameters"]), pj, rtol=0,
                               atol=NN_RTOL * np.abs(pj).max())
    ip_j, ip_t = oj["identified_properties"], ot["identified_properties"]
    assert json.dumps(ip_t, sort_keys=True).count("values") == \
        json.dumps(ip_j, sort_keys=True).count("values")
    for prop, entry in ip_j.items():
        assert ip_t[prop]["type"] == entry["type"]
        want = np.asarray(numbers(entry))
        np.testing.assert_allclose(numbers(ip_t[prop]), want, rtol=0,
                                   atol=PROPS_RTOL * np.abs(want).max())


# 100 rows of the 8 x 16 PINN grid: the port's history against JAX's,
# relative to each column's largest value, and u relative to max|u|
# (measured on the CPU: 4.5e-7 and 2.1e-7, PERF.md).
GRID_ROW_RTOL = 5e-6


def test_pinn_grid_runs_the_kernel_dispatch_beside_jax(monkeypatch):
    doc = pinn_grid_document(8, 16, max_iterations=100)
    jp, tp = parse_both(doc)
    assert material_kernel.fused_coefficients_supported(
        tp.problem.material, tp.problem.dimension)
    calls = []
    real = material_kernel.material_coefficients_reference

    def counting(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(material_kernel, "material_coefficients_reference",
                        counting)
    jr = j_solve_gd(jp.problem, jp.config, jp.measured_disp, jp.measured_dofs)
    tr = solve_gd(tp.problem, tp.config, tp.measured_disp, tp.measured_dofs,
                  device="cpu")
    nelm = tp.problem.nelm
    # One twin evaluation per GD iteration, one for the reactions.
    assert calls == [nelm] * 101
    assert len(tr.history) == len(jr.history) == 100
    assert not tr.converged and not jr.converged
    keys = list(jr.history[0])
    hj = np.array([[e[k] for k in keys] for e in jr.history])
    ht = np.array([[e[k] for k in keys] for e in tr.history])
    err = np.abs(ht - hj).max(axis=0) / np.abs(hj).max(axis=0)
    assert err.max() <= GRID_ROW_RTOL, dict(zip(keys, err))
    assert ht[-1, 1] < 0.2 * ht[0, 1]           # loss_total falls
    np.testing.assert_allclose(tr.displacements, jr.displacements, rtol=0,
                               atol=GRID_ROW_RTOL * np.abs(jr.displacements).max())


@pytest.mark.parametrize("name", ["example3.json", "example7-P.json",
                                  "pinn_grid"])
def test_parse_pinn_documents_match_jax(name):
    """pinn_config / solver_config precedence, the measured displacements
    and each NN field's shape (input_dim, widths, scale) as the JAX parser
    gives them."""
    import dataclasses

    doc = (pinn_grid_document(4, 6) if name == "pinn_grid"
           else json.loads((CORPUS / name).read_text()))
    jp, tp = j_parse(doc), parse_problem_dict(doc)
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)
    np.testing.assert_array_equal(tp.measured_dofs, jp.measured_dofs)
    np.testing.assert_array_equal(tp.measured_disp, jp.measured_disp)
    for prop in ("young", "area", "density"):
        jf, tf = getattr(jp.problem.material, prop), \
            getattr(tp.problem.material, prop)
        assert type(tf).__name__ == type(jf).__name__
        if isinstance(jf, J.MLPField):
            assert (tf.input_dim, tf.enforce_positive) == \
                (jf.input_dim, jf.enforce_positive)
            assert float(tf.scale) == float(jf.scale)
            assert [tuple(w.shape) for w, _ in tf.layers] == \
                [tuple(w.shape) for w, _ in jf.layers]
        else:
            assert tf.eval_scalar() == jf.eval_scalar()


def test_gd_keeps_theta_on_the_problem_device():
    """The GD driver moves theta to the problem arrays' device (a parsed
    material is built on the CPU) and leaves the trained material there."""
    doc = pinn_grid_document(3, 4, max_iterations=12)
    tp = parse_problem_dict(doc)
    data = tp.problem.to_device("cpu")
    res = solve_gd(tp.problem, tp.config, tp.measured_disp, tp.measured_dofs,
                   data=data)
    assert len(res.history) == 12
    params = tp.problem.material.trainable_params()
    assert len(params) == 18
    assert all(p.device == data.device and not p.requires_grad
               for p in params)
    assert set(res.nn_parameters) == {f"param_{i}" for i in range(18)}
    assert res.nn_parameters["param_0"].shape == (20, 3)   # torch (out, in)


def test_log_gd_progress_rows(caplog):
    from pinn_fem_tpu.utils.progress import log_gd_progress as j_log
    from pinn_fem_tpu_torch.utils.progress import log_gd_progress

    hist = [{"iteration": float(i), "loss_total": 1.0 / i,
             "loss_physics": 0.5 / i, "loss_data": 0.1, "u_norm": 2.0,
             "residual_norm": 1e-3, "theta_norm": 3.0} for i in range(1, 26)]
    hist.append({"load_factor": 1.0, "iterations": 2.0})   # NR entry: skipped
    lines = {}
    for tag, fn in (("jax", j_log), ("torch", log_gd_progress)):
        caplog.clear()
        with caplog.at_level("INFO"):
            fn(hist, 10)
        lines[tag] = [r.getMessage() for r in caplog.records]
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 2 + 4       # header, rule, 1, 10, 20, 25


def test_gd_and_hybrid_run_on_cpu_through_main(tmp_path, monkeypatch):
    """A PINN document through the port's main(): exit 0 on a run that
    does not converge, success false, the NN outputs written."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    doc = pinn_grid_document(3, 4, max_iterations=15)
    doc["solver_type"] = "pinn-hybrid"
    path = tmp_path / "pg.json"
    path.write_text(json.dumps(doc))
    assert torch_cli.main([str(path)]) == 0
    out = json.loads((tmp_path / "pg.res.json").read_text())
    log = (tmp_path / "pg.log").read_text()
    assert out["success"] is False and out["iterations"] == 15
    assert "Status: FAILED" in log and "[SUCCESS]" in log
    assert set(out["identified_properties"]) == {"young", "area", "density"}
    variations = out["identified_properties"]["young"]["load_factor_variations"]
    assert list(variations) == ["load_factor_0.2", "load_factor_0.5",
                                "load_factor_1.0"]
    assert torch.isfinite(torch.tensor(
        variations["load_factor_1.0"]["at_elements"]["values"])).all()
