"""Measure the port's agreement with the JAX package on the CPU: the
numbers behind the bounds of tests/test_torch_gd.py,
tests/test_torch_material.py and tests/test_torch_second_order.py, and
the float32 drift of the GD and full-NR trajectories.

    JAX_PLATFORMS=cpu python tests/measure_torch_agreement.py [part ...]

Parts (all by default), one JSON line each:
  corpus  the eight NN corpus documents on JAX's weights, port vs JAX:
          iteration counts, u, reactions, final-row columns, nn_parameters
          and identified properties;
  grid    100 GD rows of the 8 x 16 PINN grid, port vs JAX;
  grad    the twin's autograd against jax.grad (test_torch_material.py);
  drift   two port runs of the 100 x 200 PINN grid on the CPU, 50 rows,
          whose measured data differ by one float32 ulp;
  second_order  full-NR example9 / example10 through both CLIs (u,
          nn_parameters, the last row against its column's largest value
          in the increment, each increment's rows), example9 cold started,
          gn on example2 / example3 / example7, H and g at one z of
          example10, and 5 full-NR rows of the 4 x 8 PINN grid, port vs
          JAX;
  fnr_drift  two port runs of the PINN grid as a full-NR document on the
          CPU, 3 rows, whose measured data differ by one float32 ulp
          (grid size from argv: fnr_drift=16x32; 8 x 16 by default).
Not collected by pytest (no test_ prefix).  fnr_drift imports no JAX, so
it also runs where JAX is not installed.
"""

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]



def rel_max(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def corpus():
    import test_torch_gd as G

    for name in ("example3", "example3-P", "example4", "example4-P",
                 "example6", "example6-P", "example7", "example7-P"):
        doc = json.loads((G.CORPUS / f"{name}.json").read_text())
        jp, tp = G.parse_both(doc)
        jr = G.j_solve(jp.problem, jp.config, jp.measured_disp,
                       jp.measured_dofs, verbose=False)
        tr = G.solve(tp.problem, tp.config, tp.measured_disp,
                     tp.measured_dofs, verbose=False, device="cpu")
        hj, ht = jr.history[-1], tr.history[-1]
        oj = G.j_output(jr, jp.problem)
        ot = G.result_to_output_dict(tr, tp.problem)
        print(json.dumps({
            "part": "corpus", "document": name,
            "converged": [jr.converged, tr.converged],
            "iterations": [len(jr.history), len(tr.history)],
            "u_abs": float(np.abs(tr.displacements - jr.displacements).max()),
            "reactions_abs": float(np.abs(tr.reactions - jr.reactions).max()),
            "final_row_rel": {k: abs(ht[k] - hj[k]) / max(abs(hj[k]), 1e-30)
                              for k in G.ROW_RTOL},
            "nn_parameters_rel": rel_max(G.numbers(ot["nn_parameters"]),
                                         G.numbers(oj["nn_parameters"])),
            "identified_rel": rel_max(
                G.numbers(ot["identified_properties"]),
                G.numbers(oj["identified_properties"])),
        }), flush=True)


def history_array(result):
    keys = list(result.history[0])
    return keys, np.array([[e[k] for k in keys] for e in result.history])


def column_drift(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b).max(axis=0), 1e-30))


def grid():
    import test_torch_gd as G

    doc = G.pinn_grid_document(8, 16, max_iterations=100)
    jp, tp = G.parse_both(doc)
    jr = G.j_solve_gd(jp.problem, jp.config, jp.measured_disp,
                      jp.measured_dofs)
    tr = G.solve_gd(tp.problem, tp.config, tp.measured_disp,
                    tp.measured_dofs, device="cpu")
    keys, hj = history_array(jr)
    _, ht = history_array(tr)
    print(json.dumps({
        "part": "grid", "rows": len(ht),
        "column_rel": dict(zip(keys, column_drift(ht, hj).max(axis=0)
                               .tolist())),
        "u_rel": rel_max(tr.displacements, jr.displacements)}), flush=True)


def grad():
    import test_torch_material as M

    for hidden in (1, 2):
        worst = []

        def spy(got, want, rtol=0, atol=0, **kw):
            worst.append((np.abs(np.asarray(got) - np.asarray(want)).max(),
                          np.abs(np.asarray(want)).max()))

        real = M.np.testing.assert_allclose
        M.np.testing.assert_allclose = spy
        try:
            M.test_twin_autograd_matches_jax_grad(hidden)
        finally:
            M.np.testing.assert_allclose = real
        scale = max(w for _, w in worst)
        print(json.dumps({"part": "grad", "hidden_layers": hidden,
                          "rel_to_max_grad": float(max(e for e, _ in worst)
                                                   / scale)}),
              flush=True)


def drift(rows: int = 50):
    import test_torch_gd as G

    from pinn_fem_tpu_torch.io.schema import parse_problem_dict

    doc = G.pinn_grid_document(100, 200, max_iterations=rows)
    runs = []
    for factor in (1.0, 1.0 + 2.0 ** -23):
        p = parse_problem_dict(doc)
        measured = (np.asarray(p.measured_disp, np.float32)
                    * np.float32(factor)).astype(float)
        runs.append(history_array(G.solve_gd(
            p.problem, p.config, measured, p.measured_dofs, device="cpu")))
    keys, a = runs[0]
    err = column_drift(runs[1][1], a)
    print(json.dumps({"part": "drift", "rows": rows,
                      "column_rel": dict(zip(keys, err.max(axis=0).tolist())),
                      "row5_max": float(err[5].max())}), flush=True)


class increment_histories:
    """Each increment's history from module.solve_full_nr, while in the
    with block."""

    def __init__(self, module):
        self.module, self.inner, self.histories = (
            module, module.solve_full_nr, [])

    def __enter__(self):
        def spy(*args, **kwargs):
            result = self.inner(*args, **kwargs)
            self.histories.append(result.history)
            return result

        self.module.solve_full_nr = spy
        return self.histories

    def __exit__(self, *exc):
        self.module.solve_full_nr = self.inner


def second_order():
    import tempfile

    import test_torch_second_order as S

    def last_row_rel(hj, ht):
        return {k: abs(ht[-1][k] - hj[-1][k])
                / max(max(abs(e[k]) for e in hj), 1e-30) for k in hj[-1]}

    with tempfile.TemporaryDirectory() as tmp:
        for name in ("example9.json", "example10.json"):
            d = Path(tmp) / name.split(".")[0]
            d.mkdir()
            doc = json.loads((S.CORPUS / name).read_text())
            with increment_histories(S.j_driver) as hj, \
                    increment_histories(S.t_driver) as ht:
                j, t = S.both_clis(d, name, doc)
            print(json.dumps({
                "part": "second_order", "document": name,
                "converged": [j["converged"], t["converged"]],
                "rows": [[len(h) for h in hj], [len(h) for h in ht]],
                "free_residual": S.free_residual_norm(doc, t),
                "u_rel": rel_max(t["displacements"], j["displacements"]),
                "nn_parameters_rel": rel_max(S.flat_parameters(t),
                                             S.flat_parameters(j)),
                "last_row_rel_to_column": last_row_rel(j["history"],
                                                       t["history"])}),
                flush=True)

        doc = json.loads((S.CORPUS / "example9.json").read_text())
        jp, tp = S.j_parse(doc), S.parse_problem_dict(doc)
        for p in (jp, tp):
            p.config.nr_warm_start = False
        with increment_histories(S.j_driver) as hj, \
                increment_histories(S.t_driver) as ht:
            jr = S.j_solve(jp.problem, jp.config, verbose=False)
            tr = S.solve(tp.problem, tp.config, verbose=False, device="cpu")
        print(json.dumps({
            "part": "second_order", "document": "example9 cold start",
            "rows": [[len(h) for h in hj], [len(h) for h in ht]],
            "last_increment_free_residuals": [
                [(2.0 * e["loss_physics"]) ** 0.5 for e in h[-1]]
                for h in (hj, ht)],
            "u_rel": rel_max(tr.displacements, jr.displacements)}),
            flush=True)

        for name in ("example2.json", "example3.json", "example7.json"):
            d = Path(tmp) / ("gn_" + name.split(".")[0])
            d.mkdir()
            doc = json.loads((S.CORPUS / name).read_text())
            doc.setdefault("solver_config", {})["method"] = "gn"
            doc["pinn_config"]["max_iterations"] = 100
            j, t = S.both_clis(d, name, doc)
            print(json.dumps({
                "part": "second_order", "document": f"gn {name}",
                "converged": [j["converged"], t["converged"]],
                "rows": [j["iterations"], t["iterations"]],
                "u_abs": float(np.abs(np.subtract(t["displacements"],
                                                  j["displacements"])).max()),
                "nn_parameters_rel": (rel_max(S.flat_parameters(t),
                                              S.flat_parameters(j))
                                      if "nn_parameters" in j else None)}),
                flush=True)

        h_gap, g_gap = S.hessian_gaps()
        print(json.dumps({"part": "second_order",
                          "document": "example10 H and g at lf 0.1",
                          "hessian_rel": h_gap, "gradient_rel": g_gap}),
              flush=True)

        d = Path(tmp) / "grid"
        d.mkdir()
        doc = S.pinn_grid_document(4, 8, max_iterations=5)
        doc["solver_config"]["method"] = "full-nr"
        j, t = S.both_clis(d, "grid.json", doc)
        keys = list(j["history"][0])
        hj = np.array([[e[k] for k in keys] for e in j["history"]])
        ht = np.array([[e[k] for k in keys] for e in t["history"]])
        print(json.dumps({
            "part": "second_order", "document": "pinn grid 4x8 full-nr",
            "rows": [len(hj), len(ht)],
            "entry_rel": float((np.abs(ht - hj)
                                / np.maximum(np.abs(hj), 1e-30)).max())}),
            flush=True)


def fnr_drift(size: str = "8x16", rows: int = 3):
    """Two CPU runs of the grid's full-NR rows, measured data 1 ulp
    apart."""
    from pinn_fem_tpu_torch.examples_grid import pinn_grid_document
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict
    from pinn_fem_tpu_torch.solvers.full_newton import solve_full_nr

    r, c = (int(v) for v in size.split("x"))
    doc = pinn_grid_document(r, c, max_iterations=rows)
    doc["solver_config"]["method"] = "full-nr"
    runs = []
    for factor in (1.0, 1.0 + 2.0 ** -23):
        p = parse_problem_dict(doc)
        measured = (np.asarray(p.measured_disp, np.float32)
                    * np.float32(factor)).astype(float)
        runs.append(history_array(solve_full_nr(
            p.problem, p.config, measured, p.measured_dofs, device="cpu")))
    keys, a = runs[0]
    err = column_drift(runs[1][1], a)
    print(json.dumps({"part": "fnr_drift", "grid": size, "rows": rows,
                      "column_rel": dict(zip(keys, err.max(axis=0).tolist())),
                      "row_max": err.max(axis=1).tolist()}), flush=True)


if __name__ == "__main__":
    parts = {"corpus": corpus, "grid": grid, "grad": grad, "drift": drift,
             "second_order": second_order, "fnr_drift": fnr_drift}
    for part in sys.argv[1:] or list(parts):
        name, _, arg = part.partition("=")
        parts[name](*([arg] if arg else []))
