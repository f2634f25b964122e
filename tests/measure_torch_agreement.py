"""Measure the port's agreement with the JAX package on the CPU: the
numbers behind the bounds of tests/test_torch_gd.py and
tests/test_torch_material.py, and the float32 drift of the GD trajectory.

    JAX_PLATFORMS=cpu python tests/measure_torch_agreement.py [part ...]

Parts (all by default), one JSON line each:
  corpus  the eight NN corpus documents on JAX's weights, port vs JAX:
          iteration counts, u, reactions, final-row columns, nn_parameters
          and identified properties;
  grid    100 GD rows of the 8 x 16 PINN grid, port vs JAX;
  grad    the twin's autograd against jax.grad (test_torch_material.py);
  drift   two port runs of the 100 x 200 PINN grid on the CPU, 50 rows,
          whose measured data differ by one float32 ulp.
Not collected by pytest (no test_ prefix).
"""

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import test_torch_gd as G  # noqa: E402
import test_torch_material as M  # noqa: E402


def rel_max(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def corpus():
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


if __name__ == "__main__":
    parts = {"corpus": corpus, "grid": grid, "grad": grad, "drift": drift}
    for part in sys.argv[1:] or list(parts):
        parts[part]()
