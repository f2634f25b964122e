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
  truss_ext  thermal loads, support settlement and Green-Lagrange, port
          vs JAX (tests/test_torch_truss_extensions.py): f_th of each
          case, the Green-Lagrange element and assembly, the 24 x 48
          thermal / settlement documents through both CLIs (each against
          float64 too), example1 heated, the settled bar and the 4 x 8
          grid under large stretch.
  legacy  the legacy solvers, scalar identification and API CLIs, port
          vs JAX (tests/test_torch_legacy.py): u, reactions, history rows
          (first row and all, against each column's largest value),
          nn_parameters, E*A, iteration counts;
  x64     example1 / example2 / example7-P through both CLIs, both in
          float64 (tests/test_torch_x64.py): iterations, u, nn_parameters;
  gather  the gather-based PCG on shuffled grids, port vs JAX
          (tests/test_torch_gather.py): segment sums, K u, diag(K), the
          PCG, solve_nr(linear_solver="cg") plain / thermal / settlement,
          the shuffled 24 x 48 document through both CLIs (each against
          float64 too) and the RCM-reordered banded solve;
  checkpoint  resumes across the packages and the GD resume
          (tests/test_torch_checkpoint.py): u and theta gaps.
  dynamics  the truss dynamics, port vs JAX (tests/test_torch_dynamics.py):
          the mass and geometric ops, stable_dt of each case, each
          solve_transient case's history gaps, exact_restart, the
          checkpointed runs and the cross-package resumes, and the two
          documents through both CLIs (the grid's also against float64).
  mg      the banded multigrid, port vs JAX (tests/test_torch_mg.py): the
          building blocks, the 20 x 40 grid's and the chain's levels and
          Cholesky factor, one V-cycle, the MG-PCG, solve_nr(cg_precond=
          "mg") on the 16 x 32 grid at tol 1e-5 and 1e-4 (Newton counts,
          residuals, u; also the port on JAX-assembled diagonals), and
          both packages' Jacobi and MG PCG on the guided 2 x 2,000 and
          2 x 10,000 strips (MG capped at 200 iterations there) in float32
          against float64 (fault 3.14).
Not collected by pytest (no test_ prefix).  fnr_drift imports no JAX, so
it also runs where JAX is not installed.
"""

import json
import os
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


def truss_ext():
    import tempfile

    import torch

    import test_torch_truss_extensions as X

    def line(case, **fields):
        print(json.dumps({"part": "truss_ext", "case": case, **fields}),
              flush=True)

    for name in ("1d-scalar", "2d-per-node", "2d-per-element",
                 "3d-per-node", "ring-nelm-eq-nnode"):
        nodes, elements, dim, alpha, delta_t = X._thermal_case(name)
        j, t = X.problems(nodes, elements, np.zeros(dim * len(nodes)), [0],
                          dim)
        jd, td = j.to_device(), t.to_device("cpu")
        f_j = X.j_thermal.thermal_loads(
            jd, j.material, alpha, X.j_thermal.element_delta_t(
                jd, delta_t, len(nodes)))
        f_t = X.tp.thermal_loads(td, t.material, alpha,
                                 X.t_thermal.element_delta_t(
                                     td, delta_t, len(nodes)))
        line(f"f_th {name}", rel=rel_max(f_t.numpy(), np.asarray(f_j)))

    for dim in (2, 3):
        rng = np.random.default_rng(dim)
        x0 = rng.uniform(-1.0, 1.0, (64, 2, dim)).astype(np.float32)
        u_e = rng.uniform(-0.3, 0.3, (64, 2 * dim)).astype(np.float32)
        inv_len = (1.0 / np.linalg.norm(x0[:, 1] - x0[:, 0], axis=1)
                   ).astype(np.float32)
        e = rng.uniform(0.5, 2.0, 64).astype(np.float32)
        a = rng.uniform(0.5, 2.0, 64).astype(np.float32)
        want = X.j_elements.truss2d_green_lagrange_batch(x0, u_e, inv_len,
                                                         e, a)
        got = X.t_elements.truss2d_green_lagrange_batch(
            *(torch.from_numpy(v) for v in (x0, u_e, inv_len, e, a)))
        line(f"green-lagrange batch {dim}D",
             ke_fe_strain_rel=[rel_max(g.numpy(), np.asarray(w))
                               for g, w in zip(got, want)])

    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("thermal", "settlement", "settlement-only"):
            doc = X._grid_doc(kind)
            d = Path(tmp) / kind
            d.mkdir()
            j, t = X.run_both(d, "grid.json", doc)
            u64, r64, _, _ = X.eg.float64_reference(doc)
            line(f"grid 24x48 {kind}",
                 converged=[j["converged"], t["converged"]],
                 iterations=[j["history"][-1]["iterations"],
                             t["history"][-1]["iterations"]],
                 residual=[j["history"][-1]["residual"],
                           t["history"][-1]["residual"]],
                 u_port_vs_jax=rel_max(t["displacements"],
                                       j["displacements"]),
                 u_vs_float64=[rel_max(j["displacements"], u64),
                               rel_max(t["displacements"], u64)],
                 reactions_vs_float64=[rel_max(j["reactions"], r64),
                                       rel_max(t["reactions"], r64)])
        doc = json.loads((X.CORPUS / "example1.json").read_text())
        doc["thermal"] = {"alpha": 0.01, "delta_t": [0.0, 10.0, 20.0, 30.0]}
        d = Path(tmp) / "example1"
        d.mkdir()
        j, t = X.run_both(d, "example1.json", doc)
        line("example1 heated",
             u_rel=rel_max(t["displacements"], j["displacements"]),
             reactions_rel=rel_max(t["reactions"], j["reactions"]))

    up = np.zeros(6)
    up[-1] = X.DELTA
    jb, tb = X._settle_bar(6)
    u_j, r_j, _ = X._settle(jb, X.jp.solve_nr, up)
    u_t, r_t, _ = X._settle(tb, X.tp.solve_nr, up, device="cpu")
    line("settled bar", u_rel=rel_max(u_t, u_j),
         reactions_rel=rel_max(r_t, r_j))

    nodes, elements, loads, fixed = X.eg.grid_arrays(4, 8)
    j, t = X.problems(nodes, elements, loads * 0.3, fixed, 2)
    r_j = X.jp.solve_nr(j, X.jp.SolverConfig(max_iterations=50,
                                             tolerance=1e-6), 1.0,
                        geometric_nonlinear=True)
    r_t = X.tp.solve_nr(t, X.tp.SolverConfig(max_iterations=50,
                                             tolerance=1e-6), 1.0,
                        geometric_nonlinear=True, device="cpu")
    line("green-lagrange grid 4x8", history=[r_j.history[0],
                                             r_t.history[0]],
         u_rel=rel_max(r_t.displacements, r_j.displacements),
         reactions_rel=rel_max(r_t.reactions, r_j.reactions))


def printer(part: str):
    """A line(case, **fields) that prints one JSON line of `part`."""
    def line(case, **fields):
        print(json.dumps({"part": part, "case": case, **fields}),
              flush=True)
    return line


def legacy():
    import test_torch_legacy as L

    line = printer("legacy")
    J, T = L.J, L.T
    for kind in ("scalar", "frozen_nn"):
        pj, pt = L.both_chains(L.nn_material() if kind == "frozen_nn"
                               else None)
        rj = J.solve_incremental_newton(pj)
        rt = T.solve_incremental_newton(pt, device="cpu")
        line(f"incremental newton chain {kind}",
             u_rel=L.rel_err(rj.displacements, rt.displacements),
             reactions_rel=L.rel_err(rj.reactions, rt.reactions),
             iterations=[[e["iterations"] for e in r.history]
                         for r in (rj, rt)])
    jp, tp = L.grid_both()
    rj = J.solve_incremental_newton(jp.problem,
                                    J.LegacySolverConfig(n_increments=3))
    rt = T.solve_incremental_newton(tp.problem,
                                    T.LegacySolverConfig(n_increments=3),
                                    device="cpu")
    line("incremental newton 4x8 grid, frozen fields",
         u_rel=L.rel_err(rj.displacements, rt.displacements),
         iterations=[[e["iterations"] for e in r.history]
                     for r in (rj, rt)],
         residuals=[[e["residual"] for e in r.history] for r in (rj, rt)])
    for measured in (True, False):
        pj, pt = L.both_chains(L.nn_material())
        kw = L.MEASURED if measured else {}
        cfg = dict(max_iterations=300, learning_rate_u=0.01,
                   learning_rate_theta=1e-3)
        rj = J.solve_pinn_gradient_descent(
            pj, pj.loads, config=J.PINNGradientDescentConfig(**cfg), **kw)
        rt = T.solve_pinn_gradient_descent(
            pt, pt.loads, config=T.PINNGradientDescentConfig(**cfg),
            device="cpu", **kw)
        line(f"legacy gd chain, measured={measured}",
             first_row=L.rows_err(rj.history[:1], rt.history[:1]),
             rows=L.rows_err(rj.history, rt.history),
             u_rel=L.rel_err(rj.displacements, rt.displacements),
             nn_rel=max(L.rel_err(v, rt.nn_parameters[k])
                        for k, v in rj.nn_parameters.items()))
    pj, pt = L.both_chains(L.nn_material(seed=3))
    cfg = dict(max_iterations=50, alpha_physics=0.1, alpha_data=10.0)
    rj = J.solve_pinn_newton_raphson(pj, pj.loads,
                                     config=J.PINNSolverConfig(**cfg),
                                     **L.MEASURED)
    rt = T.solve_pinn_newton_raphson(pt, pt.loads,
                                     config=T.PINNSolverConfig(**cfg),
                                     device="cpu", **L.MEASURED)
    line("legacy gauss-newton chain", rows=[len(rj.history),
                                            len(rt.history)],
         rows_rel=L.rows_err(rj.history, rt.history),
         u_rel=L.rel_err(rj.displacements, rt.displacements))
    for method, kw in (("gn", dict(max_iterations=60, tolerance=1e-10)),
                       ("gd", dict(n_iterations=2000, learning_rate=3e-3,
                                   beta=1e3))):
        pj, pt = L.si_problem(J), L.si_problem(T)
        a = getattr(L.j_scalar, f"identify_scalars_{method}")(
            pj, pj.loads, **L.SI, **kw)
        b = getattr(L.scalar_inverse, f"identify_scalars_{method}")(
            pt, pt.loads, device="cpu", **L.SI, **kw)
        ea = [r["young_final"] * r["area_final"] for r in (a, b)]
        line(f"identify_scalars_{method} SI", ea=ea,
             ea_rel=abs(ea[1] - ea[0]) / ea[0],
             rows=[len(a["history"]), len(b["history"])],
             first_row=L.rows_err(a["history"][:1], b["history"][:1]))


def x64():
    import os
    import tempfile

    import jax

    import test_torch_x64 as X

    line = printer("x64")
    os.environ[X.X64_VARIABLE] = "1"
    with jax.enable_x64(True), tempfile.TemporaryDirectory() as tmp:
        for name in ("example1", "example2", "example7-P"):
            sub = Path(tmp) / name
            sub.mkdir()
            j, t = X.run_both(sub, name)
            nn = [X.rel_err(v, t["nn_parameters"][k])
                  for k, v in (j.get("nn_parameters") or {}).items()]
            line(f"x64 {name}", iterations=[j["iterations"],
                                            t["iterations"]],
                 u_rel=X.rel_err(j["displacements"], t["displacements"]),
                 nn_rel=max(nn) if nn else None)
    del os.environ[X.X64_VARIABLE]


def gather():
    import json as _json
    import logging
    import tempfile

    import jax.numpy as jnp
    import torch

    import test_torch_gather as G

    line = printer("gather")
    worst = 0.0
    for dim in (1, 2, 3):
        for seed in range(20):
            elements, ndof = G.random_mesh(dim, seed)
            dof_map = G.dof_map_of(elements, dim)
            gm = G.t_scatter.build_gather_map(dof_map, ndof)
            fe = np.random.default_rng(seed).standard_normal(
                dof_map.shape).astype(np.float32)
            ours = G.t_scatter.segment_sum_dofs(torch.from_numpy(fe),
                                                torch.from_numpy(gm))
            theirs = G.j_scatter.segment_sum_dofs(
                jnp.asarray(fe), jnp.asarray(gm), jnp.asarray(dof_map))
            worst = max(worst, rel_max(ours, theirs))
    line("segment_sum random meshes", rel=worst)

    doc = G.shuffled(10, 16)
    jpp, tpp = G.parsed_both(doc)
    jd, td = jpp.problem.to_device(), tpp.problem.to_device("cpu")
    rng = np.random.default_rng(0)
    u = rng.standard_normal(tpp.problem.ndof).astype(np.float32)
    s = rng.uniform(0.5, 2.0, tpp.problem.nelm).astype(np.float32)
    b = np.asarray(doc["loads"], np.float32)
    x_t, it_t, _ = G.t_cg.cg_solve(td, torch.from_numpy(s),
                                   torch.from_numpy(b), 1e-6, 5000)
    x_j, it_j, _ = G.j_cg.cg_solve(jd, jnp.asarray(s), jnp.asarray(b),
                                   tol=1e-6, max_iter=5000)
    line("operator 10x16",
         ku_rel=rel_max(G.t_cg.apply_stiffness(td, torch.from_numpy(s),
                                               torch.from_numpy(u)),
                        G.j_cg.apply_stiffness(jd, jnp.asarray(s),
                                               jnp.asarray(u))),
         diag_rel=rel_max(G.t_cg.stiffness_diagonal(td, torch.from_numpy(s)),
                          G.j_cg.stiffness_diagonal(jd, jnp.asarray(s))),
         pcg_iterations=[int(it_j), int(it_t)], x_rel=rel_max(x_t, x_j))

    for kind in ("plain", "thermal", "settlement"):
        doc = G.shuffled(12, 24, kind, seed=2)
        jpp, tpp = G.parsed_both(doc)
        r_j = G.jp.solve_nr(jpp.problem, G.jp.SolverConfig(tolerance=1e-5),
                            1.0, linear_solver="cg",
                            prescribed_u=jpp.prescribed)
        r_t = G.t_newton.solve_nr(tpp.problem,
                                  G.tp.SolverConfig(tolerance=1e-5), 1.0,
                                  linear_solver="cg",
                                  prescribed_u=tpp.prescribed, device="cpu")
        line(f"newton 12x24 {kind}",
             iterations=[r_j.history[0]["iterations"],
                         r_t.history[0]["iterations"]],
             u_rel=rel_max(r_t.displacements, r_j.displacements),
             reactions_rel=rel_max(r_t.reactions, r_j.reactions))

    doc = G.shuffled(24, 48, tolerance=1e-5, n_increments=2)
    u64 = G.eg.float64_solution(doc["nodes"], doc["elements"],
                                np.asarray(doc["loads"], float),
                                doc["fixed_dofs"])
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, cli in (("jax", G.jax_cli), ("torch", G.torch_cli)):
            path = Path(tmp) / f"{tag}.json"
            path.write_text(_json.dumps(doc))
            outs.append(cli.run(str(path)) if tag == "jax"
                        else cli.run(str(path), device="cpu"))
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    j, t = (np.asarray(o["displacements"], float).reshape(-1) for o in outs)
    line("cli 24x48 shuffled", converged=[o["converged"] for o in outs],
         iterations=[[h["iterations"] for h in o["history"]] for o in outs],
         port_vs_jax=rel_max(t, j), port_vs_f64=rel_max(t, u64),
         jax_vs_f64=rel_max(j, u64))

    doc = G.shuffled(24, 48, seed=6)
    _, tpp = G.parsed_both(doc)
    cfg = G.tp.SolverConfig(tolerance=1e-5)
    gathered = G.t_newton.solve_nr(tpp.problem, cfg, 1.0, device="cpu")
    p2, order = G.t_reorder.reorder_problem(tpp.problem)
    banded = G.t_newton.solve_nr(p2, cfg, 1.0, device="cpu")
    u_b = G.t_reorder.restore_field(banded.displacements.reshape(-1),
                                    order, 2)
    u64 = G.eg.float64_solution(doc["nodes"], doc["elements"],
                                np.asarray(doc["loads"], float),
                                doc["fixed_dofs"])
    line("rcm banded 24x48", u_rel_vs_gather=rel_max(
        u_b, gathered.displacements.reshape(-1)),
         u_rel_vs_f64=rel_max(u_b, u64),
         gather_vs_f64=rel_max(gathered.displacements.reshape(-1), u64))


def checkpoint():
    import json as _json
    import tempfile

    import test_torch_checkpoint as C

    line = printer("checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        for writer, reader, tag in ((C.jp, C.tp, "jax-to-port"),
                                    (C.tp, C.jp, "port-to-jax")):
            ckpt = str(Path(tmp) / tag)
            C._solve(writer, config=writer.SolverConfig(
                method="nr", n_increments=1, load_factor_final=0.5),
                checkpoint_dir=ckpt)
            resumed = C._solve(reader, config=reader.SolverConfig(
                method="nr", n_increments=2), checkpoint_dir=ckpt,
                resume=True)
            whole = C._solve(reader, config=reader.SolverConfig(
                method="nr", n_increments=2))
            line(f"nr resume {tag}", u_rel=rel_max(resumed.displacements,
                                                   whole.displacements))
        doc = _json.loads((C.CORPUS / "example3.json").read_text())
        doc["solver_config"] = {"n_increments": 2}

        def run(config=None, **kw):
            parsed = C.parse_problem_dict(doc)
            for key, value in (config or {}).items():
                setattr(parsed.config, key, value)
            res = C.tp.solve(parsed.problem, parsed.config,
                             parsed.measured_disp, parsed.measured_dofs,
                             verbose=False, device="cpu", **kw)
            return parsed.problem, res

        ckpt = str(Path(tmp) / "gd")
        run({"n_increments": 1, "load_factor_final": 0.5},
            checkpoint_dir=ckpt)
        resumed, r2 = run(checkpoint_dir=ckpt, resume=True)
        whole, r3 = run()
        theta = max(rel_max(a, b) for a, b in zip(
            C.leaves(C.get_theta(resumed.material)),
            C.leaves(C.get_theta(whole.material))))
        line("gd resume example3", u_rel=rel_max(r2.displacements,
                                                 r3.displacements),
             theta_rel=theta, rows=[len(r2.history), len(r3.history)])


def dynamics():
    import tempfile

    import test_torch_dynamics as D

    line = printer("dynamics")
    line("ops", **D.ops_gaps())
    for case in D.DT_CASES:
        j, t = D.stable_dt_pair(case)
        line(f"stable_dt {case}", rel=abs(t - j) / j)
    for case in D.CASES:
        line(f"transient {case}", **D.history_gaps(*D.transient_pair(case)))
    line("exact_restart", **D.exact_restart_gaps())
    os.environ["PINN_FEM_TORCH_DEVICE"] = "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        line("checkpoint", **D.checkpoint_gaps(Path(tmp)))
        for name, make in D.CLI_DOCS.items():
            j, t = D.cli_pair(Path(tmp), make(), name)
            line(f"cli {name}", **D.cli_gaps(j, t))
    line("grid24x48 vs float64", rel=D.grid_float64_gap())


def mg():
    import jax.numpy as jnp
    import torch

    import pinn_fem_tpu as jp
    import pinn_fem_tpu_torch as tp
    import test_torch_mg as M
    from pinn_fem_tpu.ops import dia as j_dia
    from pinn_fem_tpu.ops.cg import stiffness_coefficients as j_coeffs
    from pinn_fem_tpu.solvers import newton as j_newton
    from pinn_fem_tpu_torch import examples_grid as eg
    from pinn_fem_tpu_torch.ops import dia as t_dia
    from pinn_fem_tpu_torch.ops import mg as t_mg
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients as t_coeffs
    from pinn_fem_tpu_torch.solvers import newton as t_newton

    line = printer("mg")
    rng = np.random.default_rng(0)
    da, db = M.random_dia(rng), M.random_dia(rng)
    j = M.j_mg.dia_mul(M.OFFSETS, jnp.asarray(da), M.OFFSETS,
                       jnp.asarray(db), M.N)
    t = t_mg.dia_mul(M.OFFSETS, torch.as_tensor(da), M.OFFSETS,
                     torch.as_tensor(db), M.N)
    line("dia_mul", rel=rel_max(t[1], j[1]))
    for comp in (1, 2):
        d = M.random_dia(np.random.default_rng(1))
        j = M.j_mg.coarsen(M.OFFSETS, jnp.asarray(d), M.N, components=comp)
        t = t_mg.coarsen(M.OFFSETS, torch.as_tensor(d), M.N, components=comp)
        line(f"coarsen components={comp}", rel=rel_max(t[1], j[1]))

    ops = M.make_operators()
    jax_pcg = M.jax_grid_solve(ops)
    hier = M.make_hierarchies(ops, jax_pcg)
    for name, (jh, th) in hier.items():
        line(f"hierarchy {name}", levels=[
            [lvl.ndof, len(lvl.offsets), lvl.smoothed] for lvl in th.levels],
            level_rel=[rel_max(a.diags, np.asarray(b.diags))
                       for a, b in zip(th.levels, jh.levels)],
            chol_rel=rel_max(th.chol, np.tril(np.asarray(jh.chol))))
    jh, th = hier["grid20x40"]
    b = np.random.default_rng(5).normal(size=th.levels[0].ndof)
    b = b.astype(np.float32)
    line("v_cycle grid20x40", rel=rel_max(
        t_mg.v_cycle(th, torch.from_numpy(b)),
        np.asarray(M.j_mg.v_cycle(jh, jnp.asarray(b)))))
    op = ops["grid20x40"]
    x_j, it_j, _ = jax_pcg[1]
    args = (op["t_layout"], *M.t_args(op, "diags", "loads", "mask"))
    x_t, it_t, _ = t_dia.dia_cg_solve(*args, tol=1e-6, max_iter=20000,
                                      precond="mg", components=2)
    _, it_jac, _ = t_dia.dia_cg_solve(*args, tol=1e-6, max_iter=20000)
    line("mg pcg grid20x40", iterations=[int(it_t), int(it_j)],
         jacobi_iterations=int(it_jac), x_rel=rel_max(x_t, np.asarray(x_j)))

    def jax_assembled(layout, s, gvec):
        lay = j_dia.DiaLayout(offsets=layout.offsets,
                              entry_slot=layout.entry_slot.astype(np.int32),
                              ndof=layout.ndof, bandwidth=layout.bandwidth)
        return torch.as_tensor(np.array(j_dia.assemble_dia(
            lay, jnp.asarray(s.numpy()), jnp.asarray(gvec.numpy()))))

    for tol in (1e-5, 1e-4):
        jprob, tprob = M.grid_problems(16, 32)
        kw = dict(linear_solver="cg-dia", cg_precond="mg")
        want = j_newton.solve_nr(jprob, jp.SolverConfig(
            max_iterations=20, tolerance=tol), 1.0, **kw)
        got = t_newton.solve_nr(tprob, tp.SolverConfig(
            max_iterations=20, tolerance=tol), 1.0, device="cpu", **kw)
        assembled = t_dia.assemble_dia
        t_dia.assemble_dia = jax_assembled
        try:
            on_jax = t_newton.solve_nr(M.grid_problems(16, 32)[1],
                                       tp.SolverConfig(max_iterations=20,
                                                       tolerance=tol), 1.0,
                                       device="cpu", **kw)
        finally:
            t_dia.assemble_dia = assembled
        line(f"solve_nr mg 16x32 tol {tol}",
             newton=[got.history[0]["iterations"],
                     want.history[0]["iterations"],
                     on_jax.history[0]["iterations"]],
             residual=[got.history[0]["residual"],
                       want.history[0]["residual"],
                       on_jax.history[0]["residual"]],
             u_rel=rel_max(got.displacements, want.displacements))

    for length, mg_cap in ((2000, 200_000), (10_000, 200)):
        problem = eg.strip_problem(length)
        u_ref = eg.float64_solution(problem.nodes, problem.elements,
                                    problem.loads, problem.fixed_dofs)
        jprob = jp.TrussProblem(
            nodes=problem.nodes, elements=problem.elements,
            material=jp.Material(young=1.0, area=1.0, density=1.0),
            loads=problem.loads, fixed_dofs=problem.fixed_dofs, dimension=2)
        jd = jprob.to_device()
        j_layout = j_dia.dia_layout(np.asarray(jd.dof_map), jprob.ndof)
        j_diags = j_dia.assemble_dia(
            j_layout, j_coeffs(jd, jprob.material, 1.0), jd.gvec)
        td = problem.to_device("cpu")
        t_layout = t_dia.dia_layout(td.dof_map.numpy(), problem.ndof)
        t_diags = t_dia.assemble_dia(
            t_layout, t_coeffs(td, problem.material, 1.0), td.gvec)
        for precond in ("jacobi", "mg"):
            kw = dict(tol=1e-6, precond=precond, components=2,
                      max_iter=200_000 if precond == "jacobi" else mg_cap)
            xj, itj, rj = j_dia.dia_cg_solve(j_layout, j_diags,
                                             jnp.asarray(jd.loads),
                                             jd.free_mask, **kw)
            xt, itt, rt = t_dia.dia_cg_solve(t_layout, t_diags, td.loads,
                                             td.free_mask, **kw)
            line(f"strip 2x{length} {precond}", max_iter=kw["max_iter"],
                 iterations=[int(itt), int(itj)],
                 rel_residual=[float(rt), float(rj)],
                 x_rel_vs_float64=[rel_max(xt, u_ref),
                                   rel_max(np.asarray(xj), u_ref)])

if __name__ == "__main__":
    parts = {"corpus": corpus, "grid": grid, "grad": grad, "drift": drift,
             "second_order": second_order, "fnr_drift": fnr_drift,
             "truss_ext": truss_ext, "legacy": legacy, "x64": x64,
             "gather": gather, "checkpoint": checkpoint,
             "dynamics": dynamics, "mg": mg}
    for part in sys.argv[1:] or list(parts):
        name, _, arg = part.partition("=")
        parts[name](*([arg] if arg else []))
