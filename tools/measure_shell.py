"""CPU measurements of the shell family (the kernels' plain twins).

    python tools/measure_shell.py [--roof N..] [--plastic] [--panel]
        [--guard] [--modal N..] [--jax]

--roof N..: dyn-shell.json's Scordelis-Lo roof refined to N x N through
solve_shell_static_banded (tol 1e-7): the Jacobi iterations, u against
scipy float64 solves of the same float32 diagonals and of the float64
operator, the midside free-edge deflection beside the float64 sparse
solutions of the dense tier's operator (drilling eps 1e-6) and the banded
tier's (1e-3).  --plastic: dyn-shell-plastic.json and its strip meshed 40
x 8 (above DENSE_DOF_LIMIT) on the float32 device tier against the float64
tier, by step.  --panel: the banded Marguerre Newton on the 8 x 16 shallow
panel of tests/test_shell_nonlinear.py against the float64 Newton.
--guard: the response spectrum's mechanism-guard ratio lambda_1 /
lambda_bound (refused below 1e-6) of the 4 x 4 roof (drilling rotations
free) and of cylindrical panels cantilevered from y = 0 with the global
theta_z held.  --modal N..: the roof's five lowest eigenvalues from the
congruence
through M's Cholesky factor (scipy.linalg.eigh(K, M), the JAX package's)
against the reciprocal pencil through K's (the port's).  --jax adds the
JAX package's runs where it has one (run with JAX_PLATFORMS=cpu).  One
line of JSON each.

    JAX_PLATFORMS=cpu python tools/measure_shell.py --roof 16 32 48 \
        --plastic --panel --modal 4 8 --jax
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pinn_fem_tpu_torch.io.shell_io import parse_shell_document  # noqa: E402
from pinn_fem_tpu_torch.models import shell as SH  # noqa: E402


def roof_document(n: int) -> dict:
    doc = json.loads((ROOT / "examples" / "json" / "dyn-shell.json")
                     .read_text())
    doc["mesh"].update(nx=n, ny=n)
    return doc


def csr64(layout, diags):
    import scipy.sparse as sp

    d = diags.double().cpu().numpy()
    n = layout.ndof
    rows, cols, vals = [], [], []
    for k, off in enumerate(layout.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(d[k, i])
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(n, n))


def blocks_csr(problem, blocks):
    import scipy.sparse as sp

    dm = problem.dof_map()
    rows = np.repeat(dm[:, :, None], 24, 2).ravel()
    cols = np.repeat(dm[:, None, :], 24, 1).ravel()
    return sp.csr_matrix((blocks.numpy().ravel(), (rows, cols)),
                         shape=(problem.ndof, problem.ndof))


def solve64(k, f, free):
    import scipy.sparse.linalg as spl

    u = np.zeros(f.size)
    u[free] = spl.spsolve(k[free][:, free].tocsc(), f[free])
    return u


def roof(n: int) -> dict:
    problem = parse_shell_document(roof_document(n))[0]
    mid = 6 * ((n // 2) * (n + 1) + n) + 2
    t0 = time.perf_counter()
    res, iters, rel = SH.solve_shell_static_banded(problem, device="cpu")
    seconds = time.perf_counter() - t0
    layout, diags, _ = SH._banded_operator(problem, torch.float32, "cpu")
    f = SH._static_loads(problem, "cpu").numpy()
    free = problem.free_dofs()
    u_same = solve64(csr64(layout, diags), f, free)
    u64 = solve64(csr64(layout, SH._banded_operator(
        problem, torch.float64, "cpu")[1]), f, free)
    dense_eps = solve64(blocks_csr(problem, SH._stiffness_blocks(
        problem, "cpu")), f, free)
    scale = np.abs(u64).max()
    u = res.displacements
    return {"roof": n, "ndof": problem.ndof, "n_diags": layout.n_diags,
            "bandwidth": layout.bandwidth, "iterations": iters,
            "relative_residual": rel, "s": seconds,
            "u_gap_vs_same_system": float(np.abs(u - u_same).max() / scale),
            "u_gap_vs_float64": float(np.abs(u - u64).max() / scale),
            "float32_representation_floor": float(
                np.abs(u_same - u64).max() / scale),
            "midside_w_float32": float(u[mid]),
            "midside_w_float64_banded_eps": float(u64[mid]),
            "midside_w_float64_dense_eps": float(dense_eps[mid])}


def plastic_strip_document(nx: int, ny: int) -> dict:
    doc = json.loads((ROOT / "examples" / "json" / "dyn-shell-plastic.json")
                     .read_text())
    xs, ys = np.linspace(0.0, 4.0, nx + 1), np.linspace(0.0, 1.0, ny + 1)
    doc["nodes"] = [[x, y, 0.0] for y in ys for x in xs]
    na = nx + 1
    doc["elements"] = [[j * na + i, j * na + i + 1, j * na + i + 1 + na,
                        j * na + i + na] for j in range(ny) for i in range(nx)]
    right = [j * na + nx for j in range(ny + 1)]
    w = np.full(ny + 1, 1.0 / ny)
    w[[0, -1]] = 0.5 / ny
    doc["point_loads"] = [[nd, 0, 15.0 * wi] for nd, wi in zip(right, w)] \
        + [[nd, 4, -0.5625 * wi] for nd, wi in zip(right, w)]
    return doc


def plastic(with_jax: bool):
    from pinn_fem_tpu_torch.solvers.shell_plasticity import \
        solve_shell_plastic

    for label, doc in (("corpus", json.loads(
            (ROOT / "examples" / "json" / "dyn-shell-plastic.json")
            .read_text())), ("strip_40x8", plastic_strip_document(40, 8))):
        problem = parse_shell_document(doc)[0]
        kw = dict(sigma_y=300.0, n_layers=20,
                  load_factors=doc["analysis"]["load_factors"])
        f64 = solve_shell_plastic(problem, host=True, **kw)
        runs = {"port": lambda: solve_shell_plastic(problem, host=False,
                                                    device="cpu", **kw)}
        if with_jax:
            from pinn_fem_tpu.io.shell_io import \
                parse_shell_document as j_parse
            from pinn_fem_tpu.solvers.shell_plasticity import \
                solve_shell_plastic as j_plastic

            jp = j_parse(doc)[0]
            runs["jax"] = lambda: j_plastic(jp, host=False, **kw)
        scale = np.abs(f64.displacements).max(axis=1)
        for who, run in runs.items():
            t0 = time.perf_counter()
            r = run()
            print(json.dumps({
                "plastic": label, "package": who, "ndof": problem.ndof,
                "s": time.perf_counter() - t0, "converged": r.converged,
                "iterations": np.asarray(r.iterations).tolist(),
                "residuals": np.asarray(r.residuals).tolist(),
                "n_plastic": np.asarray(r.n_plastic).tolist(),
                "n_plastic_float64": f64.n_plastic.tolist(),
                "u_gap_vs_float64_by_step": (
                    np.abs(r.displacements - f64.displacements).max(axis=1)
                    / scale).tolist()}), flush=True)


def panel(with_jax: bool) -> None:
    from pinn_fem_tpu_torch.solvers import shell_nonlinear as SN

    nodes, el = SH.cylinder_panel_mesh(25.0, 16.0, 15.0, 8, 16)
    ends = np.flatnonzero((nodes[:, 1] == 0.0) | (nodes[:, 1] == 16.0))
    kw = dict(nodes=nodes, elements=el, young=200e3, poisson=0.3,
              thickness=0.1, density=1.0, loads=np.zeros(6 * len(nodes)),
              fixed_dofs=(6 * ends[:, None] + np.arange(6)).ravel(),
              pressure=-0.15)
    problem = SH.ShellProblem(**kw)
    lfs = np.linspace(1.0 / 3.0, 1.0, 3)
    host = SN.solve_shell_nonlinear(problem, load_factors=lfs, tol=1e-10,
                                    device="cpu")
    scale = np.abs(host.displacements[-1]).max()
    runs = {"port": lambda: SN.solve_shell_nonlinear_banded(
        problem, load_factors=lfs, device="cpu")}
    if with_jax:
        import pinn_fem_tpu.models.shell as JS
        import pinn_fem_tpu.solvers.shell_nonlinear as JN

        jp = JS.ShellProblem(**kw)
        runs["jax"] = lambda: JN.solve_shell_nonlinear_banded(
            jp, load_factors=lfs)
    for who, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        print(json.dumps({
            "panel": "8x16", "package": who, "ndof": problem.ndof,
            "s": time.perf_counter() - t0, "converged": r.converged,
            "iterations": r.iterations.tolist(),
            "residuals": r.residuals.tolist(),
            "u_gap_vs_float64": float(np.abs(
                r.displacements[-1] - host.displacements[-1]).max()
                / scale)}), flush=True)


def modal(n: int) -> dict:
    import scipy.linalg

    problem = parse_shell_document(roof_document(n))[0]
    k, m = (a.numpy() for a in SH.shell_matrices(problem, device="cpu"))
    m = m + 1e-10 * np.diag(m).max() * np.eye(m.shape[0])
    free = problem.free_dofs()
    kf, mf = k[np.ix_(free, free)], m[np.ix_(free, free)]
    congruence = scipy.linalg.eigh(kf, mf, eigvals_only=True)[:5]
    reciprocal = 1.0 / scipy.linalg.eigh(mf, kf, eigvals_only=True)[::-1][:5]
    port = SH.shell_modal(problem, 5, device="cpu").eigenvalues
    return {"modal_roof": n, "ndof": problem.ndof,
            "cond_m": float(np.linalg.cond(mf)),
            "congruence_err": float(np.abs(congruence - reciprocal).max()
                                    / reciprocal.max()),
            "port_err": float(np.abs(port - reciprocal).max()
                              / reciprocal.max()),
            "eigenvalues": reciprocal.tolist()}


def guard() -> None:
    from pinn_fem_tpu_torch.solvers.continuum_spectrum import _family_of

    cases = {"roof_4x4_free": roof_document(4)}
    for nx, ny in ((8, 6), (16, 12)):
        cases[f"panel_{nx}x{ny}_theta_z_held"] = {
            "element_type": "shell",
            "mesh": {"type": "cylinder_panel", "radius": 25.0,
                     "length": 40.0, "half_angle_deg": 40.0, "nx": nx,
                     "ny": ny},
            "material": {"young": 4.32e8, "poisson": 0.2,
                         "thickness": 1.0, "density": 2.0},
            "supports": [{"nodes": "y_min", "dofs": [0, 1, 2, 3, 4, 5]},
                         {"nodes": list(range((nx + 1) * (ny + 1))),
                          "dofs": [5]}]}
    for name, doc in cases.items():
        problem = parse_shell_document(doc)[0]
        fam = _family_of(problem, torch.device("cpu"))
        om, _ = fam.modal(problem, 1)
        print(json.dumps({"guard": name, "ndof": problem.ndof,
                          "ratio": float(om[0] ** 2
                                         / fam.lam_bound(problem))}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roof", type=int, nargs="*", default=[])
    ap.add_argument("--plastic", action="store_true")
    ap.add_argument("--panel", action="store_true")
    ap.add_argument("--guard", action="store_true")
    ap.add_argument("--modal", type=int, nargs="*", default=[])
    ap.add_argument("--jax", action="store_true",
                    help="add the JAX package's runs")
    args = ap.parse_args()
    for n in args.roof:
        print(json.dumps(roof(n)), flush=True)
    if args.plastic:
        plastic(args.jax)
    if args.panel:
        panel(args.jax)
    if args.guard:
        guard()
    for n in args.modal:
        print(json.dumps(modal(n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
