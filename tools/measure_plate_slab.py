"""CPU measurements of the plate family's float32 tiers (the twins).

    python tools/measure_plate_slab.py [--sizes 32 64] [--plastic R..]
        [--jax]

For each n, dyn-plate.json refined to an n x n slab of thickness 0.02
(hard simply supported, q = -1000) through solve_plate_static_banded at
tol 1e-7 on the CPU (the kernels' plain twins): the Jacobi iterations, u
against scipy float64 solves of the same float32 diagonals and of the
float64 operator, and the centre deflection against mindlin_navier_w.
--plastic R.. adds dyn-plate-plastic.json's strip refined R times: the
device tier in float32 and in float64 against the float64 tier, by step
(residuals, iterations, yielding elements, the u gap); --jax adds the JAX
package's float32 device tier (run with JAX_PLATFORMS=cpu).  One line of
JSON each.

    JAX_PLATFORMS=cpu python tools/measure_plate_slab.py --sizes \
        --plastic 1 2 4 --jax
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

from pinn_fem_tpu_torch.io.plate_io import parse_plate_document  # noqa: E402
from pinn_fem_tpu_torch.models import plate as PL  # noqa: E402


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


def solve64(k, f, free):
    import scipy.sparse.linalg as spl

    u = np.zeros(f.size)
    u[free] = spl.spsolve(k[free][:, free].tocsc(), f[free])
    return u


def slab(n: int, t: float = 0.02) -> dict:
    doc = json.loads((ROOT / "examples" / "json" / "dyn-plate.json")
                     .read_text())
    doc["mesh"].update(nx=n, ny=n)
    doc["material"]["thickness"] = t
    problem = parse_plate_document(doc)[0]
    t0 = time.perf_counter()
    res, iters, rel = PL.solve_plate_static_banded(problem, tol=1e-7,
                                                   device="cpu")
    seconds = time.perf_counter() - t0
    layout, diags, _ = PL._banded_operator(problem, torch.float32, "cpu")
    diags64 = PL._banded_operator(problem, torch.float64, "cpu")[1]
    f = PL._static_loads(problem, "cpu").numpy()
    free = problem.free_dofs()
    u_same = solve64(csr64(layout, diags), f, free)
    u64 = solve64(csr64(layout, diags64), f, free)
    u = res.displacements
    scale = np.abs(u64).max()
    centre = (n // 2) * (n + 1) + n // 2
    w_ex = PL.mindlin_navier_w(1.0, 1.0, 0.5, 0.5, -1000.0, 2e11, 0.3, t)
    return {"n": n, "ndof": problem.ndof, "n_diags": layout.n_diags,
            "bandwidth": layout.bandwidth, "iterations": iters,
            "relative_residual": rel, "cpu_s": seconds,
            "u_gap_vs_same_system": float(np.abs(u - u_same).max() / scale),
            "u_gap_vs_float64": float(np.abs(u - u64).max() / scale),
            "float32_floor": float(np.abs(u_same - u64).max() / scale),
            "navier_err": float(abs(u[3 * centre] - w_ex) / abs(w_ex))}


def _tier(res, f64) -> dict:
    gap = (np.abs(res.displacements - f64.displacements).max(axis=1)
           / np.abs(f64.displacements).max(axis=1))
    return {"converged": bool(res.converged),
            "residuals": np.asarray(res.residuals).tolist(),
            "iterations": np.asarray(res.iterations).tolist(),
            "n_plastic": np.asarray(res.n_plastic).tolist(),
            "u_gap_vs_float64_by_step": gap.tolist()}


def plastic_strip(refine: int, with_jax: bool) -> dict:
    """dyn-plate-plastic.json's strip refined `refine` times (16 r x r
    elements): the float64 tier (host=True), the port's device tier in
    float32 and in float64 (PINN_FEM_TPU_X64=1), and with_jax the JAX
    package's device tier (float32), each step's residual, iterations,
    yielding elements and u gap against the float64 tier."""
    import os

    from pinn_fem_tpu_torch.solvers.plate_plasticity import \
        solve_plate_plastic

    doc = json.loads((ROOT / "examples" / "json" / "dyn-plate-plastic.json")
                     .read_text())
    doc["mesh"].update(nx=16 * refine, ny=refine)
    problem, an = parse_plate_document(doc)
    kw = dict(sigma_y=an["sigma_y"], n_layers=an["n_layers"],
              load_factors=an["load_factors"])
    out = {"document": "dyn-plate-plastic", "refine": refine,
           "ndof": problem.ndof}
    t0 = time.perf_counter()
    f64 = solve_plate_plastic(problem, host=True, **kw)
    out["float64"] = dict(_tier(f64, f64), cpu_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    f32 = solve_plate_plastic(problem, host=False, device="cpu", **kw)
    out["device_float32"] = dict(_tier(f32, f64),
                                 cpu_s=time.perf_counter() - t0)
    os.environ["PINN_FEM_TPU_X64"] = "1"
    try:
        x64 = solve_plate_plastic(problem, host=False, device="cpu", **kw)
    finally:
        del os.environ["PINN_FEM_TPU_X64"]
    out["device_float64"] = _tier(x64, f64)
    if with_jax:
        from pinn_fem_tpu.io.plate_io import parse_plate_document as jparse
        from pinn_fem_tpu.solvers.plate_plasticity import \
            solve_plate_plastic as jax_plastic

        t0 = time.perf_counter()
        jax32 = jax_plastic(jparse(doc)[0], host=False, **kw)
        out["jax_device_float32"] = dict(_tier(jax32, f64),
                                         cpu_s=time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[32, 64])
    ap.add_argument("--plastic", type=int, nargs="*", default=None,
                    metavar="R", help="refinements of dyn-plate-plastic's "
                    "strip (bare: 1)")
    ap.add_argument("--jax", action="store_true",
                    help="add the JAX package's float32 device tier "
                    "(JAX_PLATFORMS=cpu)")
    args = ap.parse_args()
    for n in args.sizes:
        print(json.dumps(slab(n)), flush=True)
    for r in ([] if args.plastic is None else args.plastic or [1]):
        print(json.dumps(plastic_strip(r, args.jax)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
