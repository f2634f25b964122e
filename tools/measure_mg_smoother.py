"""Per-level smoother margin of the banded multigrid, and its PCG.

    python tools/measure_mg_smoother.py [ROWSxCOLS ...] [--device cpu|cuda]
                                         [--x64] [--iters N]

For each cross-braced grid (examples_grid.grid_problem; 354x707 by
default) builds the hierarchy of ops/mg.py and prints one JSON line per
level: ndof, diagonals, rho(D^-1 A) by N power iterations (200 by default)
and omega * rho.  Damped Jacobi with omega = 2/3 is a convergent smoother,
and the V-cycle positive definite, only while omega * rho < 2.  Then one
line with dia_cg_solve(precond="mg") at tol 1e-6 (iterations, relative
residual) and a check of the cycle's symmetry (a.Mb against b.Ma) and
sign (a.Ma) on seeded vectors.  --x64 runs in float64 (CPU only: the card's
kernel refuses float64).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("grids", nargs="*", default=["354x707"])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--x64", action="store_true")
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args()
    if args.x64:
        os.environ["PINN_FEM_TPU_X64"] = "1"

    import torch

    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops import mg
    from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
    from pinn_fem_tpu_torch.ops.dia import (assemble_dia, dia_cg_solve,
                                            dia_layout, dia_matvec)

    dev = torch.device(args.device)
    for grid in args.grids:
        rows, cols = (int(v) for v in grid.split("x"))
        problem = grid_problem(rows, cols)
        data = problem.to_device(dev)
        layout = dia_layout(data.dof_map.cpu().numpy(), problem.ndof)
        diags = assemble_dia(layout, stiffness_coefficients(
            data, problem.material, 1.0), data.gvec)
        h = mg.build_hierarchy(layout, diags, data.free_mask, components=2)
        gen = torch.Generator(device=dev).manual_seed(0)
        for li, lvl in enumerate(h.levels):
            v = torch.randn(lvl.ndof, generator=gen, device=dev,
                            dtype=diags.dtype)
            rho = 0.0
            for _ in range(args.iters):
                w = lvl.inv_diag * dia_matvec(lvl.layout, lvl.diags, v)
                rho = float(torch.linalg.vector_norm(w)
                            / torch.linalg.vector_norm(v))
                v = w / torch.linalg.vector_norm(w)
            print(json.dumps({"grid": grid, "level": li, "ndof": lvl.ndof,
                              "n_diags": len(lvl.offsets),
                              "smoothed": lvl.smoothed, "rho": rho,
                              "omega_rho": mg._OMEGA * rho}), flush=True)
        a, b = (torch.randn(problem.ndof, generator=gen, device=dev,
                            dtype=diags.dtype) * data.free_mask
                for _ in range(2))
        t0 = time.perf_counter()
        _, it, res = dia_cg_solve(layout, diags, data.loads, data.free_mask,
                                  tol=1e-6, max_iter=300, precond="mg",
                                  components=2)
        print(json.dumps({
            "grid": grid, "ndof": problem.ndof, "dtype": str(diags.dtype),
            "device": str(dev), "levels": len(h.levels),
            "mg_pcg_iterations": int(it), "mg_pcg_rel_residual": float(res),
            "solve_s": time.perf_counter() - t0,
            "a_Mb": float(a @ mg.v_cycle(h, b)),
            "b_Ma": float(b @ mg.v_cycle(h, a)),
            "a_Ma": float(a @ mg.v_cycle(h, a))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
