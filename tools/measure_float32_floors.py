"""Float32 residual floors of the nonlinear analyses at full width.

    python tools/measure_float32_floors.py [--device cuda|cpu]
                                           [--tols 2e-5,3e-5,5e-5]

JSON lines on chip_smoke.py phase 18's problems:

  * statics: solve_elastoplastic on chip_smoke's 40 x 80 grid (6,400
    DOFs, the float32 device tier) under its 32-step cyclic history at the
    default tol 1e-9, which the device tier floors at 1e-5: converged,
    the largest residual and the iterations a step;
  * arch: chip_smoke's 6,000-DOF arch (ARCH_* constants, fixed arc
    length, stop once lambda is back below 0.9 of its peak) in float64
    (the device tier on float64 data, tol 1e-8), |f_int32 - f_int64| at
    its limit state (the rounding floor of the float32 residual), that
    over the limit load, and max |u| there; then solve_riks in float32 at
    each tolerance of --tols: converged, points, the corrector
    iterations, the largest residual, the limit load (largest lambda) and
    its gap from float64.

The same problems and parameters as chip_smoke.py 18(b) and 18(d), so
the tolerances those phases pass can be read off here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tols", default="2e-5,3e-5,5e-5")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from pinn_fem_tpu_torch import solve_elastoplastic, solve_riks
    from pinn_fem_tpu_torch.examples_grid import grid_problem
    from pinn_fem_tpu_torch.ops.assembly import assemble_system_nonlinear

    dev = torch.device(args.device)
    grid = grid_problem(*cs.PLASTIC_GRID)
    t0 = time.perf_counter()
    res = solve_elastoplastic(
        grid, sigma_y=cs.PLASTIC_SIGMA_Y, hardening_iso=cs.PLASTIC_H_ISO,
        hardening_kin=cs.PLASTIC_H_KIN, load_factors=cs.plastic_history(),
        device=dev)
    print(json.dumps({
        "case": "statics", "ndof": grid.ndof, "tol": 1e-5,
        "converged": res.converged,
        "max_residual": float(res.residuals.max()),
        "iterations": res.iterations.tolist(),
        "s": time.perf_counter() - t0}), flush=True)

    arch = cs.arch_problem()
    kw = dict(n_steps=cs.ARCH_STEPS, initial_dlambda=cs.ARCH_DLAMBDA,
              max_dl_growth=1.0)

    def stop_after_peak():
        peak = [float("-inf")]

        def stop(u, lam):
            peak[0] = max(peak[0], lam)
            return lam < 0.9 * peak[0]
        return stop

    t0 = time.perf_counter()
    f64 = solve_riks(arch, data=arch.to_device(dev, torch.float64),
                     stop_fn=stop_after_peak(), **kw)
    limit64 = float(f64.load_factors.max())
    u = torch.as_tensor(f64.displacements[int(f64.load_factors.argmax())],
                        device=dev).float()
    d32, d64 = arch.to_device(dev), arch.to_device(dev, torch.float64)
    gap = (assemble_system_nonlinear(d32, arch.material, u)[1].double()
           - assemble_system_nonlinear(d64, arch.material, u.double())[1])
    floor = float(torch.linalg.vector_norm(gap * d64.free_mask))
    print(json.dumps({
        "case": "arch_float64", "ndof": arch.ndof, "converged": f64.converged,
        "points": int(f64.load_factors.size), "limit_load": limit64,
        "float32_floor": floor, "floor_over_load": floor / limit64,
        "u_max_at_limit": float(u.abs().max()),
        "s": time.perf_counter() - t0}), flush=True)
    for tol in (float(t) for t in args.tols.split(",")):
        t0 = time.perf_counter()
        f32 = solve_riks(arch, tol=tol, stop_fn=stop_after_peak(),
                         device=dev, **kw)
        limit = float(f32.load_factors.max()) if f32.load_factors.size \
            else None
        print(json.dumps({
            "case": "arch_float32", "tol": tol, "converged": f32.converged,
            "points": int(f32.load_factors.size),
            "iterations": f32.iterations.tolist(),
            "max_residual": (float(f32.residuals.max())
                             if f32.residuals.size else None),
            "limit_load": limit,
            "limit_gap": (abs(limit - limit64) / limit64
                          if limit is not None else None),
            "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
