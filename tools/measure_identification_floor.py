#!/usr/bin/env python3
"""The float32 floor of banded identification on the plane strip.

    python3 tools/measure_identification_floor.py [--strip NX NY]
        [--device cuda|cpu] [--tols 1e-8 1e-9 1e-10] [--iters 120]

Twin data from solve_plane_static_banded at tol 1e-10 on the JAX
package's benchmark strip (examples_grid.plane_strip_document) with the
zones y < 2 at E = 800 and y >= 2 at E = 1400, probes every 11th non-zero
DOF; then, for each PCG tolerance, on the float32 path of
solvers/banded_inverse (the diagonals rounded once, dia_solve_diff): the
loss and the zone gradient at the true moduli, the model's u there
against the twin data's u (max gap over max |u|), and, with --iters,
identify_plane_young_banded from E = 1000 at lr 0.2 (the zones, the
smallest and the last loss).  One JSON line each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pinn_fem_tpu_torch.examples_grid import plane_strip_document  # noqa: E402
from pinn_fem_tpu_torch.io.plane_io import parse_plane_document  # noqa: E402
from pinn_fem_tpu_torch.models import plane as TP  # noqa: E402
from pinn_fem_tpu_torch.ops.dia import (assemble_dia_blocks,  # noqa: E402
                                        dia_solve_diff)
from pinn_fem_tpu_torch.solvers import banded_inverse as BI  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strip", type=int, nargs=2, default=(128, 512))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tols", type=float, nargs="+",
                    default=(1e-8, 1e-9, 1e-10))
    ap.add_argument("--iters", type=int, default=120)
    args = ap.parse_args()
    dev = torch.device(args.device)
    problem = dataclasses.replace(
        parse_plane_document(plane_strip_document(*args.strip))[0],
        young=1000.0)
    cent = problem.coords().mean(axis=1)
    zones = [np.flatnonzero(cent[:, 1] < 2.0),
             np.flatnonzero(cent[:, 1] >= 2.0)]
    true = np.where(cent[:, 1] < 2.0, 800.0, 1400.0)
    twin, it, rel = TP.solve_plane_static_banded(
        dataclasses.replace(problem, young=true), tol=1e-10, device=dev)
    u_twin = twin.displacements
    probe = np.arange(u_twin.size)[np.abs(u_twin) > 1e-12][::11]
    meas = u_twin[probe]
    print(json.dumps({"strip": list(args.strip), "ndof": problem.ndof,
                      "device": str(dev), "twin_iterations": int(it),
                      "twin_relative_residual": rel,
                      "probes": int(probe.size)}), flush=True)
    layout = TP.plane_dia_layout(problem)
    blocks_of = TP._young_blocks_of(problem, dev)
    f32 = torch.float32
    f = torch.as_tensor(TP._identification_loads(problem), dtype=f32,
                        device=dev)
    mask = torch.as_tensor(problem.free_mask(), dtype=f32, device=dev)
    idx, m32, scale = BI.measurement(probe, meas, f32, dev)
    _, young_of, _ = BI.young_parameterization(
        problem.young, cent, zones, dtype=f32, device=dev)
    at_truth = [torch.log(torch.tensor([800.0, 1400.0], device=dev))]
    for tol in args.tols:
        u_truth = []

        def loss_fn(ps):
            diags = assemble_dia_blocks(layout, blocks_of(young_of(ps)))
            u = dia_solve_diff(layout, diags.to(f32), f, mask, tol=tol)
            u_truth.append(u.detach().double().cpu().numpy())
            return torch.mean((u[idx] - m32) ** 2) / scale

        loss, (grad,) = BI.value_and_grad(loss_fn, at_truth)
        row = {"tol": tol, "loss_at_truth": float(loss),
               "zone_gradient_at_truth": grad.tolist(),
               "u_gap_at_truth": float(np.abs(u_truth[0] - u_twin).max()
                                       / np.abs(u_twin).max())}
        if args.iters:
            t0 = time.perf_counter()
            young, hist, _ = TP.identify_plane_young_banded(
                problem, probe, meas, zones=zones, n_iter=args.iters,
                learning_rate=0.2, tol=tol, device=dev)
            row.update(zone_young=[float(young[z].mean()) for z in zones],
                       loss_min=float(hist.min()),
                       loss_min_at=int(hist.argmin()) + 1,
                       loss_last=float(hist[-1]),
                       seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
