"""Hybrid GD -> NR solver (counterpart of pinn_fem_tpu/solvers/hybrid.py).

  Phase 1 (only with config.preconditioning): GD with the budget
  min(300, max//3) at the relaxed tolerance max(1e-4, 10 tol); it ends the
  solve if it already meets the tight tolerance (solver.py:552-586).

  Phase 2: with NN materials, a second GD at the tight tolerance and the
  remaining budget, warm-started ("GD->GD", solver.py:594-651); with scalar
  materials, Newton-Raphson warm-started from phase 1 (solver.py:653-692).

GD entries keep their keys in the merged history; the NR phase adds its
one increment entry, stamped with the unified iteration count
(solver.py:678-686).  A failed phase 1 falls back to a cold NR for scalar
materials only: with NN materials the GD->GD phase runs the same code, so
the error is raised.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ..config import SolverConfig, SolverResult
from ..models.problem import ProblemData, TrussProblem
from ..utils.progress import PACKAGE_LOGGER
from .gd import _merge_history, solve_gd
from .newton import solve_nr


def solve_hybrid(problem: TrussProblem, config: Optional[SolverConfig] = None,
                 measured_disp: Optional[np.ndarray] = None,
                 measured_dofs: Optional[np.ndarray] = None,
                 target_load_factor: float = 1.0,
                 u_initial: Optional[np.ndarray] = None,
                 data: Optional[ProblemData] = None,
                 device=None) -> SolverResult:
    config = config or SolverConfig()
    data = data if data is not None else problem.to_device(device)
    has_nn = problem.material.has_trainable_params
    args = (measured_disp, measured_dofs, target_load_factor)

    gd_result = None
    gd_budget = 0
    if config.preconditioning:
        gd_config = config.with_(
            max_iterations=min(300, config.max_iterations // 3),
            tolerance=max(1e-4, config.tolerance * 10),
        )
        gd_budget = gd_config.max_iterations
        try:
            gd_result = solve_gd(problem, gd_config, *args, u_initial,
                                 skip_preconditioning=True, data=data)
        except RuntimeError as e:  # reference: cold NR (solver.py:584-586)
            if has_nn:
                raise
            logging.getLogger(f"{PACKAGE_LOGGER}.solvers").warning(
                "hybrid GD phase failed: %s, proceeding with cold NR", e)
        else:
            last = gd_result.history[-1] if gd_result.history else {}
            if gd_result.converged \
                    and last.get("residual_norm", 1.0) < config.tolerance:
                return gd_result

    u_warm = (gd_result.displacements.flatten() if gd_result is not None
              else u_initial)

    if has_nn:
        final_config = config.with_(
            max_iterations=config.max_iterations
            - (gd_budget if gd_result else 0))
        final = solve_gd(problem, final_config, *args, u_warm,
                         skip_preconditioning=True, data=data)
        if gd_result is not None:
            final.history = _merge_history(gd_result.history, final.history)
        return final

    nr = solve_nr(problem, config, target_load_factor, u_warm, data=data)
    if gd_result is not None:
        gd_iters = (gd_result.history[-1].get("iteration", 0.0)
                    if gd_result.history else 0.0)
        nr_iters = nr.history[-1].get("iterations", 1.0) if nr.history else 1.0
        unified = list(gd_result.history)
        if nr.history:
            unified.append(dict(nr.history[-1], iteration=gd_iters + nr_iters))
        nr.history = unified
    return nr
