"""Universal incremental-loading driver (counterpart of
pinn_fem_tpu/solvers/driver.py).

Method resolution (explicit config.method, else: no NN and no measurements
-> "nr", otherwise "gd"), load stepping lf_i = lf0 + (i/n)(lf1 - lf0),
warm starts between increments (full-nr only under config.nr_warm_start),
early stop on a non-converged increment, and the last increment's result.
The problem arrays are moved to the device once and shared by every
increment.

Every method of the JAX driver is ported: "nr"; "gd" and "hybrid";
"full-nr" (classic NR with scalar materials, the coupled (u, theta)
Newton with NN fields); and "gn".  So are its checkpoint_dir / resume
(utils/checkpoint.py): the files are the JAX driver's, so either package
resumes the other's run.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ..config import SolverConfig, SolverResult
from ..models.problem import TrussProblem
from ..utils.checkpoint import load_increment_state, save_increment_state
from ..utils.progress import (PACKAGE_LOGGER, ensure_console_logging,
                              log_gd_progress)
from .full_newton import solve_full_nr
from .gauss_newton import solve_gauss_newton
from .gd import get_theta, set_theta, solve_gd
from .hybrid import solve_hybrid
from .newton import solve_nr

logger = logging.getLogger(f"{PACKAGE_LOGGER}.solvers")

METHODS = ("nr", "gd", "hybrid", "full-nr", "full_nr", "gn")


def resolve_method(problem: TrussProblem, config: SolverConfig,
                   measured_disp=None, measured_dofs=None) -> str:
    if config.method != "auto":
        return config.method.lower()
    has_nn = problem.material.has_trainable_params
    has_meas = measured_disp is not None and measured_dofs is not None
    if not has_nn and not has_meas:
        return "nr"
    return "gd"


def solve(problem: TrussProblem, config: Optional[SolverConfig] = None,
          measured_disp: Optional[np.ndarray] = None,
          measured_dofs: Optional[np.ndarray] = None, verbose: bool = True,
          checkpoint_dir: Optional[str] = None, resume: bool = False,
          device=None) -> SolverResult:
    """Universal incremental solve on `device` ("cuda" when None).

    With checkpoint_dir set, (u, theta) is saved after every converged
    increment; with resume=True a saved state is restored (u, and theta
    into the material) and the run goes on after its increment, or
    re-runs the last increment when the saved run had finished.
    """
    config = config or SolverConfig()
    method = resolve_method(problem, config, measured_disp, measured_dofs)
    if method not in METHODS:
        raise ValueError(f"Unknown solver method: {method}")
    data = problem.to_device(device)
    if verbose:
        ensure_console_logging()

    result: Optional[SolverResult] = None
    u_current: Optional[np.ndarray] = None
    start_increment = 1
    if checkpoint_dir and resume:
        restored = load_increment_state(checkpoint_dir,
                                        get_theta(problem.material))
        if restored is not None:
            done_inc, u_current, theta = restored
            if theta:
                problem.material = set_theta(problem.material, theta)
            start_increment = min(done_inc + 1, config.n_increments)
            if verbose:
                logger.info("[resume] restored checkpoint after increment %d",
                            done_inc)

    for iinc in range(start_increment, config.n_increments + 1):
        load_factor = config.load_factor_initial + (iinc / config.n_increments) * (
            config.load_factor_final - config.load_factor_initial
        )
        if verbose:
            start = "WARM_START" if u_current is not None else "COLD_START"
            logger.info("%4d | %12.4f | %10s", iinc, load_factor, start)

        if method == "gd":
            result = solve_gd(problem, config, measured_disp, measured_dofs,
                              target_load_factor=load_factor,
                              u_initial=u_current, data=data)
        elif method == "hybrid":
            result = solve_hybrid(problem, config, measured_disp,
                                  measured_dofs, target_load_factor=load_factor,
                                  u_initial=u_current, data=data)
        elif method in ("full-nr", "full_nr"):
            # As in the JAX driver: the warm start only under
            # config.nr_warm_start (the reference never warm-starts).
            result = solve_full_nr(
                problem, config, measured_disp, measured_dofs,
                target_load_factor=load_factor, data=data,
                u_initial=u_current if config.nr_warm_start else None)
        elif method == "gn":
            result = solve_gauss_newton(
                problem, config, measured_disp, measured_dofs,
                target_load_factor=load_factor, u_initial=u_current,
                data=data)
        else:
            result = solve_nr(problem, config, target_load_factor=load_factor,
                              u_initial=u_current, data=data)

        u_current = result.displacements.flatten()
        if verbose:
            # The reference's progress table (GD or full-NR rows), from
            # the history.
            log_gd_progress(result.history, config.print_every)
            status = "CONVERGED" if result.converged else "FAILED"
            logger.info("%4d | %12.6f | %10s", iinc, load_factor, status)
        if checkpoint_dir and result.converged:
            save_increment_state(
                checkpoint_dir, iinc, u_current, get_theta(problem.material),
                meta={"method": method, "load_factor": load_factor})
        if not result.converged:
            if verbose:
                logger.warning("Increment %d did not converge, stopping.", iinc)
            break
    return result
