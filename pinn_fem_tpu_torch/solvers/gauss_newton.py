"""Gauss-Newton + Levenberg-Marquardt + Armijo backtracking solver
(counterpart of pinn_fem_tpu/solvers/gauss_newton.py).

Simultaneous solve of z = [u_free, theta] on the stacked weighted residual

    R(z) = [ alpha_physics * (F_int(u, theta) - lf * F_ext)_free ]
           [ alpha_data    * (u_measured - u[measured_dofs])     ]

with LM damping 1e-6 tr(J^T J) / n_z, a backtracking line search (accept
when |R(z + s dz)| < |R(z)| (1 - 1e-4 s), else s *= 0.7, 15 tries) and
convergence on relative_error = |R| / max(|u_free|, min_denom) < tol
(solvers/phases.gn_phase).  The Jacobian is one torch.func.jacrev on the
torch form of the material.  History rows {iteration (1-based),
r_physics, r_data, r_total, relative_error, step_size}.  As in the JAX
solver, an accepted theta step is applied once, and a scalar material
makes it a displacement-only solver (theta empty).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverConfig, SolverResult
from ..models.problem import ProblemData, TrussProblem
from .full_newton import initial_state, measurements_on
from .gd import export_nn_parameters, get_theta, set_theta
from .phases import gn_phase, reactions_of

_KEYS = ("iteration", "r_physics", "r_data", "r_total", "relative_error",
         "step_size")


def solve_gauss_newton(problem: TrussProblem,
                       config: Optional[SolverConfig] = None,
                       measured_disp: Optional[np.ndarray] = None,
                       measured_dofs: Optional[np.ndarray] = None,
                       target_load_factor: float = 1.0,
                       u_initial: Optional[np.ndarray] = None,
                       data: Optional[ProblemData] = None,
                       alpha_physics: Optional[float] = None,
                       alpha_data: Optional[float] = None,
                       device=None) -> SolverResult:
    """Gauss-Newton / LM solve for one load increment (method "gn").
    alpha_physics / alpha_data override the config's weights; device:
    where to solve when `data` is not given ("cuda" when None)."""
    config = config or SolverConfig()
    data = data if data is not None else problem.to_device(device)
    material = problem.material.to(data.device)
    has_meas, mvals, mdofs = measurements_on(data, measured_disp,
                                             measured_dofs)
    free_idx, u0 = initial_state(problem, data, u_initial)
    theta = get_theta(material)
    hist_cap = 256
    while hist_cap < config.max_iterations:
        hist_cap *= 2
    a_p = alpha_physics if alpha_physics is not None else config.alpha_physics
    a_d = alpha_data if alpha_data is not None else config.alpha_data

    out = gn_phase(
        data, material, set_theta, u0, theta, free_idx, target_load_factor,
        mvals, mdofs, has_meas, min(config.max_iterations, hist_cap),
        config.tolerance, a_p, a_d, config.min_denominator)
    problem.material = set_theta(material, out.theta) if theta else material
    reactions = reactions_of(data, problem.material, out.u,
                             target_load_factor)

    shape = ((-1, 1) if problem.dimension == 1
             else (problem.nnode, problem.dimension))
    return SolverResult(
        displacements=out.u.cpu().numpy().astype(float).reshape(shape),
        reactions=reactions.cpu().numpy().astype(float).reshape(shape),
        converged=out.converged,
        history=[dict(zip(_KEYS, row)) for row in out.hist],
        nn_parameters=(export_nn_parameters(get_theta(problem.material))
                       if theta else None),
    )
