"""Full Newton-Raphson over the coupled (u, theta) unknowns (counterpart of
pinn_fem_tpu/solvers/full_newton.py).

The true coupled Hessian of L = 0.5 ||R_free||^2 + mean_data over
z = [u_free, theta] comes from torch.func.jacfwd(torch.func.grad(L)) on
the torch form of the material (ops/assembly.material_coefficients says
why), and Levenberg-Marquardt-damped Newton steps are solved by Cholesky
(solvers/phases.full_nr_phase).  The JAX module's contracts hold:

  * without trainable parameters, full-NR is classic NR (solve_nr);
  * convergence on the total gradient norm, or on ||R_free|| < tol with
    the data RMS below config.full_nr_data_tolerance;
  * history rows {iteration (0-based), loss_total, loss_physics,
    loss_data, grad_norm_u, grad_norm_theta}, loss_total unweighted;
  * the physics residual is restricted to the free DOFs.

The trained material replaces problem.material (on the solve's device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig, SolverResult
from ..models.problem import ProblemData, TrussProblem
from .gd import export_nn_parameters, get_theta, set_theta
from .newton import solve_nr
from .phases import full_nr_phase, reactions_of


def measurements_on(data: ProblemData, measured_disp, measured_dofs):
    """(has_meas, values, dofs) on data's device; (False, None, None)
    without measurements."""
    provided = measured_disp is not None and measured_dofs is not None
    if not (provided and len(np.asarray(measured_dofs).reshape(-1)) > 0):
        return False, None, None
    vals = torch.as_tensor(np.asarray(measured_disp, dtype=float),
                           dtype=data.loads.dtype).to(data.device)
    dofs = torch.as_tensor(np.asarray(measured_dofs, dtype=np.int64)
                           ).to(data.device)
    return True, vals, dofs


def initial_state(problem: TrussProblem, data: ProblemData, u_initial):
    """(free DOF indices on the device, u0 with its fixed DOFs zeroed)."""
    free_np, _ = problem.free_fixed()
    free_idx = torch.as_tensor(free_np).to(data.device)
    u0 = torch.zeros(problem.ndof, dtype=data.loads.dtype, device=data.device)
    if u_initial is not None:
        u_np = np.asarray(u_initial, dtype=float).reshape(-1)[free_np]
        u0[free_idx] = torch.as_tensor(u_np, dtype=u0.dtype).to(data.device)
    return free_idx, u0


def solve_full_nr(problem: TrussProblem, config: Optional[SolverConfig] = None,
                  measured_disp: Optional[np.ndarray] = None,
                  measured_dofs: Optional[np.ndarray] = None,
                  target_load_factor: float = 1.0,
                  u_initial: Optional[np.ndarray] = None,
                  data: Optional[ProblemData] = None,
                  device=None) -> SolverResult:
    """Full-NR solve for one load increment (method "full-nr").  device:
    where to solve when `data` is not given ("cuda" when None)."""
    config = config or SolverConfig()
    if not problem.material.has_trainable_params:
        return solve_nr(problem, config, target_load_factor, u_initial,
                        data=data, device=device)

    data = data if data is not None else problem.to_device(device)
    material = problem.material.to(data.device)
    has_meas, mvals, mdofs = measurements_on(data, measured_disp,
                                             measured_dofs)
    free_idx, u0 = initial_state(problem, data, u_initial)
    hist_cap = 1024
    while hist_cap < config.max_iterations:
        hist_cap *= 2

    out = full_nr_phase(
        data, material, set_theta, u0, get_theta(material), free_idx,
        target_load_factor, mvals, mdofs, has_meas,
        min(config.max_iterations, hist_cap), config.tolerance,
        config.full_nr_data_tolerance, config.learning_rate_u,
        config.learning_rate_theta)
    problem.material = set_theta(material, out.theta)
    reactions = reactions_of(data, problem.material, out.u,
                             target_load_factor)

    keys = ("loss_total", "loss_physics", "loss_data", "grad_norm_u",
            "grad_norm_theta")
    history = [{"iteration": int(row[0]), **dict(zip(keys, row[1:]))}
               for row in out.hist]
    shape = ((-1, 1) if problem.dimension == 1
             else (problem.nnode, problem.dimension))
    return SolverResult(
        displacements=out.u.cpu().numpy().astype(float).reshape(shape),
        reactions=reactions.cpu().numpy().astype(float).reshape(shape),
        converged=out.converged,
        history=history,
        nn_parameters=export_nn_parameters(get_theta(problem.material)),
    )
