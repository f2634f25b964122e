"""Legacy solver API surface (counterpart of pinn_fem_tpu/solvers/legacy.py).

The reference keeps three older, self-contained solvers beside the unified
one, all exported from its package root:

  * solve_incremental_newton: classic incremental Newton-Raphson, used by
    the api_fem_solver CLI;
  * solve_pinn_gradient_descent: PINN gradient descent with the legacy
    losses and convergence gate;
  * solve_pinn_newton_raphson: Gauss-Newton + LM, delegated to
    solvers.gauss_newton.solve_gauss_newton.

Same result shapes and history formats as the JAX module.  Its lax.scan
and lax.while_loop become Python loops: the incremental Newton reads one
flag per Newton iteration (nr_phase), the legacy GD one history row per
iteration (its convergence test).  MLP fields that kernel 4 takes
(ops/kernels/material_kernel.fused_coefficients_supported) are evaluated
by it on a card, in every Newton assembly and in every GD loss, whose
backward is kernel 4b; other fields take their torch form, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SolverConfig, SolverResult
from ..models.problem import TrussProblem
from ..ops.assembly import assemble_system, internal_force_and_strain
from .full_newton import measurements_on
from .gauss_newton import solve_gauss_newton
from .gd import export_nn_parameters, get_theta, set_theta
from .phases import Adam, _flatten, _unflatten, in_working_precision, nr_phase


@dataclass(frozen=True)
class LegacySolverConfig:
    n_increments: int = 10
    max_iterations: int = 80
    tolerance: float = 1e-6
    min_denominator: float = 1e-12


@dataclass
class PINNSolverConfig:
    max_iterations: int = 50
    tolerance: float = 1e-6
    alpha_physics: float = 1.0
    alpha_data: float = 1.0
    min_denominator: float = 1e-12
    max_step_u: float = 1e-3
    max_step_theta: float = 0.1
    line_search: bool = True


@dataclass
class PINNGradientDescentConfig:
    max_iterations: int = 1000
    tolerance: float = 1e-6
    learning_rate_u: float = 1e-7
    learning_rate_theta: float = 1e-4
    alpha_physics: float = 1.0
    alpha_data: float = 100.0
    print_every: int = 10


@dataclass
class PINNSolverResult:
    displacements: np.ndarray
    nn_parameters: Dict[str, np.ndarray]
    converged: bool
    history: List[Dict[str, float]] = field(default_factory=list)


def _shape(problem: TrussProblem):
    return ((-1, 1) if problem.dimension == 1
            else (problem.nnode, problem.dimension))


def solve_incremental_newton(problem: TrussProblem,
                             config: Optional[LegacySolverConfig] = None,
                             device=None) -> SolverResult:
    """Classic incremental Newton-Raphson with the legacy contract: one
    dense nr_phase per increment at load factor (i + 1) / n_increments,
    u carried across increments and never reset; one history row PER
    INCREMENT {increment, load_factor, iterations, residual, max_strain,
    converged}; converged = every increment converged; reactions against
    the FULL loads.  NN material fields are evaluated FROZEN (the unified
    solve_nr refuses them).  device: where to solve ("cuda" when None)."""
    config = config or LegacySolverConfig()
    data = problem.to_device(device)
    material = problem.material.to(data.device)
    dt = data.loads.dtype
    np_dt = np.float64 if dt == torch.float64 else np.float32
    u = torch.zeros(data.ndof, dtype=dt, device=data.device)
    lfs, iters, convs, values = [], [], [], []
    for i in range(config.n_increments):
        # (i + 1) / n as the JAX scan gets it: XLA turns the division by
        # the static count into a product with its rounded reciprocal
        # (9 / 10 gives 0.90000004 in float32, not 0.9 rounded).
        lf = float(np_dt(i + 1) * (np_dt(1.0) / np_dt(config.n_increments)))
        out = nr_phase(data, material, u, lf, config.max_iterations,
                       config.tolerance, config.min_denominator)
        u = out.u
        lfs.append(lf)
        iters.append(out.n_iters)
        convs.append(out.converged)
        values.append(torch.stack([out.residual, out.max_strain]))

    k_final, _, _ = assemble_system(data, material, u, 1.0)
    reactions = (k_final @ u - data.loads) * data.fixed_mask
    u_np = u.cpu().numpy().astype(float)
    if not np.all(np.isfinite(u_np)):
        raise RuntimeError("Tangent stiffness became singular during solve")
    values = torch.stack(values).tolist() if values else []
    history = [
        {
            "increment": float(i + 1),
            "load_factor": lfs[i],
            "iterations": float(iters[i]),
            "residual": values[i][0],
            "max_strain": values[i][1],
            "converged": 1.0 if convs[i] else 0.0,
        }
        for i in range(len(lfs))
    ]
    return SolverResult(
        displacements=u_np.reshape(_shape(problem)),
        reactions=reactions.cpu().numpy().astype(float).reshape(
            _shape(problem)),
        converged=all(convs),
        history=history,
    )


def solve_pinn_gradient_descent(
    problem: TrussProblem,
    f_ext: np.ndarray,
    measured_disp: Optional[np.ndarray] = None,
    measured_dofs: Optional[np.ndarray] = None,
    config: Optional[PINNGradientDescentConfig] = None,
    device=None,
) -> PINNSolverResult:
    """Legacy PINN GD: dual Adam on u and theta, u masked to the free DOFs
    after each step; loss alpha_physics * MEAN of the squared free-DOF
    residual (f_int - f_ext) + alpha_data * mean data misfit (0 without
    measurements); converged once iteration > 10 and loss < tol.  The
    trained theta replaces problem.material's (on the solve's device).
    History rows {iteration, loss_total, loss_physics, loss_data, u_norm}.
    device: where to solve ("cuda" when None)."""
    config = config or PINNGradientDescentConfig()
    if not problem.material.has_trainable_params:
        raise ValueError(
            "Model must have trainable NN parameters (use an MLP field)")
    data = problem.to_device(device)
    dt, dev = data.loads.dtype, data.device
    material = problem.material.to(dev)
    theta0 = get_theta(material)
    has_meas, mvals, mdofs = measurements_on(data, measured_disp,
                                             measured_dofs)
    f = torch.as_tensor(np.asarray(f_ext, dtype=float).reshape(-1),
                        dtype=dt).to(dev)
    tol = in_working_precision(config.tolerance, dt)
    n_free = torch.sum(data.free_mask)
    zero = torch.zeros((), dtype=dt, device=dev)

    u = torch.zeros(data.ndof, dtype=dt, device=dev)
    th = _flatten(theta0).detach()
    opt_u, opt_th = Adam(u), Adam(th)
    rows: List[List[float]] = []
    it, conv = 0, False
    while it < config.max_iterations and not conv:
        u, th = u.requires_grad_(), th.requires_grad_()
        mat = set_theta(material, _unflatten(th, theta0))
        f_int, _ = internal_force_and_strain(data, mat, u, 1.0)
        r = (f_int - f) * data.free_mask
        loss_p = torch.sum(r * r) / n_free
        if has_meas:
            rd = mvals - u[mdofs]
            loss_d = torch.mean(rd * rd)
        else:
            loss_d = zero
        loss = config.alpha_physics * loss_p + config.alpha_data * loss_d
        g_u, g_th = torch.autograd.grad(loss, [u, th])
        with torch.no_grad():
            u = (u - config.learning_rate_u * opt_u.direction(g_u)) \
                * data.free_mask
            th = th - config.learning_rate_theta * opt_th.direction(g_th)
            row = torch.stack([loss, loss_p, loss_d,
                               torch.linalg.vector_norm(u)]).tolist()
        rows.append(row)
        # NaN compares false, as the JAX gate's does.
        conv = it > 10 and row[0] < tol
        it += 1

    problem.material = set_theta(material, _unflatten(th.detach(), theta0))
    history = [{"iteration": float(k + 1), "loss_total": row[0],
                "loss_physics": row[1],
                "loss_data": row[2] if has_meas else 0.0,
                "u_norm": row[3]} for k, row in enumerate(rows)]
    return PINNSolverResult(
        displacements=u.cpu().numpy().astype(float).reshape(_shape(problem)),
        nn_parameters=export_nn_parameters(get_theta(problem.material)),
        converged=conv,
        history=history,
    )


def solve_pinn_newton_raphson(
    problem: TrussProblem,
    f_ext: np.ndarray,
    measured_disp: Optional[np.ndarray] = None,
    measured_dofs: Optional[np.ndarray] = None,
    config: Optional[PINNSolverConfig] = None,
    device=None,
) -> PINNSolverResult:
    """Legacy Gauss-Newton + LM + Armijo PINN solver: solve_gauss_newton
    at load factor 1 with problem.loads swapped for f_ext, and restored
    whatever happens.  device: where to solve ("cuda" when None)."""
    config = config or PINNSolverConfig()
    if not problem.material.has_trainable_params:
        raise ValueError(
            "Model must have trainable NN parameters (use an MLP field)")
    loads_backup = problem.loads
    problem.loads = np.asarray(f_ext, dtype=float).reshape(-1)
    try:
        result = solve_gauss_newton(
            problem,
            SolverConfig(max_iterations=config.max_iterations,
                         tolerance=config.tolerance,
                         min_denominator=config.min_denominator),
            measured_disp, measured_dofs, target_load_factor=1.0,
            alpha_physics=config.alpha_physics,
            alpha_data=config.alpha_data, device=device)
    finally:
        problem.loads = loads_backup
    return PINNSolverResult(
        displacements=result.displacements,
        nn_parameters=result.nn_parameters or {},
        converged=result.converged,
        history=result.history,
    )
