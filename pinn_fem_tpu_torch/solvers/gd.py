"""Gradient-descent / PINN solver (counterpart of pinn_fem_tpu/solvers/gd.py).

Dual Adam on the displacements u (lr_u) and the NN material parameters
theta (lr_theta), loss

    L = alpha_physics * 0.5 ||R_free||^2  (+ alpha_data * mean((u_meas - u)^2))

with the data term present only when measurements exist and alpha_data > 0;
BC projection u[fixed] = 0 after every step; convergence only after
iteration 10 on residual_norm < tol OR loss < tol; two-phase
"preconditioning" with the reference's budgets (phase 1: min(300, max//3)
iterations at max(1e-4, 10 tol); phase 2: the remaining budget,
warm-started) and the merged history with renumbered iterations
(solver.py:169-195).  Adam is torch.optim.Adam's defaults with fresh state
per phase (solvers/phases.py).

Each GD iteration evaluates the loss through ops.assembly
.internal_force_and_strain, so three MLP fields that kernel 4 takes run the
CUDA forward and backward kernels once per iteration on a card.  theta is
moved to the problem arrays' device before the phase; the trained material
replaces problem.material (on that device), as the JAX solver does.
The history is a plain list (the JAX package's power-of-two history buffer
was a device-side allocation it needed; a Python loop does not).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..config import SolverConfig, SolverResult
from ..models.fields import Material, MLPField
from ..models.problem import ProblemData, TrussProblem
from ..utils.progress import PACKAGE_LOGGER
from .phases import gd_phase, reactions_of, theta_param_list

_FIELDS = ("young", "area", "density")


def get_theta(material: Material) -> list:
    """Trainable parameters: the layers of each MLP field, in the
    reference's young -> area -> density order (model.py:36-43)."""
    return [f.layers for f in (getattr(material, n) for n in _FIELDS)
            if isinstance(f, MLPField)]


def set_theta(material: Material, theta: list) -> Material:
    """The material with its MLP fields' layers replaced by theta's."""
    fields = {}
    k = 0
    for name in _FIELDS:
        f = getattr(material, name)
        if isinstance(f, MLPField):
            f = f.replace(layers=theta[k])
            k += 1
        fields[name] = f
    return Material(**fields)


def export_nn_parameters(theta: list) -> dict:
    """{param_i: ndarray} with torch's (out, in) weight shapes
    (solver.py:387-392)."""
    params = {}
    for i, t in enumerate(theta_param_list(theta)):
        a = t.detach().cpu().numpy()
        params[f"param_{i}"] = (a.T if i % 2 == 0 else a).copy()
    return params


def _hist_rows_to_dicts(hist: List[List[float]], has_nn: bool,
                        has_meas: bool) -> List[dict]:
    out = []
    for row in hist:
        entry = {
            "iteration": row[0],
            "loss_total": row[1],
            "loss_physics": row[2],
            "loss_data": row[3] if has_meas else 0.0,
            "u_norm": row[4],
            "residual_norm": row[5],
        }
        if has_nn:
            entry["theta_norm"] = row[6]
        out.append(entry)
    return out


def _run_gd_phase(problem: TrussProblem, data: ProblemData,
                  config: SolverConfig, measured_disp, measured_dofs,
                  target_load_factor: float, u_initial) -> SolverResult:
    """One GD phase; replaces problem.material with the trained one."""
    dtype, dev = data.loads.dtype, data.device
    material = problem.material.to(dev)
    theta = get_theta(material)
    has_nn = len(theta) > 0

    provided = measured_disp is not None and measured_dofs is not None
    if provided and config.alpha_data == 0.0:
        logging.getLogger(f"{PACKAGE_LOGGER}.solvers").warning(
            "measured_dofs provided but alpha_data=0.0; data term ignored")
    has_meas = (provided and config.alpha_data > 0.0
                and len(np.asarray(measured_dofs).reshape(-1)) > 0)
    if has_meas:
        mvals = torch.as_tensor(np.asarray(measured_disp, dtype=float),
                                dtype=dtype).to(dev)
        mdofs = torch.as_tensor(np.asarray(measured_dofs, dtype=np.int64)
                                ).to(dev)
    else:
        mvals = mdofs = None

    if u_initial is not None:
        u0 = torch.as_tensor(np.asarray(u_initial, dtype=float).reshape(-1),
                             dtype=dtype).to(dev)
    else:
        u0 = torch.zeros(problem.ndof, dtype=dtype, device=dev)

    out = gd_phase(data, material, set_theta, u0, theta, target_load_factor,
                   mvals, mdofs, bool(has_meas), config.max_iterations,
                   config.tolerance, config.learning_rate_u,
                   config.learning_rate_theta, config.alpha_physics,
                   config.alpha_data)
    problem.material = set_theta(material, out.theta) if has_nn else material
    reactions = reactions_of(data, problem.material, out.u,
                             target_load_factor)

    shape = ((-1, 1) if problem.dimension == 1
             else (problem.nnode, problem.dimension))
    return SolverResult(
        displacements=out.u.cpu().numpy().astype(float).reshape(shape),
        reactions=reactions.cpu().numpy().astype(float).reshape(shape),
        converged=out.converged,
        history=_hist_rows_to_dicts(out.hist, has_nn, bool(has_meas)),
        nn_parameters=(export_nn_parameters(get_theta(problem.material))
                       if has_nn else None),
    )


def _merge_history(first: List[dict], second: List[dict]) -> List[dict]:
    """first, then second renumbered after first's last iteration."""
    offset = first[-1].get("iteration", 0.0) if first else 0.0
    return list(first) + [dict(e, iteration=e.get("iteration", 0.0) + offset)
                          for e in second]


def solve_gd(problem: TrussProblem, config: Optional[SolverConfig] = None,
             measured_disp: Optional[np.ndarray] = None,
             measured_dofs: Optional[np.ndarray] = None,
             target_load_factor: float = 1.0,
             u_initial: Optional[np.ndarray] = None,
             skip_preconditioning: bool = False,
             data: Optional[ProblemData] = None,
             device=None) -> SolverResult:
    """GD/PINN solve for one load increment (reference solve_gd,
    solver.py:83).  device: where to solve when `data` is not given
    ("cuda" when None)."""
    config = config or SolverConfig()
    data = data if data is not None else problem.to_device(device)
    args = (measured_disp, measured_dofs, target_load_factor)

    if config.preconditioning and not skip_preconditioning:
        precon_config = config.with_(
            max_iterations=min(300, config.max_iterations // 3),
            tolerance=max(1e-4, config.tolerance * 10),
            preconditioning=False,
        )
        precon = _run_gd_phase(problem, data, precon_config, *args,
                               u_initial)
        last = precon.history[-1] if precon.history else {}
        if precon.converged \
                and last.get("residual_norm", 1.0) < config.tolerance:
            return precon
        main_config = config.with_(
            max_iterations=config.max_iterations - precon_config.max_iterations,
            preconditioning=False,
        )
        main = _run_gd_phase(problem, data, main_config, *args,
                             precon.displacements.flatten())
        main.history = _merge_history(precon.history, main.history)
        return main

    return _run_gd_phase(problem, data, config, *args, u_initial)
