"""Scalar material identification: recover (young, area) from measured
displacements (counterpart of pinn_fem_tpu/solvers/scalar_inverse.py).

The documented contract of the reference's two scalar identification API
scripts (whose solver imports never existed), with working internals:

  * gradient descent with Adam on (u, log E, log A), loss
    alpha * mean(R_free^2) + beta * mean((u_meas - u)^2), parameter bounds
    enforced by projection after each step;
  * Gauss-Newton with LM damping lambda_lm on the stacked residual over
    (u_free, log E, log A), with halving backtracking.

Log parameters keep the identification well-conditioned across the ~11
orders of magnitude between E (~2e11 Pa) and A (~1e-2 m^2), and both
residual blocks are normalized (physics by max|F_ext|, data by
max|u_measured|), so the force-unit physics rows (~1e6 N) cannot drown the
meter-unit data rows (~1e-4 m).

Both materials are scalar, so no repo kernel is on these paths: the
internal force is the matrix-free torch form (ops.assembly), E and A are
0-d tensors the loss is differentiated in.  The GD runs its fixed number
of iterations with no host read (its rows are read once, at the end); the
Gauss-Newton reads one flag per backtracking try and one row per
iteration.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.fields import Material, ScalarField
from ..models.problem import TrussProblem
from ..ops.assembly import internal_force_and_strain
from .phases import Adam, in_working_precision

_LS_TRIES = 12   # Gauss-Newton backtracking halvings


def _with_scalars(material: Material, young: torch.Tensor,
                  area: torch.Tensor) -> Material:
    return Material(young=ScalarField(value=young),
                    area=ScalarField(value=area), density=material.density)


def _as(values, dtype, device, np_type=float) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np_type).reshape(-1),
                           dtype=dtype).to(device)


def _scales(f_ext: torch.Tensor, mvals: torch.Tensor):
    """(max|f_ext|, max|u_measured|), each at least 1e-30."""
    def scale(v):
        return torch.clamp_min(torch.max(torch.abs(v)), 1e-30)

    return scale(f_ext), scale(mvals)


def identify_scalars_gd(
    problem: TrussProblem,
    f_ext: np.ndarray,
    u_measured: np.ndarray,
    measured_dofs: np.ndarray,
    young_init: float,
    area_init: float,
    n_iterations: int = 500,
    learning_rate: float = 1e-3,
    alpha: float = 1.0,
    beta: float = 100.0,
    young_bounds: Tuple[float, float] = (1e9, 500e9),
    area_bounds: Tuple[float, float] = (1e-3, 0.1),
    device=None,
) -> Dict:
    """Gradient-descent identification of scalar (E, A): n_iterations Adam
    steps, no stopping test.  History rows {iteration, loss_total,
    loss_physics, loss_data, young, area}.  device: where to solve ("cuda"
    when None)."""
    data = problem.to_device(device)
    dt, dev = data.loads.dtype, data.device
    f = _as(f_ext, dt, dev)
    mvals = _as(u_measured, dt, dev)
    mdofs = _as(measured_dofs, torch.int64, dev, np.int64)
    bounds = _as([young_bounds, area_bounds], dt, dev).reshape(2, 2)
    log_lo, log_hi = torch.log(bounds[:, 0]), torch.log(bounds[:, 1])
    f_scale, u_scale = _scales(f, mvals)
    n_free = torch.sum(data.free_mask)

    u = torch.zeros(data.ndof, dtype=dt, device=dev)
    p = torch.tensor([np.log(young_init), np.log(area_init)], dtype=dt,
                     device=dev)
    opt_u, opt_p = Adam(u), Adam(p)
    rows = []
    for it in range(n_iterations):
        u, p = u.requires_grad_(), p.requires_grad_()
        mat = _with_scalars(problem.material, torch.exp(p[0]),
                            torch.exp(p[1]))
        f_int, _ = internal_force_and_strain(data, mat, u, 1.0)
        r = (f_int - f) * data.free_mask / f_scale
        loss_p = torch.sum(r * r) / n_free
        rd = (mvals - u[mdofs]) / u_scale
        loss_d = torch.mean(rd * rd)
        loss = alpha * loss_p + beta * loss_d
        g_u, g_p = torch.autograd.grad(loss, [u, p])
        with torch.no_grad():
            u = (u - learning_rate * opt_u.direction(g_u)) * data.free_mask
            # The projection comes after the Adam step.
            p = torch.clamp(p - learning_rate * opt_p.direction(g_p),
                            log_lo, log_hi)
            rows.append(torch.stack([loss, loss_p, loss_d,
                                     torch.exp(p[0]), torch.exp(p[1])]))

    rows = torch.stack(rows).tolist() if rows else []
    history = [{"iteration": float(k + 1), "loss_total": row[0],
                "loss_physics": row[1], "loss_data": row[2],
                "young": row[3], "area": row[4]}
               for k, row in enumerate(rows)]
    young, area = torch.exp(p.detach()).tolist()
    return {
        "u_final": u.detach().cpu().numpy().astype(float),
        "young_final": young,
        "area_final": area,
        "history": history,
    }


def identify_scalars_gn(
    problem: TrussProblem,
    f_ext: np.ndarray,
    u_measured: np.ndarray,
    measured_dofs: np.ndarray,
    young_init: float,
    area_init: float,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    lambda_lm: float = 1e-3,
    device=None,
) -> Dict:
    """Gauss-Newton/LM identification of scalar (E, A) over
    z = [u_free, log E, log A]: dz from (J^T J + lambda I) dz = -J^T r (an
    LU solve, as jnp.linalg.solve), J dense from torch.func.jacrev; the
    step halves up to 12 times until ||r|| falls; converged when
    ||r|| < tol or no step was accepted.  History rows {iteration,
    residual, young, area}.  device: where to solve ("cuda" when None)."""
    data = problem.to_device(device)
    dt, dev = data.loads.dtype, data.device
    free_np, _ = problem.free_fixed()
    free_idx = torch.as_tensor(free_np).to(dev)
    n_free = int(free_np.size)
    f = _as(f_ext, dt, dev)
    mvals = _as(u_measured, dt, dev)
    mdofs = _as(measured_dofs, torch.int64, dev, np.int64)
    f_scale, u_scale = _scales(f, mvals)
    tol = in_working_precision(tolerance, dt)

    def u_of(z):
        u = torch.zeros(data.ndof, dtype=dt, device=dev)
        return u.scatter(0, free_idx, z[:n_free])

    def residual(z):
        u = u_of(z)
        mat = _with_scalars(problem.material, torch.exp(z[n_free]),
                            torch.exp(z[n_free + 1]))
        f_int, _ = internal_force_and_strain(data, mat, u, 1.0)
        rp = (f_int - f)[free_idx] / f_scale
        rd = (mvals - u[mdofs]) / u_scale
        r = torch.cat([rp, rd])
        return r, r

    jacobian_and_residual = torch.func.jacrev(residual, has_aux=True)
    z = torch.cat([torch.zeros(n_free, dtype=dt, device=dev),
                   torch.tensor([np.log(young_init), np.log(area_init)],
                                dtype=dt, device=dev)])
    eye = torch.eye(z.numel(), dtype=dt, device=dev)
    rows = []
    it, conv = 0, False
    while it < max_iterations and not conv:
        j, r = jacobian_and_residual(z)
        with torch.no_grad():
            r_norm = torch.linalg.vector_norm(r)
            dz = torch.linalg.solve(j.T @ j + lambda_lm * eye, -(j.T @ r))
            step = torch.ones((), dtype=dt, device=dev)
            ok = False
            for _ in range(_LS_TRIES):   # one flag read a try
                r_new = torch.linalg.vector_norm(residual(z + step * dz)[0])
                ok = bool(torch.isfinite(r_new) & (r_new < r_norm))
                if ok:
                    break
                step = step * 0.5
            if ok:
                z = z + step * dz
            row = torch.stack([r_norm, torch.exp(z[n_free]),
                               torch.exp(z[n_free + 1])]).tolist()
        rows.append(row)
        conv = row[0] < tol or not ok
        it += 1

    history = [{"iteration": float(k + 1), "residual": row[0],
                "young": row[1], "area": row[2]}
               for k, row in enumerate(rows)]
    young, area = torch.exp(z[n_free:n_free + 2]).tolist()
    return {
        "u_final": u_of(z).cpu().numpy().astype(float),
        "young_final": young,
        "area_final": area,
        "converged": conv,
        "history": history,
    }
