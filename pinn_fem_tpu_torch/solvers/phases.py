"""Solver phases (counterpart of pinn_fem_tpu/solvers/phases.py: GD_HIST_COLS,
GDPhaseOut, gd_phase, NRPhaseOut, nr_phase, reactions_of).

The JAX phases run inside lax.while_loop; here each is a Python loop that
reads its convergence test on the host once per iteration (one device sync
per GD or Newton iteration).  The full-NR and Gauss-Newton phases wait for
ROADMAP item 6.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from ..models.fields import Material
from ..models.problem import ProblemData
from ..ops.assembly import (assemble_system, internal_force_and_strain,
                             scatter_add)
from ..ops.linalg import masked_solve

# GD history columns (reference solve_gd history keys, solver.py:308-322).
GD_HIST_COLS = 7  # iteration, loss_total, loss_physics, loss_data, u_norm,
                  # residual_norm, theta_norm

# torch.optim.Adam defaults, written out as optax.scale_by_adam computes
# them (the JAX package's ADAM): b1, b2, eps, eps_root = 0.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam moments of one tensor; fresh state per phase, as the reference
    builds a new torch.optim.Adam per call (solver.py:234-238)."""

    def __init__(self, like: torch.Tensor):
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def direction(self, g: torch.Tensor) -> torch.Tensor:
        """The step direction mu_hat / (sqrt(nu_hat) + eps) for gradient g."""
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        self.count += 1
        # Bias corrections in the working precision, as optax takes them.
        one = np.float32(1.0)
        bc1 = float(one - np.float32(ADAM_B1) ** np.float32(self.count))
        bc2 = float(one - np.float32(ADAM_B2) ** np.float32(self.count))
        return (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + ADAM_EPS)


class GDPhaseOut(NamedTuple):
    u: torch.Tensor
    theta: list
    hist: List[List[float]]  # one GD_HIST_COLS row per iteration
    n_iters: int
    converged: bool


def theta_param_list(theta: list) -> list:
    """Flat [W1, b1, W2, b2, ...] per field: the reference's parameter
    order (torch Module.parameters() over Sequential Linear layers)."""
    return [t for layers in theta for layer in layers for t in layer]


def _flatten(theta: list):
    """theta -> one flat tensor in theta_param_list order, or None."""
    params = theta_param_list(theta)
    return torch.cat([t.reshape(-1) for t in params]) if params else None


def _unflatten(flat: torch.Tensor, like: list) -> list:
    """Views of `flat` shaped as `like`; one split, so autograd returns the
    flat gradient with one concatenation."""
    shapes = [t.shape for t in theta_param_list(like)]
    pieces = iter(p.view(s) for p, s in zip(
        torch.split(flat, [math.prod(s) for s in shapes]), shapes))
    return [[(next(pieces), next(pieces)) for _ in layers] for layers in like]


def gd_phase(data: ProblemData, material: Material, set_theta_fn,
             u0: torch.Tensor, theta0: list, load_factor: float,
             measured_vals: torch.Tensor, measured_dofs: torch.Tensor,
             has_meas: bool, max_iter: int, tol: float, lr_u: float,
             lr_theta: float, alpha_physics: float, alpha_data: float
             ) -> GDPhaseOut:
    """One GD optimization phase (reference solve_gd inner loop,
    solver.py:252-355): dual Adam on u and theta, BC projection, and the
    convergence gate after iteration 10 on residual_norm < tol OR
    loss < tol.  Adam also steps the fixed DOFs; the projection zeroes
    them.  theta0 must lie on u0's device."""
    dt = u0.dtype
    lf = float(load_factor)
    tol32 = float(np.float32(tol))
    f_ext = lf * data.loads
    u = u0.detach()
    th = _flatten(theta0)
    if th is not None:
        th = th.detach()
        if th.device != u.device:
            raise ValueError("theta and u lie on different devices")
    opt_u = Adam(u)
    opt_th = Adam(th) if th is not None else None
    if th is not None:
        # theta_norm = sum over the parameter tensors of their norms.
        sizes = [t.numel() for t in theta_param_list(theta0)]
        leaf_of = torch.repeat_interleave(
            torch.arange(len(sizes), device=th.device),
            torch.tensor(sizes, device=th.device))
    hist: List[List[float]] = []
    it, conv = 0, False
    while it < max_iter and not conv:
        u = u.requires_grad_()
        wrt = [u]
        mat = material
        if th is not None:
            th = th.requires_grad_()
            wrt.append(th)
            mat = set_theta_fn(material, _unflatten(th, theta0))
        f_int, _ = internal_force_and_strain(data, mat, u, lf)
        r = (f_int - f_ext) * data.free_mask
        loss_p = 0.5 * torch.sum(r * r)
        if has_meas:
            rd = measured_vals - u[measured_dofs]
            loss_d = torch.mean(rd * rd)
            loss = alpha_physics * loss_p + alpha_data * loss_d
        else:
            loss_d = torch.zeros((), dtype=dt, device=u.device)
            loss = alpha_physics * loss_p
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(wrt, grads)]

        with torch.no_grad():
            u = (u - lr_u * opt_u.direction(grads[0])) * data.free_mask
            theta_norm = torch.zeros((), dtype=dt, device=u.device)
            if th is not None:
                th = th - lr_theta * opt_th.direction(grads[1])
                theta_norm = torch.sum(torch.sqrt(
                    scatter_add(len(sizes), leaf_of, th * th)))
            row = [float(it + 1)] + torch.stack([
                loss, loss_p, loss_d, torch.linalg.vector_norm(u),
                torch.linalg.vector_norm(r), theta_norm]).tolist()
        hist.append(row)
        loss_v, rnorm = row[1], row[5]
        conv = it > 10 and (rnorm < tol32
                            or (not math.isnan(loss_v) and loss_v < tol32))
        it += 1
    theta = _unflatten(th, theta0) if th is not None else []
    return GDPhaseOut(u=u, theta=theta, hist=hist, n_iters=it,
                      converged=conv)


class NRPhaseOut(NamedTuple):
    u: torch.Tensor
    n_iters: int
    residual: torch.Tensor
    converged: bool
    max_strain: torch.Tensor


def nr_phase(data: ProblemData, material: Material, u0: torch.Tensor,
             load_factor: float, max_iter: int, tol: float,
             min_denom: float) -> NRPhaseOut:
    """One Newton-Raphson phase: same update rule and relative-du criterion
    ||du|| / max(||u||, min_denom) <= tol as the reference solve_nr loop."""
    dt, dev = u0.dtype, u0.device
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    min_denom_t = torch.tensor(min_denom, dtype=dt, device=dev)
    u = u0
    res = torch.tensor(float("inf"), dtype=dt, device=dev)
    max_strain = torch.zeros((), dtype=dt, device=dev)
    it, conv = 0, False
    while it < max_iter and not conv:
        k, f_int, max_strain = assemble_system(data, material, u, load_factor)
        rhs = load_factor * data.loads - f_int
        du = masked_solve(k, rhs, data.free_mask)
        u = u + du
        res = (torch.linalg.vector_norm(du)
               / torch.maximum(torch.linalg.vector_norm(u), min_denom_t))
        conv = bool(res <= tol_t)
        it += 1
    return NRPhaseOut(u=u, n_iters=it, residual=res, converged=conv,
                      max_strain=max_strain)


def reactions_of(data: ProblemData, material: Material, u: torch.Tensor,
                 load_factor) -> torch.Tensor:
    """f_int - lf * f_ext with the free DOFs zeroed (no autograd graph)."""
    with torch.no_grad():
        f_int, _ = internal_force_and_strain(data, material, u, load_factor)
        return (f_int - load_factor * data.loads) * data.fixed_mask
