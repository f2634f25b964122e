"""Solver phases (counterpart of pinn_fem_tpu/solvers/phases.py: GD_HIST_COLS,
GDPhaseOut, gd_phase, NRPhaseOut, nr_phase, reactions_of, ZPhaseOut,
full_nr_phase, gn_phase).

The JAX phases run inside lax.while_loop; here each is a Python loop that
reads its convergence test on the host once per iteration (one device sync
per GD or Newton iteration).  The full-NR and Gauss-Newton phases also
read one flag for each Levenberg-Marquardt or line-search try.

The second-order phases work on z = [u_free, theta_flat] and take two
routes through the material (ops/assembly.material_coefficients): the
gradient, Hessian, Jacobian and the residual that multiplies J^T come
from the torch form under torch.func; every value-only evaluation (the
history row, the LM trial losses, the line-search and stall residual
norms) takes the value route, kernel 4 on a card.  Two values compared
with each other always come from the same route.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

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


_LM_TRIES = 16   # full-NR lambda escalations before the gradient fallback
_LS_TRIES = 15   # Gauss-Newton Armijo backtracking tries
_ARMIJO_C = 1e-4
_LS_SHRINK = 0.7


class ZPhaseOut(NamedTuple):
    """Output of the coupled (u, theta) phases (full-NR, Gauss-Newton)."""

    u: torch.Tensor           # (ndof,) full displacement vector
    theta: list
    hist: List[List[float]]   # six columns a row
    converged: bool
    accepted: List[bool]      # per step: LM try / line search accepted
    host_syncs: int           # device values read on the host


class ZSpace:
    """z = [u_free, theta_flat] (theta in _flatten order) and back."""

    def __init__(self, data: ProblemData, material: Material, set_theta_fn,
                 theta0: list, free_idx: torch.Tensor):
        self.data, self.material = data, material
        self.set_theta_fn, self.theta0 = set_theta_fn, theta0
        self.free_idx, self.n_free = free_idx, free_idx.numel()

    def pack(self, u: torch.Tensor) -> torch.Tensor:
        th = _flatten(self.theta0)
        parts = [u[self.free_idx]] + ([th] if th is not None else [])
        return torch.cat(parts).detach()

    def u_of(self, z: torch.Tensor) -> torch.Tensor:
        u = torch.zeros(self.data.ndof, dtype=z.dtype, device=z.device)
        return u.scatter(0, self.free_idx, z[:self.n_free])

    def theta_of(self, z: torch.Tensor) -> list:
        if not self.theta0:
            return []
        return _unflatten(z[self.n_free:], self.theta0)

    def internal_force(self, z: torch.Tensor, load_factor: float,
                       torch_form: bool) -> torch.Tensor:
        """f_int at (u, theta) of z, the material on the route given."""
        mat = (self.set_theta_fn(self.material, self.theta_of(z))
               if self.theta0 else self.material)
        f_int, _ = internal_force_and_strain(self.data, mat, self.u_of(z),
                                             load_factor, torch_form)
        return f_int


class FullNRLoss:
    """The full-NR loss of z, L = 0.5 ||R_free||^2 + mean((u_m - meas)^2)
    (unweighted), on either material route."""

    def __init__(self, space: ZSpace, load_factor: float,
                 measured_vals: Optional[torch.Tensor],
                 measured_dofs: Optional[torch.Tensor], has_meas: bool):
        self.space, self.lf = space, float(load_factor)
        self.mvals, self.mdofs, self.has_meas = (measured_vals, measured_dofs,
                                                 has_meas)

    def parts(self, z: torch.Tensor, torch_form: bool = False):
        """(loss, loss_physics, loss_data)."""
        data = self.space.data
        f_int = self.space.internal_force(z, self.lf, torch_form)
        r = (f_int - self.lf * data.loads) * data.free_mask
        lp = 0.5 * torch.sum(r * r)
        if self.has_meas:
            rd = self.space.u_of(z)[self.mdofs] - self.mvals
            ld = torch.mean(rd * rd)
        else:
            ld = torch.zeros((), dtype=z.dtype, device=z.device)
        return lp + ld, lp, ld

    def value(self, z: torch.Tensor) -> torch.Tensor:
        """The loss on the value route (kernel 4 on a card)."""
        return self.parts(z)[0]

    def hessian_and_gradient(self, z: torch.Tensor):
        """(H, g) of the torch form, from one torch.func.jacfwd over
        torch.func.grad (forward over reverse)."""
        def grad_twice(zz):
            g = torch.func.grad(lambda x: self.parts(x, True)[0])(zz)
            return g, g

        return torch.func.jacfwd(grad_twice, has_aux=True)(z)


class GNResidual:
    """The Gauss-Newton residual of z, [alpha_p (f_int - lf f)_free,
    alpha_d (meas - u_m)], on either material route."""

    def __init__(self, space: ZSpace, load_factor: float,
                 measured_vals: Optional[torch.Tensor],
                 measured_dofs: Optional[torch.Tensor], has_meas: bool,
                 alpha_physics: float, alpha_data: float):
        self.space, self.lf = space, float(load_factor)
        self.mvals, self.mdofs, self.has_meas = (measured_vals, measured_dofs,
                                                 has_meas)
        self.a_p, self.a_d = alpha_physics, alpha_data

    def parts(self, z: torch.Tensor, torch_form: bool = False):
        """(r, physics part unweighted, data part unweighted)."""
        space = self.space
        f_int = space.internal_force(z, self.lf, torch_form)
        rp = (f_int - self.lf * space.data.loads)[space.free_idx]
        if self.has_meas:
            rd = self.mvals - space.u_of(z)[self.mdofs]
            return torch.cat([self.a_p * rp, self.a_d * rd]), rp, rd
        return (self.a_p * rp, rp,
                torch.zeros((0,), dtype=z.dtype, device=z.device))

    def norm(self, z: torch.Tensor) -> torch.Tensor:
        """||r|| on the value route (kernel 4 on a card)."""
        return torch.linalg.vector_norm(self.parts(z)[0])

    def jacobian_and_residual(self, z: torch.Tensor):
        """(J, r) of the torch form, from one torch.func.jacrev."""
        def residual_twice(zz):
            r = self.parts(zz, True)[0]
            return r, r

        return torch.func.jacrev(residual_twice, has_aux=True)(z)


def lm_step(z: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
            loss0: torch.Tensor, loss_value: Callable, lr: torch.Tensor):
    """Levenberg-Marquardt-damped Newton step (JAX full_nr_phase
    newton_step): lambda from max(1e-6 tr(H) / n_z, 1e-12), times 10 while
    below lambda0 * 10^16; a try is accepted when its Cholesky succeeds,
    every entry of z is finite and loss_value(z_new) < loss0; with no
    accepted try, the gradient step z - lr * g.  H is read in its lower
    triangle and not symmetrized, as cho_factor(lower=True) reads it.
    Returns (z_next, tries, accepted), one flag read on the host per
    try."""
    n_z = z.numel()
    eye = torch.eye(n_z, dtype=z.dtype, device=z.device)
    lam0 = torch.clamp_min(1e-6 * torch.trace(h) / n_z, 1e-12)
    limit = lam0 * 10.0 ** _LM_TRIES
    lam, tries = lam0, 0
    while True:
        chol, info = torch.linalg.cholesky_ex(h + lam * eye)
        z_new = z - torch.cholesky_solve(g[:, None], chol)[:, 0]
        ok = ((lam < limit) & (info == 0) & torch.all(torch.isfinite(z_new))
              & (loss_value(z_new) < loss0))
        lam = lam * 10.0
        ok, more = torch.stack([ok, lam < limit]).tolist()
        tries += 1
        if ok:
            return z_new, tries, True
        if not more:
            return z - lr * g, tries, False


def full_nr_phase(data: ProblemData, material: Material, set_theta_fn,
                  u0: torch.Tensor, theta0: list, free_idx: torch.Tensor,
                  load_factor: float, measured_vals: Optional[torch.Tensor],
                  measured_dofs: Optional[torch.Tensor], has_meas: bool,
                  max_iter: int, tol: float, data_tol: float, lr_u: float,
                  lr_theta: float, clock: Optional[Callable] = None
                  ) -> ZPhaseOut:
    """One full-Newton phase over z = [u_free, theta] (JAX full_nr_phase):
    `FullNRLoss`, H and g from its torch form, LM steps (`lm_step`) on its
    value route.  Converged when the gradient norm is below tol, or when
    ||R_free|| = sqrt(2 loss_physics) is, with the data RMS below data_tol
    where there are measurements.  History rows [iteration (0-based),
    loss_total, loss_physics, loss_data, grad_norm_u, grad_norm_theta],
    none on the converging iteration.  clock(part), when given, is called
    after each part of an iteration ("loss", "gradient_and_hessian",
    "lm"), for measurement."""
    dt, dev = u0.dtype, u0.device
    space = ZSpace(data, material, set_theta_fn, theta0, free_idx)
    objective = FullNRLoss(space, load_factor, measured_vals, measured_dofs,
                           has_meas)
    n_free = space.n_free
    z = space.pack(u0)
    lr = torch.cat([torch.full((n_free,), lr_u, dtype=dt, device=dev),
                    torch.full((z.numel() - n_free,), lr_theta, dtype=dt,
                               device=dev)])
    tol32, data_tol32 = float(np.float32(tol)), float(np.float32(data_tol))
    hist: List[List[float]] = []
    accepted: List[bool] = []
    it, conv, syncs = 0, False, 0
    while it < max_iter and not conv:
        with torch.no_grad():
            loss, lp, ld = objective.parts(z)
        if clock:
            clock("loss")
        h, g = objective.hessian_and_gradient(z)
        if clock:
            clock("gradient_and_hessian")
        with torch.no_grad():
            gnu = torch.linalg.vector_norm(g[:n_free])
            gnt = torch.linalg.vector_norm(g[n_free:])
            row = torch.stack([loss, lp, ld, gnu, gnt,
                               torch.sqrt(gnu * gnu + gnt * gnt),
                               torch.sqrt(2.0 * lp), torch.sqrt(ld)]).tolist()
            syncs += 1
            total, rnorm, drms = row[5:]
            conv = total < tol32 or (rnorm < tol32
                                     and (not has_meas or drms < data_tol32))
            if not conv:
                z, tries, ok = lm_step(z, g, h, loss, objective.value, lr)
                syncs += tries
                accepted.append(ok)
                hist.append([float(it)] + row[:5])
                if clock:
                    clock("lm")
        it += 1
    return ZPhaseOut(u=space.u_of(z), theta=space.theta_of(z), hist=hist,
                     converged=conv, accepted=accepted, host_syncs=syncs)


def gn_phase(data: ProblemData, material: Material, set_theta_fn,
             u0: torch.Tensor, theta0: list, free_idx: torch.Tensor,
             load_factor: float, measured_vals: Optional[torch.Tensor],
             measured_dofs: Optional[torch.Tensor], has_meas: bool,
             max_iter: int, tol: float, alpha_physics: float,
             alpha_data: float, min_denom: float) -> ZPhaseOut:
    """One Gauss-Newton / LM / Armijo phase over z = [u_free, theta] (JAX
    gn_phase): `GNResidual`, J and the r that multiplies J^T from its
    torch form, damping 1e-6 tr(J^T J) / n_z; backtracking on its value
    route, accepted when |R(z + s dz)| < |R(z)| (1 - 1e-4 s), s *= 0.7, at
    most 15 tries.  Converged when relative_error = |R| / max(|u_free|,
    min_denom) < tol; a step that was not accepted and did not lower |R|
    stalls the loop.  History rows [iteration (1-based), r_physics,
    r_data, r_total, relative_error, step_size], one every iteration."""
    dt, dev = u0.dtype, u0.device
    space = ZSpace(data, material, set_theta_fn, theta0, free_idx)
    residual = GNResidual(space, load_factor, measured_vals, measured_dofs,
                          has_meas, alpha_physics, alpha_data)
    n_free = space.n_free
    z = space.pack(u0)
    eye = torch.eye(z.numel(), dtype=dt, device=dev)
    tol32 = float(np.float32(tol))
    hist: List[List[float]] = []
    steps_accepted: List[bool] = []
    it, conv, stalled, syncs = 0, False, False, 0
    while it < max_iter and not conv and not stalled:
        j, r = residual.jacobian_and_residual(z)
        with torch.no_grad():
            rv, rp, rd = residual.parts(z)
            r_norm = torch.linalg.vector_norm(rv)
            jtj = j.T @ j
            damping = 1e-6 * torch.trace(jtj) / z.numel()
            dz = torch.linalg.solve(jtj + damping * eye, -(j.T @ r))
            step = torch.ones((), dtype=dt, device=dev)
            accepted = False
            for _ in range(_LS_TRIES):   # one flag read a try
                r_test = residual.norm(z + step * dz)
                ok = torch.isfinite(r_test) & (
                    r_test < r_norm * (1.0 - _ARMIJO_C * step))
                syncs += 1
                if bool(ok):
                    accepted = True
                    break
                step = step * _LS_SHRINK
            z_new = z + step * dz
            rel_err = r_norm / torch.clamp_min(
                torch.linalg.vector_norm(z_new[:n_free]), min_denom)
            vals = [torch.linalg.vector_norm(rp), torch.linalg.vector_norm(rd),
                    r_norm, rel_err, step]
            if not accepted:
                vals.append(residual.norm(z_new))
            row = torch.stack(vals).tolist()
            syncs += 1
        hist.append([float(it + 1)] + row[:5])
        steps_accepted.append(accepted)
        conv = row[3] < tol32 and row[4] > 0
        # Stall: the line search never accepted and the step it ended on
        # did not lower the residual.
        stalled = not accepted and row[5] >= row[2]
        z = z_new
        it += 1
    return ZPhaseOut(u=space.u_of(z), theta=space.theta_of(z), hist=hist,
                     converged=conv, accepted=steps_accepted,
                     host_syncs=syncs)
