"""Solver phases (counterpart of pinn_fem_tpu/solvers/phases.py: GD_HIST_COLS,
GDPhaseOut, gd_phase, NRPhaseOut, nr_phase, reactions_of, ZPhaseOut,
full_nr_phase, gn_phase), and the batched phases of
pinn_fem_tpu/parallel/batched.py (its vmap of gd_phase and nr_phase).

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

The batched phases (`gd_phase_batched`, `nr_phase_batched`) run B
members on one mesh with vmap's meaning for lax.while_loop: the loop runs
while any member is active, and a member that has stopped keeps its whole
state (u, theta, both Adam moments, its iteration count, converged and
the last residual norm) through a device mask.  The batched GD reads the
mask on the host every GD_CHECK_EVERY iterations, never in between.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.fields import Material
from ..models.problem import ProblemData
from ..ops.assembly import (assemble_stiffness_batched, assemble_system,
                             assemble_system_nonlinear,
                             internal_force_and_strain,
                             internal_force_and_strain_batched,
                             material_coefficients_batched, scatter_add)
from ..ops.linalg import factor_masked, masked_solve, solve_factored

# GD history columns (reference solve_gd history keys, solver.py:308-322).
GD_HIST_COLS = 7  # iteration, loss_total, loss_physics, loss_data, u_norm,
                  # residual_norm, theta_norm

# torch.optim.Adam defaults, written out as optax.scale_by_adam computes
# them (the JAX package's ADAM): b1, b2, eps, eps_root = 0.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def in_working_precision(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype` (float32 or float64), as jnp.asarray(x, dtype)
    rounds a tolerance before the JAX phases compare with it."""
    return float(np.asarray(x, dtype=np.float64 if dtype == torch.float64
                            else np.float32))


class Adam:
    """Adam moments of one tensor; fresh state per phase, as the reference
    builds a new torch.optim.Adam per call (solver.py:234-238)."""

    def __init__(self, like: torch.Tensor):
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0
        self.np_dtype = (np.float64 if like.dtype == torch.float64
                         else np.float32)

    def direction(self, g: torch.Tensor,
                  live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step direction mu_hat / (sqrt(nu_hat) + eps) for gradient g.
        live (B,) bool, for B members (the rows of g): the moments of the
        members where it is false stay as they are.  The count is the
        live members' own: they all started together."""
        mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        if live is not None:
            keep = live.view(-1, *([1] * (g.dim() - 1)))
            mu = torch.where(keep, mu, self.mu)
            nu = torch.where(keep, nu, self.nu)
        self.mu, self.nu = mu, nu
        self.count += 1
        # Bias corrections in the working precision, as optax takes them.
        dt = self.np_dtype
        bc1 = float(dt(1.0) - dt(ADAM_B1) ** dt(self.count))
        bc2 = float(dt(1.0) - dt(ADAM_B2) ** dt(self.count))
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
    tol_w = in_working_precision(tol, dt)
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
        conv = it > 10 and (rnorm < tol_w
                            or (not math.isnan(loss_v) and loss_v < tol_w))
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
             min_denom: float, nonlinear: bool = False) -> NRPhaseOut:
    """One Newton-Raphson phase: same update rule and relative-du criterion
    ||du|| / max(||u||, min_denom) <= tol as the reference solve_nr loop.

    nonlinear=True assembles the Green-Lagrange tangent and internal force
    (2D / 3D).  The one flag read an iteration carries the convergence test
    and the Cholesky info code.  A tangent that fails to factor ends the
    phase with u all NaN: JAX's NaN factor makes its u NaN and its loop runs
    on to max_iter, and either way solve_nr's finite check raises."""
    assemble = assemble_system_nonlinear if nonlinear else assemble_system
    dt, dev = u0.dtype, u0.device
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    min_denom_t = torch.tensor(min_denom, dtype=dt, device=dev)
    u = u0
    res = torch.tensor(float("inf"), dtype=dt, device=dev)
    max_strain = torch.zeros((), dtype=dt, device=dev)
    it, conv = 0, False
    while it < max_iter and not conv:
        k, f_int, max_strain = assemble(data, material, u, load_factor)
        rhs = load_factor * data.loads - f_int
        du, info = masked_solve(k, rhs, data.free_mask)
        u = u + du
        res = (torch.linalg.vector_norm(du)
               / torch.maximum(torch.linalg.vector_norm(u), min_denom_t))
        flags = int((res <= tol_t).to(torch.int32) + 2 * (info != 0))
        it += 1
        if flags & 2:
            u = torch.full_like(u, float("nan"))
            res = torch.full_like(res, float("nan"))
            break
        conv = bool(flags & 1)
    return NRPhaseOut(u=u, n_iters=it, residual=res, converged=conv,
                      max_strain=max_strain)


def reactions_of(data: ProblemData, material: Material, u: torch.Tensor,
                 load_factor) -> torch.Tensor:
    """f_int - lf * f_ext with the free DOFs zeroed (no autograd graph)."""
    with torch.no_grad():
        f_int, _ = internal_force_and_strain(data, material, u, load_factor)
        return (f_int - load_factor * data.loads) * data.fixed_mask


# ------------------------------------------------------ B members at once

# Iterations of the batched GD between two reads of its active mask: the
# results are those of a test every iteration, since a stopped member's
# state does not change; at most CHECK_EVERY - 1 iterations run after the
# last member has stopped.
GD_CHECK_EVERY = 32

# float64 bytes of one chunk of the batched dense assembly (per-member
# tangents are assembled and factored this many members at a time).
DENSE_CHUNK_BYTES = 1 << 30


class BatchedGDPhaseOut(NamedTuple):
    u: torch.Tensor            # (B, ndof)
    theta: Optional[torch.Tensor]  # (B, P) flat parameters, None without
    n_iters: torch.Tensor      # (B,) int32 iterations each member ran
    converged: torch.Tensor    # (B,) bool
    rnorm: torch.Tensor        # (B,) ||r|| at each member's last iteration
                               # (inf where it ran none)


def gd_phase_batched(data: ProblemData, material: Material,
                     loads: torch.Tensor, u0: torch.Tensor,
                     params0: Optional[torch.Tensor],
                     load_factors: torch.Tensor,
                     measured_vals: Optional[torch.Tensor],
                     measured_dofs: Optional[torch.Tensor], has_meas: bool,
                     max_iter: int, tol: float, lr_u: float,
                     lr_theta: float, alpha_physics: float,
                     alpha_data: float, active: Optional[torch.Tensor] = None
                     ) -> BatchedGDPhaseOut:
    """`gd_phase` for B members at once, as the JAX package vmaps it:
    loads (B, ndof), u0 (B, ndof), params0 (B, P) flat theta (None when
    the material has no MLP field), load_factors (B,), measured_vals
    (B, m) at the shared measured_dofs.

    Member b runs the single phase's iteration (dual Adam, BC projection,
    the gate after iteration 10 on ||r|| < tol or loss < tol) until it
    converges or reaches max_iter; from then on its u, theta, Adam moments,
    count, converged flag and ||r|| stay as they were.  active (B,) bool:
    members that run at all (default all); the others keep u0 and params0
    and end with 0 iterations, converged false and ||r|| inf.  One
    evaluation of the members' loss an iteration: kernel 4 once and 4b
    once for all members on a card.  The mask is read on the host every
    GD_CHECK_EVERY iterations."""
    dt, dev = u0.dtype, u0.device
    members = u0.shape[0]
    tol_w = in_working_precision(tol, dt)
    f_ext = load_factors[:, None] * loads
    u = u0.detach().clone()
    th = None if params0 is None else params0.detach().clone()
    if th is not None and th.device != dev:
        raise ValueError("theta and u lie on different devices")
    opt_u = Adam(u)
    opt_th = Adam(th) if th is not None else None
    live = (torch.ones(members, dtype=torch.bool, device=dev)
            if active is None else active.to(dev).clone())
    iters = torch.zeros(members, dtype=torch.int32, device=dev)
    conv = torch.zeros(members, dtype=torch.bool, device=dev)
    rnorm = torch.full((members,), float("inf"), dtype=dt, device=dev)
    it = 0
    while it < max_iter:
        u = u.requires_grad_()
        wrt = [u]
        if th is not None:
            th = th.requires_grad_()
            wrt.append(th)
        f_int, _ = internal_force_and_strain_batched(data, material, u,
                                                     load_factors, th)
        r = (f_int - f_ext) * data.free_mask
        loss_p = 0.5 * torch.sum(r * r, dim=1)
        if has_meas:
            rd = measured_vals - u[:, measured_dofs]
            loss = (alpha_physics * loss_p
                    + alpha_data * torch.mean(rd * rd, dim=1))
        else:
            loss = alpha_physics * loss_p
        # The members are independent: the gradient of the sum is each
        # member's own.
        grads = torch.autograd.grad(torch.sum(loss), wrt, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(wrt, grads)]

        with torch.no_grad():
            step = live[:, None]
            u_new = (u - lr_u * opt_u.direction(grads[0], live)) \
                * data.free_mask
            u = torch.where(step, u_new, u)
            if th is not None:
                th = torch.where(
                    step, th - lr_theta * opt_th.direction(grads[1], live), th)
            rn = torch.linalg.vector_norm(r, dim=1)
            stop = (it > 10) & ((rn < tol_w)
                                | (~torch.isnan(loss) & (loss < tol_w)))
            rnorm = torch.where(live, rn, rnorm)
            conv = torch.where(live, stop, conv)
            iters = iters + live.to(torch.int32)
            live = live & ~stop
        it += 1
        if it % GD_CHECK_EVERY == 0 and not bool(live.any()):
            break
    return BatchedGDPhaseOut(u=u.detach(),
                             theta=None if th is None else th.detach(),
                             n_iters=iters, converged=conv, rnorm=rnorm)


class BatchedNRPhaseOut(NamedTuple):
    u: torch.Tensor            # (B, ndof)
    n_iters: torch.Tensor      # (B,) int32
    residual: torch.Tensor     # (B,)
    converged: torch.Tensor    # (B,) bool


def nr_phase_batched(data: ProblemData, material: Material,
                     loads: torch.Tensor, u0: torch.Tensor,
                     load_factors: torch.Tensor, max_iter: int, tol: float,
                     min_denom: float,
                     tangent_load_factor: Optional[float] = None
                     ) -> BatchedNRPhaseOut:
    """`nr_phase` (linear elements, dense) for B members at once: loads
    (B, ndof), u0 (B, ndof), load_factors (B,).

    The linear tangent does not depend on u, so it is assembled and
    factored once for the phase (the JAX loop refactors the same matrix
    every iteration).  tangent_load_factor: the load factor every member
    shares; then one tangent serves all members (one factorization, B
    right-hand sides), as vmap leaves an unbatched K.  None: each member's
    own tangent at its load factor (a (B, ndof, ndof) factorization,
    assembled DENSE_CHUNK_BYTES at a time).  A member whose tangent does
    not factor ends with u all NaN, residual NaN, converged false and
    max_iter iterations, as JAX's NaN factor runs its member to max_iter;
    nothing raises.  One flag read an iteration (a Newton iteration is a
    dense solve; the single nr_phase reads once an iteration too)."""
    dt, dev = u0.dtype, u0.device
    members, ndof = u0.shape
    mask = data.free_mask
    if tangent_load_factor is not None:
        k = assemble_system(data, material, u0[0], tangent_load_factor)[0]
        factors = factor_masked(k, mask)
        failed = (factors[2] != 0).expand(members)
    else:
        young, area, _ = material_coefficients_batched(data, material,
                                                       load_factors)
        chunk = max(1, DENSE_CHUNK_BYTES // (8 * ndof * ndof))
        parts = [factor_masked(assemble_stiffness_batched(
            data, young[b:b + chunk], area[b:b + chunk]), mask)
            for b in range(0, members, chunk)]
        factors = tuple(torch.cat(col) for col in zip(*parts))
        failed = factors[2] != 0
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    min_denom_t = torch.tensor(min_denom, dtype=dt, device=dev)
    u = u0.clone()
    live = ~failed
    iters = torch.zeros(members, dtype=torch.int32, device=dev)
    conv = torch.zeros(members, dtype=torch.bool, device=dev)
    res = torch.full((members,), float("inf"), dtype=dt, device=dev)
    it = 0
    while it < max_iter:
        f_int, _ = internal_force_and_strain_batched(data, material, u,
                                                     load_factors)
        du = solve_factored(*factors[:2], load_factors[:, None] * loads
                            - f_int, mask)
        u_new = u + du
        r_new = (torch.linalg.vector_norm(du, dim=1)
                 / torch.maximum(torch.linalg.vector_norm(u_new, dim=1),
                                 min_denom_t))
        stop = r_new <= tol_t
        u = torch.where(live[:, None], u_new, u)
        res = torch.where(live, r_new, res)
        conv = torch.where(live, stop, conv)
        iters = iters + live.to(torch.int32)
        live = live & ~stop
        it += 1
        if not bool(live.any()):
            break
    nan = torch.tensor(float("nan"), dtype=dt, device=dev)
    return BatchedNRPhaseOut(
        u=torch.where(failed[:, None], nan, u),
        n_iters=torch.where(failed, max_iter, iters).to(torch.int32),
        residual=torch.where(failed, nan, res),
        converged=conv & ~failed)


def reactions_of_batched(data: ProblemData, material: Material,
                         loads: torch.Tensor, u: torch.Tensor,
                         load_factors: torch.Tensor, params=None
                         ) -> torch.Tensor:
    """`reactions_of` of B members: (B, ndof), each at its own u, loads,
    load factor and parameters (no autograd graph)."""
    with torch.no_grad():
        f_int, _ = internal_force_and_strain_batched(data, material, u,
                                                     load_factors, params)
        return (f_int - load_factors[:, None] * loads) * data.fixed_mask


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
    tol_w = in_working_precision(tol, dt)
    data_tol_w = in_working_precision(data_tol, dt)
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
            conv = total < tol_w or (rnorm < tol_w
                                     and (not has_meas or drms < data_tol_w))
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
    tol_w = in_working_precision(tol, dt)
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
        conv = row[3] < tol_w and row[4] > 0
        # Stall: the line search never accepted and the step it ended on
        # did not lower the residual.
        stalled = not accepted and row[5] >= row[2]
        z = z_new
        it += 1
    return ZPhaseOut(u=space.u_of(z), theta=space.theta_of(z), hist=hist,
                     converged=conv, accepted=steps_accepted,
                     host_syncs=syncs)
