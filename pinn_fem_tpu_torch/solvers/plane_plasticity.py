"""Incremental elastoplastic statics for the plane continuum family: load
stepping and damped Newton with the consistent tangent over the batched J2
Gauss-point map of ops/plane_plastic.py (counterpart of
pinn_fem_tpu/solvers/plane_plasticity.py).

Within a load step the trial state is the committed state of the previous
step; the internal variables commit at the step's end.  Residuals are
normalized by the load-pattern norm |f_ext|.  Each Newton update is damped
by Armijo backtracking on |r| (the consistent tangent is discontinuous at
the yield surface).  Two tiers, as in the JAX package:

  * float64 (ndof <= DENSE_DOF_LIMIT, the default; host=True forces it):
    the JAX host tier's algorithm (stop at res <= tol only, the masked
    tangent solved by `torch.linalg.solve`, up to 11 halvings keeping the
    best trial) in float64 torch on the caller's device, the card by
    default, or on the CPU with host=True;
  * device (host=False, or above the limit): the JAX device program's
    algorithm in the working dtype: the tolerance floored at 1e-5 in
    float32, a stall stop once the residual is inside sqrt(tol), the dense
    masked tangent factored by LU with one refinement sweep
    (`ops.linalg.masked_solve(assume_spd=False)`), the line search halving
    down to 2^-10.  The residual, the stop test and the first trial of the
    line search are computed on the device and read by the host once a
    Newton iteration; a rejected first trial reads once a halving.  The
    records stay on the device and are fetched once.  The JAX package pads
    the schedule to a power of two (a bucket of its compiled program) and
    cuts its outputs back to n; the port runs the n steps.

The dense tangent is one float64 scatter rounded once to the working dtype
(ops/assembly.scatter_add).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.plane import PlaneProblem, _body_force_vectors
from ..ops.assembly import scatter_add
from ..ops.linalg import masked_solve
from ..ops.plane_plastic import (gp_geometry, gp_geometry_bbar,
                                 initial_plane_state, plane_plastic_blocks,
                                 plane_plastic_blocks_bbar, von_mises_4)
from ..ops.plastic import params_arrays
from ..utils.runtime import default_dtype, resolve_device


class PlanePlasticResult(NamedTuple):
    load_factors: np.ndarray     # (n_steps,)
    displacements: np.ndarray    # (n_steps, ndof)
    stresses: np.ndarray         # (n_steps, m, 3) gp-avg Voigt
    sigma_zz: np.ndarray         # (n_steps, m) gp-avg out-of-plane
    von_mises: np.ndarray        # (n_steps, m) gp-avg
    eq_plastic: np.ndarray       # (n_steps, m) gp-avg alpha
    iterations: np.ndarray       # (n_steps,)
    residuals: np.ndarray        # (n_steps,) final |R|/|f_ext|
    converged: bool
    n_plastic: np.ndarray        # (n_steps,) elements actively yielding


def _schedule(load_factors, target, n_steps) -> np.ndarray:
    from .plasticity import ramp_schedule

    if load_factors is None:
        load_factors = ramp_schedule(float(target), int(n_steps))
    lfs = np.asarray(load_factors, dtype=float).reshape(-1)
    if lfs.size == 0:
        raise ValueError("load_factors must be non-empty")
    return lfs


class _System:
    """The element geometry, material and load pattern of one tier, in
    `dtype` on `device`; `__call__(u, state)` assembles (K or None, f_int,
    sig3, szz, new state)."""

    def __init__(self, problem: PlaneProblem, sy, hi, hk, bbar: bool,
                 tangent_floor: float, dtype, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=device).to(dtype)

        self.ndof = problem.ndof
        geometry = gp_geometry_bbar if bbar else gp_geometry
        self.b, self.wdet = (a.to(dtype) for a in geometry(problem, device))
        self.dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                                  device=device)
        self.flat = self.dm[:, :, None] * self.ndof + self.dm[:, None, :]
        self.mask = t(problem.free_mask())
        # Summed in float64 and rounded once, as the JAX tiers take it.
        self.f_ext = ((_body_force_vectors(problem, device)
                       + torch.as_tensor(problem.loads, device=device))
                      * torch.as_tensor(problem.free_mask(), device=device)
                      ).to(dtype)
        self.material = [t(a) for a in (problem.young, problem.poisson,
                                        problem.thickness, sy, hi, hk)]
        self.bbar, self.plane_strain = bbar, problem.plane_strain
        self.floor = tangent_floor

    def __call__(self, u, state, tangent: bool = True):
        young, poisson, thick, sy, hi, hk = self.material
        if self.bbar:
            ke, fe, sig3, szz, st = plane_plastic_blocks_bbar(
                self.b, self.wdet, thick, u[self.dm], state, young, poisson,
                sy, hi, hk, self.floor)
        else:
            ke, fe, sig3, szz, st = plane_plastic_blocks(
                self.b, self.wdet, thick, u[self.dm], state, young, poisson,
                sy, hi, hk, self.plane_strain, self.floor)
        n = self.ndof
        k = (scatter_add(n * n, self.flat, ke).reshape(n, n) if tangent
             else None)
        return k, scatter_add(n, self.dm, fe), sig3, szz, st


def _rows(u, sig3, szz, st, state0):
    """One step's record: u, gp-averaged stresses, sigma_zz, von Mises,
    alpha, and the count of elements whose alpha rose."""
    vm = von_mises_4(sig3, szz)
    n_pl = torch.count_nonzero(torch.any(st.alpha > state0.alpha, dim=1))
    return (u, sig3.mean(dim=1), szz.mean(dim=1), vm.mean(dim=1),
            st.alpha.mean(dim=1), n_pl)


def _result(lfs, rows, iters, residuals, ok) -> PlanePlasticResult:
    cols = [torch.stack(c).cpu().numpy().astype(float) for c in zip(*rows)]
    u, sig, szz, vm, al, n_pl = cols
    return PlanePlasticResult(
        load_factors=np.asarray(lfs, dtype=float), displacements=u,
        stresses=sig, sigma_zz=szz, von_mises=vm, eq_plastic=al,
        iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float), converged=bool(ok),
        n_plastic=n_pl.astype(int))


def _float64_solve(problem: PlaneProblem, sy, hi, hk, lfs, tol, max_iter,
                   tangent_floor, min_denom, bbar: bool,
                   device) -> PlanePlasticResult:
    """The JAX host tier (_host_solve) in float64 torch on `device`."""
    f64 = torch.float64
    system = _System(problem, sy, hi, hk, bbar, tangent_floor, f64, device)
    mask, f_ext = system.mask, system.f_ext
    fnorm = max(float(torch.linalg.vector_norm(f_ext)), min_denom)
    km_fix = torch.diag(1.0 - mask)
    ngp = system.wdet.shape[1]
    u = torch.zeros(problem.ndof, dtype=f64, device=device)
    state = initial_plane_state(problem.nelm, ngp, f64, device)

    def resid_norm(u_try, lf):
        _, f_int, _, _, _ = system(u_try, state, tangent=False)
        return float(torch.linalg.vector_norm((lf * f_ext - f_int) * mask)
                     ) / fnorm

    rows, iters, residuals, all_ok = [], [], [], True
    for lf in lfs:
        lf = float(lf)
        ok, res, it_used = False, np.inf, max_iter
        for it in range(max_iter):
            k_t, f_int, sig3, szz, st = system(u, state)
            r = (lf * f_ext - f_int) * mask
            res = float(torch.linalg.vector_norm(r)) / fnorm
            if res <= tol:
                ok, it_used = True, it
                break
            km = mask[:, None] * k_t * mask[None, :] + km_fix
            du = torch.linalg.solve(km, r) * mask
            # Armijo backtracking on |r|; the best trial is kept when no
            # halving satisfies it.
            s, best_s, best_res = 1.0, 1.0, np.inf
            for _ in range(11):
                res_try = resid_norm(u + s * du, lf)
                if res_try < best_res:
                    best_s, best_res = s, res_try
                if res_try <= (1.0 - 1e-4 * s) * res:
                    break
                s *= 0.5
            u = u + best_s * du
        all_ok &= ok
        if not ok:
            # The loop updates u after assembling: evaluate (sigma, state)
            # once more at the final u.
            _, f_int, sig3, szz, st = system(u, state, tangent=False)
            res = float(torch.linalg.vector_norm(
                (lf * f_ext - f_int) * mask)) / fnorm
        rows.append(_rows(u, sig3, szz, st, state))
        state = st
        iters.append(it_used)
        residuals.append(res)
    return _result(lfs, rows, iters, residuals, all_ok)


def _device_solve(problem: PlaneProblem, sy, hi, hk, lfs, tol, max_iter,
                  tangent_floor, min_denom, bbar: bool, dtype,
                  device) -> PlanePlasticResult:
    """The JAX device program (_device_core) in `dtype` on `device`."""
    npf = np.float64 if dtype == torch.float64 else np.float32
    system = _System(problem, sy, hi, hk, bbar, float(npf(tangent_floor)),
                     dtype, device)
    mask, f_ext = system.mask, system.f_ext
    fnorm = torch.clamp_min(torch.linalg.vector_norm(f_ext),
                            float(npf(min_denom)))
    tol_t = torch.tensor(tol, dtype=dtype, device=device)
    sqrt_tol = torch.sqrt(tol_t)
    ngp = system.wdet.shape[1]
    u = torch.zeros(problem.ndof, dtype=dtype, device=device)
    state = initial_plane_state(problem.nelm, ngp, dtype, device)
    one = torch.ones((), dtype=dtype, device=device)

    rows, iters, res_rows, conv_rows = [], [], [], []
    for lf in lfs:
        lf = float(npf(lf))

        def resid_of(u_try):
            _, f_int, _, _, _ = system(u_try, state, tangent=False)
            return torch.linalg.vector_norm((lf * f_ext - f_int) * mask) \
                / fnorm

        res_prev = torch.full((), float("inf"), dtype=dtype, device=device)
        it = 0
        while it < max_iter:
            k_t, f_int, _, _, _ = system(u, state)
            r = (lf * f_ext - f_int) * mask
            res = torch.linalg.vector_norm(r) / fnorm
            stalled = (res >= res_prev) & (res_prev <= sqrt_tol)
            done = (res <= tol_t) | stalled
            res_prev = torch.minimum(res, res_prev)
            du = masked_solve(k_t, r, mask, assume_spd=False)[0]
            res_try = resid_of(u + du)
            first_ok = res_try <= (1.0 - 1e-4) * res
            done_h, first_ok_h = torch.stack([done, first_ok]).tolist()
            if done_h:
                break
            s_use = one
            if not first_ok_h:
                s, best_s, best_res = one, one, res_try
                while True:
                    s = s * 0.5
                    res_try = resid_of(u + s * du)
                    better = res_try < best_res
                    best_s = torch.where(better, s, best_s)
                    best_res = torch.where(better, res_try, best_res)
                    accepted = res_try <= (1.0 - 1e-4 * s) * res
                    go_on = torch.logical_not(accepted) & (s > 2.0 ** -10)
                    if not bool(go_on):
                        break
                s_use = torch.where(accepted, s, best_s)
            u = u + s_use * du
            it += 1
        # One final evaluation pins (sigma, state) to the final u.
        _, f_int, sig3, szz, st = system(u, state, tangent=False)
        res = torch.linalg.vector_norm((lf * f_ext - f_int) * mask) / fnorm
        rows.append(_rows(u, sig3, szz, st, state))
        res_rows.append(res)
        conv_rows.append(res <= tol_t)
        iters.append(it)
        state = st
    residuals = torch.stack(res_rows).cpu().numpy()
    return _result(lfs, rows, iters, residuals,
                   bool(torch.stack(conv_rows).all()))


def solve_plane_plastic(
    problem: PlaneProblem,
    sigma_y,
    hardening_iso=0.0,
    hardening_kin=0.0,
    load_factors: Optional[Sequence[float]] = None,
    n_steps: int = 20,
    target_load_factor: float = 1.0,
    tol: float = 1e-9,
    max_iter: int = 30,
    tangent_floor: float = 1e-8,
    min_denom: float = 1e-12,
    host: Optional[bool] = None,
    bbar: Optional[bool] = None,
    device=None,
) -> PlanePlasticResult:
    """Trace the elastoplastic plane-continuum response along a load-factor
    history.

    The JAX package's arguments: sigma_y, hardening_iso, hardening_kin
    scalar or (nelm,); load_factors an explicit history, by default
    `ramp_schedule(target_load_factor, n_steps)`; tol relative to |f_ext|;
    host (module docstring); bbar mean-dilatation elements, by default on
    for plane-strain Q4 (fully integrated Q4 locks in incompressible J2
    flow), ignored in plane stress, refused for CST.  The port's own:
    device, where to solve ("cuda" when None; host=True: the CPU)."""
    from . import newton

    lfs = _schedule(load_factors, target_load_factor, n_steps)
    sy, hi, hk = params_arrays(problem.nelm, sigma_y, hardening_iso,
                               hardening_kin)
    if bbar is None:
        bbar = problem.plane_strain and problem.nen == 4
    bbar = bool(bbar) and problem.plane_strain
    if bbar and problem.nen != 4:
        raise ValueError("B-bar needs Q4 elements — CST has a single "
                         "strain point (use a quad mesh for "
                         "incompressible plane-strain plasticity)")
    dense64 = (problem.ndof <= newton.DENSE_DOF_LIMIT if host is None
               else host)
    if dense64:
        where = torch.device("cpu") if host else resolve_device(device)
        return _float64_solve(problem, sy, hi, hk, lfs, tol, int(max_iter),
                              tangent_floor, min_denom, bbar, where)
    dtype = default_dtype()
    # The float32 floor (the truss solver's measured ~5e-6 rule).
    tol_dev = (max(float(tol), 1e-5) if dtype == torch.float32
               else float(tol))
    return _device_solve(problem, sy, hi, hk, lfs, tol_dev, int(max_iter),
                         tangent_floor, min_denom, bbar, dtype,
                         resolve_device(device))
