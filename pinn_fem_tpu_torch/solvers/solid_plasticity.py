"""Incremental elastoplastic statics for the 3D solid family: load stepping
and damped Newton with the consistent tangent over the batched J2 hex8
Gauss-point map of ops/solid_plastic.py (counterpart of
pinn_fem_tpu/solvers/solid_plasticity.py).

The plane family's driver carried to 3D (solvers/plane_plasticity.py, whose
two loops this module runs on a solid system): the trial state is the
committed state of the previous step, residuals are normalized by |f_ext|,
Armijo backtracking damps each Newton update.  Two tiers, as in the JAX
package:

  * float64 (ndof <= DENSE_DOF_LIMIT, the default; host=True forces it):
    the JAX host tier's algorithm in float64 torch on the caller's device,
    the card by default, or on the CPU with host=True;
  * device (host=False, or above the limit): the JAX device program in the
    working dtype: the dense tangent factored by LU a Newton iteration
    (`ops.linalg.masked_solve(assume_spd=False)`), one read of (done,
    first trial accepted) an iteration, the tolerance floored at 1e-5 in
    float32.  The JAX package pads the schedule to a power of two (a
    bucket of its compiled program) and cuts its outputs back; the port
    runs the n steps.

B-bar (mean dilatation) is the default: fully integrated hex8 locks in
incompressible J2 flow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.solid import SolidProblem, _body_force_vectors3
from ..ops.plastic import params_arrays
from ..ops.solid_plastic import (gp_geometry3, gp_geometry3_bbar,
                                 initial_solid_state, solid_plastic_blocks,
                                 solid_plastic_force, von_mises_6)
from ..utils.runtime import default_dtype, resolve_device
from .plane_plasticity import (_System, _columns, _schedule, device_loop,
                               float64_loop, n_yielding)


class SolidPlasticResult(NamedTuple):
    load_factors: np.ndarray     # (n_steps,)
    displacements: np.ndarray    # (n_steps, ndof)
    stresses: np.ndarray         # (n_steps, m, 6) gp-avg Voigt
    von_mises: np.ndarray        # (n_steps, m) gp-avg
    eq_plastic: np.ndarray       # (n_steps, m) gp-avg alpha
    iterations: np.ndarray       # (n_steps,)
    residuals: np.ndarray        # (n_steps,) final |R|/|f_ext|
    converged: bool
    n_plastic: np.ndarray        # (n_steps,) elements actively yielding


class _SolidSystem(_System):
    """The hex8 system of one tier, in `dtype` on `device`: the plane
    system's interface with the solid blocks (the line search's force-only
    evaluations take the force-only map, the same stresses)."""

    def __init__(self, problem: SolidProblem, sy, hi, hk, bbar: bool,
                 tangent_floor: float, dtype, device):
        self.ndof = problem.ndof
        geometry = gp_geometry3_bbar if bbar else gp_geometry3
        self.b, self.wdet = (a.to(dtype) for a in geometry(problem, device))
        self._common(problem, _body_force_vectors3(problem, device), dtype,
                     device)
        self.material = [self._t(a) for a in (
            problem.young, problem.poisson, sy, hi, hk)]
        self.floor = tangent_floor
        self.nelm = problem.nelm

    def initial_state(self):
        return initial_solid_state(self.nelm, self.dtype, self.device)

    def __call__(self, u, state, tangent: bool = True):
        u_e = u[self.dm]
        if tangent:
            ke, fe, sig6, st = solid_plastic_blocks(
                self.b, self.wdet, u_e, state, *self.material, self.floor)
        else:
            ke = None
            fe, sig6, st = solid_plastic_force(self.b, self.wdet, u_e,
                                               state, *self.material)
        return (*self.assemble(ke, fe, tangent), sig6, st)

    @staticmethod
    def rows(u, sig6, st, state0):
        return (u, sig6.mean(dim=1), von_mises_6(sig6).mean(dim=1),
                st.alpha.mean(dim=1), n_yielding(st, state0))


def _result(lfs, rows, iters, residuals, ok) -> SolidPlasticResult:
    u, sig, vm, al, n_pl = _columns(rows)
    return SolidPlasticResult(
        load_factors=np.asarray(lfs, dtype=float), displacements=u,
        stresses=sig, von_mises=vm, eq_plastic=al,
        iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float), converged=bool(ok),
        n_plastic=n_pl.astype(int))


def _float64_solve(problem: SolidProblem, sy, hi, hk, lfs, tol, max_iter,
                   tangent_floor, min_denom, bbar: bool,
                   device) -> SolidPlasticResult:
    """The JAX host tier (_host_solve) in float64 torch on `device`."""
    system = _SolidSystem(problem, sy, hi, hk, bbar, tangent_floor,
                          torch.float64, device)
    return _result(lfs, *float64_loop(system, lfs, tol, max_iter,
                                      min_denom))


def _device_solve(problem: SolidProblem, sy, hi, hk, lfs, tol, max_iter,
                  tangent_floor, min_denom, bbar: bool, dtype,
                  device) -> SolidPlasticResult:
    """The JAX device program (_device_core) in `dtype` on `device`."""
    npf = np.float64 if dtype == torch.float64 else np.float32
    system = _SolidSystem(problem, sy, hi, hk, bbar,
                          float(npf(tangent_floor)), dtype, device)
    return _result(lfs, *device_loop(system, lfs, tol, max_iter, min_denom))


def solve_solid_plastic(
    problem: SolidProblem,
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
    bbar: bool = True,
    device=None,
) -> SolidPlasticResult:
    """Trace the elastoplastic 3D response along a load-factor history.

    The JAX package's arguments (those of solve_plane_plastic; bbar on by
    default).  The port's own: device, where to solve ("cuda" when None;
    host=True: the CPU)."""
    from . import newton

    lfs = _schedule(load_factors, target_load_factor, n_steps)
    sy, hi, hk = params_arrays(problem.nelm, sigma_y, hardening_iso,
                               hardening_kin)
    dense64 = (problem.ndof <= newton.DENSE_DOF_LIMIT if host is None
               else host)
    if dense64:
        where = torch.device("cpu") if host else resolve_device(device)
        return _float64_solve(problem, sy, hi, hk, lfs, tol, int(max_iter),
                              tangent_floor, min_denom, bool(bbar), where)
    dtype = default_dtype()
    tol_dev = (max(float(tol), 1e-5) if dtype == torch.float32
               else float(tol))
    return _device_solve(problem, sy, hi, hk, lfs, tol_dev, int(max_iter),
                         tangent_floor, min_denom, bool(bbar), dtype,
                         resolve_device(device))
