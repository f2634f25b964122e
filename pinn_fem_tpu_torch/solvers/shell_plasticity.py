"""Incremental elastoplastic statics for the flat-facet shell family: load
stepping and damped Newton with the consistent layered tangent over the
batched map of ops/shell_plastic.py (counterpart of
pinn_fem_tpu/solvers/shell_plasticity.py).

The plate family's layered plasticity carried to membrane and bending
kinematics, eps(z) = eps_m + z kappa, so yield couples N and M.  The loops
are the plane family's (solvers/plane_plasticity.py) on a shell system:
the trial state is the committed state of the previous step, residuals are
normalized by |f_ext|, Armijo backtracking damps each Newton update.  Two
tiers, as in the JAX package:

  * float64 (ndof <= DENSE_DOF_LIMIT, the default; host=True forces it):
    the JAX host tier's algorithm (`_host_solve`) in float64 torch on the
    caller's device, the card by default, or on the CPU with host=True;
  * device (host=False, or above the limit): the JAX device program
    (`_device_core`) in the working dtype: the dense tangent factored by LU
    a Newton iteration (`ops.linalg.masked_solve(assume_spd=False)`), one
    read of (done, first trial accepted) an iteration, the tolerance
    floored at 1e-5 in float32.  The JAX package pads the schedule to a
    power of two (a bucket of its compiled program) and cuts its outputs
    back; the port runs the n steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.shell import ShellProblem, _load_vectors, _require_no_thermal
from ..ops.plastic import params_arrays
from ..ops.shell_plastic import (initial_shell_state, shell_gp_geometry,
                                 shell_plastic_blocks, shell_plastic_force)
from ..utils.runtime import default_dtype, resolve_device
from .plane_plasticity import (_System, _columns, _schedule, device_loop,
                               float64_loop, n_yielding)


class ShellPlasticResult(NamedTuple):
    load_factors: np.ndarray      # (n_steps,)
    displacements: np.ndarray     # (n_steps, ndof)
    membrane_forces: np.ndarray   # (n_steps, m, 3) gp-avg local N
    moments: np.ndarray           # (n_steps, m, 3) gp-avg local M
    von_mises: np.ndarray         # (n_steps, m) extreme-fiber / layer max
    eq_plastic: np.ndarray        # (n_steps, m) layer / gp-avg alpha
    iterations: np.ndarray        # (n_steps,)
    residuals: np.ndarray         # (n_steps,) final |R|/|f_ext|
    converged: bool
    n_plastic: np.ndarray         # (n_steps,) elements actively yielding


class _ShellSystem(_System):
    """The layered facet system of one tier, in `dtype` on `device`: the
    plane system's interface with the shell blocks (the line search's
    force-only evaluations take the force-only map, the same
    resultants)."""

    def __init__(self, problem: ShellProblem, sy, hi, hk, n_layers: int,
                 tangent_floor: float, dtype, device):
        _require_no_thermal(problem, "plasticity")
        self.ndof = problem.ndof
        self.geometry = [a.to(dtype) for a in shell_gp_geometry(problem,
                                                                 device)]
        self._common(problem, _load_vectors(problem, device), dtype, device)
        self.material = [self._t(a) for a in (
            problem.thickness, problem.young, problem.poisson, sy, hi, hk)]
        self.n_layers = int(n_layers)
        self.floor = tangent_floor
        self.nelm = problem.nelm

    def initial_state(self):
        return initial_shell_state(self.nelm, self.n_layers, self.dtype,
                                   self.device)

    def __call__(self, u, state, tangent: bool = True):
        thick, young, poisson, sy, hi, hk = self.material
        args = (*self.geometry, thick, u[self.dm], state, young, poisson,
                sy, hi, hk, self.n_layers)
        if tangent:
            ke, fe, nres, mom, vmf, st = shell_plastic_blocks(*args,
                                                              self.floor)
        else:
            ke = None
            fe, nres, mom, vmf, st = shell_plastic_force(*args)
        return (*self.assemble(ke, fe, tangent), (nres, mom, vmf), st)

    @staticmethod
    def rows(u, sig, st, state0):
        nres, mom, vmf = sig
        return (u, nres, mom, vmf, st.alpha.mean(dim=1),
                n_yielding(st, state0))


def _result(lfs, rows, iters, residuals, ok) -> ShellPlasticResult:
    u, nf, mom, vm, al, n_pl = _columns(rows)
    return ShellPlasticResult(
        load_factors=np.asarray(lfs, dtype=float), displacements=u,
        membrane_forces=nf, moments=mom, von_mises=vm, eq_plastic=al,
        iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float), converged=bool(ok),
        n_plastic=n_pl.astype(int))


def solve_shell_plastic(
    problem: ShellProblem,
    sigma_y,
    hardening_iso=0.0,
    hardening_kin=0.0,
    n_layers: int = 20,
    load_factors: Optional[Sequence[float]] = None,
    n_steps: int = 20,
    target_load_factor: float = 1.0,
    tol: float = 1e-9,
    max_iter: int = 30,
    tangent_floor: float = 1e-8,
    min_denom: float = 1e-12,
    host: Optional[bool] = None,
    device=None,
) -> ShellPlasticResult:
    """Trace the layered elastoplastic shell response along a load-factor
    history.

    The JAX package's arguments: sigma_y, hardening_iso, hardening_kin
    scalar or (nelm,), shared by the Gauss points and layers; n_layers an
    even count of through-thickness midpoint layers; load_factors an
    explicit history, by default `ramp_schedule(target_load_factor,
    n_steps)`; tol relative to |f_ext|; host (module docstring).  The
    port's own: device, where to solve ("cuda" when None; host=True: the
    CPU)."""
    from . import newton

    if int(n_layers) < 2 or int(n_layers) % 2:
        raise ValueError("n_layers must be an even count >= 2 "
                         "(ops/plate_plastic.py: midpoint layers give "
                         "the exact plastic moment only for even N)")
    lfs = _schedule(load_factors, target_load_factor, n_steps)
    sy, hi, hk = params_arrays(problem.nelm, sigma_y, hardening_iso,
                               hardening_kin)
    dense64 = (problem.ndof <= newton.DENSE_DOF_LIMIT if host is None
               else host)
    if dense64:
        where = torch.device("cpu") if host else resolve_device(device)
        system = _ShellSystem(problem, sy, hi, hk, n_layers, tangent_floor,
                              torch.float64, where)
        return _result(lfs, *float64_loop(system, lfs, tol, int(max_iter),
                                          min_denom))
    dtype = default_dtype()
    npf = np.float64 if dtype == torch.float64 else np.float32
    tol_dev = (max(float(tol), 1e-5) if dtype == torch.float32
               else float(tol))
    system = _ShellSystem(problem, sy, hi, hk, n_layers,
                          float(npf(tangent_floor)), dtype,
                          resolve_device(device))
    return _result(lfs, *device_loop(system, lfs, tol_dev, int(max_iter),
                                     min_denom))
