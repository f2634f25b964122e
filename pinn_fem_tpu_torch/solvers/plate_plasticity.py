"""Incremental elastoplastic statics for the Mindlin plate family: load
stepping and damped Newton with the consistent layered tangent over the
batched map of ops/plate_plastic.py (counterpart of
pinn_fem_tpu/solvers/plate_plasticity.py).

The plane family's load stepping carried to bending
(solvers/plane_plasticity.py, whose two loops this module runs on a plate
system): the trial state is the committed state of the previous step,
residuals are normalized by |f_ext|, Armijo backtracking damps each Newton
update.  Two tiers, as in the JAX package:

  * float64 (ndof <= DENSE_DOF_LIMIT, the default; host=True forces it):
    the JAX host tier's algorithm (`_host_solve`) in float64 torch on the
    caller's device, the card by default, or on the CPU with host=True;
  * device (host=False, or above the limit): the JAX device program
    (`_device_core`) in the working dtype: the dense tangent factored by
    LU a Newton iteration (`ops.linalg.masked_solve(assume_spd=False)`),
    one read of (done, first trial accepted) an iteration, the tolerance
    floored at 1e-5 in float32.  The JAX package pads the schedule to a
    power of two (a bucket of its compiled program) and cuts its outputs
    back; the port runs the n steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.plate import PlateProblem, _pressure_vectors
from ..ops.plastic import params_arrays
from ..ops.plate_plastic import (initial_plate_state, plate_gp_geometry,
                                 plate_plastic_blocks, plate_plastic_force)
from ..utils.runtime import default_dtype, resolve_device
from .plane_plasticity import (_System, _columns, _schedule, device_loop,
                               float64_loop, n_yielding)


class PlatePlasticResult(NamedTuple):
    load_factors: np.ndarray     # (n_steps,)
    displacements: np.ndarray    # (n_steps, ndof)
    moments: np.ndarray          # (n_steps, m, 3) gp-avg [Mxx, Myy, Mxy]
    von_mises: np.ndarray        # (n_steps, m) extreme-fiber max
    eq_plastic: np.ndarray       # (n_steps, m) layer / gp-avg alpha
    iterations: np.ndarray       # (n_steps,)
    residuals: np.ndarray        # (n_steps,) final |R|/|f_ext|
    converged: bool
    n_plastic: np.ndarray        # (n_steps,) elements actively yielding


class _PlateSystem(_System):
    """The layered MITC4 system of one tier, in `dtype` on `device`: the
    plane system's interface with the plate blocks (the line search's
    force-only evaluations take the force-only map, the same
    resultants)."""

    def __init__(self, problem: PlateProblem, sy, hi, hk, n_layers: int,
                 tangent_floor: float, dtype, device):
        if problem.temperature is not None:
            raise ValueError(
                "plate plasticity does not take a temperature-gradient "
                "load case — the thermal moment is a constant static "
                "load, not proportional to the ramp; run thermoelastic "
                'bending as analysis type "static"')
        self.ndof = problem.ndof
        self.bb, self.det, self.ks_e = (
            a.to(dtype) for a in plate_gp_geometry(problem, device))
        self._common(problem, _pressure_vectors(problem, device), dtype,
                     device)
        self.material = [self._t(a) for a in (
            problem.thickness, problem.young, problem.poisson, sy, hi, hk)]
        self.n_layers = int(n_layers)
        self.floor = tangent_floor
        self.nelm = problem.nelm

    def initial_state(self):
        return initial_plate_state(self.nelm, self.n_layers, self.dtype,
                                   self.device)

    def __call__(self, u, state, tangent: bool = True):
        thick, young, poisson, sy, hi, hk = self.material
        args = (self.bb, self.det, self.ks_e, thick, u[self.dm], state,
                young, poisson, sy, hi, hk, self.n_layers)
        if tangent:
            ke, fe, mom, vmf, st = plate_plastic_blocks(*args, self.floor)
        else:
            ke = None
            fe, mom, vmf, st = plate_plastic_force(*args)
        return (*self.assemble(ke, fe, tangent), (mom, vmf), st)

    @staticmethod
    def rows(u, sig, st, state0):
        mom, vmf = sig
        return (u, mom.mean(dim=1), vmf, st.alpha.mean(dim=1),
                n_yielding(st, state0))


def _result(lfs, rows, iters, residuals, ok) -> PlatePlasticResult:
    u, mom, vm, al, n_pl = _columns(rows)
    return PlatePlasticResult(
        load_factors=np.asarray(lfs, dtype=float), displacements=u,
        moments=mom, von_mises=vm, eq_plastic=al,
        iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float), converged=bool(ok),
        n_plastic=n_pl.astype(int))


def solve_plate_plastic(
    problem: PlateProblem,
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
) -> PlatePlasticResult:
    """Trace the layered elastoplastic plate response along a load-factor
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
        system = _PlateSystem(problem, sy, hi, hk, n_layers, tangent_floor,
                              torch.float64, where)
        return _result(lfs, *float64_loop(system, lfs, tol, int(max_iter),
                                          min_denom))
    dtype = default_dtype()
    npf = np.float64 if dtype == torch.float64 else np.float32
    tol_dev = (max(float(tol), 1e-5) if dtype == torch.float32
               else float(tol))
    system = _PlateSystem(problem, sy, hi, hk, n_layers,
                          float(npf(tangent_floor)), dtype,
                          resolve_device(device))
    return _result(lfs, *device_loop(system, lfs, tol_dev, int(max_iter),
                                     min_denom))
