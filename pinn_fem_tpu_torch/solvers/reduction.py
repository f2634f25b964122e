"""Guyan reduction (static condensation) and Craig-Bampton reduction
(counterpart of pinn_fem_tpu/solvers/reduction.py).

Partition the free DOFs into retained MASTERS m and condensed SLAVES s;
with T = [I; -K_ss^{-1} K_sm],

    K_red = T^T K T = K_mm - K_ms K_ss^{-1} K_sm   (exact for statics)
    M_red = T^T M T                                (Guyan: slave inertia
                                                    ignored dynamically)
    f_red = T^T f

Craig-Bampton augments T with the first n_modes fixed-interface normal
modes of the slave block (mass-normalized), so the slave inertia re-enters
through modal coordinates.  Fixed DOFs are in neither set.

Dense-only in both packages (refused above DENSE_DOF_LIMIT).  The
operators are ops/host's float64 K and lumped mass (the JAX package's host
path); the condensation (solve, eigh, products) runs in float64 torch on
the caller's device, the card by default.  The results are numpy arrays,
as in the JAX package.  The modes' signs come from the eigensolver
(LAPACK, torch, cuSOLVER), so the modal rows and columns of a
Craig-Bampton k_red / m_red may differ in sign between packages and
devices; the master block and the reduced frequencies do not.
`reduce_model` takes the truss and the plane, solid, frame, space-frame,
plate and shell families (their consistent float64 K and M from the
families' `*_matrices`, through the dense cores; the shell's mass with the
uniform ridge of models/shell.shell_modal, without which the drilling
direction leaves the Craig-Bampton slave pencil singular).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models.problem import TrussProblem
from ..utils.runtime import resolve_device

class ReducedModel(NamedTuple):
    k_red: np.ndarray        # (n_m, n_m)
    m_red: np.ndarray        # (n_m, n_m)
    t: np.ndarray            # (n_free, n_m) recovery basis (master->free)
    master_dofs: np.ndarray  # (n_m,) global DOF indices
    free_dofs: np.ndarray    # (n_free,) global DOF order of t's rows

    def expand(self, u_m: np.ndarray, ndof: int) -> np.ndarray:
        """(n_m,) master displacements -> (ndof,) full vector (zeros on
        fixed DOFs; slaves recovered by static interpolation)."""
        u = np.zeros(ndof)
        u[self.free_dofs] = self.t @ np.asarray(u_m).reshape(-1)
        return u


def _dense_limit_check(ndof: int) -> None:
    from . import newton

    if ndof > newton.DENSE_DOF_LIMIT:
        raise ValueError(
            f"reduction is dense-only ({ndof} DOFs > "
            f"{newton.DENSE_DOF_LIMIT}); condense a substructure, not the "
            "full large mesh")


def _split(free_idx: np.ndarray, master_dofs):
    """(masters, their positions in free_idx, the slaves' positions)."""
    masters = np.asarray(master_dofs, dtype=int)
    if np.unique(masters).size != masters.size:
        raise ValueError("master_dofs contains duplicates")
    if np.setdiff1d(masters, free_idx).size:
        raise ValueError("master_dofs must be free DOFs")
    pos = {int(d): i for i, d in enumerate(free_idx)}
    m_loc = np.array([pos[int(d)] for d in masters])
    s_loc = np.setdiff1d(np.arange(free_idx.size), m_loc)
    return masters, m_loc, s_loc


def _partition(problem: TrussProblem, master_dofs, data):
    """Validate the masters and build the free-block partition, with
    K_ff and the lumped mass from ops/host in float64."""
    if data is not None:
        # The float64 operators read the problem's arrays: a custom
        # ProblemData would be ignored, so it is refused.
        raise ValueError("reduction assembles on the host from the "
                         "problem itself; the data argument is no "
                         "longer consumed — drop it")
    from ..ops import host as H

    _dense_limit_check(problem.ndof)
    free_idx = np.asarray(problem.free_fixed()[0])
    masters, m_loc, s_loc = _split(free_idx, master_dofs)
    k_ff = H.host_stiffness(problem)[np.ix_(free_idx, free_idx)]
    m_all = H.host_lumped_mass(problem)
    return free_idx, masters, m_loc, s_loc, k_ff, m_all[free_idx]


def _condense(k_ff, m_ff, m_loc, s_loc, n_modes: int, device,
              guyan_k: bool):
    """(k_red, m_red, t) in float64 numpy, computed in torch on `device`:
    the static basis -K_ss^{-1} K_sm, with n_modes fixed-interface modes
    of (K_ss, M_ss) (M a (n,) lumped diagonal or an (n, n) matrix).
    guyan_k: K_red = K_mm + K_ms Phi_s (Guyan's form), else T^T K T."""
    f64 = dict(dtype=torch.float64, device=device)
    k = torch.as_tensor(np.asarray(k_ff, dtype=np.float64), **f64)
    m = torch.as_tensor(np.asarray(m_ff, dtype=np.float64), **f64)
    mi = torch.as_tensor(m_loc, dtype=torch.long, device=device)
    si = torch.as_tensor(s_loc, dtype=torch.long, device=device)
    k_ms = k[mi][:, si]
    k_ss = k[si][:, si]
    phi_stat = -torch.linalg.solve(k_ss, k_ms.T)          # (n_s, n_m)
    n_m = m_loc.size
    t = torch.zeros((k.shape[0], n_m + n_modes), **f64)
    t[mi, torch.arange(n_m, device=device)] = 1.0
    t[si, :n_m] = phi_stat
    if n_modes:
        if m.dim() == 1:
            d = torch.sqrt(m[si])
            b = k_ss / d[:, None] / d[None, :]
            _, y = torch.linalg.eigh(0.5 * (b + b.T))
            t[si, n_m:] = y[:, :n_modes] / d[:, None]     # mass-normalized
        else:
            lo = torch.linalg.cholesky(m[si][:, si])
            c = torch.linalg.solve_triangular(lo, k_ss, upper=False)
            c = torch.linalg.solve_triangular(lo, c.T, upper=False)
            _, y = torch.linalg.eigh(0.5 * (c + c.T))
            t[si, n_m:] = torch.linalg.solve_triangular(
                lo.T, y[:, :n_modes], upper=True)
    if guyan_k:
        k_red = k[mi][:, mi] + k_ms @ phi_stat
    else:
        k_red = t.T @ (k @ t)
    m_red = (t.T @ (m[:, None] * t) if m.dim() == 1 else t.T @ (m @ t))
    k_red = 0.5 * (k_red + k_red.T)
    m_red = 0.5 * (m_red + m_red.T)
    return (k_red.cpu().numpy(), m_red.cpu().numpy(), t.cpu().numpy())


def guyan_reduce(problem: TrussProblem, master_dofs: Sequence[int],
                 data=None, device=None) -> ReducedModel:
    """Condense the free DOFs onto the given masters (global DOF ids;
    must be free), on `device` ("cuda" when None)."""
    free_idx, masters, m_loc, s_loc, k_ff, m_diag = _partition(
        problem, master_dofs, data)
    k_red, m_red, t = _condense(k_ff, m_diag, m_loc, s_loc, 0,
                                resolve_device(device), guyan_k=True)
    return ReducedModel(k_red=k_red, m_red=m_red, t=t, master_dofs=masters,
                        free_dofs=free_idx)


def reduce_loads(model: ReducedModel, loads: np.ndarray) -> np.ndarray:
    """(ndof,) loads -> (n_m,) consistent reduced loads f_red = T^T f."""
    return model.t.T @ np.asarray(loads).reshape(-1)[model.free_dofs]


def craig_bampton(problem: TrussProblem, master_dofs: Sequence[int],
                  n_modes: int = 4, data=None,
                  device=None) -> ReducedModel:
    """Craig-Bampton: Guyan's static basis augmented with the first
    n_modes fixed-interface normal modes of the slave block (eigh of the
    mass-scaled K_ss), on `device` ("cuda" when None).  The extra columns
    are generalized coordinates: t maps [u_m; q] to the free DOFs."""
    free_idx, masters, m_loc, s_loc, k_ff, m_diag = _partition(
        problem, master_dofs, data)
    n_modes = min(n_modes, s_loc.size)
    k_red, m_red, t = _condense(k_ff, m_diag, m_loc, s_loc, n_modes,
                                resolve_device(device), guyan_k=False)
    return ReducedModel(k_red=k_red, m_red=m_red, t=t, master_dofs=masters,
                        free_dofs=free_idx)


def _partition_dense(k, fixed_dofs, master_dofs):
    ndof = np.asarray(k).shape[0]
    free_idx = np.setdiff1d(np.arange(ndof),
                            np.asarray(fixed_dofs, dtype=int))
    masters, m_loc, s_loc = _split(free_idx, master_dofs)
    return free_idx, masters, m_loc, s_loc


def guyan_reduce_dense(k, m, fixed_dofs, master_dofs,
                       device=None) -> ReducedModel:
    """Guyan condensation of an explicit (K, M) pair; M may be consistent
    (dense).  On `device` ("cuda" when None)."""
    free_idx, masters, m_loc, s_loc = _partition_dense(k, fixed_dofs,
                                                       master_dofs)
    ix = np.ix_(free_idx, free_idx)
    k_red, m_red, t = _condense(np.asarray(k)[ix], np.asarray(m)[ix], m_loc,
                                s_loc, 0, resolve_device(device),
                                guyan_k=True)
    return ReducedModel(k_red=k_red, m_red=m_red, t=t, master_dofs=masters,
                        free_dofs=free_idx)


def craig_bampton_dense(k, m, fixed_dofs, master_dofs, n_modes: int = 4,
                        device=None) -> ReducedModel:
    """Craig-Bampton on an explicit (K, M) pair: the fixed-interface modes
    of the consistent slave block (the generalized eigenproblem through
    M_ss's Cholesky factor, mass-normalized).  On `device` ("cuda" when
    None)."""
    free_idx, masters, m_loc, s_loc = _partition_dense(k, fixed_dofs,
                                                       master_dofs)
    n_modes = min(int(n_modes), s_loc.size)
    ix = np.ix_(free_idx, free_idx)
    k_red, m_red, t = _condense(np.asarray(k)[ix], np.asarray(m)[ix], m_loc,
                                s_loc, n_modes, resolve_device(device),
                                guyan_k=False)
    return ReducedModel(k_red=k_red, m_red=m_red, t=t, master_dofs=masters,
                        free_dofs=free_idx)


def reduce_model(problem, master_dofs, method: str = "guyan",
                 n_modes: int = 4, device=None) -> ReducedModel:
    """Family-dispatching reduction on `device` ("cuda" when None): a
    TrussProblem takes the lumped float64 path above, a PlaneProblem,
    SolidProblem, FrameProblem, SpaceFrameProblem, PlateProblem or
    ShellProblem its own consistent dense (K, M) through the dense cores
    (the shell's M ridged)."""
    from ..models.frame import FrameProblem, frame_matrices
    from ..models.frame3d import SpaceFrameProblem, space_frame_matrices
    from ..models.plane import PlaneProblem, plane_matrices
    from ..models.plate import PlateProblem, plate_matrices
    from ..models.shell import ShellProblem, _ridged, shell_matrices
    from ..models.solid import SolidProblem, solid_matrices

    def ridged_shell_matrices(p, device):
        k, m = shell_matrices(p, device=device)
        return k, _ridged(m)

    if isinstance(problem, TrussProblem):
        if method == "guyan":
            return guyan_reduce(problem, master_dofs, device=device)
        if method == "craig_bampton":
            return craig_bampton(problem, master_dofs, n_modes=n_modes,
                                 device=device)
        raise ValueError('reduction method must be "guyan" or '
                         '"craig_bampton"')
    kind = type(problem).__name__
    mats = next((fn for cls, fn in (
        (PlaneProblem, plane_matrices), (SolidProblem, solid_matrices),
        (FrameProblem, frame_matrices), (PlateProblem, plate_matrices),
        (SpaceFrameProblem, space_frame_matrices),
        (ShellProblem, ridged_shell_matrices))
        if isinstance(problem, cls)), None)
    if mats is not None:
        _dense_limit_check(problem.ndof)
        k, m = (a.cpu().numpy() for a in mats(problem, device=device))
        if method == "guyan":
            return guyan_reduce_dense(k, m, problem.fixed_dofs,
                                      master_dofs, device=device)
        if method == "craig_bampton":
            return craig_bampton_dense(k, m, problem.fixed_dofs,
                                       master_dofs, n_modes=n_modes,
                                       device=device)
        raise ValueError('reduction method must be "guyan" or '
                         '"craig_bampton"')
    raise TypeError("reduce_model needs a Truss/Plane/Solid/"
                    "Frame/SpaceFrame/Shell/Plate problem, "
                    f"got {kind}")
