"""Masked boundary-condition linear solves with iterative refinement.

Counterpart of pinn_fem_tpu/ops/linalg.py.  The full (ndof, ndof) system
is solved with the fixed DOFs eliminated in place,

    K_bc = M K M + (I - M),   rhs_bc = M rhs,   M = diag(free_mask),

whose solution is du_free = K_ff^{-1} rhs_f and du_fixed = 0.  One sweep of
iterative refinement recovers float32 accuracy after the factorization.
Cholesky by default; assume_spd=False factors by LU with partial pivoting,
for tangents that are indefinite (past a limit point, or a plastic tangent
near its floor).
"""

from __future__ import annotations

from typing import Tuple

import torch


def apply_bc_operator(k: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """K -> M K M + (I - M), with unit diagonal on fixed DOFs."""
    m = free_mask
    return k * m[:, None] * m[None, :] + torch.diag(1.0 - m)


def masked_solve(k: torch.Tensor, rhs: torch.Tensor, free_mask: torch.Tensor,
                 refine_steps: int = 1, assume_spd: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve K_ff du_f = rhs_f by Cholesky (assume_spd) or LU; du is 0 on
    fixed DOFs.

    Returns (du, info): info is cholesky_ex's or lu_factor_ex's device
    code, nonzero when K_bc is not positive definite (Cholesky) or exactly
    singular (LU); JAX's factorizations return NaN there, and du is then
    meaningless.  Reading info is left to the caller, so the solve itself
    never waits for the device."""
    k_bc, factor, info = factor_masked(k, free_mask, assume_spd)
    rhs_bc = rhs * free_mask
    du = _solve(factor, rhs_bc[:, None])[:, 0]
    for _ in range(refine_steps):
        r = (rhs_bc - k_bc @ du) * free_mask
        du = du + _solve(factor, r[:, None])[:, 0]
    return du * free_mask, info


def factor_masked(k: torch.Tensor, free_mask: torch.Tensor,
                  assume_spd: bool = True):
    """(K_bc, its factor, the factorization's info) of one K (ndof, ndof)
    or of B of them (B, ndof, ndof): `masked_solve`'s factorization, kept
    for `solve_factored`.  The factor is the Cholesky factor, or with
    assume_spd=False the (LU, pivots) pair."""
    k_bc = apply_bc_operator(k, free_mask)
    if assume_spd:
        chol, info = torch.linalg.cholesky_ex(k_bc)
        return k_bc, chol, info
    lu, pivots, info = torch.linalg.lu_factor_ex(k_bc)
    return k_bc, (lu, pivots), info


def _solve(factor, b: torch.Tensor) -> torch.Tensor:
    """factor^{-1} b for b (..., ndof, nrhs)."""
    if isinstance(factor, tuple):
        return torch.linalg.lu_solve(factor[0], factor[1], b)
    return torch.cholesky_solve(b, factor)


def solve_factored(k_bc: torch.Tensor, factor, rhs: torch.Tensor,
                   free_mask: torch.Tensor, refine_steps: int = 1
                   ) -> torch.Tensor:
    """`masked_solve` of B right-hand sides rhs (B, ndof) with factors from
    `factor_masked` (Cholesky or LU): one shared K (ndof, ndof) for all
    members, or each member's own (B, ndof, ndof).  refine_steps sweeps
    of refinement (0 solves with the factor alone).  du is 0 on fixed
    DOFs."""
    shared = k_bc.dim() == 2

    def solve(b):
        if shared:
            return _solve(factor, b.T).T
        return _solve(factor, b[..., None])[..., 0]

    def apply(x):
        return x @ k_bc.T if shared else (k_bc @ x[..., None])[..., 0]

    rhs_bc = rhs * free_mask
    du = solve(rhs_bc)
    for _ in range(refine_steps):
        du = du + solve((rhs_bc - apply(du)) * free_mask)
    return du * free_mask
