"""Masked boundary-condition linear solves with iterative refinement.

Counterpart of pinn_fem_tpu/ops/linalg.py.  The full (ndof, ndof) system
is solved with the fixed DOFs eliminated in place,

    K_bc = M K M + (I - M),   rhs_bc = M rhs,   M = diag(free_mask),

whose solution is du_free = K_ff^{-1} rhs_f and du_fixed = 0.  One sweep of
iterative refinement recovers float32 accuracy after the factorization.
"""

from __future__ import annotations

from typing import Tuple

import torch


def apply_bc_operator(k: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """K -> M K M + (I - M), with unit diagonal on fixed DOFs."""
    m = free_mask
    return k * m[:, None] * m[None, :] + torch.diag(1.0 - m)


def masked_solve(k: torch.Tensor, rhs: torch.Tensor, free_mask: torch.Tensor,
                 refine_steps: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve K_ff du_f = rhs_f by Cholesky; du is 0 on fixed DOFs.

    Returns (du, info): info is cholesky_ex's device code, nonzero when
    K_bc is not positive definite (JAX's cho_factor returns NaN there), and
    du is then meaningless.  Reading info is left to the caller, so the
    solve itself never waits for the device."""
    k_bc, chol, info = factor_masked(k, free_mask)
    rhs_bc = rhs * free_mask

    def solve(b):
        return torch.cholesky_solve(b[:, None], chol)[:, 0]

    du = solve(rhs_bc)
    for _ in range(refine_steps):
        r = (rhs_bc - k_bc @ du) * free_mask
        du = du + solve(r)
    return du * free_mask, info


def factor_masked(k: torch.Tensor, free_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(K_bc, its Cholesky factor, cholesky_ex's info) of one K (ndof,
    ndof) or of B of them (B, ndof, ndof): `masked_solve`'s factorization,
    kept for `solve_factored`."""
    k_bc = apply_bc_operator(k, free_mask)
    chol, info = torch.linalg.cholesky_ex(k_bc)
    return k_bc, chol, info


def solve_factored(k_bc: torch.Tensor, chol: torch.Tensor, rhs: torch.Tensor,
                   free_mask: torch.Tensor) -> torch.Tensor:
    """`masked_solve` (one sweep of refinement) of B right-hand sides rhs
    (B, ndof) with factors from `factor_masked`: one shared K (ndof, ndof)
    for all members, or each member's own (B, ndof, ndof).  du is 0 on
    fixed DOFs."""
    shared = k_bc.dim() == 2

    def solve(b):
        if shared:
            return torch.cholesky_solve(b.T, chol).T
        return torch.cholesky_solve(b[..., None], chol)[..., 0]

    def apply(x):
        return x @ k_bc.T if shared else (k_bc @ x[..., None])[..., 0]

    rhs_bc = rhs * free_mask
    du = solve(rhs_bc)
    du = du + solve((rhs_bc - apply(du)) * free_mask)
    return du * free_mask
