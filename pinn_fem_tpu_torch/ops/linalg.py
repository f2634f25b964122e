"""Masked boundary-condition linear solves with iterative refinement.

Counterpart of pinn_fem_tpu/ops/linalg.py.  The full (ndof, ndof) system
is solved with the fixed DOFs eliminated in place,

    K_bc = M K M + (I - M),   rhs_bc = M rhs,   M = diag(free_mask),

whose solution is du_free = K_ff^{-1} rhs_f and du_fixed = 0.  One sweep of
iterative refinement recovers float32 accuracy after the factorization.
"""

from __future__ import annotations

import torch


def apply_bc_operator(k: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """K -> M K M + (I - M), with unit diagonal on fixed DOFs."""
    m = free_mask
    return k * m[:, None] * m[None, :] + torch.diag(1.0 - m)


def masked_solve(k: torch.Tensor, rhs: torch.Tensor, free_mask: torch.Tensor,
                 refine_steps: int = 1) -> torch.Tensor:
    """Solve K_ff du_f = rhs_f by Cholesky; du is 0 on fixed DOFs."""
    k_bc = apply_bc_operator(k, free_mask)
    rhs_bc = rhs * free_mask
    chol = torch.linalg.cholesky(k_bc)

    def solve(b):
        return torch.cholesky_solve(b[:, None], chol)[:, 0]

    du = solve(rhs_bc)
    for _ in range(refine_steps):
        r = (rhs_bc - k_bc @ du) * free_mask
        du = du + solve(r)
    return du * free_mask
