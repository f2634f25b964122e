"""Newton-Raphson phase on the dense system (counterpart of
pinn_fem_tpu/solvers/phases.py: NRPhaseOut, nr_phase, reactions_of).

The JAX phase runs inside lax.while_loop; here it is a Python loop that
reads the convergence flag once per Newton iteration.  The GD, full-NR and
Gauss-Newton phases wait for ROADMAP item 6.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.fields import Material
from ..models.problem import ProblemData
from ..ops.assembly import assemble_system, internal_force_and_strain
from ..ops.linalg import masked_solve


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
    """f_int - lf * f_ext with the free DOFs zeroed."""
    f_int, _ = internal_force_and_strain(data, material, u, load_factor)
    return (f_int - load_factor * data.loads) * data.fixed_mask
