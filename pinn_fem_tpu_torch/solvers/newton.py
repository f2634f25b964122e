"""Classic Newton-Raphson solver (counterpart of pinn_fem_tpu/solvers/newton.py).

Same update rule, convergence criteria, reactions and single-entry history
{load_factor, iterations, residual, max_strain, converged} as the JAX
solver.  Up to DENSE_DOF_LIMIT DOFs the tangent is a dense Cholesky solve;
above it, on a banded mesh, each Newton iteration assembles the DIA
diagonals and solves with the fused two-kernel Jacobi-PCG: the CUDA
kernels on a card, their plain twins on the CPU.  The Newton loops are
Python loops that read one flag per Newton iteration; the PCG loop inside
keeps its state on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig, SolverResult
from ..models.fields import Material
from ..models.problem import ProblemData, TrussProblem
from ..ops.assembly import assemble_system

# DOF count above which the dense factorization gives way to banded PCG
# (dense K is O(ndof^2) memory).
DENSE_DOF_LIMIT = 2048


def _nr_core(data: ProblemData, material: Material, u0: torch.Tensor,
             load_factor: torch.Tensor, max_iter: int, tol: float,
             min_denom: float):
    """One load increment of dense Newton-Raphson."""
    from .phases import nr_phase

    out = nr_phase(data, material, u0, load_factor, max_iter, tol, min_denom)
    # Reactions: K u - lf * loads, free DOFs zeroed.
    k_final, _, _ = assemble_system(data, material, out.u, load_factor)
    reactions = (k_final @ out.u - load_factor * data.loads) * data.fixed_mask
    return (out.u, reactions, out.n_iters, out.residual, out.converged,
            out.max_strain)


def _dia_layout_of(problem: TrussProblem, data: ProblemData):
    """Banded layout cached on the problem; None when the mesh has too many
    distinct diagonals for the memory budget (up to 192 diagonals while
    the diagonal storage stays under about 1 GB)."""
    cached = getattr(problem, "_dia_layout_cache", None)
    if cached is not None:
        return cached if cached != "unsupported" else None
    from ..ops.dia import dia_layout

    budget = int(min(192, max(64, (2**30) // max(4 * problem.ndof, 1))))
    try:
        layout = dia_layout(data.dof_map.cpu().numpy(), problem.ndof,
                            max_diags=budget)
    except ValueError:
        problem._dia_layout_cache = "unsupported"
        return None
    problem._dia_layout_cache = layout
    return layout


def _nr_dia_core(layout, data: ProblemData, material: Material,
                 u0: torch.Tensor, load_factor: torch.Tensor, max_iter: int,
                 tol: float, min_denom: float, cg_tol: float,
                 cg_max_iter: int, precond: str = "jacobi"):
    """One load increment of Newton-Raphson on the banded operator, with
    the fused PCG (ops/kernels/cg_kernel.fused_cg_solve) as inner solve.

    Convergence is on the true force residual |R_free| / |lf F_free|: the
    dense path's ||du|| / ||u|| criterion is out of reach with iterative
    inner solves.  A step that does not reduce the residual is rejected
    and ends the loop (float32 floor); the increment counts as converged
    when the residual reached is at most sqrt(tol).
    """
    from ..ops.cg import stiffness_coefficients
    from ..ops.dia import assemble_dia, dia_matvec
    from ..ops.kernels import fused_cg_solve

    if precond != "jacobi":
        raise NotImplementedError(
            f"preconditioner {precond!r}: only Jacobi is ported; multigrid "
            "(ops/mg.py) is ROADMAP item 13")
    dt, dev = u0.dtype, u0.device
    f_ext = load_factor * data.loads
    f_norm = torch.clamp_min(torch.linalg.vector_norm(f_ext * data.free_mask),
                             min_denom)
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    u = u0
    res = torch.tensor(float("inf"), dtype=dt, device=dev)
    it, stop = 0, False
    while it < max_iter and not stop:
        s = stiffness_coefficients(data, material, load_factor)
        diags = assemble_dia(layout, s, data.gvec)
        rhs = f_ext - dia_matvec(layout, diags, u)
        du, _, _ = fused_cg_solve(layout, diags, rhs, data.free_mask,
                                  tol=cg_tol, max_iter=cg_max_iter)
        u_new = u + du
        r = (f_ext - dia_matvec(layout, diags, u_new)) * data.free_mask
        res_new = torch.linalg.vector_norm(r) / f_norm
        # Monotone acceptance: reject steps that do not reduce the true
        # force residual (iterating on float32 noise diverges).
        take = bool(res_new < res)
        if take:
            u, res = u_new, res_new
        stop = bool(res <= tol_t) or not take
        it += 1
    conv = bool(res <= torch.sqrt(tol_t))

    s = stiffness_coefficients(data, material, load_factor)
    diags = assemble_dia(layout, s, data.gvec)
    reactions = (dia_matvec(layout, diags, u) - f_ext) * data.fixed_mask
    strain = torch.sum(data.gvec * u[data.dof_map], dim=-1) * data.inv_len
    return u, reactions, it, res, conv, torch.max(torch.abs(strain))


def solve_nr(
    problem: TrussProblem,
    config: Optional[SolverConfig] = None,
    target_load_factor: float = 1.0,
    u_initial: Optional[np.ndarray] = None,
    data: Optional[ProblemData] = None,
    linear_solver: str = "auto",
    geometric_nonlinear: bool = False,
    cg_precond: str = "auto",
    device=None,
) -> SolverResult:
    """Single-increment NR solve (driven by solvers.driver.solve).

    linear_solver: "dense" (Cholesky on the assembled K), "cg-dia" (banded
    operator), or "auto" (banded above DENSE_DOF_LIMIT).  "cg" prefers the
    banded operator and needs the gather-based PCG only for meshes without
    a banded layout.
    device: where to solve when `data` is not given ("cuda" when None).
    """
    if geometric_nonlinear:
        raise NotImplementedError(
            "geometric nonlinearity is not yet ported, ROADMAP item 5")
    config = config or SolverConfig()
    if problem.material.has_trainable_params:
        raise ValueError(
            "Newton-Raphson solver with NN materials not fully supported yet. "
            "Use solve_gd() for problems with NN parameters."
        )

    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    if u_initial is not None and config.nr_warm_start:
        u0 = torch.as_tensor(np.asarray(u_initial, dtype=float).reshape(-1),
                             dtype=dtype).to(dev)
    else:
        u0 = torch.zeros(problem.ndof, dtype=dtype, device=dev)
    lf = torch.tensor(target_load_factor, dtype=dtype, device=dev)

    if linear_solver == "auto":
        linear_solver = "cg" if problem.ndof > DENSE_DOF_LIMIT else "dense"
    if linear_solver == "cg":
        if _dia_layout_of(problem, data) is None:
            raise NotImplementedError(
                "meshes without a banded layout need the gather-based PCG, "
                "not yet ported, ROADMAP item 10")
        linear_solver = "cg-dia"

    if linear_solver == "cg-dia":
        layout = _dia_layout_of(problem, data)
        if layout is None:
            raise ValueError("mesh bandwidth too wide for the DIA operator")
        if cg_precond == "auto":
            cg_precond = "jacobi"
        out = _nr_dia_core(
            layout, data, problem.material, u0, lf, config.max_iterations,
            config.tolerance, config.min_denominator,
            cg_tol=max(config.tolerance * 0.1, 5e-8),
            cg_max_iter=min(max(20 * problem.ndof, 1000), 100_000),
            precond=cg_precond,
        )
    elif linear_solver == "dense":
        out = _nr_core(data, problem.material, u0, lf, config.max_iterations,
                       config.tolerance, config.min_denominator)
    else:
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    u, reactions, it, res, conv, max_strain = out
    u_np = u.cpu().numpy().astype(float)
    if not np.all(np.isfinite(u_np)):
        raise RuntimeError("Tangent stiffness became singular during solve")

    history = [
        {
            "load_factor": float(target_load_factor),
            "iterations": float(it),
            "residual": float(res),
            "max_strain": float(max_strain),
            "converged": 1.0 if conv else 0.0,
        }
    ]
    shape = (-1, 1) if problem.dimension == 1 else (problem.nnode, problem.dimension)
    return SolverResult(
        displacements=u_np.reshape(shape),
        reactions=reactions.cpu().numpy().astype(float).reshape(shape),
        converged=conv,
        history=history,
    )
