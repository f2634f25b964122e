"""Classic Newton-Raphson solver (counterpart of pinn_fem_tpu/solvers/newton.py).

Same update rule, convergence criteria, reactions and single-entry history
{load_factor, iterations, residual, max_strain, converged} as the JAX
solver.  Up to DENSE_DOF_LIMIT DOFs the tangent is a dense Cholesky solve;
above it, on a banded mesh, each Newton iteration assembles the DIA
diagonals and solves with the fused two-kernel Jacobi-PCG (or, with
cg_precond="mg", the multigrid-preconditioned PCG of ops/mg.py): the CUDA
kernels on a card, their plain twins on the CPU.  A mesh whose numbering
gives no banded layout takes the gather-based matrix-free PCG (ops/cg.py,
torch ops on every device; RCM, ops/reorder.py, can renumber such a mesh
back onto the banded operator).  The Newton loops are Python loops that
read one flag per Newton iteration; the PCG loops inside keep their state
on the device.  Geometric nonlinearity (Green-Lagrange) takes the dense path
only, as in the JAX package.  Prescribed nonzero displacements of fixed
DOFs (support settlement) take every path.

As in the JAX package, the banded and gather paths divide the free
residual by max(||lf f_free||, min_denominator): a settlement document
with no load on a free DOF divides by min_denominator, so its relative
residual stays far above tol and the increment reports converged = false
(ROADMAP fault 3.9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig, SolverResult
from ..models.fields import Material
from ..models.problem import ProblemData, TrussProblem
from ..ops.assembly import assemble_system, assemble_system_nonlinear
from ..utils.runtime import require_float32

# DOF count above which the dense factorization gives way to banded PCG
# (dense K is O(ndof^2) memory).
DENSE_DOF_LIMIT = 2048


def _nr_core(data: ProblemData, material: Material, u0: torch.Tensor,
             load_factor: torch.Tensor, max_iter: int, tol: float,
             min_denom: float, nonlinear: bool = False):
    """One load increment of dense Newton-Raphson (Green-Lagrange
    kinematics when `nonlinear`)."""
    from .phases import nr_phase

    out = nr_phase(data, material, u0, load_factor, max_iter, tol, min_denom,
                   nonlinear=nonlinear)
    # Reactions: f_int - lf * loads (K u for linear kinematics), free DOFs
    # zeroed.
    if nonlinear:
        _, f_int, _ = assemble_system_nonlinear(data, material, out.u,
                                                load_factor)
    else:
        k_final, _, _ = assemble_system(data, material, out.u, load_factor)
        f_int = k_final @ out.u
    reactions = (f_int - load_factor * data.loads) * data.fixed_mask
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


def _force_newton(assemble, data: ProblemData, u0: torch.Tensor,
                  load_factor: torch.Tensor, max_iter: int, tol: float,
                  min_denom: float):
    """The Newton loop of the banded and gather cores: one load increment
    with an iterative inner solve.  assemble() gives (matvec, solve) for
    the current material: K v, and the masked PCG solution of K du = rhs.

    Convergence is on the true force residual |R_free| / max(|lf F_free|,
    min_denom): the dense path's ||du|| / ||u|| criterion is out of reach
    with iterative inner solves.  A step that does not reduce the residual
    is rejected and ends the loop (float32 floor); the increment counts as
    converged when the residual reached is at most sqrt(tol).
    """
    dt, dev = u0.dtype, u0.device
    f_ext = load_factor * data.loads
    f_norm = torch.clamp_min(torch.linalg.vector_norm(f_ext * data.free_mask),
                             min_denom)
    tol_t = torch.tensor(tol, dtype=dt, device=dev)
    u = u0
    res = torch.tensor(float("inf"), dtype=dt, device=dev)
    it, stop = 0, False
    while it < max_iter and not stop:
        matvec, solve = assemble()
        u_new = u + solve(f_ext - matvec(u))
        r = (f_ext - matvec(u_new)) * data.free_mask
        res_new = torch.linalg.vector_norm(r) / f_norm
        # Monotone acceptance: reject steps that do not reduce the true
        # force residual (iterating on float32 noise diverges).
        take = bool(res_new < res)
        if take:
            u, res = u_new, res_new
        stop = bool(res <= tol_t) or not take
        it += 1
    conv = bool(res <= torch.sqrt(tol_t))

    matvec, _ = assemble()
    reactions = (matvec(u) - f_ext) * data.fixed_mask
    strain = torch.sum(data.gvec * u[data.dof_map], dim=-1) * data.inv_len
    return u, reactions, it, res, conv, torch.max(torch.abs(strain))


def _nr_dia_core(layout, data: ProblemData, material: Material,
                 u0: torch.Tensor, load_factor: torch.Tensor, max_iter: int,
                 tol: float, min_denom: float, cg_tol: float,
                 cg_max_iter: int, precond: str = "jacobi",
                 components: int = 1):
    """One load increment of Newton-Raphson on the banded operator.  The
    inner solve is the fused Jacobi PCG (ops/kernels/cg_kernel.
    fused_cg_solve) or, with precond "mg", the multigrid-preconditioned
    PCG (ops/dia.dia_cg_solve, kernel 1 on every level), its hierarchy
    built once per Newton iteration."""
    from ..ops.cg import stiffness_coefficients
    from ..ops.dia import assemble_dia, dia_cg_solve, dia_matvec
    from ..ops.kernels import fused_cg_solve

    if precond not in ("jacobi", "mg"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    if u0.device.type == "cuda":
        require_float32(u0.dtype, "banded Newton (kernels 1-3: dia_matvec, "
                        "dia_dir_matvec, cg_update)" if precond == "jacobi"
                        else "banded Newton with multigrid (kernel 1: "
                        "dia_matvec, on every level)")

    def solver(diags):
        if precond == "mg":
            return lambda rhs: dia_cg_solve(
                layout, diags, rhs, data.free_mask, tol=cg_tol,
                max_iter=cg_max_iter, precond="mg",
                components=components)[0]
        return lambda rhs: fused_cg_solve(layout, diags, rhs, data.free_mask,
                                          tol=cg_tol,
                                          max_iter=cg_max_iter)[0]

    def assemble():
        s = stiffness_coefficients(data, material, load_factor)
        diags = assemble_dia(layout, s, data.gvec)
        return lambda v: dia_matvec(layout, diags, v), solver(diags)

    return _force_newton(assemble, data, u0, load_factor, max_iter, tol,
                         min_denom)


def _nr_core_cg(data: ProblemData, material: Material, u0: torch.Tensor,
                load_factor: torch.Tensor, max_iter: int, tol: float,
                min_denom: float, cg_tol: float, cg_max_iter: int):
    """One load increment of Newton-Raphson with the gather-based
    matrix-free PCG (ops/cg.cg_solve) as inner solve: K is never formed.
    No repo kernel is on this path (kernel 4 only where the material is an
    MLP, which solve_nr refuses), so it runs in any dtype on every
    device."""
    from ..ops.cg import apply_stiffness, cg_solve, stiffness_coefficients

    def assemble():
        s = stiffness_coefficients(data, material, load_factor)
        return (lambda v: apply_stiffness(data, s, v),
                lambda rhs: cg_solve(data, s, rhs, tol=cg_tol,
                                     max_iter=cg_max_iter)[0])

    return _force_newton(assemble, data, u0, load_factor, max_iter, tol,
                         min_denom)


def solve_nr(
    problem: TrussProblem,
    config: Optional[SolverConfig] = None,
    target_load_factor: float = 1.0,
    u_initial: Optional[np.ndarray] = None,
    data: Optional[ProblemData] = None,
    linear_solver: str = "auto",
    geometric_nonlinear: bool = False,
    cg_precond: str = "auto",
    prescribed_u: Optional[np.ndarray] = None,
    device=None,
) -> SolverResult:
    """Single-increment NR solve (driven by solvers.driver.solve).

    linear_solver: "dense" (Cholesky on the assembled K), "cg" (the
    banded operator when the numbering gives a banded layout, else the
    gather-based matrix-free PCG), "cg-dia" (banded operator only), or
    "auto" ("cg" above DENSE_DOF_LIMIT, else "dense").
    cg_precond: the banded PCG's preconditioner: "jacobi" (the fused
    kernels 2-3), "mg" (the banded smoothed-aggregation multigrid of
    ops/mg.py, aggregating `problem.dimension` components per node) or
    "auto" ("jacobi", the JAX package's default).  The other paths ignore
    it.
    geometric_nonlinear: opt-in Green-Lagrange kinematics (2D / 3D, dense
    solver only).
    prescribed_u: (ndof,) values of the fixed DOFs (support settlement).
    They seed u0 and persist, since every update is masked to the free
    DOFs: on the dense path by the masked solve, on the banded path by the
    PCG's masked result.
    device: where to solve when `data` is not given ("cuda" when None).
    """
    if geometric_nonlinear and linear_solver not in ("auto", "dense"):
        raise ValueError(
            "geometric_nonlinear requires the dense linear solver")
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
    if prescribed_u is not None:
        up = torch.as_tensor(np.asarray(prescribed_u, dtype=float).reshape(-1),
                             dtype=dtype).to(dev)
        u0 = u0 * data.free_mask + up * (1.0 - data.free_mask)
    lf = torch.tensor(target_load_factor, dtype=dtype, device=dev)

    if geometric_nonlinear:
        linear_solver = "dense"
    elif linear_solver == "auto":
        linear_solver = "cg" if problem.ndof > DENSE_DOF_LIMIT else "dense"
    if linear_solver == "cg" and _dia_layout_of(problem, data) is not None:
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
            precond=cg_precond, components=problem.dimension,
        )
    elif linear_solver == "cg":
        out = _nr_core_cg(
            data, problem.material, u0, lf, config.max_iterations,
            config.tolerance, config.min_denominator,
            cg_tol=max(config.tolerance * 0.1, 5e-8),
            cg_max_iter=max(20 * problem.ndof, 1000),
        )
    elif linear_solver == "dense":
        out = _nr_core(data, problem.material, u0, lf, config.max_iterations,
                       config.tolerance, config.min_denominator,
                       nonlinear=geometric_nonlinear)
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
