"""Matrix-free Jacobi-PCG for meshes without a banded layout (counterpart of
pinn_fem_tpu/ops/cg.py).

For the linear truss the stiffness action needs no matrix:

    K u = sum over elements of s_e (g_e . u_e) g_e,   s_e = E_e A_e / L_e

one gather of u, an elementwise block and a gather-based segment sum
(ops/scatter.py, summed in float64 and rounded once).  The Jacobi
diagonal is the segment sum of s_e g_e^2.  The JAX package computes this
path with plain XLA gathers and sums and no Pallas kernel, so plain torch
ops are its port.

`cg_solve` has the JAX contract: the masked operator M K M + (I - M), the
float32 breakdown guards (stop when r.z is not finite and positive), the
test on the recurrence residual, and (x * mask, iterations, |r| / |b|).
On CPU tensors it runs the plain loop that tests its condition on the host
every iteration (`cg_solve_reference`); on CUDA tensors `cg_solve_flagged`,
which keeps alpha, beta, r.z and the stop flag on the device, freezes its
state once the stop test holds and reads the flag every CHECK_EVERY
iterations, as the fused banded PCG does
(ops/kernels/cg_kernel._pcg).  Both forms run the same operations in the
same order, so they give the same iterations and x on the same device.
The two loops (`pcg_plain`, `pcg_flagged`) take any operator and
preconditioner apply: the banded Jacobi twin and the multigrid PCG of
ops/dia.py run `pcg_plain` too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.fields import Material
from ..models.problem import ProblemData
from .assembly import material_coefficients
from .scatter import segment_sum_dofs

# Iterations between two host reads of the device loop's live flag (the
# fused banded PCG's CHECK_EVERY).
CHECK_EVERY = 32


def stiffness_coefficients(data: ProblemData, material: Material,
                           load_factor=1.0) -> torch.Tensor:
    """s_e = E_e A_e / L_e for every element (kernel 4 where it applies,
    as ops.assembly.material_coefficients decides)."""
    return material_coefficients(data, material, load_factor)[2]


def apply_stiffness(data: ProblemData, s: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Matrix-free K @ u: gather, element block, gather-based segment
    sum."""
    u_e = u[data.dof_map]
    gu = torch.sum(data.gvec * u_e, dim=-1)
    fe = (s * gu)[:, None] * data.gvec
    return segment_sum_dofs(fe, data.ensure_gather_map())


def stiffness_diagonal(data: ProblemData, s: torch.Tensor) -> torch.Tensor:
    """diag(K) from s_e g_e^2 (the Jacobi preconditioner)."""
    contrib = s[:, None] * data.gvec * data.gvec
    return segment_sum_dofs(contrib, data.ensure_gather_map())


def _setup(data: ProblemData, s: torch.Tensor, rhs: torch.Tensor, tol,
           x0: Optional[torch.Tensor]):
    """The operator, the Jacobi apply, b, x0, |b| and tol |b| of both loop
    forms."""
    mask = data.free_mask
    fixed = 1.0 - mask
    b = rhs * mask

    def a_op(x):
        return apply_stiffness(data, s, x * mask) * mask + x * fixed

    inv_diag = 1.0 / (stiffness_diagonal(data, s) * mask + fixed)
    b_norm = torch.clamp_min(torch.linalg.vector_norm(b), 1e-30)
    tol_b = torch.as_tensor(tol, dtype=b.dtype, device=b.device) * b_norm
    x = torch.zeros_like(b) if x0 is None else x0 * mask
    return a_op, (lambda r: inv_diag * r), b, x, b_norm, tol_b


def _start(a_op, precond, b, x):
    """r0 = b - A x0, p0 = z0 = M^-1 r0 and r0.z0."""
    r = b - a_op(x)
    z = precond(r)
    return r, z, torch.dot(r, z)


def _step(a_op, precond, x, r, p, rz, tiny):
    """One PCG iteration: (x, r, p, r.z) after it."""
    ap = a_op(p)
    denom = torch.dot(p, ap)
    alpha = rz / torch.where(denom.abs() > 0, denom, tiny)
    x = x + alpha * p
    r = r - alpha * ap
    z = precond(r)
    rz_new = torch.dot(r, z)
    beta = rz_new / torch.where(rz != 0, rz, tiny)
    return x, r, z + beta * p, rz_new


def _live(it, max_iter, rz, r, tol_b):
    """The loop condition: iterations left, r.z finite and positive, and
    the recurrence residual above tol |b|."""
    return ((it < max_iter) & torch.isfinite(rz) & (rz > 0)
            & (torch.linalg.vector_norm(r) > tol_b))


def pcg_plain(a_op, precond, b: torch.Tensor, x: torch.Tensor, tol_b,
              max_iter: int):
    """The PCG recurrence on A = a_op with M^-1 = precond from x: the
    condition is read on the host every iteration.  Returns (x,
    iterations, r)."""
    r, p, rz = _start(a_op, precond, b, x)
    tiny = torch.tensor(1e-30, dtype=rz.dtype, device=rz.device)
    it = 0
    while bool(_live(it, max_iter, rz, r, tol_b)):
        x, r, p, rz = _step(a_op, precond, x, r, p, rz, tiny)
        it += 1
    return x, torch.tensor(it, dtype=torch.int32), r


def pcg_flagged(a_op, precond, b: torch.Tensor, x: torch.Tensor, tol_b,
                max_iter: int):
    """The same recurrence as a device loop: the stop test stays on the
    device, an iteration after it leaves (x, r, p, r.z) and the count as
    they were, and the host reads the flag every CHECK_EVERY
    iterations."""
    r, p, rz = _start(a_op, precond, b, x)
    tiny = torch.tensor(1e-30, dtype=rz.dtype, device=rz.device)
    it = torch.zeros((), dtype=torch.int32, device=rz.device)
    live = _live(it, max_iter, rz, r, tol_b)
    rounds = 0
    while rounds % CHECK_EVERY or bool(live):
        x1, r1, p1, rz1 = _step(a_op, precond, x, r, p, rz, tiny)
        x = torch.where(live, x1, x)
        r = torch.where(live, r1, r)
        p = torch.where(live, p1, p)
        rz = torch.where(live, rz1, rz)
        it = it + live.to(torch.int32)
        live = live & _live(it, max_iter, rz, r, tol_b)
        rounds += 1
    return x, it.cpu(), r


def cg_solve_reference(data: ProblemData, s: torch.Tensor, rhs: torch.Tensor,
                       tol=1e-6, max_iter=10000,
                       x0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain loop (pcg_plain)."""
    a_op, precond, b, x, b_norm, tol_b = _setup(data, s, rhs, tol, x0)
    x, it, r = pcg_plain(a_op, precond, b, x, tol_b, max_iter)
    return x * data.free_mask, it, torch.linalg.vector_norm(r) / b_norm


def cg_solve_flagged(data: ProblemData, s: torch.Tensor, rhs: torch.Tensor,
                     tol=1e-6, max_iter=10000,
                     x0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The device loop (pcg_flagged), on any device."""
    a_op, precond, b, x, b_norm, tol_b = _setup(data, s, rhs, tol, x0)
    x, it, r = pcg_flagged(a_op, precond, b, x, tol_b, max_iter)
    return x * data.free_mask, it, torch.linalg.vector_norm(r) / b_norm


def cg_solve(data: ProblemData, s: torch.Tensor, rhs: torch.Tensor,
             tol=1e-6, max_iter=10000, x0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi-preconditioned CG on the BC-masked operator M K M + (I - M):
    the solution is zero on the fixed DOFs and the free block matches the
    dense factorization.  Returns (x, iterations, relative recurrence
    residual).  CPU tensors take `cg_solve_reference`, CUDA tensors
    `cg_solve_flagged`; any dtype (no repo kernel is on this path)."""
    solve = (cg_solve_reference if rhs.device.type == "cpu"
             else cg_solve_flagged)
    return solve(data, s, rhs, tol, max_iter, x0)
