"""Banded (DIA) sparse stiffness: K u as a sum of shifted contiguous slices.

Counterpart of pinn_fem_tpu/ops/dia.py.  For meshes whose DOF ordering is
banded (chains, towers, grids) the stiffness has a few dozen nonzero
diagonals, and

    (K u)[i] = sum_k diag_k[i] * u[i + off_k]

reads only contiguous slices.  The diagonals are assembled once per Newton
iteration by one scatter pass; every CG iteration after that streams them.

Usage:
    layout = dia_layout(dof_map, ndof)            # host, once per mesh
    diags  = assemble_dia(layout, s, gvec)        # device, per assembly
    y      = dia_matvec(layout, diags, u)         # device, per CG step

On CUDA tensors `dia_matvec` and `dia_cg_solve` run the hand-written
kernels of ops/kernels/ (the stencil matvec, and the fused two-kernel
Jacobi-PCG of ops/kernels/cg_kernel.fused_cg_solve); on CPU tensors they run
the plain PyTorch versions, `dia_matvec_reference` and
`dia_cg_solve_reference`, which the kernels are held against.
`dia_cg_solve(precond="mg")` preconditions with the banded multigrid of
ops/mg.py, whose every level matvec is `dia_matvec`.

`dia_solve_diff` is the differentiable banded solve: its backward pass is
one more `dia_cg_solve` with the same operator (the adjoint of an SPD
system is the system itself), so an identification step on a card runs
the fused PCG twice, forward and adjoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.runtime import require_float32
from .assembly import scatter_add
from .cg import pcg_plain
from .kernels.dia_kernel import dia_matvec, dia_matvec_reference

__all__ = ["DiaLayout", "dia_layout", "assemble_dia", "assemble_dia_blocks",
           "dia_matvec", "dia_matvec_reference", "dia_diagonal",
           "dia_cg_solve", "dia_cg_solve_reference", "dia_solve_diff",
           "dia_diags_grad"]


@dataclass(frozen=True)
class DiaLayout:
    """Static banded layout of a mesh's stiffness.

    offsets: (nd,) sorted diagonal offsets (include 0), int64.
    entry_slot: (nelm, 2d, 2d) int64: for element-local entry (a, b), the
        flat index k * ndof + row into the (nd, ndof) diagonal array.  int64
        because nd * ndof passes 2**31 on large meshes.  None for an
        operator not assembled from elements (a multigrid level, ops/mg.py).
    ndof, bandwidth: ints.
    """

    offsets: np.ndarray
    entry_slot: Optional[np.ndarray]
    ndof: int
    bandwidth: int
    _on_device: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_diags(self) -> int:
        return int(self.offsets.size)

    def cached(self, key, make):
        """make(), computed once per key and kept with the layout (device
        copies and the kernels' launch data)."""
        value = self._on_device.get(key)
        if value is None:
            value = self._on_device[key] = make()
        return value

    def _tensor(self, name: str, device) -> torch.Tensor:
        device = torch.device(device)
        return self.cached((name, str(device)), lambda: torch.as_tensor(
            getattr(self, name), dtype=torch.int64, device=device))

    def offsets_on(self, device) -> torch.Tensor:
        """(nd,) int64 offsets on `device`, copied once and kept."""
        return self._tensor("offsets", device)

    def entry_slot_on(self, device) -> torch.Tensor:
        """(nelm, 2d, 2d) int64 scatter map on `device`, copied once."""
        if self.entry_slot is None:
            raise ValueError("this layout has no element scatter map")
        return self._tensor("entry_slot", device)


def dia_layout(dof_map: np.ndarray, ndof: int,
               max_diags: int = 64,
               max_bandwidth: Optional[int] = None) -> DiaLayout:
    """Build the static DIA layout (numpy, on the host).

    The cost of a banded matvec scales with the number of distinct offsets
    (n_diags), not the bandwidth.  Raises ValueError when the mesh has more
    than max_diags distinct offsets, or when an explicit max_bandwidth is
    exceeded.
    """
    dof_map = np.asarray(dof_map, dtype=np.int64)
    rows = dof_map[:, :, None]           # (nelm, 2d, 1)
    cols = dof_map[:, None, :]           # (nelm, 1, 2d)
    offs = (cols - rows)                 # (nelm, 2d, 2d)
    bandwidth = int(np.abs(offs).max()) if offs.size else 0
    if max_bandwidth is not None and bandwidth > max_bandwidth:
        raise ValueError(
            f"mesh bandwidth {bandwidth} exceeds {max_bandwidth}; "
            "renumber DOFs or use the gather-based operator"
        )
    unique_offs = np.unique(offs)
    if unique_offs.size > max_diags:
        raise ValueError(
            f"mesh has {unique_offs.size} distinct diagonals "
            f"(> {max_diags}); renumber DOFs or use the gather-based operator"
        )
    k_of = np.searchsorted(unique_offs, offs)                # (nelm, 2d, 2d)
    entry_slot = k_of * ndof + np.broadcast_to(rows, offs.shape)
    return DiaLayout(
        offsets=unique_offs.astype(np.int64),
        entry_slot=entry_slot.astype(np.int64),
        ndof=ndof,
        bandwidth=bandwidth,
    )


def assemble_dia(layout: DiaLayout, s: torch.Tensor, gvec: torch.Tensor
                 ) -> torch.Tensor:
    """Diagonals (nd, ndof) from element stiffness coefficients:
    ke[e, a, b] = s_e g_a g_b scattered once into diagonal storage."""
    ke = s[:, None, None] * gvec[:, :, None] * gvec[:, None, :]
    return assemble_dia_blocks(layout, ke)


def assemble_dia_blocks(layout: DiaLayout, blocks: torch.Tensor
                        ) -> torch.Tensor:
    """Diagonals (nd, ndof) from full element blocks (nelm, w, w), summed
    in float64 and rounded once (see ops/assembly.scatter_add: the order
    of a float32 scatter decides the float32 solution's accuracy)."""
    flat = scatter_add(layout.n_diags * layout.ndof,
                       layout.entry_slot_on(blocks.device), blocks)
    return flat.reshape(layout.n_diags, layout.ndof)


def dia_diagonal(layout: DiaLayout, diags: torch.Tensor) -> torch.Tensor:
    """diag(K): the offset-0 row."""
    k0 = int(np.where(layout.offsets == 0)[0][0])
    return diags[k0]


def _masked_system(layout: DiaLayout, diags: torch.Tensor, rhs: torch.Tensor,
                   free_mask: torch.Tensor, tol, x0: Optional[torch.Tensor],
                   matvec):
    """The masked operator M K M + (I - M) on `matvec`, b = M rhs, x0,
    |b| and tol |b|."""
    mask = free_mask

    def a_op(x):
        return matvec(layout, diags, x * mask) * mask + x * (1.0 - mask)

    b = rhs * mask
    b_norm = torch.clamp_min(torch.linalg.vector_norm(b), 1e-30)
    tol_b = torch.as_tensor(tol, dtype=b.dtype, device=b.device) * b_norm
    x = torch.zeros_like(b) if x0 is None else x0 * mask
    return a_op, b, x, b_norm, tol_b


def dia_cg_solve(
    layout: DiaLayout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
    precond: str = "jacobi",
    components: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCG on the banded operator with masked BCs.

    Returns (x * mask, iterations, relative recurrence-residual norm), the
    contract of pinn_fem_tpu.ops.dia.dia_cg_solve.

    precond "jacobi": CPU tensors run the plain recurrence
    (`dia_cg_solve_reference`); CUDA tensors the fused kernels
    (ops/kernels/cg_kernel.fused_cg_solve), as the JAX package's
    use_pallas=True does on a TPU.

    precond "mg": the banded smoothed-aggregation multigrid V-cycle
    (ops/mg.py) as the preconditioner; `components` is the DOFs per node
    its aggregation keeps apart.  The hierarchy and its coarsest Cholesky
    factor are built once per call and reused by every iteration.  The
    operator and every level's matvec are kernel 1 on a CUDA tensor (a
    float64 one is refused), the twin on a CPU tensor.  The recurrence is
    the plain one, whose stop test is computed on the device and read by
    the host once an iteration (ops/cg.pcg_plain), on every device: a
    V-cycle enqueues about a hundred torch ops (1-2 ms of host time at
    40k DOFs) against tens of microseconds for a flag read, so reading
    every iteration costs a few percent and runs no V-cycle past the stop,
    where the frozen-state loop of ops/cg.pcg_flagged would add about ten
    ops an iteration to save reads that cost less.  Kernel 1 thus runs
    (1 + V)(1 + iterations) times a solve, V = mg.cycle_matvecs.
    """
    if precond == "mg":
        from .mg import build_hierarchy, v_cycle

        if rhs.device.type == "cuda":
            require_float32(rhs.dtype, "multigrid PCG (kernel 1: dia_matvec, "
                            "on every level)")
        hierarchy = build_hierarchy(layout, diags, free_mask,
                                    components=components)
        a_op, b, x, b_norm, tol_b = _masked_system(
            layout, diags, rhs, free_mask, tol, x0, dia_matvec)
        x, it, r = pcg_plain(a_op, lambda v: v_cycle(hierarchy, v), b, x,
                             tol_b, max_iter)
        return x * free_mask, it, torch.linalg.vector_norm(r) / b_norm
    if precond != "jacobi":
        raise ValueError(f"unknown preconditioner {precond!r}")
    if rhs.device.type == "cpu":
        return dia_cg_solve_reference(layout, diags, rhs, free_mask, tol,
                                      max_iter, x0)
    from .kernels import fused_cg_solve

    return fused_cg_solve(layout, diags, rhs, free_mask, tol, max_iter, x0)


def dia_cg_solve_reference(
    layout: DiaLayout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain Jacobi-PCG recurrence of pinn_fem_tpu.ops.dia.dia_cg_solve
    in PyTorch, on any device.  The loop tests its condition on the host
    every iteration; the fused kernel form keeps it on the device.
    Float32 breakdown guards as in the reference: the loop trusts the
    recurrence residual and stops when r.z is no longer finite and
    positive (ops/cg.pcg_plain).
    """
    a_op, b, x, b_norm, tol_b = _masked_system(
        layout, diags, rhs, free_mask, tol, x0, dia_matvec_reference)
    inv_diag = 1.0 / (dia_diagonal(layout, diags) * free_mask
                      + (1.0 - free_mask))
    x, it, r = pcg_plain(a_op, lambda v: inv_diag * v, b, x, tol_b, max_iter)
    return x * free_mask, it, torch.linalg.vector_norm(r) / b_norm


def dia_diags_grad(layout: DiaLayout, lam: torch.Tensor, u: torch.Tensor,
                   free_mask: torch.Tensor) -> torch.Tensor:
    """(nd, ndof) gradient of lam . (M K(diags) M u) with respect to the
    diagonals: g[k, i] = m_i lam_i m_{i+off_k} u_{i+off_k}, zero where
    i + off_k falls outside [0, ndof).  One gather of the padded M u over
    all diagonals at once (a view of every shift, indexed by the
    offsets), then one product."""
    b = layout.bandwidth
    mu = torch.nn.functional.pad(u * free_mask, (b, b))
    shifts = mu.unfold(0, layout.ndof, 1)          # (2b + 1, ndof) view
    rows = layout.offsets_on(u.device) + b
    return (lam * free_mask)[None, :] * shifts[rows]


class _DiaSolveDiff(torch.autograd.Function):
    """u = (M K M + I - M)^-1 M rhs with the adjoint rule: the backward
    solves the same system for lam = A^-1 du and returns
    (-dia_diags_grad(lam, u), M lam)."""

    @staticmethod
    def forward(ctx, diags, rhs, layout, free_mask, tol, max_iter, precond):
        d = diags.detach()
        u, _, _ = dia_cg_solve(layout, d, rhs.detach(), free_mask, tol=tol,
                               max_iter=max_iter, precond=precond)
        ctx.layout, ctx.args = layout, (tol, max_iter, precond)
        ctx.save_for_backward(d, u, free_mask)
        return u

    @staticmethod
    def backward(ctx, g):
        d, u, mask = ctx.saved_tensors
        tol, max_iter, precond = ctx.args
        lam, _, _ = dia_cg_solve(ctx.layout, d, g.contiguous(), mask,
                                 tol=tol, max_iter=max_iter, precond=precond)
        grad_diags = grad_rhs = None
        if ctx.needs_input_grad[0]:
            grad_diags = -dia_diags_grad(ctx.layout, lam, u, mask)
        if ctx.needs_input_grad[1]:
            grad_rhs = lam * mask
        return grad_diags, grad_rhs, None, None, None, None, None


def dia_solve_diff(layout: DiaLayout, diags: torch.Tensor, rhs: torch.Tensor,
                   free_mask: torch.Tensor, tol: float = 1e-7,
                   max_iter: int = 20000,
                   precond: str = "jacobi") -> torch.Tensor:
    """Differentiable banded solve u = K(diags)^-1 rhs on the free DOFs
    (zero on the fixed ones), with gradients to `diags` and `rhs` by the
    adjoint method (pinn_fem_tpu.ops.dia.dia_solve_diff, a
    lax.custom_linear_solve(symmetric=True) of the masked operator
    M K M + (I - M)).

    Forward: `dia_cg_solve` on the detached diagonals (the fused PCG,
    kernels 1-3, on a CUDA tensor; the plain recurrence on a CPU one).
    Backward: one more `dia_cg_solve` with the same diagonals, tol and
    max_iter on the upstream gradient, giving lam; then d rhs = M lam and
    d diags = -dia_diags_grad(lam, u).  Gradients reach element blocks
    through the autograd of `assemble_dia_blocks` (its float64 scatter
    transposes to a gather back).  Memory stays O(band * ndof).
    """
    return _DiaSolveDiff.apply(diags, rhs, layout, free_mask, float(tol),
                               int(max_iter), precond)
