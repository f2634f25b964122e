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
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from .assembly import scatter_add
from .kernels.dia_kernel import dia_matvec, dia_matvec_reference

__all__ = ["DiaLayout", "dia_layout", "assemble_dia", "assemble_dia_blocks",
           "dia_matvec", "dia_matvec_reference", "dia_diagonal",
           "dia_cg_solve", "dia_cg_solve_reference"]


@dataclass(frozen=True)
class DiaLayout:
    """Static banded layout of a mesh's stiffness.

    offsets: (nd,) sorted diagonal offsets (include 0), int64.
    entry_slot: (nelm, 2d, 2d) int64: for element-local entry (a, b), the
        flat index k * ndof + row into the (nd, ndof) diagonal array.  int64
        because nd * ndof passes 2**31 on large meshes.
    ndof, bandwidth: ints.
    """

    offsets: np.ndarray
    entry_slot: np.ndarray
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


def dia_cg_solve(
    layout: DiaLayout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
    precond: str = "jacobi",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi-PCG on the banded operator with masked BCs.

    Returns (x * mask, iterations, relative recurrence-residual norm), the
    contract of pinn_fem_tpu.ops.dia.dia_cg_solve.  CPU tensors run the
    plain recurrence (`dia_cg_solve_reference`); CUDA tensors the fused
    kernels (ops/kernels/cg_kernel.fused_cg_solve), as the JAX package's
    use_pallas=True does on a TPU.
    """
    if precond == "mg":
        raise NotImplementedError(
            "multigrid preconditioning (ops/mg.py) is not yet ported, "
            "ROADMAP item 13")
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
    """
    mask = free_mask
    b_vec = rhs * mask

    def a_op(x):
        return (dia_matvec_reference(layout, diags, x * mask) * mask
                + x * (1.0 - mask))

    diag = dia_diagonal(layout, diags) * mask + (1.0 - mask)
    inv_diag = 1.0 / diag
    b_norm = torch.clamp_min(torch.linalg.vector_norm(b_vec), 1e-30)
    tol_b = torch.as_tensor(tol, dtype=b_vec.dtype, device=b_vec.device) * b_norm
    tiny = torch.tensor(1e-30, dtype=b_vec.dtype, device=b_vec.device)
    x = torch.zeros_like(b_vec) if x0 is None else x0 * mask

    r = b_vec - a_op(x)
    z = inv_diag * r
    rz = torch.dot(r, z)
    p = z
    it = 0
    # Float32 breakdown guards as in the reference: the loop trusts the
    # recurrence residual and stops when r.z is no longer finite and
    # positive (a reliable end-of-progress signal for SPD systems).
    while (it < max_iter and bool(torch.isfinite(rz)) and bool(rz > 0)
           and bool(torch.linalg.vector_norm(r) > tol_b)):
        ap = a_op(p)
        denom = torch.dot(p, ap)
        alpha = rz / torch.where(denom.abs() > 0, denom, tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, tiny)
        p = z + beta * p
        rz = rz_new
        it += 1
    return (x * mask, torch.tensor(it, dtype=torch.int32),
            torch.linalg.vector_norm(r) / b_norm)
