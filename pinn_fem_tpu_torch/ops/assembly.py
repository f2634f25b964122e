"""Global system assembly (counterpart of pinn_fem_tpu/ops/assembly.py).

Material is evaluated at element midpoints with (load_factor, x[, y])
inputs; density never enters the stiffness.  When the three fields are
MLPs that kernel 4 takes (ops/kernels/material_kernel.py,
`fused_coefficients_supported`), (E, A, s) come from
`fused_material_coefficients`: the CUDA kernels on a card, their twin on
the CPU.  Otherwise each field's own `eval_batch` (the torch form).
`torch_form=True` takes the torch form on every device: the route of the
second-order methods (see `material_coefficients`).

Every scatter-add accumulates in float64 and rounds once to the working
type (`scatter_add`).  A float32 scatter rounds after each addition, so
its result depends on the order in which contributions arrive, and on a
CUDA device that order is whatever the atomics give.  The order is not
harmless: on a regular grid, assembled diagonals rounded in an arbitrary
order perturb the rigid-body cancellation of K row by row.  With a float32
scatter, the float32 Newton solution of the 100 x 200 grid
(examples_grid.py) landed 1.3e-3 (relative, max norm) from the float64
solution on an H100, against 1.1e-4 on the CPU with its sequential order;
on the 50 x 100 grid, float64 accumulation brings the CPU's 6.5e-5 to
3.0e-5.  This is a divergence from the JAX package, whose float32 scatter
rounds in XLA's order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.fields import Material, assembly_inputs
from ..models.problem import ProblemData
from .elements import truss_linear_batch
from .kernels.material_kernel import (fused_coefficients_supported,
                                      fused_material_coefficients,
                                      material_coefficients_reference)


def material_coefficients(data: ProblemData, material: Material, load_factor,
                          torch_form: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(young, area, s = young * area / L) at all element midpoints.

    torch_form=False is the value route: kernel 4 where
    `fused_coefficients_supported` holds (its twin on the CPU).
    torch_form=True evaluates the same functions in torch ops on every
    device (`material_coefficients_reference`, or each field's
    `eval_batch`), so torch.func can differentiate them to any order.
    This is the form the full-NR and Gauss-Newton methods differentiate,
    not a fallback: the JAX package's full-NR and Gauss-Newton
    differentiate its XLA form (pinn_fem_tpu/ops/assembly.py:30) and never
    its Pallas kernel, and kernel 4's backward (4b) is first-order only
    (`MaterialCoefficients` has no forward-mode or vmap rule, so torch.func
    refuses it).  A forward-over-reverse rule for kernel 4 waits for a card
    measurement that asks for it (ROADMAP item 6)."""
    if fused_coefficients_supported(material, data.dimension):
        if torch_form:
            young, area, _, s = material_coefficients_reference(
                data.mid, data.inv_len, load_factor, material)
        else:
            young, area, _, s = fused_material_coefficients(data, material,
                                                            load_factor)
        return young, area, s
    x = assembly_inputs(data.mid, data.dimension, load_factor)
    young, area = material.young.eval_batch(x), material.area.eval_batch(x)
    return young, area, young * area * data.inv_len


def material_values(data: ProblemData, material: Material, load_factor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(young, area) at all element midpoints in one batch."""
    young, area, _ = material_coefficients(data, material, load_factor)
    return young, area


def scatter_add(size: int, index: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
    """out[index[i]] += values[i] into a zero (size,) vector, summed in
    float64 and rounded once to values.dtype: the same result in any order
    of accumulation, on any device."""
    out = torch.zeros(size, dtype=torch.float64, device=values.device)
    out.index_add_(0, index.reshape(-1), values.reshape(-1).double())
    return out.to(values.dtype)


def _scatter_dofs(data: ProblemData, fe: torch.Tensor) -> torch.Tensor:
    return scatter_add(data.ndof, data.dof_map, fe)


def assemble_system(data: ProblemData, material: Material, u: torch.Tensor,
                    load_factor=1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense global stiffness K (ndof, ndof), internal force and max |strain|."""
    young, area = material_values(data, material, load_factor)
    u_e = u[data.dof_map]                                  # (nelm, 2d)
    elem = truss_linear_batch(data.gvec, data.inv_len, u_e, young, area)
    ndof = data.ndof
    # Flat (row * ndof + col) slots: one scatter_add builds dense K.
    slots = data.dof_map[:, :, None] * ndof + data.dof_map[:, None, :]
    k_global = scatter_add(ndof * ndof, slots, elem.ke).reshape(ndof, ndof)
    f_int = _scatter_dofs(data, elem.fe_int)
    max_abs_strain = (torch.max(torch.abs(elem.strain)) if data.nelm
                      else torch.zeros((), dtype=u.dtype, device=u.device))
    return k_global, f_int, max_abs_strain


def internal_force_and_strain(data: ProblemData, material: Material,
                              u: torch.Tensor, load_factor=1.0,
                              torch_form: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-free internal force (K is never formed) and element strains:
    the GD loss's hot path.  torch_form: the material's route, as in
    `material_coefficients`."""
    _, _, s = material_coefficients(data, material, load_factor, torch_form)
    u_e = u[data.dof_map]
    gu = torch.sum(data.gvec * u_e, dim=-1)
    fe = (s * gu)[:, None] * data.gvec
    return _scatter_dofs(data, fe), gu * data.inv_len
