"""Geometric (initial-stress) stiffness (counterpart of
pinn_fem_tpu/ops/geometric.py).

For a truss element carrying axial force N (tension positive):

    ke_g = (N / L0) [[ I, -I],
                     [-I,  I]]          (I the dim x dim identity)

the initial-stress term of the Green-Lagrange tangent, linearized about a
static state u0.  Its block has the stiffness's (dof_map x dof_map)
sparsity, so the DIA layout's entry_slot map applies unchanged.
"""

from __future__ import annotations

import torch

from ..models.fields import Material, assembly_inputs
from ..models.problem import ProblemData
from .assembly import scatter_add


def element_axial_forces(data: ProblemData, material: Material,
                         u: torch.Tensor, load_factor=1.0) -> torch.Tensor:
    """(nelm,) axial forces N_e = E A eps_e at the state u (linear strain,
    material at element midpoints, each field's eval_batch)."""
    x = assembly_inputs(data.mid, data.dimension, load_factor)
    young = material.young.eval_batch(x)
    area = material.area.eval_batch(x)
    u_e = u.reshape(-1)[data.dof_map]
    strain = torch.sum(data.gvec * u_e, dim=-1) * data.inv_len
    return young * area * strain


def _geometric_blocks(data: ProblemData, n_e: torch.Tensor) -> torch.Tensor:
    """(nelm, 2d, 2d) blocks (N_e / L0) [[I, -I], [-I, I]]."""
    coef = n_e * data.inv_len
    eye = torch.eye(data.dimension, dtype=coef.dtype, device=coef.device)
    pattern = torch.cat([torch.cat([eye, -eye], 1),
                         torch.cat([-eye, eye], 1)], 0)
    return coef[:, None, None] * pattern[None, :, :]


def assemble_geometric(data: ProblemData, n_e: torch.Tensor) -> torch.Tensor:
    """Dense (ndof, ndof) geometric stiffness from element axial forces."""
    ke = _geometric_blocks(data, n_e)
    ndof = data.ndof
    slots = data.dof_map[:, :, None] * ndof + data.dof_map[:, None, :]
    return scatter_add(ndof * ndof, slots, ke).reshape(ndof, ndof)


def assemble_geometric_dia(layout, data: ProblemData,
                           n_e: torch.Tensor) -> torch.Tensor:
    """Geometric stiffness in the banded DIA layout of the material K."""
    from .dia import assemble_dia_blocks

    return assemble_dia_blocks(layout, _geometric_blocks(data, n_e))
