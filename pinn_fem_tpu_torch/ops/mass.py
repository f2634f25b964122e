"""Mass matrices of truss meshes (counterpart of pinn_fem_tpu/ops/mass.py).

Each element's mass m_e = rho A L0 takes the material at the element
midpoint, the stiffness's rule.  Density and area come from each field's
`eval_batch`, as in the JAX package: kernel 4 computes s = E A / L for the
stiffness, and the mass needs rho and A only once per operator.

Forms:
  * lumped (diagonal): half of m_e on every translational DOF of each end
    node, what the explicit integrator wants (M^-1 is pointwise);
  * consistent: me = (m_e / 6) [[2I, I], [I, 2I]] per element, dense or in
    the banded DIA layout of the stiffness (the same sparsity, so the
    stiffness layout's entry_slot map applies).

The payload mass of ProblemData.point_mass adds on the diagonal of both.
Every scatter-add sums in float64 and rounds once (ops/assembly.scatter_add).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fields import Material, assembly_inputs
from ..models.problem import ProblemData
from .assembly import scatter_add


def element_masses(data: ProblemData, material: Material,
                   load_factor=1.0) -> torch.Tensor:
    """(nelm,) element masses rho A L0, material at element midpoints."""
    x = assembly_inputs(data.mid, data.dimension, load_factor)
    rho = material.density.eval_batch(x)
    area = material.area.eval_batch(x)
    return rho * area / data.inv_len


def lumped_mass(data: ProblemData, material: Material,
                load_factor=1.0) -> torch.Tensor:
    """Diagonal (ndof,) lumped mass vector, payload mass included."""
    m_e = element_masses(data, material, load_factor)
    contrib = (0.5 * m_e)[:, None].expand(data.dof_map.shape)
    m = scatter_add(data.ndof, data.dof_map, contrib)
    if data.point_mass is not None:
        m = m + data.point_mass
    return m


def _consistent_me(data: ProblemData, m_e: torch.Tensor) -> torch.Tensor:
    """(nelm, 2d, 2d) consistent element mass blocks."""
    eye = torch.eye(data.dimension, dtype=m_e.dtype, device=m_e.device)
    pattern = torch.cat([torch.cat([2.0 * eye, eye], 1),
                         torch.cat([eye, 2.0 * eye], 1)], 0) / 6.0
    return m_e[:, None, None] * pattern[None, :, :]


def consistent_mass(data: ProblemData, material: Material,
                    load_factor=1.0) -> torch.Tensor:
    """Dense (ndof, ndof) consistent mass, payload mass on the diagonal."""
    me = _consistent_me(data, element_masses(data, material, load_factor))
    ndof = data.ndof
    slots = data.dof_map[:, :, None] * ndof + data.dof_map[:, None, :]
    m = scatter_add(ndof * ndof, slots, me).reshape(ndof, ndof)
    if data.point_mass is not None:
        m = m + torch.diag(data.point_mass)
    return m


def consistent_mass_dia(layout, data: ProblemData, material: Material,
                        load_factor=1.0) -> torch.Tensor:
    """Consistent mass in the banded DIA layout of the stiffness."""
    from .dia import assemble_dia_blocks

    me = _consistent_me(data, element_masses(data, material, load_factor))
    diags = assemble_dia_blocks(layout, me)
    if data.point_mass is not None:
        k0 = int(np.where(np.asarray(layout.offsets) == 0)[0][0])
        diags[k0] += data.point_mass
    return diags


def total_mass(data: ProblemData, material: Material) -> torch.Tensor:
    """Scalar structural mass (lumped and consistent row sums both
    integrate to it)."""
    return torch.sum(element_masses(data, material))
