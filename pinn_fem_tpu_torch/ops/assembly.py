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

The `*_batched` functions take B members on one mesh, the JAX package's
vmap over a batch of problems (parallel/batched.py): u (B, ndof), load
factors (B,) and, for the MLP fields, flat parameters (B, P) in theta
order.  Kernel 4's fields take one batched launch for all members
(`fused_material_coefficients_batched`); other fields evaluate member by
member.  The members' forces are one float64 scatter over B * ndof slots
(member b's at offset b * ndof), rounded once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.fields import Material, MLPField, assembly_inputs
from ..models.problem import ProblemData
from .elements import truss2d_green_lagrange_batch, truss_linear_batch
from .kernels.material_kernel import (fused_coefficients_supported,
                                      fused_material_coefficients,
                                      fused_material_coefficients_batched,
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
    k_global = _assemble_dense(data, elem.ke)
    f_int = _scatter_dofs(data, elem.fe_int)
    max_abs_strain = (torch.max(torch.abs(elem.strain)) if data.nelm
                      else torch.zeros((), dtype=u.dtype, device=u.device))
    return k_global, f_int, max_abs_strain


def _assemble_dense(data: ProblemData, ke: torch.Tensor) -> torch.Tensor:
    """Dense (ndof, ndof) K from element blocks: one float64 scatter_add
    over flat (row * ndof + col) slots."""
    ndof = data.ndof
    slots = data.dof_map[:, :, None] * ndof + data.dof_map[:, None, :]
    return scatter_add(ndof * ndof, slots, ke).reshape(ndof, ndof)


def assemble_system_nonlinear(data: ProblemData, material: Material,
                              u: torch.Tensor, load_factor=1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Green-Lagrange tangent K (ndof, ndof), internal force and max
    |e_gl| (2D and 3D), as assemble_system returns them.  The rest
    coordinates come from the midpoints and the rest chords
    dx0 = g[:, dim:] / inv_len."""
    if data.dimension not in (2, 3):
        raise ValueError("geometric nonlinearity requires a 2D or 3D truss")
    young, area = material_values(data, material, load_factor)
    dim = data.dimension
    dx0 = data.gvec[:, dim:] / data.inv_len[:, None]
    x0 = torch.stack([data.mid - 0.5 * dx0, data.mid + 0.5 * dx0], dim=1)
    elem = truss2d_green_lagrange_batch(x0, u[data.dof_map], data.inv_len,
                                        young, area)
    return (_assemble_dense(data, elem.ke), _scatter_dofs(data, elem.fe_int),
            torch.max(torch.abs(elem.strain)))


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


def compute_residual_and_jacobian(data: ProblemData, material: Material,
                                  u: torch.Tensor, f_ext: torch.Tensor,
                                  free_idx, load_factor=1.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R_free, K_ff): the residual (f_int(u) - f_ext)[free] and the
    tangent K(u)[free, :][:, free], the reference's exported
    nn_assembly.py:234-261 helper.  free_idx: the free DOFs
    (TrussProblem.free_fixed()[0]); f_ext carries any load factor, which
    load_factor forwards to load-factor-aware NN fields.  Differentiable
    in u and in the material parameters."""
    k_global, f_int, _ = assemble_system(data, material, u, load_factor)
    free = torch.as_tensor(np.asarray(free_idx, dtype=np.int64)).to(u.device)
    return (f_int - f_ext)[free], k_global[free][:, free]


def element_strain_stress(data: ProblemData, material: Material,
                          u: torch.Tensor, engineering: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element strain and stress sigma = E eps.  engineering: eps =
    (L - L0) / L0 on the deformed chord (api_fem_solver's
    compute_element_stresses); otherwise the linear strain g.u_e / L0."""
    u_e = u[data.dof_map]                                   # (nelm, 2d)
    dim = data.dimension
    du = u_e[:, dim:] - u_e[:, :dim]                        # (nelm, dim)
    # Rest chord = direction cosines * L0 = gvec[:, dim:] / inv_len.
    dx0 = data.gvec[:, dim:] / data.inv_len[:, None]
    if engineering:
        l_def = torch.linalg.vector_norm(dx0 + du, dim=1)
        eps = (l_def - 1.0 / data.inv_len) * data.inv_len
    else:
        eps = torch.sum(data.gvec * u_e, dim=-1) * data.inv_len
    x = assembly_inputs(data.mid, dim, 1.0)
    young = material.young.eval_batch(x)
    return eps, young * eps


# --------------------------------------------------------- B members at once

def member_material(material: Material, flat: torch.Tensor) -> Material:
    """The material with its MLP fields' layers taken from `flat`, one
    member's parameters in theta order (young, area, density; W then b a
    layer), as views of it."""
    fields, k = {}, 0
    for name in ("young", "area", "density"):
        f = getattr(material, name)
        if isinstance(f, MLPField):
            layers = []
            for w, b in f.layers:
                nw, nb = w.numel(), b.numel()
                layers.append((flat[k:k + nw].view(w.shape),
                               flat[k + nw:k + nw + nb].view(b.shape)))
                k += nw + nb
            f = f.replace(layers=layers)
        fields[name] = f
    return Material(**fields)


def material_coefficients_batched(data: ProblemData, material: Material,
                                  load_factors: torch.Tensor,
                                  params=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(young, area, s), each (B, nelm), of B members: member b is the
    material with its MLP fields' parameters params[b] ((B, P), None: the
    material's own) at load factor load_factors[b].

    Fields that kernel 4 takes run its batched launch (the batched twin on
    the CPU); other fields evaluate member by member in torch ops, and a
    material without MLP fields once for all members (its values do not
    depend on the load factor)."""
    members = load_factors.shape[0]
    if fused_coefficients_supported(material, data.dimension):
        if params is None:
            params = torch.cat([t.reshape(-1)
                                for t in material.trainable_params()])
            params = params.expand(members, -1).contiguous()
        young, area, _, s = fused_material_coefficients_batched(
            data, material, load_factors, params)
        return young, area, s
    if not material.has_trainable_params:
        young, area, s = material_coefficients(data, material, 1.0)
        return tuple(t.expand(members, -1) for t in (young, area, s))
    rows = []
    for b in range(members):
        mat = material if params is None else member_material(material,
                                                              params[b])
        x = assembly_inputs(data.mid, data.dimension, load_factors[b])
        young, area = mat.young.eval_batch(x), mat.area.eval_batch(x)
        rows.append((young, area, young * area * data.inv_len))
    return tuple(torch.stack(col) for col in zip(*rows))


def scatter_add_members(size: int, index: torch.Tensor, values: torch.Tensor
                        ) -> torch.Tensor:
    """`scatter_add` of each member: out[b, index[i]] += values[b, i] into
    zero (B, size), one float64 index_add_ over B * size slots (member b's
    at offset b * size), rounded once to values.dtype."""
    members = values.shape[0]
    offsets = torch.arange(members, device=values.device) * size
    flat = (index.reshape(1, -1) + offsets[:, None]).reshape(-1)
    out = torch.zeros(members * size, dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, flat, values.reshape(-1).double())
    return out.view(members, size).to(values.dtype)


def internal_force_and_strain_batched(data: ProblemData, material: Material,
                                      u: torch.Tensor,
                                      load_factors: torch.Tensor,
                                      params=None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`internal_force_and_strain` of B members: f_int (B, ndof) and the
    element strains (B, nelm) at u (B, ndof), each member with its own
    parameters params[b] and load factor load_factors[b]."""
    _, _, s = material_coefficients_batched(data, material, load_factors,
                                            params)
    u_e = u[:, data.dof_map]                               # (B, nelm, 2d)
    gu = torch.sum(data.gvec * u_e, dim=-1)
    fe = (s * gu)[..., None] * data.gvec
    return (scatter_add_members(data.ndof, data.dof_map, fe),
            gu * data.inv_len)


def assemble_stiffness_batched(data: ProblemData, young: torch.Tensor,
                               area: torch.Tensor) -> torch.Tensor:
    """Dense K (B, ndof, ndof) of B members from their element values
    (B, nelm): `assemble_system`'s K for each, one float64 scatter."""
    ndof = data.ndof
    s = young * area * data.inv_len
    ke = s[..., None, None] * data.gvec[:, :, None] * data.gvec[:, None, :]
    slots = data.dof_map[:, :, None] * ndof + data.dof_map[:, None, :]
    return scatter_add_members(ndof * ndof, slots, ke).view(-1, ndof, ndof)
