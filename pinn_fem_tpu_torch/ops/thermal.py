"""Thermal (free-strain) loading: equivalent nodal forces for alpha dT
(counterpart of pinn_fem_tpu/ops/thermal.py).

With free strain eps0 = alpha dT per element, the element energy is
U = 1/2 E A L (eps - eps0)^2, so equilibrium solves

    K u = f_ext + f_th,   f_th = sum_e E A alpha dT_e g_e

(g_e the signed direction pair: a heated element pushes its end nodes
apart).  Exact for linear kinematics.  Closed-form anchors: a fully
constrained bar stays at u = 0 with support reactions E A alpha dT, a free
bar elongates alpha dT L stress-free, and any statically determinate truss
heated uniformly displaces as a pure scaling about its support,
u = alpha dT (x - x_fix), with zero member stress.

Mechanical stress recovery subtracts the free strain,
sigma = E (eps - alpha dT); `thermal_free_strains` gives eps0 for that.
f_th is scattered with the float64 `scatter_add` of ops/assembly.py.
"""

from __future__ import annotations

import torch

from ..models.fields import Material
from ..models.problem import ProblemData
from .assembly import material_values, scatter_add


def _per_element(values, nelm: int, name: str, dtype, device) -> torch.Tensor:
    arr = torch.as_tensor(values, dtype=dtype, device=device)
    if arr.ndim == 0:
        return arr.expand(nelm)
    if tuple(arr.shape) == (nelm,):
        return arr
    raise ValueError(f"{name} must be a scalar or length-nelm list")


def element_delta_t(data: ProblemData, delta_t, nnode: int) -> torch.Tensor:
    """Element temperature changes from a scalar, per-node (nnode,) or
    per-element (nelm,) spec; per node averages the two end nodes.

    When nelm == nnode (a closed ring) the shapes are ambiguous and per
    node wins: the document schema is node-centric (supports, loads and
    measurements are all per node)."""
    arr = torch.as_tensor(delta_t, dtype=data.loads.dtype, device=data.device)
    if arr.ndim == 0:
        return arr.expand(data.nelm)
    if tuple(arr.shape) == (nnode,):
        conn = data.dof_map[:, ::data.dimension] // data.dimension
        return 0.5 * (arr[conn[:, 0]] + arr[conn[:, 1]])
    if tuple(arr.shape) == (data.nelm,):
        return arr
    raise ValueError("delta_t must be scalar, (nnode,) or (nelm,)")


def thermal_free_strains(data: ProblemData, alpha, dt_e) -> torch.Tensor:
    """(nelm,) free strains eps0 = alpha dT."""
    a = _per_element(alpha, data.nelm, "alpha", data.loads.dtype, data.device)
    return a * dt_e


def thermal_loads(data: ProblemData, material: Material, alpha, dt_e,
                  load_factor=1.0) -> torch.Tensor:
    """(ndof,) equivalent nodal forces f_th = sum_e E A alpha dT g_e."""
    young, area = material_values(data, material, load_factor)
    coef = young * area * thermal_free_strains(data, alpha, dt_e)
    return scatter_add(data.ndof, data.dof_map, coef[:, None] * data.gvec)
