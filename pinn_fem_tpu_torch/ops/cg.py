"""Element stiffness coefficients (counterpart of pinn_fem_tpu/ops/cg.py).

Only `stiffness_coefficients` is ported: the banded Newton core assembles
its diagonals from it.  The gather-based matrix-free PCG of the JAX module
(apply_stiffness, cg_solve, stiffness_diagonal) waits for ROADMAP item 10.
"""

from __future__ import annotations

import torch

from ..models.fields import Material
from ..models.problem import ProblemData
from .assembly import material_coefficients


def stiffness_coefficients(data: ProblemData, material: Material,
                           load_factor=1.0) -> torch.Tensor:
    """s_e = E_e A_e / L_e for every element (kernel 4 where it applies,
    as ops.assembly.material_coefficients decides)."""
    return material_coefficients(data, material, load_factor)[2]
