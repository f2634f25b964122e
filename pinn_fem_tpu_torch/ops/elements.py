"""Batched truss element kernel (counterpart of pinn_fem_tpu/ops/elements.py).

Only the linear kernel is ported; the Green-Lagrange kernel comes with
geometric nonlinearity (ROADMAP item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ElementBatch(NamedTuple):
    ke: torch.Tensor      # (nelm, 2d, 2d) element stiffness
    fe_int: torch.Tensor  # (nelm, 2d) internal force
    strain: torch.Tensor  # (nelm,) axial strain


def truss_linear_batch(gvec: torch.Tensor, inv_len: torch.Tensor,
                       u_e: torch.Tensor, young: torch.Tensor,
                       area: torch.Tensor) -> ElementBatch:
    """Linear truss kernel (1D, 2D and 3D) over a batch of elements:
    ke = s g g^T, fe = s (g.u) g, eps = (g.u) / L0, with s = E A / L0."""
    s = young * area * inv_len
    gu = torch.sum(gvec * u_e, dim=-1)
    ke = s[:, None, None] * gvec[:, :, None] * gvec[:, None, :]
    fe = (s * gu)[:, None] * gvec
    strain = gu * inv_len
    return ElementBatch(ke=ke, fe_int=fe, strain=strain)
