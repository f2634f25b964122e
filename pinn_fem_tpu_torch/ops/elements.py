"""Batched truss element kernels (counterpart of pinn_fem_tpu/ops/elements.py).

The linear kernel carries every path but one; the Green-Lagrange kernel
carries the opt-in geometrically nonlinear Newton
(solve_nr(geometric_nonlinear=True)).  The single-element wrappers keep
the reference's element API for tests and demos.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.runtime import default_dtype


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


def truss2d_green_lagrange_batch(x0: torch.Tensor, u_e: torch.Tensor,
                                 inv_len: torch.Tensor, young: torch.Tensor,
                                 area: torch.Tensor) -> ElementBatch:
    """Geometrically nonlinear (Green-Lagrange) truss kernel over a batch,
    in any dimension (read from x0's last axis).

    e_gl = (L^2 - L0^2) / (2 L0^2), computed cancellation-free as
    (dx0.delta + |delta|^2 / 2) / L0^2; with d = [-dx, dx] the deformed
    chord, the variationally consistent force and tangent of
    U = 1/2 E A L0 e_gl^2 are

        f_e = (EA/L0) e_gl d,
        K_e = (EA/L0^3) d d^T + (EA/L0) e_gl [[I, -I], [-I, I]].

    x0: (nelm, 2, dim) rest coordinates of the nodes (i, j); u_e: (nelm,
    2 dim) displacements ordered [u_i..., u_j...]."""
    dim = x0.shape[-1]
    dx0 = x0[:, 1, :] - x0[:, 0, :]
    u2 = u_e.reshape(u_e.shape[0], 2, dim)
    delta = u2[:, 1, :] - u2[:, 0, :]
    dx = dx0 + delta
    inv_l0_sq = inv_len * inv_len
    e_gl = (torch.sum(dx0 * delta, dim=-1)
            + 0.5 * torch.sum(delta * delta, dim=-1)) * inv_l0_sq
    d = torch.cat([-dx, dx], dim=1)
    ea_invl = young * area * inv_len
    ke_mat = (ea_invl * inv_len * inv_len)[:, None, None] * (
        d[:, :, None] * d[:, None, :])
    eye = torch.eye(dim, dtype=u_e.dtype, device=u_e.device)
    b_geo = torch.cat([torch.cat([eye, -eye], 1), torch.cat([-eye, eye], 1)])
    ke_geo = (ea_invl * e_gl)[:, None, None] * b_geo[None, :, :]
    fe = (ea_invl * e_gl)[:, None] * d
    return ElementBatch(ke=ke_mat + ke_geo, fe_int=fe, strain=e_gl)


def _single(out: ElementBatch) -> ElementBatch:
    return ElementBatch(ke=out.ke[0], fe_int=out.fe_int[0],
                        strain=out.strain[0])


def _vec(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=default_dtype()).reshape(-1)


def truss1d_linear_element(x_i0, x_j0, u_i, u_j, young,
                           area) -> ElementBatch:
    l0 = abs(float(x_j0) - float(x_i0))
    return _single(truss_linear_batch(
        _vec([-1.0, 1.0])[None, :], _vec([1.0 / l0]),
        _vec([u_i, u_j])[None, :], _vec([young]), _vec([area])))


def truss2d_linear_element(x_i0, x_j0, u_i, u_j, young,
                           area) -> ElementBatch:
    dx0 = _vec(x_j0) - _vec(x_i0)
    l0 = torch.linalg.vector_norm(dx0)
    c = dx0 / l0
    return _single(truss_linear_batch(
        torch.cat([-c, c])[None, :], (1.0 / l0).reshape(1),
        torch.cat([_vec(u_i), _vec(u_j)])[None, :], _vec([young]),
        _vec([area])))


def truss2d_element_state(x_i0, x_j0, u_i, u_j, young,
                          area) -> ElementBatch:
    x0 = torch.stack([_vec(x_i0), _vec(x_j0)])[None, :, :]
    l0 = torch.linalg.vector_norm(x0[0, 1] - x0[0, 0])
    return _single(truss2d_green_lagrange_batch(
        x0, torch.cat([_vec(u_i), _vec(u_j)])[None, :],
        (1.0 / l0).reshape(1), _vec([young]), _vec([area])))
