"""Layered through-thickness J2 elastoplasticity for the Mindlin plate
family (counterpart of pinn_fem_tpu/ops/plate_plastic.py): the plane-stress
radial return of ops/plane_plastic.py stacked over thickness layers at the
MITC4 bending Gauss points.

At each bending Gauss point the in-plane strain varies linearly through
the thickness, eps(z) = z kappa; each of N layers carries a plane-stress J2
state at its midpoint z_l = t((l + 1/2)/N - 1/2), evaluated by
`plane_return_map` (sigma_zz = 0 by its nested Newton and static
condensation).  The stress resultants and the consistent bending tangent
are midpoint sums, M = sum_l w_l z_l sigma_l, D_b = sum_l w_l z_l^2 C_l,
w_l = t/N.  The transverse shear stays elastic: the MITC4 assumed-shear
stiffness is hoisted once and added unchanged.  With even N the fully
plastic moment is exact (sigma_y t^2 / 4) and the elastic layered rigidity
is (1 - 1/N^2) D.

The layer states ride PlanePlasticState with the Gauss axis merged over
(gauss point, layer): (m, 4 N, ...).  The JAX functions take an array
namespace `xp`; these take tensors and compute in their dtype on their
device.
"""

from __future__ import annotations

import torch

from .plane_plastic import (PlanePlasticState, initial_plane_state,
                            plane_return_map, plane_return_map_force,
                            von_mises_4)

__all__ = [
    "PlanePlasticState", "initial_plane_state", "initial_plate_state",
    "plate_gp_geometry", "layer_centers", "plate_plastic_blocks",
    "plate_plastic_force",
]


def initial_plate_state(nelm: int, n_layers: int, dtype=torch.float64,
                        device=None) -> PlanePlasticState:
    """Committed layer states, Gauss axis merged: (m, 4 N, ...)."""
    return initial_plane_state(nelm, 4 * int(n_layers), dtype, device)


def plate_gp_geometry(problem, device=None):
    """The hoisted element geometry, float64 on `device` (CPU when None):
    bb (m, 4, 3, 12) curvature-displacement stacks at the 2 x 2 bending
    Gauss points (weights 1), det (m, 4) their Jacobians, ks_e (m, 12, 12)
    the elastic MITC4 assumed-shear stiffness blocks."""
    from ..models.plate import (_GP, _bend_b, _dmats, _elements, _material,
                                _mitc_rows, _shape_grads, _shear_b_mitc)

    coords, _ = _elements(problem, device)
    _, ds = _dmats(*_material(problem, device, "young", "poisson",
                              "thickness"))
    rows = _mitc_rows(coords)
    bbs, dets, ks = [], [], None
    for xi, eta in _GP:
        _, dx, dy, det = _shape_grads(coords, xi, eta)
        bbs.append(_bend_b(dx, dy))
        dets.append(det)
        bs, dets_s = _shear_b_mitc(coords, rows, xi, eta)
        kg = (ds * dets_s)[:, None, None] * torch.einsum("mia,mib->mab",
                                                         bs, bs)
        ks = kg if ks is None else ks + kg
    return torch.stack(bbs, dim=1), torch.stack(dets, dim=1), ks


def layer_centers(thickness: torch.Tensor, n_layers: int):
    """((m, N) midpoint layer centers z_l, (m,) layer weight t / N)."""
    u = (torch.arange(n_layers, dtype=thickness.dtype,
                      device=thickness.device) + 0.5) / n_layers - 0.5
    return thickness[:, None] * u[None, :], thickness / n_layers


def _layer_strains(bb, thickness, u_e, n_layers: int):
    """(kappa (m, 4, 3), z (m, N), w (m,), eps (m, 4 N, 3))."""
    m, ngp = bb.shape[0], bb.shape[1]
    kap = torch.einsum("mgia,ma->mgi", bb, u_e)
    z, w = layer_centers(thickness, n_layers)
    eps = z[:, None, :, None] * kap[:, :, None, :]          # (m, 4, N, 3)
    return kap, z, w, eps.reshape(m, ngp * n_layers, 3)


def plate_plastic_blocks(bb, det, ks_e, thickness, u_e,
                         state: PlanePlasticState, young, poisson, sigma_y,
                         h_iso, h_kin, n_layers: int,
                         tangent_floor: float = 1e-8):
    """One Newton iteration's element quantities, batched over (element,
    Gauss point, layer): (ke (m, 12, 12), fe (m, 12), the Gauss-point
    moments (m, 4, 3), the extreme-fiber von Mises (m,) = the maximum over
    layers and Gauss points, the would-be-committed state).  The bending
    tangent blends in tangent_floor of the exact elastic rigidity (a
    perfectly plastic mechanism never hands Newton a singular K); the
    residual uses the return-mapped resultants."""
    from ..models.plate import _dmats

    m, ngp = bb.shape[0], bb.shape[1]
    nl = int(n_layers)
    _, z, w, eps3 = _layer_strains(bb, thickness, u_e, nl)
    sig3, d3, szz, new_state = plane_return_map(
        eps3, state, young, poisson, sigma_y, h_iso, h_kin,
        plane_strain=False)
    sig_l = sig3.reshape(m, ngp, nl, 3)
    d_l = d3.reshape(m, ngp, nl, 3, 3)
    wz = w[:, None] * z                                     # (m, N)
    mom = torch.sum(wz[:, None, :, None] * sig_l, dim=2)    # (m, 4, 3)
    db_t = torch.sum((wz * z)[:, None, :, None, None] * d_l, dim=2)
    db_e, _ = _dmats(young, poisson, thickness)
    db_t = db_t + tangent_floor * db_e[:, None]
    fe = torch.einsum("mgia,mgi,mg->ma", bb, mom, det) \
        + torch.einsum("mab,mb->ma", ks_e, u_e)
    ke = torch.einsum("mgia,mgij,mgjb,mg->mab", bb, db_t, bb, det) + ks_e
    vm_fiber = torch.amax(von_mises_4(sig3, szz), dim=1)
    return ke, fe, mom, vm_fiber, new_state


def plate_plastic_force(bb, det, ks_e, thickness, u_e,
                        state: PlanePlasticState, young, poisson, sigma_y,
                        h_iso, h_kin, n_layers: int):
    """Force-only plate_plastic_blocks, the same resultants and state: (fe,
    moments, extreme-fiber von Mises, new state)."""
    m, ngp = bb.shape[0], bb.shape[1]
    nl = int(n_layers)
    _, z, w, eps3 = _layer_strains(bb, thickness, u_e, nl)
    sig3, szz, new_state = plane_return_map_force(
        eps3, state, young, poisson, sigma_y, h_iso, h_kin,
        plane_strain=False)
    wz = w[:, None] * z
    mom = torch.sum(wz[:, None, :, None] * sig3.reshape(m, ngp, nl, 3),
                    dim=2)
    fe = torch.einsum("mgia,mgi,mg->ma", bb, mom, det) \
        + torch.einsum("mab,mb->ma", ks_e, u_e)
    vm_fiber = torch.amax(von_mises_4(sig3, szz), dim=1)
    return fe, mom, vm_fiber, new_state
