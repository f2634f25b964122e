"""Layered through-thickness J2 elastoplasticity for the flat-facet shell
family (counterpart of pinn_fem_tpu/ops/shell_plastic.py): the plane-stress
radial return of ops/plane_plastic.py stacked over thickness layers at the
facet Gauss points, with membrane and bending kinematics

    eps(z) = eps_m + z kappa

(the plate family carries eps(z) = z kappa only), so yield couples the
stress resultants N and M (the rectangular-section interaction m + n^2 =
1).  Resultants and the consistent tangent are midpoint sums with weights
w = t / N:

    N = sum w sigma_l        D_mm = sum w C_l
    M = sum w z_l sigma_l    D_mb = sum w z_l C_l     (the coupling)
                             D_bb = sum w z_l^2 C_l

D_mb vanishes while every layer is elastic (symmetric z sums).  The
transverse shear and the drilling stabilization stay elastic.  The layer
states ride PlanePlasticState with the Gauss axis merged over (Gauss
point, layer): (m, 4 N, ...).  The JAX functions take an array namespace
`xp`; these take tensors and compute in their dtype on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from .plane_plastic import (PlanePlasticState, initial_plane_state,
                            plane_return_map, plane_return_map_force,
                            von_mises_4)
from .plate_plastic import layer_centers

__all__ = ["initial_shell_state", "shell_gp_geometry",
           "shell_plastic_blocks", "shell_plastic_force"]

# Local DOF groups in the 24-wide (u, v, w, theta_x, theta_y, theta_z)-per-
# node ordering.
_MEM = np.array([6 * a + d for a in range(4) for d in (0, 1)])
_BND = np.array([6 * a + d for a in range(4) for d in (2, 3, 4)])
_DRL = np.array([6 * a + 5 for a in range(4)])


def initial_shell_state(nelm: int, n_layers: int, dtype=torch.float64,
                        device=None) -> PlanePlasticState:
    """Committed layer states, Gauss axis merged: (m, 4 N, ...)."""
    return initial_plane_state(nelm, 4 * int(n_layers), dtype, device)


def shell_gp_geometry(problem, device=None):
    """The hoisted facet geometry, float64 on `device` (CPU when None):
    t24 (m, 24, 24) local <- global transformation blocks, bm (m, 4, 3, 8)
    membrane and bb (m, 4, 3, 12) curvature stacks at the 2 x 2 Gauss
    points (bb in the (w, theta_x, theta_y) basis), det (m, 4) their
    Jacobians, ks_e (m, 12, 12) the elastic MITC4 assumed-shear blocks and
    kd_e (m, 4, 4) the elastic drilling blocks (dense-tier eps)."""
    from ..models.plate import (_bend_b, _dmats, _mitc_rows, _shape_grads,
                                _shear_b_mitc)
    from ..models.shell import (_DRILL_ALPHA, _DRILL_EPS, _GP, _facets,
                                _material, _q4_point, _q_beta,
                                _transformation)

    r, c2, area = _facets(problem, device)
    young, poisson, thickness = _material(problem, device, "young",
                                          "poisson", "thickness")
    q = _q_beta(c2)
    _, ds = _dmats(young, poisson, thickness)
    rows = _mitc_rows(c2)
    bms, bbs, dets, ks = [], [], [], None
    for xi, eta in _GP:
        bmem, det = _q4_point(c2, xi, eta)
        bms.append(bmem)
        dets.append(det)
        _, dx, dy, _ = _shape_grads(c2, xi, eta)
        # kappa = B_beta u_beta with u_beta = Q u_theta: B_theta = B_beta Q.
        bbs.append(_bend_b(dx, dy) @ q)
        bs, dets_s = _shear_b_mitc(c2, rows, xi, eta)
        kg = (ds * dets_s)[:, None, None] * torch.einsum("mia,mib->mab",
                                                         bs, bs)
        ks = kg if ks is None else ks + kg
    ks = q.T @ ks @ q
    kd = _DRILL_ALPHA * young / (2.0 * (1.0 + poisson)) * thickness * area
    pen = torch.as_tensor((np.eye(4) - 0.25) + _DRILL_EPS * np.eye(4),
                          dtype=c2.dtype, device=c2.device)
    return (_transformation(r), torch.stack(bms, dim=1),
            torch.stack(bbs, dim=1), torch.stack(dets, dim=1), ks,
            kd[:, None, None] * pen[None])


def _layer_strains(t24, bm, bb, thickness, u_e, n_layers: int):
    """(u_loc (m, 24), z (m, N), w (m,), eps (m, 4 N, 3))."""
    m, ngp = bm.shape[0], bm.shape[1]
    u_loc = torch.einsum("mij,mj->mi", t24, u_e)
    eps_m = torch.einsum("mgia,ma->mgi", bm, u_loc[:, _MEM])
    kap = torch.einsum("mgia,ma->mgi", bb, u_loc[:, _BND])
    z, w = layer_centers(thickness, n_layers)
    eps = eps_m[:, :, None, :] + z[:, None, :, None] * kap[:, :, None, :]
    return u_loc, z, w, eps.reshape(m, ngp * n_layers, 3)


def _forces(t24, bm, bb, det, ks_e, kd_e, u_loc, nres, mom):
    """(global element force (m, 24), local membrane, bending, drilling
    parts) of the layer resultants at the Gauss points."""
    fm = torch.einsum("mgia,mgi,mg->ma", bm, nres, det)
    fb = torch.einsum("mgia,mgi,mg->ma", bb, mom, det) \
        + torch.einsum("mab,mb->ma", ks_e, u_loc[:, _BND])
    fd = torch.einsum("mab,mb->ma", kd_e, u_loc[:, _DRL])
    fl = torch.zeros((t24.shape[0], 24), dtype=fm.dtype, device=fm.device)
    fl[:, _MEM] = fm
    fl[:, _BND] = fb
    fl[:, _DRL] = fd
    return torch.einsum("mji,mj->mi", t24, fl)


def shell_plastic_blocks(t24, bm, bb, det, ks_e, kd_e, thickness, u_e,
                         state: PlanePlasticState, young, poisson, sigma_y,
                         h_iso, h_kin, n_layers: int,
                         tangent_floor: float = 1e-8):
    """One Newton iteration's global element quantities, batched over
    (facet, Gauss point, layer): (ke (m, 24, 24), fe (m, 24), the
    Gauss-averaged local membrane forces (m, 3) and moments (m, 3), the
    extreme-fiber von Mises (m,) = the maximum over layers and Gauss
    points, the would-be-committed state).  D_mm and D_bb blend in
    tangent_floor of the exact elastic rigidities (the coupling D_mb takes
    none); the residual uses the return-mapped resultants."""
    from ..models.plane import _dmat as _plane_dmat
    from ..models.plate import _dmats

    m, ngp = bm.shape[0], bm.shape[1]
    nl = int(n_layers)
    u_loc, z, w, eps3 = _layer_strains(t24, bm, bb, thickness, u_e, nl)
    sig3, d3, szz, new_state = plane_return_map(
        eps3, state, young, poisson, sigma_y, h_iso, h_kin,
        plane_strain=False)
    sig_l = sig3.reshape(m, ngp, nl, 3)
    d_l = d3.reshape(m, ngp, nl, 3, 3)
    wz = w[:, None] * z
    nres = torch.sum(w[:, None, None, None] * sig_l, dim=2)
    mom = torch.sum(wz[:, None, :, None] * sig_l, dim=2)
    dmm = torch.sum(w[:, None, None, None, None] * d_l, dim=2)
    dmb = torch.sum(wz[:, None, :, None, None] * d_l, dim=2)
    dbb = torch.sum((wz * z)[:, None, :, None, None] * d_l, dim=2)
    dm_e = _plane_dmat(young, poisson, False) * thickness[:, None, None]
    db_e, _ = _dmats(young, poisson, thickness)
    dmm = dmm + tangent_floor * dm_e[:, None]
    dbb = dbb + tangent_floor * db_e[:, None]
    fe = _forces(t24, bm, bb, det, ks_e, kd_e, u_loc, nres, mom)

    def block(ba, d, bb_):
        return torch.einsum("mgia,mgij,mgjb,mg->mab", ba, d, bb_, det)

    kmb = block(bm, dmb, bb)
    kl = torch.zeros((m, 24, 24), dtype=fe.dtype, device=fe.device)
    mem, bnd, drl = (torch.as_tensor(i, device=fe.device)
                     for i in (_MEM, _BND, _DRL))
    kl[:, mem[:, None], mem[None, :]] = block(bm, dmm, bm)
    kl[:, mem[:, None], bnd[None, :]] = kmb
    kl[:, bnd[:, None], mem[None, :]] = kmb.transpose(1, 2)
    kl[:, bnd[:, None], bnd[None, :]] = block(bb, dbb, bb) + ks_e
    kl[:, drl[:, None], drl[None, :]] = kd_e
    ke = torch.einsum("mji,mjk,mkl->mil", t24, kl, t24)
    vm_fiber = torch.amax(von_mises_4(sig3, szz), dim=1)
    return ke, fe, nres.mean(dim=1), mom.mean(dim=1), vm_fiber, new_state


def shell_plastic_force(t24, bm, bb, det, ks_e, kd_e, thickness, u_e,
                        state: PlanePlasticState, young, poisson, sigma_y,
                        h_iso, h_kin, n_layers: int):
    """Force-only shell_plastic_blocks, the same resultants and state: (fe,
    membrane forces, moments, extreme-fiber von Mises, new state)."""
    m, ngp = bm.shape[0], bm.shape[1]
    nl = int(n_layers)
    u_loc, z, w, eps3 = _layer_strains(t24, bm, bb, thickness, u_e, nl)
    sig3, szz, new_state = plane_return_map_force(
        eps3, state, young, poisson, sigma_y, h_iso, h_kin,
        plane_strain=False)
    sig_l = sig3.reshape(m, ngp, nl, 3)
    nres = torch.sum(w[:, None, None, None] * sig_l, dim=2)
    mom = torch.sum((w[:, None] * z)[:, None, :, None] * sig_l, dim=2)
    fe = _forces(t24, bm, bb, det, ks_e, kd_e, u_loc, nres, mom)
    vm_fiber = torch.amax(von_mises_4(sig3, szz), dim=1)
    return fe, nres.mean(dim=1), mom.mean(dim=1), vm_fiber, new_state
