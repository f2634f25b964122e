"""Von Mises (J2) elastoplasticity for the plane continuum family: radial
return and consistent tangent, batched over Gauss points (counterpart of
pinn_fem_tpu/ops/plane_plastic.py).

Combined linear isotropic + kinematic hardening (Simo & Hughes,
"Computational Inelasticity", Box 3.2):

    yield      f = ||dev(sigma) - beta|| - sqrt(2/3) (sigma_y + H_iso alpha)
    flow       deps_p = dgamma n,  n = xi/||xi||,  xi = dev(sigma) - beta
    hardening  dalpha = sqrt(2/3) dgamma,  dbeta = (2/3) H_kin dgamma n

with the backward-Euler return dgamma = <f_trial> / (2 mu + (2/3)(H_iso +
H_kin)) from the committed state, and the algorithmic tangent

    C_ep = kappa 1x1 + 2 mu theta I_dev - 2 mu theta_bar n x n.

Both 2D constraints use one map over the 4-component engineering Voigt
state (xx, yy, zz, xy): plane strain reads rows / columns (xx, yy, xy) at
eps_zz = 0; plane stress drives sigma_zz to 0 by a fixed 8-step scalar
Newton on eps_zz, then condenses the 4 x 4 tangent on zz.  B-bar (mean
dilatation, plane-strain Q4) feeds the map its modified 4-component
strain directly.

The JAX functions take an array namespace `xp` (numpy on its float64 host
tier, jax.numpy on its device tier); these take tensors and compute in
their dtype on their device, every scalar a Python float (no promotion of
a float32 tier).  The guard on ||xi|| is 1e-300 in float64 and 1e-30
below it, the JAX tiers' values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

_SQ23 = float(np.sqrt(2.0 / 3.0))
_R = [0, 1, 3]      # in-plane rows of the 4-Voigt


class PlanePlasticState(NamedTuple):
    """Committed internal variables per Gauss point.

    eps_p: (m, ngp, 4) plastic strain, engineering Voigt (xx, yy, zz,
        gamma_xy).
    alpha: (m, ngp) accumulated equivalent plastic strain (>= 0).
    back:  (m, ngp, 4) back stress (stress-like Voigt, xy once).
    """

    eps_p: torch.Tensor
    alpha: torch.Tensor
    back: torch.Tensor


def initial_plane_state(nelm: int, ngp: int, dtype=torch.float64,
                        device=None) -> PlanePlasticState:
    """Virgin material on `device` (CPU when None)."""
    kw = dict(dtype=dtype, device=device)
    return PlanePlasticState(eps_p=torch.zeros((nelm, ngp, 4), **kw),
                             alpha=torch.zeros((nelm, ngp), **kw),
                             back=torch.zeros((nelm, ngp, 4), **kw))


def lame(young, poisson):
    """(mu, lam, kappa) from (E, nu)."""
    mu = young / (2.0 * (1.0 + poisson))
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    kappa = lam + 2.0 * mu / 3.0
    return mu, lam, kappa


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """The constant vector or matrix `values` in like's dtype on its
    device, made once per (values, dtype, device) and kept: the explicit
    integrators call the maps thousands of times."""
    key = tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                for v in values)
    return _const_tensor(key, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _const_tensor(values, dtype, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=dtype, device=device)


def _tiny(like: torch.Tensor) -> float:
    return 1e-300 if like.dtype == torch.float64 else 1e-30


def _dev4(sig: torch.Tensor) -> torch.Tensor:
    """Deviator of a stress-like Voigt 4-vector (xx, yy, zz, xy)."""
    tr3 = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    return sig - tr3[..., None] * _const([1.0, 1.0, 1.0, 0.0], sig)


def _norm4(s: torch.Tensor) -> torch.Tensor:
    """Tensor norm of a deviatoric Voigt 4-vector (xy counts twice)."""
    return torch.sqrt(s[..., 0] ** 2 + s[..., 1] ** 2 + s[..., 2] ** 2
                      + 2.0 * s[..., 3] ** 2)


def _idev(like: torch.Tensor) -> torch.Tensor:
    return _const([[2.0 / 3.0, -1.0 / 3.0, -1.0 / 3.0, 0.0],
                   [-1.0 / 3.0, 2.0 / 3.0, -1.0 / 3.0, 0.0],
                   [-1.0 / 3.0, -1.0 / 3.0, 2.0 / 3.0, 0.0],
                   [0.0, 0.0, 0.0, 0.5]], like)


def _return(eps4, state_ep, state_al, state_bk, mu, lam, sigma_y, h_iso,
            h_kin, with_state: bool = True):
    """The radial return shared by the full and force-only maps: (sigma,
    ep_new, al_new, bk_new, n, theta, theta_bar); with_state=False leaves
    the new state out (None), the other values unchanged."""
    dv = _const([1.0, 1.0, 1.0, 0.0], eps4)
    half = _const([1.0, 1.0, 1.0, 0.5], eps4)
    e = eps4 - state_ep
    tr_e = e[..., 0] + e[..., 1] + e[..., 2]
    # sigma_xy = mu gamma_e: the engineering half factor.
    sig_tr = lam[..., None] * tr_e[..., None] * dv \
        + 2.0 * mu[..., None] * (half * e)
    xi = _dev4(sig_tr) - state_bk
    nxi = _norm4(xi)
    f_tr = nxi - _SQ23 * (sigma_y + h_iso * state_al)
    plastic = f_tr > 0.0
    denom = 2.0 * mu + (2.0 / 3.0) * (h_iso + h_kin)
    dgamma = torch.where(plastic, f_tr, 0.0) / denom
    tiny = _tiny(eps4)
    n = xi / torch.clamp_min(nxi, tiny)[..., None]
    sigma = sig_tr - (2.0 * mu * dgamma)[..., None] * n
    ep_new = al_new = bk_new = None
    if with_state:
        ep_new = state_ep + dgamma[..., None] * n \
            * _const([1.0, 1.0, 1.0, 2.0], eps4)   # engineering shear flow
        al_new = state_al + _SQ23 * dgamma
        bk_new = state_bk + ((2.0 / 3.0) * h_kin * dgamma)[..., None] * n
    theta = torch.where(plastic,
                        1.0 - 2.0 * mu * dgamma / torch.clamp_min(nxi, tiny),
                        1.0)
    theta_bar = torch.where(
        plastic, 1.0 / (1.0 + (h_iso + h_kin) / (3.0 * mu)) - (1.0 - theta),
        0.0)
    return sigma, ep_new, al_new, bk_new, n, theta, theta_bar


def vm_return_map_4(eps4, state_ep, state_al, state_bk, mu, lam, sigma_y,
                    h_iso, h_kin):
    """J2 radial return on the 4-component engineering Voigt state.

    eps4: (..., 4) total strain (eps_xx, eps_yy, eps_zz, gamma_xy); the
    state and the parameters broadcast against it.  Returns (sigma4, c_ep,
    ep_new, al_new, bk_new): the return-mapped stress, the consistent
    tangent (..., 4, 4) on engineering strain, and the would-be-committed
    state."""
    sigma, ep_new, al_new, bk_new, n, theta, theta_bar = _return(
        eps4, state_ep, state_al, state_bk, mu, lam, sigma_y, h_iso, h_kin)
    dv = _const([1.0, 1.0, 1.0, 0.0], eps4)
    jmat = dv[:, None] * dv[None, :]
    kappa = lam + 2.0 * mu / 3.0
    c_ep = (kappa[..., None, None] * jmat
            + (2.0 * mu * theta)[..., None, None] * _idev(eps4)
            - (2.0 * mu * theta_bar)[..., None, None]
            * n[..., :, None] * n[..., None, :])
    return sigma, c_ep, ep_new, al_new, bk_new


def vm_return_map_4_force(eps4, state_ep, state_al, state_bk, mu, lam,
                          sigma_y, h_iso, h_kin, with_state: bool = True):
    """vm_return_map_4 without the 4 x 4 tangent: the same stress and
    state, and only the tangent's zz diagonal czz = kappa + (4/3) mu theta
    - 2 mu theta_bar n_z^2 (the plane-stress Newton's divisor);
    with_state=False: the state None (the Newton's steps before the
    last)."""
    sigma, ep_new, al_new, bk_new, n, theta, theta_bar = _return(
        eps4, state_ep, state_al, state_bk, mu, lam, sigma_y, h_iso, h_kin,
        with_state)
    kappa = lam + 2.0 * mu / 3.0
    czz = kappa + (4.0 / 3.0) * mu * theta \
        - 2.0 * mu * theta_bar * n[..., 2] ** 2
    return sigma, czz, ep_new, al_new, bk_new


def _plane_stress_start(eps3, state, mu_b, lam_b):
    """The elastic predictor of eps_zz (sigma_zz = 0 for the elastic trial
    about the committed plastic strain)."""
    exx = eps3[..., 0] - state.eps_p[..., 0]
    eyy = eps3[..., 1] - state.eps_p[..., 1]
    return state.eps_p[..., 2] - lam_b * (exx + eyy) / (lam_b + 2.0 * mu_b)


def _stack4(eps3, ezz):
    return torch.stack([eps3[..., 0], eps3[..., 1], ezz, eps3[..., 2]],
                       dim=-1)


def plane_return_map(eps3, state: PlanePlasticState, young, poisson,
                     sigma_y, h_iso, h_kin, plane_strain: bool,
                     n_ps_iter: int = 8):
    """The 2D-constrained return map: (m, ngp, 3) in-plane engineering
    strain -> (in-plane stress (m, ngp, 3), 3 x 3 consistent tangent,
    sigma_zz, new state).  Plane strain: eps_zz = 0, rows / columns (xx,
    yy, xy) of the 4 x 4 tangent.  Plane stress: n_ps_iter Newton steps on
    eps_zz drive sigma_zz to 0, then D = C_rr - C_rz C_zr / C_zz."""
    mu, lam, _ = lame(young, poisson)
    mu_b, lam_b = mu[..., None], lam[..., None]
    args = (state.eps_p, state.alpha, state.back, mu_b, lam_b,
            sigma_y[..., None], h_iso[..., None], h_kin[..., None])
    if plane_strain:
        sigma4, c4, ep, al, bk = vm_return_map_4(
            _stack4(eps3, torch.zeros_like(eps3[..., 0])), *args)
    else:
        ezz = _plane_stress_start(eps3, state, mu_b, lam_b)
        for _ in range(int(n_ps_iter)):
            sigma4, c4, ep, al, bk = vm_return_map_4(_stack4(eps3, ezz),
                                                     *args)
            ezz = ezz - sigma4[..., 2] / c4[..., 2, 2]
        sigma4, c4, ep, al, bk = vm_return_map_4(_stack4(eps3, ezz), *args)
    d3 = c4[..., _R, :][..., _R]
    if not plane_strain:
        d3 = d3 - (c4[..., _R, 2][..., :, None]
                   * c4[..., 2, _R][..., None, :]) \
            / c4[..., 2, 2][..., None, None]
    return sigma4[..., _R], d3, sigma4[..., 2], PlanePlasticState(
        eps_p=ep, alpha=al, back=bk)


def plane_return_map_force(eps3, state: PlanePlasticState, young, poisson,
                           sigma_y, h_iso, h_kin, plane_strain: bool,
                           n_ps_iter: int = 8):
    """plane_return_map without the 3 x 3 tangent: the same stress and
    state (the same eps_zz Newton with the same iteration count)."""
    mu, lam, _ = lame(young, poisson)
    mu_b, lam_b = mu[..., None], lam[..., None]
    args = (state.eps_p, state.alpha, state.back, mu_b, lam_b,
            sigma_y[..., None], h_iso[..., None], h_kin[..., None])
    if plane_strain:
        sigma4, _, ep, al, bk = vm_return_map_4_force(
            _stack4(eps3, torch.zeros_like(eps3[..., 0])), *args)
    else:
        ezz = _plane_stress_start(eps3, state, mu_b, lam_b)
        for _ in range(int(n_ps_iter)):
            sigma4, czz, _, _, _ = vm_return_map_4_force(
                _stack4(eps3, ezz), *args, with_state=False)
            ezz = ezz - sigma4[..., 2] / czz
        sigma4, _, ep, al, bk = vm_return_map_4_force(_stack4(eps3, ezz),
                                                      *args)
    return sigma4[..., _R], sigma4[..., 2], PlanePlasticState(
        eps_p=ep, alpha=al, back=bk)


# --------------------------------------------------------------------
# Element level: Gauss-point geometry, force and stiffness blocks


def _coords(problem, device) -> torch.Tensor:
    coords = problem.coords() if hasattr(problem, "coords") else problem
    if isinstance(coords, torch.Tensor):
        return coords.to(device=device or coords.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(coords, dtype=np.float64),
                           device=device)


def _gauss_stack(coords: torch.Tensor):
    from ..models.plane import _GP, _q4_point

    bs, ds = zip(*(_q4_point(coords, xi, eta) for xi, eta in _GP))
    return torch.stack(bs, dim=1), torch.stack(ds, dim=1)


def gp_geometry(problem, device=None):
    """(b, wdet): the B stack (m, ngp, 3, 2nen) and weighted Jacobians (m,
    ngp), float64 on `device` (CPU when None; a tensor of coordinates:
    its device) — CST one point weighted by its area, Q4 the 2 x 2 rule.
    `problem` is a PlaneProblem or its (m, nen, 2) coordinates."""
    from ..models.plane import _cst_b

    coords = _coords(problem, device)
    if coords.shape[1] == 3:
        b, area = _cst_b(coords)
        return b[:, None], area[:, None]
    return _gauss_stack(coords)


def gp_geometry_bbar(problem, device=None):
    """Mean-dilatation B-bar geometry of plane-strain Q4: the 4-component
    strain operator (m, ngp, 4, 8) and the weighted Jacobians, float64 on
    `device` (as gp_geometry):

        b4[0] = B[0] + d,  b4[1] = B[1] + d,  b4[2] = d,  b4[3] = B[2],
        d = (vbar - v)/3,  v = B[0] + B[1],
        vbar = sum_g |J_g| v(g) / sum_g |J_g|.
    """
    coords = _coords(problem, device)
    if coords.shape[1] != 4:
        raise ValueError("B-bar needs Q4 elements (CST has a single "
                         "strain point; use a quad mesh for "
                         "incompressible plane-strain plasticity)")
    b, wdet = _gauss_stack(coords)            # (m, 4, 3, 8), (m, 4)
    v = b[:, :, 0] + b[:, :, 1]               # (m, 4, 8) div rows
    vbar = (torch.sum(wdet[..., None] * v, dim=1)
            / torch.sum(wdet, dim=1)[..., None])
    d = (vbar[:, None] - v) / 3.0
    b4 = torch.stack([b[:, :, 0] + d, b[:, :, 1] + d, d, b[:, :, 2]], dim=2)
    return b4, wdet


def plane_plastic_blocks(b, wdet, thickness, u_e, state: PlanePlasticState,
                         young, poisson, sigma_y, h_iso, h_kin,
                         plane_strain: bool, tangent_floor: float = 1e-8):
    """One Newton iteration's element quantities, batched: (ke (m, 2nen,
    2nen), fe (m, 2nen), sig3 (m, ngp, 3), szz (m, ngp), new state).  The
    tangent blends in tangent_floor of the elastic operator (a perfectly
    plastic mechanism never hands Newton an exactly singular K); the
    residual uses the exact return-mapped stress."""
    from ..models.plane import _dmat

    eps3 = torch.einsum("mgia,ma->mgi", b, u_e)
    sig3, d3, szz, new_state = plane_return_map(
        eps3, state, young, poisson, sigma_y, h_iso, h_kin, plane_strain)
    d3 = d3 + tangent_floor * _dmat(young, poisson, plane_strain)[:, None]
    w = thickness[:, None] * wdet
    fe = torch.einsum("mgia,mgi,mg->ma", b, sig3, w)
    ke = torch.einsum("mgia,mgij,mgjb,mg->mab", b, d3, b, w)
    return ke, fe, sig3, szz, new_state


def plane_plastic_force(b, wdet, thickness, u_e, state: PlanePlasticState,
                        young, poisson, sigma_y, h_iso, h_kin,
                        plane_strain: bool):
    """Force-only plane_plastic_blocks: (fe, sig3, szz, new state)."""
    eps3 = torch.einsum("mgia,ma->mgi", b, u_e)
    sig3, szz, new_state = plane_return_map_force(
        eps3, state, young, poisson, sigma_y, h_iso, h_kin, plane_strain)
    fe = torch.einsum("mgia,mgi,mg->ma", b, sig3, thickness[:, None] * wdet)
    return fe, sig3, szz, new_state


def _bbar_map(map_fn, b4, u_e, state, young, poisson, sigma_y, h_iso,
              h_kin):
    mu, lam, _ = lame(young, poisson)
    eps4 = torch.einsum("mgia,ma->mgi", b4, u_e)
    return map_fn(eps4, state.eps_p, state.alpha, state.back,
                  mu[:, None], lam[:, None], sigma_y[:, None],
                  h_iso[:, None], h_kin[:, None])


def plane_plastic_force_bbar(b4, wdet, thickness, u_e,
                             state: PlanePlasticState, young, poisson,
                             sigma_y, h_iso, h_kin):
    """Force-only B-bar variant (plane strain Q4): (fe, sig3, szz, new
    state)."""
    sigma4, _, ep, al, bk = _bbar_map(vm_return_map_4_force, b4, u_e, state,
                                      young, poisson, sigma_y, h_iso, h_kin)
    fe = torch.einsum("mgia,mgi,mg->ma", b4, sigma4,
                      thickness[:, None] * wdet)
    return fe, sigma4[..., _R], sigma4[..., 2], PlanePlasticState(
        eps_p=ep, alpha=al, back=bk)


def plane_plastic_blocks_bbar(b4, wdet, thickness, u_e,
                              state: PlanePlasticState, young, poisson,
                              sigma_y, h_iso, h_kin, tangent_floor=1e-8):
    """B-bar plane_plastic_blocks (plane strain): the 4-component B-bar
    strain feeds the 4-Voigt map, force and stiffness contract the full
    4 x 4 tangent (with its elastic floor) with b4."""
    sigma4, c4, ep, al, bk = _bbar_map(vm_return_map_4, b4, u_e, state,
                                       young, poisson, sigma_y, h_iso, h_kin)
    mu, lam, _ = lame(young, poisson)
    dv = _const([1.0, 1.0, 1.0, 0.0], b4)
    kap = (lam + 2.0 * mu / 3.0)[:, None, None, None]
    ce = kap * (dv[:, None] * dv[None, :]) \
        + (2.0 * mu)[:, None, None, None] * _idev(b4)
    c4 = c4 + tangent_floor * ce
    w = thickness[:, None] * wdet
    fe = torch.einsum("mgia,mgi,mg->ma", b4, sigma4, w)
    ke = torch.einsum("mgia,mgij,mgjb,mg->mab", b4, c4, b4, w)
    return ke, fe, sigma4[..., _R], sigma4[..., 2], PlanePlasticState(
        eps_p=ep, alpha=al, back=bk)


def von_mises_4(sig3, szz):
    """Von Mises stress from the in-plane Voigt stress and sigma_zz."""
    sxx, syy, sxy = sig3[..., 0], sig3[..., 1], sig3[..., 2]
    return torch.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                             + (szz - sxx) ** 2) + 3.0 * sxy ** 2)
