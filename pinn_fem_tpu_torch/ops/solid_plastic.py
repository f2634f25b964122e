"""Von Mises (J2) elastoplasticity for the 3D solid family: radial return
and consistent tangent on the full 6-component engineering Voigt state,
batched over hex8 Gauss points (counterpart of
pinn_fem_tpu/ops/solid_plastic.py).

The unconstrained 3D case of ops/plane_plastic.py, with combined linear
isotropic + kinematic hardening (Simo & Hughes, Box 3.2):

    f = ||dev(sigma) - beta|| - sqrt(2/3)(sigma_y + H_iso alpha)
    dgamma = <f_trial> / (2 mu + (2/3)(H_iso + H_kin))
    C_ep = kappa 1x1 + 2 mu theta I_dev - 2 mu theta_bar n x n

Voigt order [xx, yy, zz, yz, xz, xy], engineering shear strains.  B-bar
(`gp_geometry3_bbar`, mean dilatation) replaces the divergence part of B
by its element volume average on the three normal rows; fully integrated
hex8 locks in incompressible J2 flow without it.

The JAX functions take an array namespace `xp` (numpy on its float64 host
tier, jax.numpy on its device tier); these take tensors and compute in
their dtype on their device, every scalar a Python float.  The guard on
||xi|| is 1e-300 in float64 and 1e-30 below it, the JAX tiers' values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plane_plastic import _const, _tiny, lame

_SQ23 = float(np.sqrt(2.0 / 3.0))
_DV = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]


class SolidPlasticState(NamedTuple):
    """Committed internal variables per Gauss point.

    eps_p: (m, 8, 6) plastic strain, engineering Voigt.
    alpha: (m, 8) accumulated equivalent plastic strain.
    back:  (m, 8, 6) back stress (stress-like Voigt).
    """

    eps_p: torch.Tensor
    alpha: torch.Tensor
    back: torch.Tensor


def initial_solid_state(nelm: int, dtype=torch.float64,
                        device=None) -> SolidPlasticState:
    """Virgin material on `device` (CPU when None)."""
    kw = dict(dtype=dtype, device=device)
    return SolidPlasticState(eps_p=torch.zeros((nelm, 8, 6), **kw),
                             alpha=torch.zeros((nelm, 8), **kw),
                             back=torch.zeros((nelm, 8, 6), **kw))


def _dev6(sig: torch.Tensor) -> torch.Tensor:
    tr3 = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    return sig - tr3[..., None] * _const(_DV, sig)


def _norm6(s: torch.Tensor) -> torch.Tensor:
    """Tensor norm of a deviatoric Voigt 6-vector: each shear component
    stands for two symmetric tensor entries."""
    return torch.sqrt(s[..., 0] ** 2 + s[..., 1] ** 2 + s[..., 2] ** 2
                      + 2.0 * (s[..., 3] ** 2 + s[..., 4] ** 2
                               + s[..., 5] ** 2))


def _return(eps6, state_ep, state_al, state_bk, mu, lam, sigma_y, h_iso,
            h_kin):
    """The radial return shared by the full and force-only maps: (sigma,
    ep_new, al_new, bk_new, n, dgamma, plastic, nxi)."""
    dv = _const(_DV, eps6)
    half = _const([1.0, 1.0, 1.0, 0.5, 0.5, 0.5], eps6)
    e = eps6 - state_ep
    tr_e = e[..., 0] + e[..., 1] + e[..., 2]
    sig_tr = lam[..., None] * tr_e[..., None] * dv \
        + 2.0 * mu[..., None] * (half * e)
    xi = _dev6(sig_tr) - state_bk
    nxi = _norm6(xi)
    f_tr = nxi - _SQ23 * (sigma_y + h_iso * state_al)
    plastic = f_tr > 0.0
    denom = 2.0 * mu + (2.0 / 3.0) * (h_iso + h_kin)
    dgamma = torch.where(plastic, f_tr, 0.0) / denom
    n = xi / torch.clamp_min(nxi, _tiny(eps6))[..., None]
    sigma = sig_tr - (2.0 * mu * dgamma)[..., None] * n
    ep_new = state_ep + dgamma[..., None] * n \
        * _const([1.0, 1.0, 1.0, 2.0, 2.0, 2.0], eps6)
    al_new = state_al + _SQ23 * dgamma
    bk_new = state_bk + ((2.0 / 3.0) * h_kin * dgamma)[..., None] * n
    return sigma, ep_new, al_new, bk_new, n, dgamma, plastic, nxi


def vm_return_map_6(eps6, state_ep, state_al, state_bk, mu, lam, sigma_y,
                    h_iso, h_kin):
    """J2 radial return on the 6-component engineering Voigt state.

    Returns (sigma6, c_ep (..., 6, 6), ep_new, al_new, bk_new); callers
    commit the state only at load-step convergence."""
    sigma, ep_new, al_new, bk_new, n, dgamma, plastic, nxi = _return(
        eps6, state_ep, state_al, state_bk, mu, lam, sigma_y, h_iso, h_kin)
    theta = torch.where(
        plastic, 1.0 - 2.0 * mu * dgamma / torch.clamp_min(nxi, _tiny(eps6)),
        1.0)
    theta_bar = torch.where(
        plastic, 1.0 / (1.0 + (h_iso + h_kin) / (3.0 * mu)) - (1.0 - theta),
        0.0)
    dv = _const(_DV, eps6)
    jmat = dv[:, None] * dv[None, :]
    third = 1.0 / 3.0
    idev = _const([[2 * third, -third, -third, 0.0, 0.0, 0.0],
                   [-third, 2 * third, -third, 0.0, 0.0, 0.0],
                   [-third, -third, 2 * third, 0.0, 0.0, 0.0],
                   [0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
                   [0.0, 0.0, 0.0, 0.0, 0.5, 0.0],
                   [0.0, 0.0, 0.0, 0.0, 0.0, 0.5]], eps6)
    kappa = lam + 2.0 * mu / 3.0
    c_ep = (kappa[..., None, None] * jmat
            + (2.0 * mu * theta)[..., None, None] * idev
            - (2.0 * mu * theta_bar)[..., None, None]
            * n[..., :, None] * n[..., None, :])
    return sigma, c_ep, ep_new, al_new, bk_new


def vm_return_map_6_force(eps6, state_ep, state_al, state_bk, mu, lam,
                          sigma_y, h_iso, h_kin):
    """vm_return_map_6 without the 6 x 6 tangent: the same stress and
    state, (sigma6, ep_new, al_new, bk_new) (the explicit integrators'
    map)."""
    sigma, ep_new, al_new, bk_new = _return(
        eps6, state_ep, state_al, state_bk, mu, lam, sigma_y, h_iso,
        h_kin)[:4]
    return sigma, ep_new, al_new, bk_new


def _material_args(state: SolidPlasticState, young, poisson, sigma_y,
                   h_iso, h_kin):
    mu, lam, _ = lame(young, poisson)
    return (state.eps_p, state.alpha, state.back, mu[..., None],
            lam[..., None], sigma_y[..., None], h_iso[..., None],
            h_kin[..., None])


def solid_return_map(eps6, state: SolidPlasticState, young, poisson,
                     sigma_y, h_iso, h_kin):
    """(m, 8, 6) strain -> (sigma6, 6 x 6 tangent, new state); per-element
    material broadcast over the Gauss axis."""
    sigma, c_ep, ep, al, bk = vm_return_map_6(
        eps6, *_material_args(state, young, poisson, sigma_y, h_iso, h_kin))
    return sigma, c_ep, SolidPlasticState(eps_p=ep, alpha=al, back=bk)


def _coords(problem, device) -> torch.Tensor:
    coords = problem.coords() if hasattr(problem, "coords") else problem
    if isinstance(coords, torch.Tensor):
        return coords.to(device=device or coords.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(coords, dtype=np.float64),
                           device=device)


def gp_geometry3(problem, device=None):
    """(b, wdet): the B stack (m, 8, 6, 24) and weighted Jacobians (m, 8)
    of the 2 x 2 x 2 rule (weights 1), float64 on `device` (CPU when None;
    a tensor of coordinates: its device).  `problem` is a SolidProblem or
    its (m, 8, 3) coordinates."""
    from ..models.solid import _GP3, _hex_point

    coords = _coords(problem, device)
    bs, ds = zip(*(_hex_point(coords, *p) for p in _GP3))
    return torch.stack(bs, dim=1), torch.stack(ds, dim=1)


def gp_geometry3_bbar(problem, device=None):
    """Mean-dilatation B-bar geometry: the divergence row of B at each Gauss
    point replaced by its element volume average on the three normal
    strain rows, B_bar = B + (1/3) m (div_mean - div) with m = [1, 1, 1, 0,
    0, 0]; float64 on `device`, as gp_geometry3."""
    b, wdet = gp_geometry3(problem, device)
    # Column a of B is nonzero in exactly one normal row, so their sum is
    # the divergence row.
    div = b[..., 0, :] + b[..., 1, :] + b[..., 2, :]   # (m, 8, 24)
    w = wdet[..., None]
    div_mean = (div * w).sum(dim=1, keepdim=True) \
        / w.sum(dim=1, keepdim=True)                   # (m, 1, 24)
    corr = (div_mean - div) / 3.0
    b_bar = b.clone()
    for row in range(3):
        b_bar[..., row, :] += corr
    return b_bar, wdet


def solid_plastic_blocks(b, wdet, u_e, state: SolidPlasticState, young,
                         poisson, sigma_y, h_iso, h_kin,
                         tangent_floor: float = 1e-8):
    """One Newton iteration's element quantities, batched: (ke (m, 24,
    24), fe (m, 24), sig6 (m, 8, 6), new state).  The tangent blends in
    tangent_floor of the elastic operator (a perfectly plastic mechanism
    never hands Newton an exactly singular K)."""
    from ..models.solid import _dmat3

    eps6 = torch.einsum("mgia,ma->mgi", b, u_e)
    sig6, d6, new_state = solid_return_map(eps6, state, young, poisson,
                                           sigma_y, h_iso, h_kin)
    d6 = d6 + tangent_floor * _dmat3(young, poisson)[:, None]
    fe = torch.einsum("mgia,mgi,mg->ma", b, sig6, wdet)
    ke = torch.einsum("mgia,mgij,mgjb,mg->mab", b, d6, b, wdet)
    return ke, fe, sig6, new_state


def solid_plastic_force(b, wdet, u_e, state: SolidPlasticState, young,
                        poisson, sigma_y, h_iso, h_kin):
    """Force-only solid_plastic_blocks for explicit integration: (fe (m,
    24), sig6 (m, 8, 6), new state)."""
    eps6 = torch.einsum("mgia,ma->mgi", b, u_e)
    sig6, ep, al, bk = vm_return_map_6_force(
        eps6, *_material_args(state, young, poisson, sigma_y, h_iso, h_kin))
    fe = torch.einsum("mgia,mgi,mg->ma", b, sig6, wdet)
    return fe, sig6, SolidPlasticState(eps_p=ep, alpha=al, back=bk)


def von_mises_6(sig6):
    """(.., 8, 6) Gauss-point stresses -> von Mises (same shape minus the
    Voigt axis)."""
    return float(np.sqrt(1.5)) * _norm6(_dev6(sig6))
