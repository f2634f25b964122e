"""1D rate-independent elastoplasticity for truss elements: radial return
with combined linear isotropic and kinematic hardening (counterpart of
pinn_fem_tpu/ops/plastic.py).

The textbook 1D model (Simo & Hughes, "Computational Inelasticity",
§1.2-1.4, Box 1.4):

    yield      f(sigma, q, alpha) = |sigma - q| - (sigma_y + H_iso alpha)
    flow       deps_p = dgamma * sign(sigma - q)
    hardening  dalpha = dgamma,   dq = H_kin dgamma sign(sigma - q)

Backward-Euler return over a strain increment, the trial state taken from
the COMMITTED previous step:

    sigma_tr = E (eps - eps_p_n);  xi = sigma_tr - q_n
    f_tr     = |xi| - (sigma_y + H_iso alpha_n)
    dgamma   = max(f_tr, 0) / (E + H_iso + H_kin)
    sigma    = sigma_tr - E dgamma sign(xi)

The algorithmic (consistent) tangent is piecewise constant for linear
hardening: E where elastic or unloading, E (H_iso + H_kin) / (E + H_iso +
H_kin) on plastic loading.  Everything is elementwise over the element
batch (torch.where, no branch), on any device and dtype; ops/host.py's
host_return_map and host_plastic_system are the numpy float64 mirrors.
The dense tangent is one float64 scatter rounded once
(ops/assembly.scatter_add, ROADMAP fault 3.4).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.problem import ProblemData
from .assembly import _assemble_dense, material_values, scatter_add


class PlasticParams(NamedTuple):
    """Per-element hardening parameters (broadcastable (nelm,) tensors)."""

    sigma_y: torch.Tensor  # initial yield stress (> 0)
    h_iso: torch.Tensor    # linear isotropic hardening modulus (>= 0)
    h_kin: torch.Tensor    # linear kinematic hardening modulus (>= 0)


class PlasticState(NamedTuple):
    """Committed internal variables, one per element."""

    eps_p: torch.Tensor  # plastic strain
    alpha: torch.Tensor  # accumulated (equivalent) plastic strain, >= 0
    back: torch.Tensor   # back stress q (kinematic hardening centre)


def initial_state(nelm: int, dtype=torch.float32,
                  device=None) -> PlasticState:
    """Virgin material: zero plastic strain, zero back stress, on `device`
    ("cuda" when None)."""
    from ..utils.runtime import resolve_device

    z = torch.zeros(nelm, dtype=dtype, device=resolve_device(device))
    return PlasticState(eps_p=z, alpha=z, back=z)


def params_arrays(nelm: int, sigma_y, h_iso=0.0, h_kin=0.0,
                  dtype=np.float64) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Scalar-or-per-element specs broadcast to (nelm,) numpy arrays, so a
    scalar `"sigma_y": 1.5` and a per-element list mean the same thing
    in the JSON parser and in both solver tiers."""
    def _arr(v, name, minimum):
        a = np.broadcast_to(np.asarray(v, dtype=dtype), (nelm,)).copy()
        if not np.all(np.isfinite(a)) or np.any(a < minimum):
            raise ValueError(f"plasticity: {name} must be finite and "
                             f">= {minimum}")
        return a

    return (_arr(sigma_y, "sigma_y", np.finfo(float).tiny),
            _arr(h_iso, "hardening (isotropic)", 0.0),
            _arr(h_kin, "hardening (kinematic)", 0.0))


def return_map(eps: torch.Tensor, state: PlasticState, young: torch.Tensor,
               params: PlasticParams, yield_tol: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor, PlasticState]:
    """Radial return over an element batch: eps (nelm,) the TOTAL axial
    strain at the trial displacement, state the committed variables.

    Returns (sigma, e_tan, new_state): the return-mapped stress, the
    algorithmic tangent modulus and the would-be-committed state, which
    callers commit only once the step converges.

    yield_tol = 0 is the JAX package's test, f_tr > 0.  A positive
    yield_tol counts f_tr <= yield_tol (|sigma_tr| + |q| + radius) as
    elastic: the rounding band of f_tr.  A member that yielded in the
    last step starts the next one ON the surface, where f_tr rounds to a
    few ulps of either sign; a positive one hands Newton the plastic
    tangent on an unloading step, and Newton can then cycle between two
    active sets (ROADMAP fault 3.18).  The float32 static Newton passes
    16 eps of its dtype."""
    sigma_tr = young * (eps - state.eps_p)
    xi = sigma_tr - state.back
    # sign(0) = 0 zeroes the flow direction at xi == 0, where f_tr <= 0
    # and dgamma is 0 anyway.
    sgn = torch.sign(xi)
    radius = params.sigma_y + params.h_iso * state.alpha
    f_tr = torch.abs(xi) - radius
    denom = young + params.h_iso + params.h_kin
    if yield_tol:
        band = yield_tol * (torch.abs(sigma_tr) + torch.abs(state.back)
                            + radius)
        plastic = f_tr > band
        dgamma = torch.where(plastic, f_tr, 0.0) / denom
    else:
        plastic = f_tr > 0.0
        dgamma = torch.clamp(f_tr, min=0.0) / denom
    sigma = sigma_tr - young * dgamma * sgn
    e_tan = torch.where(plastic,
                        young * (params.h_iso + params.h_kin) / denom, young)
    new_state = PlasticState(
        eps_p=state.eps_p + dgamma * sgn,
        alpha=state.alpha + dgamma,
        back=state.back + params.h_kin * dgamma * sgn,
    )
    return sigma, e_tan, new_state


def plastic_element_batch(data: ProblemData, u: torch.Tensor,
                          state: PlasticState, young: torch.Tensor,
                          area: torch.Tensor, params: PlasticParams,
                          tangent_floor: float = 1e-8,
                          yield_tol: float = 0.0):
    """Strain -> return map -> element force and tangent, batched, with the
    small-strain measure eps = g.u_e / L0 of the linear elastic element.

    Returns (s_tan, fe, sigma, eps, new_state): s_tan (nelm,) the tangent
    coefficients E_t A / L0 (the elastic `stiffness_coefficients`
    contract), fe (nelm, 2d) the element internal forces A sigma g.
    K uses max(E_t, tangent_floor * E), so perfect plasticity cannot hand
    Newton an exactly singular tangent at a mechanism; the residual always
    uses the exact return-mapped sigma.  yield_tol: `return_map`'s."""
    u_e = u[data.dof_map]
    eps = torch.sum(data.gvec * u_e, dim=-1) * data.inv_len
    sigma, e_tan, new_state = return_map(eps, state, young, params,
                                         yield_tol)
    e_stab = torch.maximum(e_tan, tangent_floor * young)
    s_tan = e_stab * area * data.inv_len
    fe = (area * sigma)[:, None] * data.gvec
    return s_tan, fe, sigma, eps, new_state


def dense_plastic_system(data: ProblemData, young: torch.Tensor,
                         area: torch.Tensor, u: torch.Tensor,
                         state: PlasticState, params: PlasticParams,
                         tangent_floor: float = 1e-8, tangent: bool = True,
                         yield_tol: float = 0.0):
    """(K_t or None, f_int, sigma, new_state) at the given material values:
    the dense tangent (tangent=True) and the internal force, each one
    float64 scatter rounded once."""
    s_tan, fe, sigma, _, new_state = plastic_element_batch(
        data, u, state, young, area, params, tangent_floor, yield_tol)
    k_t = None
    if tangent:
        k_t = _assemble_dense(
            data, s_tan[:, None, None] * data.gvec[:, :, None]
            * data.gvec[:, None, :])
    return k_t, scatter_add(data.ndof, data.dof_map, fe), sigma, new_state


def assemble_plastic_system(data: ProblemData, material, u: torch.Tensor,
                            state: PlasticState, params: PlasticParams,
                            load_factor=1.0, tangent_floor: float = 1e-8,
                            yield_tol: float = 0.0):
    """Dense tangent assembly of the elastoplastic truss: the elastic
    assembly's scatter with the element coefficient E_t and the internal
    force A sigma.  Returns (K_t, f_int, sigma, new_state)."""
    young, area = material_values(data, material, load_factor)
    return dense_plastic_system(data, young, area, u, state, params,
                                tangent_floor, yield_tol=yield_tol)
