"""Host-side (numpy, float64) dense operators: the part of
pinn_fem_tpu/ops/host.py that the dynamics family calls.

The JAX package built this module to keep small analyses off the TPU,
where every new program paid a remote compile.  Its dense float64
operators stay part of the contract all the same: `stable_dt` takes its
small-mesh bound from them on every backend, and the prestress of a small
transient document comes from `host_static_solve`.  Each function mirrors
a device op of the port (host_stiffness <-> ops/assembly.assemble_system,
host_lumped_mass <-> ops/mass.lumped_mass, host_consistent_mass <->
ops/mass.consistent_mass, host_geometric_stiffness <->
ops/geometric.assemble_geometric, host_return_map <->
ops/plastic.return_map, host_plastic_system <->
ops/plastic.assemble_plastic_system, host_nonlinear_system <->
ops/assembly.assemble_system_nonlinear), in float64.  The dense modal
and buckling analyses (solvers/modal.py, solvers/buckling.py), the dense
harmonic tier (solvers/harmonic.py), reduction (solvers/reduction.py)
and the float64 tier of the plastic transient build their float64
operators here and solve them with torch on the caller's device.  The
float64 tiers of solve_elastoplastic and solve_riks run the algebra of
host_plastic_system and host_nonlinear_system in torch on that device,
with the material values of `material_values_host`.

MLP fields are evaluated here in numpy from float64 copies of their
weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.fields import MLPField, ScalarField
from ..models.problem import TrussProblem


def _numpy64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().double().numpy()
    return np.asarray(t, dtype=np.float64)


def eval_field_host(field, x: np.ndarray) -> np.ndarray:
    """Numpy float64 form of Field.eval_batch: (n, k) inputs -> (n,)
    values, with the input adaptation, tanh hidden layers, softplus and
    scale of models/fields.py."""
    x = np.asarray(x, dtype=np.float64)
    if isinstance(field, ScalarField):
        return np.full(x.shape[0], float(_numpy64(field.value)))
    if not isinstance(field, MLPField):
        return _numpy64(field.eval_batch(torch.from_numpy(x)))
    width = x.shape[1]
    if field.input_dim < width:
        cols = np.concatenate([x[:, 1:], x[:, :1]], axis=1)
        x = cols[:, : field.input_dim]
    elif field.input_dim > width:
        x = np.concatenate(
            [x, np.zeros((x.shape[0], field.input_dim - width))], axis=1)
    layers = [(_numpy64(w), _numpy64(b)) for w, b in field.layers]
    h = x
    for w, b in layers[:-1]:
        h = np.tanh(h @ w + b)
    w, b = layers[-1]
    out = h @ w + b
    if field.enforce_positive:
        out = np.logaddexp(0.0, out)          # softplus without overflow
    return (out * float(_numpy64(field.scale)))[:, 0]


def _geometry(problem: TrussProblem):
    """(dof_map, gvec, inv_len, mid) in numpy float64, cached on the
    problem."""
    cached = getattr(problem, "_host_geometry_cache", None)
    if cached is not None:
        return cached
    coords = problem.node_coords_2d.astype(np.float64)
    i, j = problem.elements[:, 0], problem.elements[:, 1]
    dx = coords[j] - coords[i]
    lengths = np.linalg.norm(dx, axis=1)
    if np.any(lengths <= 0.0):
        raise ValueError("Element with zero initial length detected")
    cosines = dx / lengths[:, None]
    gvec = np.concatenate([-cosines, cosines], axis=1)
    mid = 0.5 * (coords[i] + coords[j])
    if problem.dimension == 1:
        dof_map = np.stack([i, j], axis=1)
    else:
        d = problem.dimension
        dof_map = np.concatenate(
            [np.stack([d * n + c for c in range(d)], axis=1) for n in (i, j)],
            axis=1)
    out = (dof_map.astype(np.int64), gvec, 1.0 / lengths, mid)
    problem._host_geometry_cache = out
    return out


def _assembly_inputs(problem: TrussProblem, load_factor: float) -> np.ndarray:
    _, _, _, mid = _geometry(problem)
    lf = np.full((mid.shape[0], 1), float(load_factor))
    return np.concatenate([lf, mid[:, : problem.dimension]], axis=1)


def material_values_host(problem: TrussProblem, load_factor: float = 1.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(young, area) at element midpoints, numpy float64."""
    x = _assembly_inputs(problem, load_factor)
    return (eval_field_host(problem.material.young, x),
            eval_field_host(problem.material.area, x))


def _scatter_blocks(problem: TrussProblem, ke: np.ndarray) -> np.ndarray:
    """(nelm, 2d, 2d) element blocks -> dense (ndof, ndof) matrix."""
    dof_map = _geometry(problem)[0]
    k = np.zeros((problem.ndof, problem.ndof))
    np.add.at(k, (dof_map[:, :, None], dof_map[:, None, :]), ke)
    return k


def host_stiffness(problem: TrussProblem,
                   load_factor: float = 1.0) -> np.ndarray:
    """Dense linear stiffness K (ndof, ndof), float64."""
    _, gvec, inv_len, _ = _geometry(problem)
    young, area = material_values_host(problem, load_factor)
    s = young * area * inv_len
    return _scatter_blocks(
        problem, s[:, None, None] * gvec[:, :, None] * gvec[:, None, :])


def host_lumped_mass(problem: TrussProblem) -> np.ndarray:
    """(ndof,) lumped mass vector, payload mass included."""
    dof_map, _, inv_len, _ = _geometry(problem)
    x = _assembly_inputs(problem, 1.0)
    m_e = (eval_field_host(problem.material.density, x)
           * eval_field_host(problem.material.area, x) / inv_len)
    m = np.zeros(problem.ndof)
    np.add.at(m, dof_map, np.broadcast_to((0.5 * m_e)[:, None],
                                          dof_map.shape))
    return m + problem.point_mass_dof()


def host_consistent_mass(problem: TrussProblem) -> np.ndarray:
    """Dense (ndof, ndof) consistent mass, payload mass on the diagonal."""
    _, _, inv_len, _ = _geometry(problem)
    x = _assembly_inputs(problem, 1.0)
    m_e = (eval_field_host(problem.material.density, x)
           * eval_field_host(problem.material.area, x) / inv_len)
    eye = np.eye(problem.dimension)
    pattern = np.block([[2.0 * eye, eye], [eye, 2.0 * eye]]) / 6.0
    return (_scatter_blocks(problem, m_e[:, None, None] * pattern[None])
            + np.diag(problem.point_mass_dof()))


def host_axial_forces(problem: TrussProblem, u: np.ndarray,
                      load_factor: float = 1.0) -> np.ndarray:
    """(nelm,) N_e = E A eps at the state u."""
    dof_map, gvec, inv_len, _ = _geometry(problem)
    young, area = material_values_host(problem, load_factor)
    u_e = np.asarray(u, dtype=np.float64).reshape(-1)[dof_map]
    return young * area * np.sum(gvec * u_e, axis=-1) * inv_len


def host_geometric_stiffness(problem: TrussProblem,
                             n_e: np.ndarray) -> np.ndarray:
    """Dense (ndof, ndof) geometric stiffness from element axial forces."""
    inv_len = _geometry(problem)[2]
    eye = np.eye(problem.dimension)
    pattern = np.block([[eye, -eye], [-eye, eye]])
    coef = np.asarray(n_e, dtype=np.float64) * inv_len
    return _scatter_blocks(problem, coef[:, None, None] * pattern[None])


def host_nonlinear_system(problem: TrussProblem, u: np.ndarray,
                          load_factor: float = 1.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(K_tangent, f_int) of the Green-Lagrange truss at state u: the
    cancellation-free e_gl, the material and initial-stress tangent."""
    if problem.dimension not in (2, 3):
        raise ValueError("geometric nonlinearity requires a 2D or 3D truss")
    dof_map, gvec, inv_len, _ = _geometry(problem)
    young, area = material_values_host(problem, load_factor)
    dim = problem.dimension
    dx0 = gvec[:, dim:] / inv_len[:, None]
    u_e = np.asarray(u, dtype=np.float64).reshape(-1)[dof_map]
    u2 = u_e.reshape(u_e.shape[0], 2, dim)
    delta = u2[:, 1, :] - u2[:, 0, :]
    dx = dx0 + delta
    inv_l0_sq = inv_len * inv_len
    e_gl = (np.sum(dx0 * delta, axis=-1)
            + 0.5 * np.sum(delta * delta, axis=-1)) * inv_l0_sq
    d = np.concatenate([-dx, dx], axis=1)
    ea_invl = young * area * inv_len
    ke_mat = (ea_invl * inv_l0_sq)[:, None, None] * (
        d[:, :, None] * d[:, None, :])
    eye = np.eye(dim)
    b_geo = np.block([[eye, -eye], [-eye, eye]])
    ke = ke_mat + (ea_invl * e_gl)[:, None, None] * b_geo[None, :, :]
    fe = (ea_invl * e_gl)[:, None] * d
    f_int = np.zeros(problem.ndof)
    np.add.at(f_int, dof_map, fe)
    return _scatter_blocks(problem, ke), f_int


def host_return_map(eps: np.ndarray, eps_p: np.ndarray, alpha: np.ndarray,
                    back: np.ndarray, young: np.ndarray, sigma_y: np.ndarray,
                    h_iso: np.ndarray, h_kin: np.ndarray):
    """ops/plastic.return_map on bare arrays: (sigma, e_tan, eps_p_new,
    alpha_new, back_new)."""
    sigma_tr = young * (eps - eps_p)
    xi = sigma_tr - back
    sgn = np.sign(xi)
    f_tr = np.abs(xi) - (sigma_y + h_iso * alpha)
    denom = young + h_iso + h_kin
    dgamma = np.maximum(f_tr, 0.0) / denom
    sigma = sigma_tr - young * dgamma * sgn
    e_tan = np.where(f_tr > 0.0, young * (h_iso + h_kin) / denom, young)
    return (sigma, e_tan, eps_p + dgamma * sgn, alpha + dgamma,
            back + h_kin * dgamma * sgn)


def host_plastic_system(problem: TrussProblem, u: np.ndarray,
                        eps_p: np.ndarray, alpha: np.ndarray,
                        back: np.ndarray, sigma_y: np.ndarray,
                        h_iso: np.ndarray, h_kin: np.ndarray,
                        load_factor: float = 1.0,
                        tangent_floor: float = 1e-8):
    """(K_t, f_int, sigma, (eps_p, alpha, back) new) of the elastoplastic
    truss: small-strain eps = g.u_e / L0, the tangent modulus floored at
    tangent_floor * E."""
    dof_map, gvec, inv_len, _ = _geometry(problem)
    young, area = material_values_host(problem, load_factor)
    u_e = np.asarray(u, dtype=np.float64).reshape(-1)[dof_map]
    eps = np.sum(gvec * u_e, axis=-1) * inv_len
    sigma, e_tan, eps_p_n, alpha_n, back_n = host_return_map(
        eps, eps_p, alpha, back, young, sigma_y, h_iso, h_kin)
    s_tan = np.maximum(e_tan, tangent_floor * young) * area * inv_len
    ke = s_tan[:, None, None] * gvec[:, :, None] * gvec[:, None, :]
    f_int = np.zeros(problem.ndof)
    np.add.at(f_int, dof_map, (area * sigma)[:, None] * gvec)
    return (_scatter_blocks(problem, ke), f_int, sigma,
            (eps_p_n, alpha_n, back_n))


def host_masks(problem: TrussProblem) -> np.ndarray:
    """(ndof,) free mask (1.0 free, 0.0 fixed)."""
    mask = np.ones(problem.ndof)
    if problem.fixed_dofs.size:
        mask[np.unique(problem.fixed_dofs)] = 0.0
    return mask


def host_static_solve(problem: TrussProblem,
                      loads: Optional[np.ndarray] = None,
                      k: Optional[np.ndarray] = None) -> np.ndarray:
    """Masked linear static solve K u = f (zeros on fixed DOFs)."""
    mask = host_masks(problem)
    k = host_stiffness(problem) if k is None else k
    f = problem.loads if loads is None else np.asarray(loads, dtype=float)
    km = mask[:, None] * k * mask[None, :] + np.diag(1.0 - mask)
    return np.linalg.solve(km, f * mask) * mask


def loads_of(problem: TrussProblem, data=None) -> np.ndarray:
    """Effective float64 load vector: data overrides problem (callers may
    pass a ProblemData with replaced loads)."""
    return _numpy64(problem.loads if data is None else data.loads)
