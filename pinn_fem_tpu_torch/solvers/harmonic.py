"""Harmonic (steady-state frequency-response) analysis (counterpart of
pinn_fem_tpu/solvers/harmonic.py).

For f(t) = Re[F e^{i omega t}] the steady state is u(t) = Re[X e^{i omega t}]
with (K + i omega C - omega^2 M) X = F and Rayleigh damping
C = alpha M + beta K.

Tiers, chosen as in the JAX package:

  * dense float64 (host None and ndof <= DENSE_DOF_LIMIT, the default):
    with Rayleigh damping the undamped modes diagonalize the complex
    dynamic stiffness exactly, so superposing the FULL lumped-mass modal
    basis is the direct solution.  K (plus K_g(u0) under prestress) and M
    are ops/host's float64 operators, the JAX host tier's own; the eigh
    and the superposition run in float64 torch on the caller's device
    (the card unless the caller asks for the CPU; host=True runs them on
    the CPU).  The basis is cached on the problem while its material and
    prestress_u are the same objects.
  * direct (host=False, dense only): the complex system in real block
    form Z = [[A, -B], [B, A]], A = K - omega^2 M, B = omega C, in the
    working dtype, batched over chunks of _SWEEP_CHUNK frequencies: one
    batched LU factorization, a solve, one refinement step on the same
    factors and the true residual of the returned solution.
  * modal superposition (method="modal" off the dense default): the
    n_modes lowest modes of solvers/modal.modal_analysis (above the dense
    limit the banded subspace iteration, whose block solves are kernels
    1-3 on a card), X(omega) = sum_j phi_j (phi_j^T F) / (omega_j^2 -
    omega^2 + 2 i zeta_j omega omega_j) with the exact Rayleigh modal
    damping zeta_j = (alpha / omega_j + beta omega_j) / 2, on the device
    in the working dtype.

Float32 contractions run with TF32 off (the package's import switches it
off), the counterpart of the JAX package's precision="highest".
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.problem import TrussProblem
from ..ops.assembly import assemble_system
from ..ops.mass import lumped_mass
from ..parallel import refuse_mesh
from ..utils.runtime import resolve_device
from .modal import _numpy


class HarmonicResult(NamedTuple):
    omegas: np.ndarray      # (n_freq,) rad/s
    real: np.ndarray        # (n_freq, n_probe) Re X
    imag: np.ndarray        # (n_freq, n_probe) Im X
    amplitude: np.ndarray   # (n_freq, n_probe) |X|
    phase: np.ndarray       # (n_freq, n_probe) arg X in radians
    # Member-force FRFs at `probe_elements` (the fatigue design
    # quantity): N_e(omega) = (EA/L) g . u_e(omega), complex.
    force_real: np.ndarray = None       # (n_freq, n_probe_elm)
    force_imag: np.ndarray = None
    force_amplitude: np.ndarray = None
    # Honesty guard: per-frequency relative residual of the returned
    # solution, and the points above residual_tol.  On the direct tier the
    # true post-refinement LU residual; on the modal tiers the truncated-
    # basis load residual ||F - M Phi q|| / ||F||, the exact and
    # frequency-independent residual of modal superposition.
    residual: np.ndarray = None         # (n_freq,)
    flagged: np.ndarray = None          # (n_freq,) bool


def _host_full_modal_basis(problem, prestress_u, device):
    """(w2, v, free, mask): the FULL lumped-mass modal basis in float64 on
    `device` (v M-orthonormal, (n_free, n_free)), cached on the problem
    while its material and prestress_u are the same objects (identity, as
    in the JAX package); a hit on another device moves the tensors."""
    from ..ops import host as H

    cached = getattr(problem, "_host_frf_cache", None)
    if (cached is not None and cached[0] is problem.material
            and cached[1] is prestress_u):
        return tuple(t.to(device) for t in cached[2])
    free_idx, _ = problem.free_fixed()
    k = H.host_stiffness(problem)
    if prestress_u is not None:
        n_e = H.host_axial_forces(problem, prestress_u)
        k = k + H.host_geometric_stiffness(problem, n_e)
    f64 = dict(dtype=torch.float64, device=device)
    k_ff = torch.as_tensor(k[np.ix_(free_idx, free_idx)], **f64)
    d = torch.sqrt(torch.as_tensor(H.host_lumped_mass(problem)[free_idx],
                                   **f64))
    b = k_ff / d[:, None] / d[None, :]
    w2, y = torch.linalg.eigh(0.5 * (b + b.T))
    v = y / d[:, None]                       # M-orthonormal, ALL modes
    out = (w2, v, torch.as_tensor(free_idx, device=device),
           torch.as_tensor(H.host_masks(problem), **f64))
    problem._host_frf_cache = (problem.material, prestress_u, out)
    return out


def _host_sweep(problem, loads, om, alpha, beta, n_modes, prestress_u,
                device):
    """(xr, xi, residual) float64 tensors on `device`: (n_freq, ndof)
    complex FRF by full (or truncated) modal superposition with exact
    Rayleigh modal damping.  The residual is the truncated-basis load
    residual ||F - M V q|| / ||F||, 0 for the full basis."""
    from ..ops import host as H

    w2, v, free, mask = _host_full_modal_basis(problem, prestress_u, device)
    f64 = dict(dtype=torch.float64, device=device)
    f_free = (torch.as_tensor(loads, **f64) * mask)[free]
    om = torch.as_tensor(om, **f64)
    if n_modes is not None:
        w2, v = w2[:n_modes], v[:, :n_modes]
    q = v.T @ f_free                                       # (J,)
    if n_modes is not None:
        m_f = torch.as_tensor(H.host_lumped_mass(problem), **f64)[free]
        res = (torch.linalg.vector_norm(f_free - m_f * (v @ q))
               / torch.clamp_min(torch.linalg.vector_norm(f_free), 1e-300))
    else:
        res = torch.zeros((), **f64)     # full basis: exact superposition
    den_r = w2[None, :] - (om * om)[:, None]
    den_i = om[:, None] * (alpha + beta * w2)[None, :]
    mag2 = torch.clamp_min(den_r * den_r + den_i * den_i, 1e-300)
    cr = q[None, :] * den_r / mag2                         # (n_freq, J)
    ci = -q[None, :] * den_i / mag2
    xr = torch.zeros((om.numel(), problem.ndof), **f64)
    xi = torch.zeros_like(xr)
    xr[:, free] = cr @ v.T
    xi[:, free] = ci @ v.T
    return xr, xi, res.expand(om.numel())


def harmonic_response(
    problem: TrussProblem,
    omegas,
    damping=(0.0, 0.0),
    method: str = "direct",
    n_modes: int = 12,
    data=None,
    probe_dofs: Optional[np.ndarray] = None,
    probe_elements: Optional[np.ndarray] = None,
    mesh=None,
    host: Optional[bool] = None,
    prestress_u=None,
    residual_tol: float = 1e-3,
    device=None,
) -> HarmonicResult:
    """Steady-state response X(omega) to the problem's load vector.

    The JAX package's arguments:
        omegas: (n_freq,) angular frequencies (rad/s).
        damping: Rayleigh (alpha, beta), C = alpha M + beta K.
        method: "direct" (dense exact) or "modal" (superposition of the
            lowest n_modes; any mesh size).
        host: None (the dense float64 tier below DENSE_DOF_LIMIT), True
            (that tier on the CPU) or False (the working-dtype tiers).
        probe_elements: element indices whose member-force FRFs
            N_e(omega) = (EA/L) g . u_e(omega) the result carries,
            computed from the full field before probe slicing.
        prestress_u: a static state whose K_g(u0) is added to K.
        residual_tol: the residual above which a point is flagged.
        mesh: the JAX package's frequency sharding, ROADMAP item 15's
            multi-device row: anything but None raises.
    The port's own: device, where to solve when `data` is not given
    ("cuda" when None); with `data`, its device.
    """
    from . import newton

    refuse_mesh(mesh, "the frequency sweep")
    limit = newton.DENSE_DOF_LIMIT
    om_host = np.asarray(omegas, dtype=float).reshape(-1)
    alpha, beta = float(damping[0]), float(damping[1])
    sel = None
    if probe_elements is not None:
        sel, s_sel, gvec_sel, dm_sel = _element_frf_constants(
            problem, probe_elements)
    probe_np = (np.arange(problem.ndof) if probe_dofs is None
                else np.asarray(probe_dofs, dtype=int))

    if ((host or host is None) and problem.ndof <= limit
            and method in ("direct", "modal")):
        from ..ops.host import loads_of

        where = (torch.device("cpu") if host
                 else data.device if data is not None
                 else resolve_device(device))
        pu = None if prestress_u is None else _numpy(prestress_u)
        xr, xi, res = _host_sweep(
            problem, loads_of(problem, data), om_host, alpha, beta,
            None if method == "direct" else n_modes, pu, where)
        dtype = torch.float64
    else:
        data = data if data is not None else problem.to_device(device)
        dtype = data.loads.dtype
        om = torch.as_tensor(om_host, dtype=dtype).to(data.device)
        if method == "direct":
            if problem.ndof > limit:
                raise ValueError("direct harmonic response is dense-only; "
                                 "use method='modal' for large meshes")
            xr, xi, res = _direct_sweep(problem, data, om, alpha, beta,
                                        prestress_u)
        elif method == "modal":
            xr, xi, res = _modal_sweep(problem, data, om, alpha, beta,
                                       n_modes, prestress_u)
        else:
            raise ValueError("method must be 'direct' or 'modal'")

    # Member forces from the FULL field, on its device; then the probed
    # columns and the forces go to the host.
    dev = xr.device
    fr = fi = None
    if sel is not None:
        s_t = torch.as_tensor(s_sel, dtype=dtype).to(dev)
        g_t = torch.as_tensor(gvec_sel, dtype=dtype).to(dev)
        dm_t = torch.as_tensor(dm_sel).to(dev)
        fr = s_t * torch.sum(g_t * xr[:, dm_t], dim=-1)
        fi = s_t * torch.sum(g_t * xi[:, dm_t], dim=-1)
    probe = torch.as_tensor(probe_np).to(dev)
    fetched = [t if t is None else t.cpu().numpy()
               for t in (xr[:, probe], xi[:, probe], fr, fi, res)]
    xr, xi, fr, fi, res = fetched
    res = np.asarray(res, dtype=float)
    # Undamped responses are exactly real; the phase of a negative real
    # FRF is -pi (the zero-damping limit from below) on every tier, so
    # exact zeros get a negative sign before arctan2.
    xi_ph = np.where(xi == 0.0, -0.0, xi)
    return HarmonicResult(
        omegas=om_host, real=xr, imag=xi,
        amplitude=np.hypot(xr, xi), phase=np.arctan2(xi_ph, xr),
        force_real=fr, force_imag=fi,
        force_amplitude=None if fr is None else np.hypot(fr, fi),
        residual=res, flagged=res > float(residual_tol),
    )


def _element_frf_constants(problem, probe_elements):
    """(sel, EA/L, gvec, dof_map) rows for the selected elements: the
    float64 host material values at the element midpoints (what assembly
    uses)."""
    from ..ops.host import _geometry, material_values_host

    sel = np.asarray(probe_elements, dtype=int).reshape(-1)
    if sel.size and (sel.min() < 0 or sel.max() >= problem.nelm):
        raise ValueError(f"probe_elements must be valid element indices "
                         f"(< {problem.nelm})")
    dof_map, gvec, inv_len, _ = _geometry(problem)
    young, area = material_values_host(problem, 1.0)
    s = (young * area * inv_len)[sel]
    return sel, s, gvec[sel], dof_map[sel]


# Frequencies solved per batched factorization: bounds the (chunk, 2n, 2n)
# block-matrix memory (about 2 GB in float32 at 2,048 DOFs).
_SWEEP_CHUNK = 32


def _direct_sweep(problem, data, om, alpha: float, beta: float,
                  prestress_u=None):
    """(xr, xi, residual) of the real 2x2-block complex solves, chunk by
    chunk; the frequencies are padded with 1 rad/s to whole chunks."""
    material = problem.material.to(data.device)
    mask = data.free_mask
    k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
    if prestress_u is not None:
        from ..ops.geometric import assemble_geometric, element_axial_forces

        u0 = torch.as_tensor(_numpy(prestress_u),
                             dtype=data.loads.dtype).to(data.device)
        k = k + assemble_geometric(data, element_axial_forces(data, material,
                                                              u0))
    k = mask[:, None] * k * mask[None, :]
    # MASKED mass in the dynamic terms: unit fixed-DOF mass would turn the
    # fixed rows into (1 - w^2), singular at w = 1 rad/s with alpha = 0.
    # The identity rows carry the fixed DOFs instead.
    m = lumped_mass(data, material) * mask
    f = data.loads * mask
    n_freq = om.shape[0]
    n_pad = -(-n_freq // _SWEEP_CHUNK) * _SWEEP_CHUNK
    om_p = torch.cat([om, torch.ones(n_pad - n_freq, dtype=om.dtype,
                                     device=om.device)])
    parts = [_solve_chunk(k, m, f, mask, om_p[i:i + _SWEEP_CHUNK],
                          alpha, beta)
             for i in range(0, n_pad, _SWEEP_CHUNK)]
    xr, xi, res = (torch.cat(t)[:n_freq] for t in zip(*parts))
    return xr, xi, res


def _solve_chunk(k, m, f, mask, w, alpha: float, beta: float):
    """One chunk of the direct sweep: the (c, 2n, 2n) block systems, one
    batched LU factorization, a solve, ONE iterative-refinement step on
    the same factors, and the true relative residual of the returned
    solution.  lu_factor_ex does not check the factors (a singular system
    gives non-finite values, as JAX's lu_factor does), so nothing syncs."""
    n = f.shape[0]
    c = w.shape[0]
    ww = w[:, None, None]
    z = torch.empty((c, 2 * n, 2 * n), dtype=k.dtype, device=k.device)
    a = z[:, :n, :n]
    a.copy_(k.expand(c, n, n))
    a.diagonal(dim1=1, dim2=2).sub_((w * w)[:, None] * m[None, :])
    # Identity rows on fixed DOFs keep the block system nonsingular.
    a.diagonal(dim1=1, dim2=2).add_(1.0 - mask)
    z[:, n:, n:] = a
    b = z[:, n:, :n]
    b.copy_((beta * k).expand(c, n, n))
    b.diagonal(dim1=1, dim2=2).add_(alpha * m)
    b.mul_(ww)                                   # omega C, already masked
    z[:, :n, n:] = -b
    rhs = torch.cat([f, torch.zeros_like(f)]).expand(c, 2 * n)[..., None]
    lu, piv, _ = torch.linalg.lu_factor_ex(z)
    x = torch.linalg.lu_solve(lu, piv, rhs)
    x = x + torch.linalg.lu_solve(lu, piv, rhs - z @ x)
    r = rhs - z @ x
    res = (torch.linalg.vector_norm(r[..., 0], dim=1)
           / torch.clamp_min(torch.linalg.vector_norm(rhs[0, :, 0]),
                             torch.finfo(f.dtype).tiny))
    x = x[..., 0]
    return x[:, :n] * mask, x[:, n:] * mask, res


def _modal_sweep(problem, data, om, alpha: float, beta: float, n_modes: int,
                 prestress_u=None):
    """Modal superposition with exact Rayleigh modal damping, on the
    device in the working dtype.  The truncated-basis residual is exact
    and frequency-independent: (K + i w C - w^2 M) Phi c = M Phi q for the
    Rayleigh-damped pencil, so r = F - M Phi q at every omega."""
    from .modal import modal_analysis

    res = modal_analysis(problem, n_modes=n_modes, data=data,
                         prestress_u=prestress_u)
    dtype, dev = data.loads.dtype, data.device
    w2 = torch.as_tensor(res.eigenvalues, dtype=dtype).to(dev)   # (J,)
    wj = torch.sqrt(torch.clamp_min(w2, 1e-30))
    phi = torch.as_tensor(res.shapes, dtype=dtype).to(dev)       # (ndof, J)
    f = data.loads * data.free_mask
    q = phi.T @ f                                        # modal forces
    zeta = 0.5 * (alpha / wj + beta * wj)
    m_lump = lumped_mass(data, problem.material.to(dev)) * data.free_mask
    r_trunc = f - m_lump * (phi @ q)
    res_rel = (torch.linalg.vector_norm(r_trunc)
               / torch.clamp_min(torch.linalg.vector_norm(f),
                                 torch.finfo(dtype).tiny))
    w = om[:, None]
    den_r = w2[None, :] - w * w
    den_i = 2.0 * zeta[None, :] * w * wj[None, :]
    mag2 = den_r * den_r + den_i * den_i
    cr = q[None, :] * den_r / mag2                       # (n_freq, J)
    ci = -q[None, :] * den_i / mag2
    return cr @ phi.T, ci @ phi.T, res_rel.expand(om.shape[0])
