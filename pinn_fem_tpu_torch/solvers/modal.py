"""Modal analysis: K phi = omega^2 M phi, dense or banded, differentiable
(counterpart of pinn_fem_tpu/solvers/modal.py).

Paths, chosen as in the JAX package:

  * dense float64 (ndof <= DENSE_DOF_LIMIT, the default): K (plus the
    prestress K_g(u0) when asked) and M are the float64 operators of
    ops/host.py, the JAX host tier's own; the reduction to standard form
    (a D^-1/2 scaling for lumped mass, a Cholesky congruence for
    consistent mass), eigh and the residual check run in float64 torch on
    the caller's device (the card unless the caller asks for the CPU;
    host=True runs them on the CPU).  The JAX package computes this tier
    with numpy / LAPACK on the host because every new TPU program paid a
    remote compile; the numbers are the same to float64 rounding.
  * dense traced (host=False): the same reduction in the working dtype
    from ops/assembly and ops/mass, with the float32 residual floor below.
    `modal_eigenpairs` is its differentiable core: gradients reach the
    material parameters, density included, through torch.linalg.eigh.
  * banded (above the dense limit, lumped mass): inverse subspace
    iteration with Rayleigh-Ritz on the DIA operator.  Each iteration
    solves K Y = M X for the k = min(2 n_modes + 4, n_free) columns, one
    warm-started Jacobi-PCG a column (ops.dia.dia_cg_solve: on a card the
    fused PCG, kernels 1-3; on the CPU the plain recurrence the JAX
    package runs with use_pallas=False), then solves a k x k generalized
    eigenproblem.  The residual check's K v is kernel 1.  The start
    vectors are jax.random.normal's (utils/prng.normal).

Float32 verification design (the JAX package's, measured there on a
40k-DOF strip with lambda_1 / ||K|| ~ 1.4e-7): the Kv-based `residuals`
have a float32 floor ~ eps32 ||K|| sqrt(n) / lambda, so `ok` accepts
floor-level residuals and, on the banded path, also requires the Ritz
values to have changed by less than 1e-3 over the last iteration.  The
Ritz values come from Y^T (M X), K Y = M X by the solve's construction.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.problem import TrussProblem
from ..ops.assembly import assemble_system
from ..ops.mass import consistent_mass, lumped_mass
from ..parallel import refuse_mesh
from ..utils.progress import PACKAGE_LOGGER
from ..utils.runtime import require_float32, resolve_device

logger = logging.getLogger(PACKAGE_LOGGER)

# The banded block solves run kernels 1-3 on a card.
BANDED_KERNELS = "kernels 1-3: dia_matvec, dia_dir_matvec, cg_update"


class ModalResult(NamedTuple):
    eigenvalues: np.ndarray   # (n_modes,) omega^2, ascending
    omegas: np.ndarray        # (n_modes,) rad/s
    frequencies: np.ndarray   # (n_modes,) Hz
    shapes: np.ndarray        # (ndof, n_modes), zeros on fixed DOFs,
                              # M-orthonormal on the free block
    residuals: np.ndarray     # (n_modes,) ||K v - lam M v|| / (lam ||M v||)
    ok: bool = True           # all residuals below the trust threshold


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=float)


def _dense_eigensolve(k_ff, m_ff_or_diag, n_modes: int, lumped: bool):
    """Smallest generalized eigenpairs on the free block."""
    if lumped:
        inv_d = 1.0 / torch.sqrt(m_ff_or_diag)
        b = inv_d[:, None] * k_ff * inv_d[None, :]
        w, y = torch.linalg.eigh(b)
        v = inv_d[:, None] * y
    else:
        lo = torch.linalg.cholesky(m_ff_or_diag)
        li_k = torch.linalg.solve_triangular(lo, k_ff, upper=False)
        b = torch.linalg.solve_triangular(lo, li_k.T, upper=False).T
        b = 0.5 * (b + b.T)
        w, y = torch.linalg.eigh(b)
        v = torch.linalg.solve_triangular(lo.T, y, upper=True)
    return w[:n_modes], v[:, :n_modes]


def modal_eigenvalues(problem: TrussProblem, n_modes: int = 6,
                      lumped: bool = True, data=None, material=None,
                      device=None) -> torch.Tensor:
    """The smallest eigenvalues omega^2 as a tensor: gradients flow to the
    material parameters, density included.  `material` overrides
    problem.material."""
    return modal_eigenpairs(problem, n_modes, lumped, data, material,
                            device=device)[0]


def modal_eigenpairs(problem: TrussProblem, n_modes: int = 6,
                     lumped: bool = True, data=None, material=None,
                     prestress_u=None, device=None):
    """(omega^2, shapes) as tensors, the differentiable core with mode
    shapes.  Shapes are (ndof, n_modes), zero on fixed DOFs,
    M-orthonormal on the free block, of arbitrary sign: compare
    sign-invariant quantities (phi^2 at sensor DOFs, MAC).

    `prestress_u` adds the initial-stress stiffness K_g(u0) of a static
    state (ops/geometric.py).  The port's own: device, where to solve
    when `data` is not given ("cuda" when None)."""
    from ..ops.geometric import assemble_geometric, element_axial_forces

    data = data if data is not None else problem.to_device(device)
    material = (material if material is not None
                else problem.material.to(data.device))
    dtype = data.loads.dtype
    free = torch.as_tensor(problem.free_fixed()[0]).to(data.device)
    k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
    if prestress_u is not None:
        u0 = torch.as_tensor(_numpy(prestress_u), dtype=dtype).to(data.device)
        k = k + assemble_geometric(data, element_axial_forces(data, material,
                                                              u0))
    k_ff = k[free][:, free]
    if lumped:
        w, v = _dense_eigensolve(k_ff, lumped_mass(data, material)[free],
                                 n_modes, True)
    else:
        m_ff = consistent_mass(data, material)[free][:, free]
        w, v = _dense_eigensolve(k_ff, m_ff, n_modes, False)
    shapes = torch.zeros((problem.ndof, n_modes), dtype=v.dtype,
                         device=v.device).index_copy(0, free, v)
    return w, shapes


def _start_vectors(seed_key, ndof: int, k: int, like: torch.Tensor):
    """(k, ndof) rows: jax.random.normal(key, (ndof, k)) transposed."""
    from ..utils import prng

    npf = np.float64 if like.dtype == torch.float64 else np.float32
    x = prng.normal(seed_key, (ndof, k), npf).T
    return torch.from_numpy(np.ascontiguousarray(x)).to(like.device)


def block_solve(layout, kd, rhs, mask, cg_tol: float, x0):
    """K^-1 rhs for each row of rhs (k, ndof), one warm-started Jacobi-PCG
    a row (ops.dia.dia_cg_solve: the fused PCG on a card) at max_iter =
    40 ndof, as the JAX package's vmapped banded solve (a vmapped
    while_loop freezes each converged column, so each column is its own
    solve)."""
    from ..ops import dia

    return torch.stack([
        dia.dia_cg_solve(layout, kd, rhs[j], mask, tol=cg_tol,
                         max_iter=40 * layout.ndof, x0=x0[j])[0]
        for j in range(rhs.shape[0])])


def _subspace_iteration(layout, kd, m_diag, mask, n_modes: int, n_iter: int,
                        cg_tol: float, seed: int, n_free: int):
    """Inverse subspace iteration on the banded operator (lumped mass):
    (w, shapes (ndof, n_modes), Ritz-value change over the last
    iteration).  Y is kept as (k, ndof) rows."""
    from ..utils import prng

    k = min(2 * n_modes + 4, n_free)
    y = _start_vectors(prng.PRNGKey(seed), layout.ndof, k, m_diag) \
        * mask[None, :]
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    w = w_prev = None
    for _ in range(n_iter):
        rhs = m_diag[None, :] * y
        y = block_solve(layout, kd, rhs, mask, cg_tol, y)     # K^-1 M X
        w_prev = w
        # Rayleigh-Ritz in the M inner product: Y^T K Y = Y^T rhs.
        a_r = y @ rhs.T
        a_r = 0.5 * (a_r + a_r.T)
        m_r = y @ (m_diag[None, :] * y).T
        m_r = 0.5 * (m_r + m_r.T)
        lo = torch.linalg.cholesky(m_r + 1e-12 * torch.trace(m_r) * eye)
        b = torch.linalg.solve_triangular(lo, a_r, upper=False)
        b = torch.linalg.solve_triangular(lo, b.T, upper=False).T
        b = 0.5 * (b + b.T)
        w, q = torch.linalg.eigh(b)
        y = torch.linalg.solve_triangular(lo.T, q, upper=True).T @ y
    if w_prev is None:
        change = torch.full((n_modes,), float("inf"), dtype=y.dtype)
    else:
        change = torch.abs(w[:n_modes] - w_prev[:n_modes]) / torch.clamp_min(
            torch.abs(w[:n_modes]), 1e-30)
    return w[:n_modes], y[:n_modes].T, change


def _result(w: np.ndarray, shapes, res, ok: bool, noise_rel: float
            ) -> ModalResult:
    """Clamp only float noise: a genuinely negative eigenvalue (a
    prestressed state past the buckling point) stays visible."""
    noise = noise_rel * max(float(np.max(np.abs(w))), 1e-300)
    w = np.where((w < 0) & (w > -noise), 0.0, w)
    omegas = np.sqrt(np.maximum(w, 0.0))
    return ModalResult(eigenvalues=np.asarray(w), omegas=omegas,
                       frequencies=omegas / (2.0 * np.pi),
                       shapes=np.asarray(shapes), residuals=np.asarray(res),
                       ok=ok)


def _float64_modal(problem: TrussProblem, n_modes: int, lumped: bool,
                   prestress_u, device) -> ModalResult:
    """The dense modal analysis in float64: ops/host's operators, the
    linear algebra in torch on `device` (the JAX package's _host_modal)."""
    from ..ops import host as H

    free_idx, _ = problem.free_fixed()
    k = H.host_stiffness(problem)
    if prestress_u is not None:
        k = k + H.host_geometric_stiffness(
            problem, H.host_axial_forces(problem, _numpy(prestress_u)))
    f64 = dict(dtype=torch.float64, device=device)
    k_ff = torch.as_tensor(k[np.ix_(free_idx, free_idx)], **f64)
    k_ff = 0.5 * (k_ff + k_ff.T)
    if lumped:
        m_f = torch.as_tensor(H.host_lumped_mass(problem)[free_idx], **f64)
        w, v = _dense_eigensolve(k_ff, m_f, n_modes, lumped=True)
        mv = m_f[:, None] * v
    else:
        m_ff = torch.as_tensor(
            H.host_consistent_mass(problem)[np.ix_(free_idx, free_idx)],
            **f64)
        m_ff = 0.5 * (m_ff + m_ff.T)
        w, v = _dense_eigensolve(k_ff, m_ff, n_modes, lumped=False)
        mv = m_ff @ v
    num = torch.linalg.vector_norm(k_ff @ v - mv * w[None, :], dim=0)
    den = torch.clamp_min(torch.abs(w) * torch.linalg.vector_norm(mv, dim=0),
                          1e-300)
    row_max = torch.max(torch.sum(torch.abs(k_ff), dim=1))
    w, v, res, row_max = (t.cpu().numpy() for t in (w, v, num / den, row_max))
    # eigh is backward-stable: floor-level residuals are check noise.
    floor = (2.3e-16 * float(row_max) * np.sqrt(problem.ndof)
             / np.maximum(np.abs(w), 1e-300))
    ok = bool(np.all(res < np.maximum(1e-8, 10.0 * floor)))
    shapes = np.zeros((problem.ndof, n_modes))
    shapes[free_idx] = v
    return _result(w, shapes, res, ok, 1e-12)


def modal_analysis(
    problem: TrussProblem,
    n_modes: int = 6,
    lumped: bool = True,
    data=None,
    n_iter: int = 25,
    cg_tol: float = 1e-8,
    seed: int = 0,
    prestress_u=None,
    host: Optional[bool] = None,
    mesh=None,
    device=None,
) -> ModalResult:
    """Lowest natural frequencies and mode shapes.

    The JAX package's arguments: dense float64 below DENSE_DOF_LIMIT
    (host None), banded inverse subspace iteration above it (lumped mass
    only there); host=True computes the dense float64 path on the CPU,
    host=False takes the dense path in the working dtype.  prestress_u
    adds the initial-stress stiffness of a static state.  mesh= (the JAX
    package's sharded block solves) is not ported.  The port's own:
    device, where to solve when `data` is not given ("cuda" when None);
    with `data`, its device.
    """
    from . import newton

    refuse_mesh(mesh, "the block solves")
    limit = newton.DENSE_DOF_LIMIT
    free_idx, _ = problem.free_fixed()
    if host or (host is None and problem.ndof <= limit):
        if problem.ndof > limit:
            raise ValueError("host modal analysis is dense-only; use the "
                             "banded device path for large meshes")
        if n_modes > free_idx.size:
            raise ValueError("n_modes exceeds the number of free DOFs")
        where = (torch.device("cpu") if host
                 else data.device if data is not None
                 else resolve_device(device))
        return _float64_modal(problem, n_modes, lumped, prestress_u, where)

    data = data if data is not None else problem.to_device(device)
    dtype = data.loads.dtype
    if n_modes > free_idx.size:
        raise ValueError("n_modes exceeds the number of free DOFs")
    material = problem.material.to(data.device)
    mask = data.free_mask
    n_e = None
    if prestress_u is not None:
        from ..ops.geometric import element_axial_forces

        u0 = torch.as_tensor(_numpy(prestress_u), dtype=dtype).to(data.device)
        n_e = element_axial_forces(data, material, u0)

    dense = problem.ndof <= limit
    if dense:
        free = torch.as_tensor(free_idx).to(data.device)
        k_full = assemble_system(data, material,
                                 torch.zeros_like(data.loads))[0]
        if n_e is not None:
            from ..ops.geometric import assemble_geometric

            k_full = k_full + assemble_geometric(data, n_e)
        k_ff = k_full[free][:, free]
        if lumped:
            w, v_free = _dense_eigensolve(
                k_ff, lumped_mass(data, material)[free], n_modes, True)
        else:
            w, v_free = _dense_eigensolve(
                k_ff, consistent_mass(data, material)[free][:, free],
                n_modes, False)
        shapes = torch.zeros((problem.ndof, n_modes), dtype=dtype,
                             device=data.device).index_copy(0, free, v_free)

        def kv(v):
            return (k_full @ v) * mask
        row_max = torch.max(torch.sum(torch.abs(k_full), dim=1))
    else:
        if not lumped:
            raise ValueError("large-mesh modal analysis requires lumped mass")
        layout = newton._dia_layout_of(problem, data)
        if layout is None:
            raise ValueError("large-mesh modal analysis requires a banded "
                             "(DIA) operator; renumber the mesh")
        if data.device.type == "cuda":
            require_float32(dtype, f"banded modal analysis ({BANDED_KERNELS})")
        from ..ops.cg import stiffness_coefficients
        from ..ops.dia import assemble_dia
        from ..ops.kernels.dia_kernel import dia_matvec
        from ..ops.mg import mask_dia

        kd = assemble_dia(layout, stiffness_coefficients(data, material, 1.0),
                          data.gvec)
        if n_e is not None:
            from ..ops.geometric import assemble_geometric_dia

            kd = kd + assemble_geometric_dia(layout, data, n_e)
        kd = mask_dia(tuple(int(o) for o in layout.offsets), kd,
                      mask).contiguous()
        m_diag = lumped_mass(data, material) * mask + (1.0 - mask)
        w, shapes, ritz_change = _subspace_iteration(
            layout, kd, m_diag, mask, n_modes, n_iter, cg_tol, seed,
            int(free_idx.size))

        def kv(v):
            return dia_matvec(layout, kd, v.contiguous()) * mask
        row_max = torch.max(torch.sum(torch.abs(kd), dim=0))

    # Residual check ||K v - lam M v|| / (lam ||M v||).
    m_vec = lumped_mass(data, material) if lumped else None
    m_full = None if lumped else consistent_mass(data, material)
    res = []
    for j in range(n_modes):
        v = shapes[:, j]
        mv = (m_vec * v if lumped else m_full @ v) * mask
        num = torch.linalg.vector_norm(kv(v) - w[j] * mv)
        den = torch.clamp_min(torch.abs(w[j]) * torch.linalg.vector_norm(mv),
                              1e-30)
        res.append(num / den)

    w, shapes, res_np = (t.cpu().numpy() for t in (w, shapes,
                                                     torch.stack(res)))
    # Gershgorin ||K||_inf: the float32 floor of the Kv-based residual of
    # mode j is ~eps32 ||K|| / lambda_j; the Ritz values stay accurate
    # below it.
    floor = (1.2e-7 * float(row_max) * np.sqrt(problem.ndof)
             / np.maximum(np.abs(w), 1e-30))
    within_floor = res_np < np.maximum(1e-2, 10.0 * floor)
    if dense:
        ok = bool(np.all(within_floor))
    else:
        rc = ritz_change.cpu().numpy()
        ok = bool(np.all(within_floor) and np.all(rc < 1e-3))
    if not ok:
        logger.warning(
            "modal_analysis: unresolved modes (residuals %s vs float32 "
            "floor %s%s) — ModalResult.ok=False", res_np, floor,
            "" if dense else f", ritz change {rc}")
    return _result(w, shapes, res_np, ok, 1e-6)


def rayleigh_coefficients(omega_1: float, zeta_1: float,
                          omega_2: float, zeta_2: float):
    """(alpha, beta) of Rayleigh damping C = alpha M + beta K with damping
    ratios zeta_1, zeta_2 at the angular frequencies omega_1, omega_2,
    from zeta(w) = alpha / (2 w) + beta w / 2."""
    if omega_1 <= 0 or omega_2 <= 0 or omega_1 == omega_2:
        raise ValueError("need two distinct positive frequencies")
    a = np.array([[1.0 / (2.0 * omega_1), omega_1 / 2.0],
                  [1.0 / (2.0 * omega_2), omega_2 / 2.0]])
    alpha, beta = np.linalg.solve(a, np.array([zeta_1, zeta_2]))
    return float(alpha), float(beta)


def mac(phi_a: np.ndarray, phi_b: np.ndarray) -> np.ndarray:
    """Modal Assurance Criterion matrix between two mode-shape sets:
    MAC_ij = |phi_a_i . phi_b_j|^2 / (|phi_a_i|^2 |phi_b_j|^2), in [0, 1]
    and invariant to scale and sign.  (ndof,) vectors or (ndof, n)
    matrices."""
    a = np.atleast_2d(np.asarray(phi_a, dtype=float).T).T
    b = np.atleast_2d(np.asarray(phi_b, dtype=float).T).T
    num = (a.T @ b) ** 2
    den = (np.sum(a * a, axis=0)[:, None]
           * np.sum(b * b, axis=0)[None, :])
    return num / np.maximum(den, 1e-300)
