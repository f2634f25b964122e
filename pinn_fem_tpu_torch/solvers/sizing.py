"""Sizing (design) optimization: member areas from load paths
(counterpart of pinn_fem_tpu/solvers/sizing.py).

The design-side mirror of identification: the structure and the loads are
known, and the per-element areas are chosen to carry the load at minimum
mass (or minimum compliance at fixed volume).  Reverse-mode autograd
through the dense masked solve gives the gradients of mass, stress,
displacement, frequency and fatigue life with respect to every area at
once (the discrete adjoint).

Three methods:

- `fully_stressed_design`: the fixpoint A <- |N(A)| / sigma_max on the
  float64 host (numpy, no device work); exact for statically determinate
  trusses.
- `optimize_sizing`: the Rockafellar augmented Lagrangian with ADAM on
  box-parameterized areas, on the dense traced solve
  (`static_response_elem`: the element blocks scattered once in float64,
  rounded once, `torch.linalg.solve` under autograd) on the caller's
  device.  Constraints: stress, Euler buckling, displacement, the
  fundamental frequency (solvers/modal_inverse.modal_observables_elem),
  fatigue life (`member_force_frf_sq`, `fatigue_life_ratio`) and a FORM
  reliability index (`pma_stress_ratios`).  The loss history stays on the
  device as scalars and is fetched once, after the last round; a float64
  host polish then scales members up until the limits hold.
- `optimize_compliance_oc`: optimality criteria on the banded operator
  past the dense limit.  One banded PCG an iteration (ops/dia.assemble_dia
  and dia_cg_solve, on a card the fused kernels 1-3), warm-started at the
  previous displacement, then the energy densities, the compliance and
  the 60-step log-space bisection of the Lagrange multiplier as device
  tensor ops: no host read inside the loop.

The member-force FRF of the fatigue constraint is the real 2 x 2-block
form of solvers/frequency_inverse.py (no complex number enters autograd).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.problem import TrussProblem
from .banded_inverse import solve_or_nan
from .phases import Adam

_F64 = torch.float64


@dataclass
class SizingResult:
    """Optimized design + the checks a designer validates first."""
    areas: np.ndarray              # (nelm,) optimized areas
    mass: float                    # final sum(rho A L)
    mass_initial: float            # mass at the starting areas
    displacements: np.ndarray      # (ndof,) at the optimized areas
    #                                ((n_cases, ndof) with load_cases)
    stress: np.ndarray             # (nelm,) sigma = E eps (the signed
    #                                governing case with load_cases)
    axial_forces: np.ndarray       # (nelm,) N = sigma A
    max_stress_ratio: float        # max |sigma| / stress_limit (nan if none)
    max_displacement_ratio: float  # max |u_probe| / limit (nan if none)
    history: np.ndarray            # per-iteration loss (or mass for FSD)
    converged: bool
    n_iter: int
    # max (-sigma) / sigma_cr over compression members (Euler, I = c A^2);
    # nan when no buckling factor.
    max_buckling_ratio: float = float("nan")
    # Achieved fundamental frequency [Hz]; nan unless a floor was active.
    fundamental_frequency_hz: float = float("nan")
    # Achieved fatigue lives [s] per element (inf where never stressed) and
    # their minimum, recomputed on the float64 host spectral path; None /
    # nan unless a fatigue floor was active.
    fatigue_life_s: Optional[np.ndarray] = None
    min_fatigue_life_s: float = float("nan")
    # Achieved FORM indices (one per limit state) and their minimum,
    # recomputed by the full HL-RF search; None / nan unless an RBDO block
    # was active.
    reliability_beta: Optional[np.ndarray] = None
    min_reliability_beta: float = float("nan")


def density_values_host(problem: TrussProblem) -> np.ndarray:
    """(nelm,) density at the element midpoints, numpy float64."""
    from ..ops.host import _assembly_inputs, eval_field_host

    return eval_field_host(problem.material.density,
                           _assembly_inputs(problem, 1.0))


def _host_area_solve(problem: TrussProblem, areas: np.ndarray,
                     loads: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(u, sigma) at the given per-element areas, the float64 host mirror
    of `static_response_elem`.  With a (C, ndof) `loads` table, u is
    (C, ndof) and sigma (C, nelm)."""
    from ..ops.host import (_geometry, _scatter_blocks, host_masks,
                            material_values_host)

    dof_map, gvec, inv_len, _ = _geometry(problem)
    young, _ = material_values_host(problem, 1.0)
    s = young * areas * inv_len
    ke = s[:, None, None] * gvec[:, :, None] * gvec[:, None, :]
    k = _scatter_blocks(problem, ke)
    mask = host_masks(problem)
    km = mask[:, None] * k * mask[None, :] + np.diag(1.0 - mask)
    f = np.asarray(problem.loads if loads is None else loads, dtype=float)
    # One multi-RHS factorization serves every load case.
    u = (np.linalg.solve(km, (f * mask).T).T * mask
         if f.ndim == 2 else np.linalg.solve(km, f * mask) * mask)
    strain = np.sum(gvec * u[..., dof_map], axis=-1) * inv_len
    return u, young * strain


def _host_mass(problem: TrussProblem, areas: np.ndarray) -> float:
    from ..ops.host import _geometry

    _, _, inv_len, _ = _geometry(problem)
    return float(np.sum(density_values_host(problem) * areas / inv_len))


def fully_stressed_design(
    problem: TrussProblem,
    stress_limit: float,
    min_area: float = 1e-6,
    max_area: Optional[float] = None,
    n_iter: int = 50,
    tol: float = 1e-12,
    load_cases=None,
    buckling_shape_factor: Optional[float] = None,
) -> SizingResult:
    """FSD fixpoint A <- clip(max_c |N_c(A)| / sigma_max, min, max) on the
    float64 host: exact for statically determinate trusses, the standard
    heuristic otherwise.  `load_cases` (C, ndof) sizes each member by its
    governing case; `buckling_shape_factor` c (I = c A^2) adds the Euler
    compression target A >= sqrt(|N| L^2 / (pi^2 E c))."""
    if stress_limit <= 0.0:
        raise ValueError("stress_limit must be positive")
    if buckling_shape_factor is not None and buckling_shape_factor <= 0.0:
        raise ValueError("buckling_shape_factor must be positive")
    from ..ops.host import _geometry, material_values_host

    loads = _load_cases_array(problem, load_cases)
    young_np, areas = material_values_host(problem, 1.0)
    areas = np.clip(np.asarray(areas, dtype=float), min_area, max_area)
    _, _, inv_len_np, _ = _geometry(problem)
    mass_init = _host_mass(problem, areas)
    c_b = buckling_shape_factor
    hist = []
    converged = False
    it = 0
    for it in range(1, n_iter + 1):
        _, sigma = _host_area_solve(problem, areas, loads=loads)
        env = np.max(np.abs(sigma), axis=0) if sigma.ndim == 2 \
            else np.abs(sigma)
        target = env * areas / stress_limit        # |N| / sigma_max
        if c_b is not None:
            comp = np.max(-sigma, axis=0) if sigma.ndim == 2 else -sigma
            n_comp = np.maximum(comp, 0.0) * areas
            a_buck = np.sqrt(n_comp / (np.pi ** 2 * young_np * c_b)
                             ) / inv_len_np
            target = np.maximum(target, a_buck)
        new = np.clip(target, min_area, max_area)
        hist.append(_host_mass(problem, new))
        step = float(np.max(np.abs(new - areas) / np.maximum(areas, 1e-30)))
        areas = new
        if step < tol:
            converged = True
            break
    u, sigma = _host_area_solve(problem, areas, loads=loads)
    env = _signed_envelope(sigma)
    buck_ratio = float("nan")
    if c_b is not None:
        comp = np.maximum(-sigma, 0.0)
        sig_cr = np.pi ** 2 * young_np * c_b * areas * inv_len_np ** 2
        buck_ratio = float(np.max(comp / sig_cr))
    return SizingResult(
        areas=areas, mass=_host_mass(problem, areas),
        mass_initial=mass_init, displacements=u, stress=env,
        axial_forces=env * areas,
        max_stress_ratio=float(np.max(np.abs(sigma)) / stress_limit),
        max_displacement_ratio=float("nan"),
        history=np.asarray(hist, dtype=float), converged=converged,
        n_iter=it, max_buckling_ratio=buck_ratio)


def _signed_envelope(sigma: np.ndarray) -> np.ndarray:
    """(nelm,) stress of each member's governing case (the signed value
    whose magnitude is the envelope); pass-through for a single case."""
    if sigma.ndim == 1:
        return sigma
    idx = np.argmax(np.abs(sigma), axis=0)
    return sigma[idx, np.arange(sigma.shape[1])]


def _load_cases_array(problem: TrussProblem, load_cases):
    """None (the problem's own loads) or a validated (C, ndof) table."""
    if load_cases is None:
        return None
    arr = np.asarray(load_cases, dtype=float)
    if arr.ndim != 2 or arr.shape[1] != problem.ndof:
        raise ValueError(f"load_cases must be (n_cases, {problem.ndof}) "
                         f"rows, got {arr.shape}")
    if arr.shape[0] < 1:
        raise ValueError("load_cases needs at least one case")
    return arr


def _per_elem(v, nelm: int, dtype, device) -> torch.Tensor:
    """A scalar, array or tensor as an (nelm,) tensor (tensors keep their
    autograd graph)."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=device, dtype=dtype)
    else:
        v = torch.as_tensor(np.asarray(v, dtype=float), dtype=dtype,
                            device=device)
    return torch.broadcast_to(v, (nelm,))


def _host_material(problem: TrussProblem):
    """(young, area, density) (nelm,) numpy float64 at the midpoints."""
    from ..ops.host import material_values_host

    young, area = material_values_host(problem, 1.0)
    return young, area, density_values_host(problem)


# Rows of a batched stiffness built at once outside autograd (the Monte
# Carlo chunks): bounds the float64 scatter buffer to 64 n^2 doubles.
_BUILD_ROWS = 64


def masked_stiffness(data, young: torch.Tensor, area: torch.Tensor
                     ) -> torch.Tensor:
    """(B, ndof, ndof) masked stiffness M K M + (I - M) in the working
    dtype for per-element (B, nelm) young and area: ke = s g g^T, one
    float64 scatter a row, rounded once.  Outside autograd the rows are
    built _BUILD_ROWS at a time into one preallocated tensor."""
    n = data.ndof
    dm = data.dof_map
    slots = (dm[:, :, None] * n + dm[:, None, :]).reshape(-1)
    mask = data.free_mask
    fixed = torch.diag(1.0 - mask)
    ggt = data.gvec[:, :, None] * data.gvec[:, None, :]

    def rows(y, a):
        s = y * a * data.inv_len
        ke = s[:, :, None, None] * ggt[None]
        k = torch.zeros((y.shape[0], n * n), dtype=_F64, device=y.device)
        k = k.index_add(1, slots, ke.reshape(y.shape[0], -1).double())
        k = k.to(y.dtype).reshape(-1, n, n)
        return mask[:, None] * k * mask[None, :] + fixed

    b = young.shape[0]
    if torch.is_grad_enabled() or b <= _BUILD_ROWS:
        return rows(young, area)
    out = torch.empty((b, n, n), dtype=young.dtype, device=young.device)
    for i in range(0, b, _BUILD_ROWS):
        out[i:i + _BUILD_ROWS] = rows(young[i:i + _BUILD_ROWS],
                                      area[i:i + _BUILD_ROWS])
    return out


def batched_response(data, young: torch.Tensor, area: torch.Tensor,
                     loads: torch.Tensor):
    """(u (B, ndof), sigma (B, nelm)) of B independent dense solves, one
    batched torch.linalg.solve: the per-sample form of
    `static_response_elem` (the JAX package's vmap over samples or limit
    states)."""
    mask = data.free_mask
    km = masked_stiffness(data, young, area)
    u = solve_or_nan(km, loads * mask) * mask
    strain = torch.sum(data.gvec * u[:, data.dof_map], dim=-1) * data.inv_len
    return u, young * strain


def static_response_elem(problem: TrussProblem, area_e, data=None,
                         young_e=None, rho_e=None, loads=None,
                         device=None):
    """Differentiable static solve with per-element areas.

    Returns (u, sigma, n_axial, mass): the dense masked solve K(A) u = f,
    element stresses sigma = E eps, axial forces N = sigma A and the
    design mass sum rho A L, each differentiable in `area_e` (and the
    optional tensor `young_e` / `rho_e`).  A (C, ndof) `loads` table solves
    every case against one factorization; u and sigma then carry a
    leading case axis.  device: where to solve when `data` is not given
    ("cuda" when None)."""
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    nelm = data.nelm
    if young_e is None or rho_e is None:
        young_h, _, rho_h = _host_material(problem)
        young_e = young_h if young_e is None else young_e
        rho_e = rho_h if rho_e is None else rho_e
    young_e = _per_elem(young_e, nelm, dtype, dev)
    rho_e = _per_elem(rho_e, nelm, dtype, dev)
    area_e = _per_elem(area_e, nelm, dtype, dev)
    km = masked_stiffness(data, young_e[None], area_e[None])[0]
    mask = data.free_mask
    f = data.loads if loads is None else (
        loads.to(dev, dtype) if isinstance(loads, torch.Tensor)
        else torch.as_tensor(np.asarray(loads, dtype=float), dtype=dtype,
                             device=dev))
    if f.dim() == 2:
        u = solve_or_nan(km, (f * mask).T).T * mask
    else:
        u = solve_or_nan(km, f * mask) * mask
    strain = torch.sum(data.gvec * u[..., data.dof_map], dim=-1) \
        * data.inv_len
    sigma = young_e * strain
    mass = torch.sum(rho_e * area_e / data.inv_len)
    return u, sigma, sigma * area_e, mass


def member_force_frf_sq(data, young_e, area_e, rho_e, omegas, alpha, beta):
    """(n_freq, nelm) |H_N(omega)|^2, the member-force FRF magnitude
    squared under the problem's load pattern, differentiable in the
    per-element areas (through K(A), the lumped M(A) and the E A / L force
    recovery).  The real 2n x 2n block form of
    solvers/frequency_inverse._frf_amplitudes (identity rows keep fixed
    DOFs nonsingular), all frequencies in one batched solve."""
    dtype, dev = data.loads.dtype, data.device
    nelm = data.nelm
    young_e = _per_elem(young_e, nelm, dtype, dev)
    area_e = _per_elem(area_e, nelm, dtype, dev)
    rho_e = _per_elem(rho_e, nelm, dtype, dev)
    from ..ops.assembly import scatter_add

    mask = data.free_mask
    k = masked_stiffness(data, young_e[None], area_e[None])[0]
    k = k - torch.diag(1.0 - mask)
    m_e = rho_e * area_e / data.inv_len
    m = scatter_add(data.ndof, data.dof_map,
                    (0.5 * m_e)[:, None].expand(data.dof_map.shape))
    if data.point_mass is not None:
        m = m + data.point_mass
    m = m * mask
    f = data.loads * mask
    n = f.shape[0]
    om = _as_tensor(omegas, dtype, dev)
    alpha = _as_tensor(alpha, dtype, dev)
    beta = _as_tensor(beta, dtype, dev)
    ea_invl = young_e * area_e * data.inv_len
    w = om[:, None, None]
    a = k[None] - (w * w) * torch.diag(m)[None] + torch.diag(1.0 - mask)[None]
    b = w * (alpha * torch.diag(m) + beta * k)[None]
    z = torch.cat([torch.cat([a, -b], dim=2), torch.cat([b, a], dim=2)],
                  dim=1)
    rhs = torch.cat([f, torch.zeros_like(f)]).expand(om.shape[0], 2 * n)
    x = torch.linalg.solve(z, rhs)
    xr, xi = x[:, :n] * mask, x[:, n:] * mask
    nr = ea_invl * torch.sum(data.gvec * xr[:, data.dof_map], dim=-1)
    ni = ea_invl * torch.sum(data.gvec * xi[:, data.dof_map], dim=-1)
    return nr * nr + ni * ni


def _as_tensor(v, dtype, dev) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(v, dtype=float), dtype=dtype,
                           device=dev)


def _trapz(y: torch.Tensor, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Trapezoid rule along `dim` (written out, as the JAX package's)."""
    dx = torch.diff(x)
    hi = y.narrow(dim, 1, y.shape[dim] - 1)
    lo = y.narrow(dim, 0, y.shape[dim] - 1)
    shape = [1] * y.dim()
    shape[dim] = dx.shape[0]
    return torch.sum(0.5 * (hi + lo) * dx.reshape(shape), dim=dim)


def fatigue_life_ratio(omegas, stress_psd, sn_exponent, sn_coefficient,
                       life_s, method: str = "dirlik"):
    """(n_q,) per-quantity r = (E[D] / T_unit * T_req)^(1/m), the fatigue
    analogue of a stress ratio (r <= 1 iff life >= T_req), differentiable
    in the stress PSDs and in a tensor `sn_coefficient`.  The torch mirror
    of solvers/fatigue.spectral_moments -> dirlik / narrowband damage
    rates; zero-PSD quantities get r = 0 through a double where (their
    gradient is zero, not d(x^(1/m))/dx at 0)."""
    mexp = float(sn_exponent)
    dtype, dev = stress_psd.dtype, stress_psd.device
    om = _as_tensor(omegas, dtype, dev)
    c = _as_tensor(sn_coefficient, dtype, dev)
    m0 = _trapz(stress_psd, om)
    m2 = _trapz((om ** 2)[:, None] * stress_psd, om)
    active = m0 > 0.0
    one = torch.ones_like(m0)
    m0s = torch.where(active, m0, one)
    m2s = torch.where(active, m2, one)
    if method == "narrowband":
        nu0 = torch.sqrt(m2s / m0s) / (2.0 * math.pi)
        rate = (nu0 / c * torch.sqrt(2.0 * m0s) ** mexp
                * math.gamma(1.0 + mexp / 2.0))
    elif method == "dirlik":
        m1 = _trapz(om[:, None] * stress_psd, om)
        m4 = _trapz((om ** 4)[:, None] * stress_psd, om)
        m1s = torch.where(active, m1, one)
        m4s = torch.where(active, m4, one)
        xm = m1s / m0s * torch.sqrt(m2s / m4s)
        alpha2 = m2s / torch.sqrt(m0s * m4s)
        d1 = 2.0 * (xm - alpha2 ** 2) / (1.0 + alpha2 ** 2)
        r = ((alpha2 - xm - d1 ** 2)
             / (1.0 - alpha2 - d1 + d1 ** 2))
        d2 = (1.0 - alpha2 - d1 + d1 ** 2) / (1.0 - r)
        d3 = 1.0 - d1 - d2
        q = 1.25 * (alpha2 - d3 - d2 * r) / d1
        nup = torch.sqrt(m4s / m2s) / (2.0 * math.pi)
        rate = (nup / c * torch.sqrt(m0s) ** mexp
                * (d1 * q ** mexp * math.gamma(1.0 + mexp)
                   + math.sqrt(2.0) ** mexp
                   * math.gamma(1.0 + mexp / 2.0)
                   * (d2 * torch.abs(r) ** mexp + d3)))
    else:
        raise ValueError('fatigue method must be "dirlik" or '
                         '"narrowband"')
    return torch.where(active, (rate * float(life_s)) ** (1.0 / mexp),
                       torch.zeros_like(m0))


def pma_stress_ratios(problem, data, young_e, rho_e, area_e, varspecs,
                      res_var, limit_c, target_beta, ls_idx,
                      n_amv: int = 10, chol=None):
    """(n_ls,) PMA stress ratios at the target-beta design points: the
    RBDO constraint of the Performance Measure Approach.

    For each limit state the Advanced Mean Value fixpoint
    u <- -beta_t grad_u g / |grad_u g| finds the worst point u* on the
    beta_t sphere, and the constraint is |sigma(A, x(u*))| / R(u*) <= 1.
    u* is found on detached areas (Danskin's theorem: the JAX package's
    stop_gradient), so the gradient in the areas is the partial at the
    design point.  All limit states run as one batch of dense solves
    (the JAX package's vmap)."""
    from .reliability import VariableMap

    dtype, dev = data.loads.dtype, data.device
    ls = torch.as_tensor(np.asarray(ls_idx, dtype=np.int64), device=dev)
    n_ls = int(ls.shape[0])
    vmap_ = VariableMap(varspecs, chol, data.nelm, dtype, dev)
    young_e = _per_elem(young_e, data.nelm, dtype, dev)
    rows = torch.arange(n_ls, device=dev)

    def demand_resistance(u, area):
        x = vmap_.physical(u)
        young = vmap_.field(x, "young", young_e)
        scale = vmap_.load_scale(x)
        _, sigma = batched_response(
            data, young, area.expand(n_ls, -1),
            data.loads[None] * scale[:, None])
        demand = torch.abs(sigma)[rows, ls]
        r = (x[:, res_var] if res_var is not None
             else torch.full((n_ls,), float(limit_c), dtype=dtype,
                             device=dev))
        return demand, r

    area_d = area_e.detach()
    u = torch.zeros((n_ls, len(varspecs)), dtype=dtype, device=dev)
    bt = torch.as_tensor(float(target_beta), dtype=dtype, device=dev)
    for _ in range(int(n_amv)):
        with torch.enable_grad():
            leaf = u.detach().requires_grad_()
            demand, r = demand_resistance(leaf, area_d)
            dg, = torch.autograd.grad(torch.sum(1.0 - demand / r), leaf)
        nrm = torch.clamp_min(torch.linalg.vector_norm(dg, dim=1), 1e-30)
        u = -bt * dg / nrm[:, None]
    demand, r = demand_resistance(u.detach(), area_e)
    return demand / r


def optimize_compliance_oc(
    problem: TrussProblem,
    volume: float,
    n_iter: int = 40,
    min_area: float = 1e-6,
    max_area: Optional[float] = None,
    move: float = 0.2,
    eta: float = 0.5,
    tol: float = 1e-3,
    cg_tol: float = 1e-6,
    cg_max_iter: int = 20000,
    initial_areas=None,
    data=None,
    use_pallas: bool = False,
    precond: str = "jacobi",
    device=None,
) -> SizingResult:
    """Large-mesh compliance sizing by optimality criteria on the banded
    DIA / PCG path, past DENSE_DOF_LIMIT.

    The fixpoint A <- clip(A (d_e / Lambda)^eta, move and gauge bounds),
    d_e = sigma_e^2 / 2E at the current solve, Lambda by bisection so that
    sum A L = V exactly.  Each iteration: assemble_dia, one
    ops/dia.dia_cg_solve warm-started at the previous displacement (on a
    card the fused kernels 1-3: kernel 1 once for r0 = b - K x0, kernels 2
    and 3 each 32 ceil(it / 32)), the energies, the compliance f . u, the
    60-step log-space bisection and the clamped update, all as device
    tensor ops; the compliance history, the area changes and the PCG
    residuals stay on the device and are fetched once, after the loop.
    precond "jacobi" or "mg" (ops/mg.py); use_pallas is the JAX package's
    switch for its TPU kernels and has no effect here.  device: where to
    solve when `data` is not given ("cuda" when None).

    Returns a SizingResult: history is the per-iteration compliance;
    converged means the last relative area move fell below `tol` with a
    healthy final PCG solve."""
    del use_pallas
    if volume is None or volume <= 0.0:
        raise ValueError("optimize_compliance_oc needs a positive volume")
    if min_area <= 0.0:
        raise ValueError("min_area must be positive (a zero-area member "
                         "makes K singular)")
    if max_area is not None and max_area <= min_area:
        raise ValueError("max_area must exceed min_area")
    if not (0.0 < move <= 1.0):
        raise ValueError("move must be in (0, 1]")

    from ..ops.dia import assemble_dia, dia_cg_solve, dia_layout
    from ..ops.host import _geometry

    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    nelm = data.nelm
    young_np, area0_np, rho_np = _host_material(problem)
    _, _, inv_len_np, _ = _geometry(problem)
    lengths_np = 1.0 / inv_len_np
    if initial_areas is not None:
        area0_np = np.broadcast_to(
            np.asarray(initial_areas, dtype=float), (nelm,)).copy()
    # Feasible start: project onto the volume, then clamp to the gauge.
    area0_np = area0_np * float(volume) / float(
        np.sum(area0_np * lengths_np))
    area0_np = np.clip(area0_np, min_area, max_area)
    if float(np.sum(np.full(nelm, min_area) * lengths_np)) > volume:
        raise ValueError("volume is below the min_area gauge volume — "
                         "infeasible")

    layout = dia_layout(data.dof_map.cpu().numpy(), problem.ndof)
    young_e = torch.as_tensor(young_np, dtype=dtype, device=dev)
    lengths = torch.as_tensor(lengths_np, dtype=dtype, device=dev)
    f = data.loads
    mask = data.free_mask
    vol_t = torch.as_tensor(float(volume), dtype=dtype, device=dev)

    def oc_iteration(areas, u_prev):
        s = young_e * areas * data.inv_len
        diags = assemble_dia(layout, s, data.gvec)
        u, _, cg_res = dia_cg_solve(
            layout, diags, f, mask, tol=cg_tol, max_iter=cg_max_iter,
            x0=u_prev, precond=precond)
        strain = torch.sum(data.gvec * u[data.dof_map], dim=-1) \
            * data.inv_len
        dens = 0.5 * young_e * strain * strain      # sigma^2 / 2E
        compliance = torch.dot(f, u)
        lower = torch.clamp_min((1.0 - move) * areas, min_area)
        upper = (1.0 + move) * areas
        if max_area is not None:
            upper = torch.clamp_max(upper, max_area)

        def clamped(lam):
            b = (dens / lam) ** eta
            return torch.minimum(torch.maximum(areas * b, lower), upper)

        # Lambda bisection in log space: sum A(Lambda) L is monotone
        # decreasing.  Device tensors throughout: no host read.
        d_max = torch.clamp_min(torch.max(dens), 1e-30)
        lo, hi = 1e-9 * d_max, 1e9 * d_max
        for _ in range(60):
            mid = torch.sqrt(lo * hi)
            too_big = torch.sum(clamped(mid) * lengths) > vol_t
            lo = torch.where(too_big, mid, lo)
            hi = torch.where(too_big, hi, mid)
        new = clamped(torch.sqrt(lo * hi))
        change = torch.max(torch.abs(new - areas)
                           / torch.clamp_min(areas, 1e-30))
        return new, u, compliance, change, cg_res

    areas_d = torch.as_tensor(area0_np, dtype=dtype, device=dev)
    u_d = torch.zeros_like(f)
    hist, changes, resids = [], [], []
    with torch.no_grad():
        for _ in range(int(n_iter)):
            areas_d, u_d, c, ch, res = oc_iteration(areas_d, u_d)
            hist.append(c)
            changes.append(ch)
            resids.append(res.to(dtype))
    # One device fetch for the whole run.
    areas = areas_d.double().cpu().numpy()
    u = u_d.double().cpu().numpy()
    hist, changes, resids = (
        torch.stack(v).double().cpu().numpy() if v else np.zeros(0)
        for v in (hist, changes, resids))

    dof_map, gvec, _, _ = _geometry(problem)
    strain = np.sum(gvec * u[dof_map], axis=-1) * inv_len_np
    sigma = young_np * strain
    return SizingResult(
        areas=areas,
        mass=float(np.sum(rho_np * areas * lengths_np)),
        mass_initial=float(np.sum(rho_np * area0_np * lengths_np)),
        displacements=u, stress=sigma, axial_forces=sigma * areas,
        max_stress_ratio=float("nan"), max_displacement_ratio=float("nan"),
        history=np.asarray(hist, dtype=float),
        converged=bool(changes.size and changes[-1] < tol
                       and resids[-1] <= 2.0 * cg_tol),
        n_iter=int(n_iter))


def _fatigue_spec(fatigue: Dict) -> Dict:
    """The validated fatigue block of optimize_sizing."""
    if fatigue.get("sn") is None:
        raise ValueError('fatigue needs "sn": {"exponent": m, '
                         '"coefficient": C}')
    f_m = float(fatigue["sn"]["exponent"])
    f_c = float(fatigue["sn"]["coefficient"])
    if f_m <= 0.0 or f_c <= 0.0:
        raise ValueError("fatigue S-N exponent and coefficient "
                         "must be positive")
    if fatigue.get("min_life_s") is None:
        raise ValueError('fatigue needs "min_life_s" (the required '
                         'life of every member, seconds)')
    f_life = float(fatigue["min_life_s"])
    if f_life <= 0.0:
        raise ValueError("fatigue min_life_s must be positive")
    f_om = np.asarray(fatigue.get("omegas", ()), dtype=float).reshape(-1)
    if f_om.size < 4 or np.any(np.diff(f_om) <= 0.0) or f_om[0] <= 0.0:
        raise ValueError('fatigue needs an ascending positive '
                         '"omegas" sweep (>= 4 points) bracketing '
                         'the structure\'s modes')
    f_psd = np.broadcast_to(np.asarray(fatigue.get("psd", 1.0), dtype=float),
                            f_om.shape).copy()
    if np.any(f_psd < 0.0) or not np.any(f_psd > 0.0):
        raise ValueError("fatigue psd must be nonnegative with "
                         "some positive band")
    f_damp = fatigue.get("damping", (0.0, 0.0))
    f_method = fatigue.get("method", "dirlik")
    if f_method not in ("dirlik", "narrowband"):
        raise ValueError('fatigue method must be "dirlik" or '
                         '"narrowband"')
    return {"m": f_m, "c": f_c, "life": f_life, "om": f_om, "psd": f_psd,
            "alpha": float(f_damp[0]), "beta": float(f_damp[1]),
            "method": f_method}


def _rbdo_spec(problem: TrussProblem, reliability: Dict) -> Dict:
    """The validated RBDO block of optimize_sizing."""
    from .reliability import _nataf_cholesky, _parse_variables

    if reliability.get("target_beta") is None:
        raise ValueError('reliability (RBDO) needs "target_beta"')
    beta_t = float(reliability["target_beta"])
    if beta_t <= 0.0:
        raise ValueError("target_beta must be positive")
    nelm = problem.nelm
    r_vars = _parse_variables(reliability.get("variables"), nelm)
    for v in r_vars:
        if v["kind"] in ("area", "density"):
            raise ValueError(
                'RBDO variables must be young / load_scale / '
                'resistance ("area" is the design vector; '
                '"density" does not enter the static limit state)')
    r_names = [v["name"] for v in r_vars]
    r_ls = dict(reliability.get("limit_state") or {})
    if r_ls.get("type", "stress") != "stress":
        raise ValueError("RBDO supports the stress limit state")
    r_res = None
    r_limit = None
    if r_ls.get("variable") is not None:
        rn = r_ls["variable"]
        if rn not in r_names:
            raise ValueError(f"RBDO resistance variable {rn!r} is "
                             f"not defined")
        r_res = r_names.index(rn)
        if r_vars[r_res]["kind"] != "resistance":
            raise ValueError(f'{rn!r} must have kind "resistance"')
    elif r_ls.get("limit") is not None:
        r_limit = float(r_ls["limit"])
    else:
        raise ValueError('RBDO limit_state needs "limit" or "variable"')
    r_elems = r_ls.get("elements")
    r_idx = (np.arange(nelm) if r_elems is None
             else np.asarray(r_elems, dtype=int).reshape(-1))
    if np.any(r_idx < 0) or np.any(r_idx >= nelm):
        raise ValueError("RBDO limit-state elements out of range")
    r_chol = _nataf_cholesky(r_vars, reliability.get("correlation"))
    return {"varspecs": r_vars, "res_var": r_res, "limit_c": r_limit,
            "beta_t": beta_t, "ls_idx": r_idx, "chol": r_chol}


def optimize_sizing(
    problem: TrussProblem,
    objective: str = "mass",
    stress_limit: Optional[float] = None,
    buckling_shape_factor: Optional[float] = None,
    displacement_limit: Optional[float] = None,
    probe_dofs=None,
    min_frequency_hz: Optional[float] = None,
    fatigue: Optional[Dict] = None,
    reliability: Optional[Dict] = None,
    volume: Optional[float] = None,
    load_cases=None,
    case_weights=None,
    min_area: float = 1e-6,
    max_area: Optional[float] = None,
    initial_areas=None,
    n_iter: int = 300,
    outer_rounds: int = 4,
    penalty: float = 10.0,
    learning_rate: float = 0.05,
    polish: bool = True,
    data=None,
    device=None,
) -> SizingResult:
    """Gradient-based sizing: ADAM on box-parameterized areas with the
    Rockafellar augmented Lagrangian mu max(0, g + lambda / 2 mu)^2,
    multiplier updates between the `outer_rounds`, a fresh Adam state and
    a halved learning rate each round (the JAX package's contract and
    docstring: objective "mass" with stress / buckling / displacement /
    frequency / fatigue / RBDO constraints, or "compliance" at a fixed
    `volume`; `load_cases` (C, ndof) envelopes with `case_weights`).
    With `polish` the float64 host scales members up until the limits
    hold; the final authority recomputes the frequency, the fatigue lives
    (solvers/fatigue.spectral_fatigue) and the FORM betas
    (solvers/reliability.form_reliability).  device: where the traced
    loop runs when `data` is not given ("cuda" when None)."""
    if objective not in ("mass", "compliance"):
        raise ValueError('objective must be "mass" or "compliance"')
    if objective == "mass" and stress_limit is None \
            and displacement_limit is None and min_frequency_hz is None \
            and fatigue is None and reliability is None:
        raise ValueError("mass minimization needs stress_limit, "
                         "displacement_limit, min_frequency_hz, a "
                         "fatigue life floor and/or a reliability "
                         "target (otherwise the optimum is the gauge "
                         "minimum everywhere)")
    if min_frequency_hz is not None and min_frequency_hz <= 0.0:
        raise ValueError("min_frequency_hz must be positive")
    if buckling_shape_factor is not None:
        if buckling_shape_factor <= 0.0:
            raise ValueError("buckling_shape_factor must be positive")
        if stress_limit is None:
            raise ValueError("buckling_shape_factor needs stress_limit "
                             "(the tension side still needs an "
                             "allowable)")
    if objective == "compliance" and volume is None:
        raise ValueError("compliance minimization needs the volume "
                         "budget (volume=...)")
    if stress_limit is not None and stress_limit <= 0.0:
        raise ValueError("stress_limit must be positive")
    if displacement_limit is not None and displacement_limit <= 0.0:
        raise ValueError("displacement_limit must be positive")
    if min_area <= 0.0:
        raise ValueError("min_area must be positive (a zero-area member "
                         "makes K singular)")
    if max_area is not None and max_area <= min_area:
        raise ValueError("max_area must exceed min_area")
    fat = None if fatigue is None else _fatigue_spec(fatigue)
    rel = None if reliability is None else _rbdo_spec(problem, reliability)

    from ..ops.host import _geometry

    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    nelm = data.nelm
    young_np, area0_np, rho_np = _host_material(problem)
    _, _, inv_len_np, _ = _geometry(problem)
    lengths_np = 1.0 / inv_len_np
    if initial_areas is not None:
        area0_np = np.broadcast_to(
            np.asarray(initial_areas, dtype=float), (nelm,)).copy()
    area0_np = np.clip(area0_np, min_area * (1.0 + 1e-9),
                       None if max_area is None
                       else max_area * (1.0 - 1e-9))

    def dev_t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype,
                               device=dev)

    young_e, rho_e, lengths = dev_t(young_np), dev_t(rho_np), \
        dev_t(lengths_np)
    probe_np = (problem.free_fixed()[0] if probe_dofs is None
                else np.asarray(probe_dofs, dtype=int).reshape(-1))
    probe = torch.as_tensor(probe_np, dtype=torch.int64, device=dev)

    # Box parameterization: bounds hold at every iterate.
    if max_area is None:
        t0 = np.log(area0_np - min_area)

        def areas_of(t):
            return min_area + torch.exp(t)
    else:
        p = (area0_np - min_area) / (max_area - min_area)
        p = np.clip(p, 1e-9, 1.0 - 1e-9)
        t0 = np.log(p / (1.0 - p))

        def areas_of(t):
            return min_area + (max_area - min_area) * torch.sigmoid(t)

    cases_np = _load_cases_array(problem, load_cases)
    n_cases = 1 if cases_np is None else cases_np.shape[0]
    loads_dev = None if cases_np is None else dev_t(cases_np)
    if case_weights is not None and cases_np is None:
        raise ValueError("case_weights needs load_cases")
    w_np = (np.ones(n_cases) if case_weights is None
            else np.asarray(case_weights, dtype=float).reshape(-1))
    if w_np.shape != (n_cases,):
        raise ValueError(f"case_weights must have one weight per case "
                         f"({n_cases}), got {w_np.shape}")
    if np.any(w_np < 0.0) or not np.any(w_np > 0.0):
        raise ValueError("case_weights must be nonnegative with at "
                         "least one positive entry")
    weights = dev_t(w_np)

    mass0 = float(np.sum(rho_np * area0_np * lengths_np))
    # Reference scales keep the loss dimensionless across unit systems.
    compliance0 = None
    if objective == "compliance":
        a_proj0 = area0_np * float(volume) / float(
            np.sum(area0_np * lengths_np))
        u0, _ = _host_area_solve(problem, a_proj0, loads=cases_np)
        f0 = (np.asarray(problem.loads, dtype=float) if cases_np is None
              else cases_np)
        compliance0 = max(abs(float(np.sum(w_np * np.atleast_1d(
            np.sum(np.atleast_2d(f0 * u0), axis=-1))))), 1e-30)

    lam_req = (None if min_frequency_hz is None
               else float((2.0 * np.pi * min_frequency_hz) ** 2))
    n_con = n_cases * ((nelm if stress_limit is not None else 0)
                       + (nelm if buckling_shape_factor is not None
                          else 0)
                       + (int(probe_np.size)
                          if displacement_limit is not None else 0)) \
        + (1 if lam_req is not None else 0) \
        + (nelm if fat is not None else 0) \
        + (int(rel["ls_idx"].size) if rel is not None else 0)
    pi2c = (None if buckling_shape_factor is None
            else np.pi ** 2 * float(buckling_shape_factor))

    def fatigue_ratio_of(a):
        """r_e = (D_e T_req)^(1/m) at areas `a`."""
        h2 = member_force_frf_sq(data, young_e, a, rho_e, fat["om"],
                                 fat["alpha"], fat["beta"])
        s_sigma = h2 * dev_t(fat["psd"])[:, None] / (a * a)
        return fatigue_life_ratio(fat["om"], s_sigma, fat["m"], fat["c"],
                                  fat["life"], method=fat["method"])

    def rbdo_ratio_of(a):
        """PMA stress ratios at the target-beta design points."""
        return pma_stress_ratios(
            problem, data, young_e, rho_e, a, rel["varspecs"],
            rel["res_var"], rel["limit_c"], rel["beta_t"], rel["ls_idx"],
            chol=rel["chol"])

    def objective_and_constraints(t):
        """(objective, g) with g the stacked constraint values, g <= 0
        feasible, in ratio units."""
        a = areas_of(t)
        if objective == "compliance":
            a = a * (volume / torch.sum(a * lengths))
        u, sigma, _, mass = static_response_elem(
            problem, a, data=data, young_e=young_e, rho_e=rho_e,
            loads=loads_dev)
        if objective == "compliance":
            f = data.loads if loads_dev is None else loads_dev
            obj = torch.sum(weights * torch.atleast_1d(torch.sum(
                torch.atleast_2d(f * u), dim=-1))) / compliance0
        else:
            obj = mass / mass0
        gs = []
        if stress_limit is not None:
            gs.append((torch.abs(sigma) / stress_limit - 1.0).reshape(-1))
        if pi2c is not None:
            sig_cr = pi2c * young_e * a * data.inv_len ** 2
            gs.append(((-sigma) / sig_cr - 1.0).reshape(-1))
        if displacement_limit is not None:
            gs.append((torch.abs(u[..., probe]) / displacement_limit
                       - 1.0).reshape(-1))
        if lam_req is not None:
            from .modal_inverse import modal_observables_elem

            lam, _ = modal_observables_elem(problem, young_e, a, rho_e, 1,
                                            data=data)
            gs.append((1.0 - lam[0] / lam_req).reshape(1))
        if fat is not None:
            gs.append((fatigue_ratio_of(a) - 1.0).reshape(-1))
        if rel is not None:
            gs.append((rbdo_ratio_of(a) - 1.0).reshape(-1))
        g = torch.cat(gs) if gs else torch.zeros(0, dtype=dtype, device=dev)
        return obj, g

    def loss_fn(t, lam, mu):
        obj, g = objective_and_constraints(t)
        if n_con == 0:
            return obj
        # Rockafellar augmented Lagrangian (the constant -lam^2 / 4 mu
        # dropped: it does not move the gradient).
        return obj + mu * torch.sum(torch.clamp_min(
            g + lam / (2.0 * mu), 0.0) ** 2)

    t = dev_t(t0)
    lam = torch.zeros(n_con, dtype=dtype, device=dev)
    mu = torch.as_tensor(float(penalty), dtype=dtype, device=dev)
    hist = []
    for r in range(int(outer_rounds)):
        # The landscape changed (new lambda, mu, lr): fresh Adam state.
        lr = float(np.asarray(learning_rate * 0.5 ** r, dtype=(
            np.float64 if dtype == _F64 else np.float32)))
        opt = Adam(t)
        for _ in range(int(n_iter)):
            leaf = t.detach().requires_grad_()
            loss = loss_fn(leaf, lam, mu)
            grad, = torch.autograd.grad(loss, leaf)
            with torch.no_grad():
                t = t - lr * opt.direction(grad)
            hist.append(loss.detach())    # device scalar: no host read
        if n_con:
            with torch.no_grad():
                _, g = objective_and_constraints(t)
                lam = torch.clamp_min(lam + 2.0 * mu * g, 0.0)
            mu = 2.0 * mu          # mild ramp: lambda does the exact work
    # One device fetch.
    hist = (torch.stack(hist).double().cpu().numpy() if hist
            else np.zeros(0))
    with torch.no_grad():
        areas = areas_of(t).double().cpu().numpy()
    if not np.all(np.isfinite(areas)):
        # A NaN design (a document that lost its supports makes K
        # singular) must fail loudly instead of reporting success.
        raise ValueError("sizing diverged to non-finite areas — check "
                         "supports (fixed_dofs), units and "
                         "learning_rate")
    if objective == "compliance":
        areas = areas * float(volume) / float(np.sum(areas * lengths_np))

    def device_max(fn, a_np) -> float:
        with torch.no_grad():
            return float(torch.max(fn(dev_t(a_np))).double().cpu())

    polish_viol = None
    if polish and objective != "compliance" \
            and (stress_limit is not None or fat is not None
                 or rel is not None):
        # Feasibility polish (float64 host): stress and buckling scale per
        # member (|sigma| ~ 1/A at fixed force), the fatigue and PMA
        # ratios uniformly (under A -> sA with structural mass the
        # member-force FRFs are invariant and every ratio falls as 1/s);
        # the best evaluated iterate is kept.
        best_viol, best_areas = float("inf"), areas.copy()
        for it_polish in range(21):
            ratio = np.zeros(nelm)
            if stress_limit is not None:
                _, sigma = _host_area_solve(problem, areas, loads=cases_np)
                ratio = np.abs(sigma) / stress_limit
                if pi2c is not None:
                    # The buckling ratio falls as 1/A^2 at fixed force:
                    # the corrective scale is its square root.
                    sig_cr = pi2c * young_np * areas * inv_len_np ** 2
                    rb = np.maximum(-sigma, 0.0) / sig_cr
                    ratio = np.maximum(ratio, np.sqrt(rb))
                if ratio.ndim == 2:
                    ratio = np.max(ratio, axis=0)
            fat_viol = (device_max(fatigue_ratio_of, areas)
                        if fat is not None else 0.0)
            rel_viol = (device_max(rbdo_ratio_of, areas)
                        if rel is not None else 0.0)
            viol = max(float(np.max(ratio)), fat_viol, rel_viol)
            if viol < best_viol:
                best_viol, best_areas = viol, areas.copy()
            if viol <= 1.0 + 1e-9 or it_polish == 20:
                break
            scale = np.maximum(ratio, 1.0)
            if fat is not None:
                scale = np.maximum(scale, fat_viol)
            if rel is not None:
                scale = np.maximum(scale, rel_viol)
            if max_area is not None:
                areas = np.minimum(areas * scale, max_area)
                if np.all((areas >= max_area - 1e-15) | (scale <= 1.0)):
                    break          # bound-limited: cannot polish further
            else:
                areas = areas * scale
        areas = best_areas
        polish_viol = best_viol

    u, sigma = _host_area_solve(problem, areas, loads=cases_np)
    env = _signed_envelope(sigma)
    abs_sigma = float(np.max(np.abs(sigma))) if nelm else 0.0
    buck_ratio = float("nan")
    if pi2c is not None:
        sig_cr = pi2c * young_np * areas * inv_len_np ** 2
        buck_ratio = float(np.max(np.maximum(-sigma, 0.0) / sig_cr))
    f1_hz = float("nan")
    if lam_req is not None:
        from .modal_inverse import modal_observables_elem

        with torch.no_grad():
            lam1 = float(modal_observables_elem(
                problem, young_e, dev_t(areas), rho_e, 1,
                data=data)[0][0].double().cpu())
        f1_hz = float(np.sqrt(max(lam1, 0.0)) / (2.0 * np.pi))
    fat_life = None
    min_life = float("nan")
    if fat is not None:
        # Lives of the final areas through the float64 host authority;
        # only the FRF sweep runs on the device.
        from .fatigue import spectral_fatigue

        with torch.no_grad():
            h2 = member_force_frf_sq(
                data, young_e, dev_t(areas), rho_e, fat["om"],
                fat["alpha"], fat["beta"]).double().cpu().numpy()
        s_sigma = h2 * fat["psd"][:, None] / (areas ** 2)[None, :]
        # Members the load pattern never stresses live forever.
        active = np.trapezoid(s_sigma, fat["om"], axis=0) > 0.0
        fat_life = np.full(nelm, np.inf)
        if np.any(active):
            sf = spectral_fatigue(fat["om"], s_sigma[:, active], fat["m"],
                                  fat["c"], method=fat["method"])
            fat_life[active] = np.atleast_1d(sf.life)
        min_life = float(np.min(fat_life)) if fat_life.size else float(
            "inf")
    rel_beta = None
    min_rel_beta = float("nan")
    if rel is not None:
        # Betas of the final areas by the full HL-RF search.
        from .reliability import form_reliability

        rres = form_reliability(
            problem, reliability["variables"],
            dict(reliability.get("limit_state") or {}),
            correlation=reliability.get("correlation"), data=data,
            areas=areas)
        rel_beta = np.asarray(rres.beta, dtype=float)
        min_rel_beta = float(np.min(rel_beta)) if rel_beta.size \
            else float("inf")
    return SizingResult(
        areas=areas, mass=_host_mass(problem, areas), mass_initial=mass0,
        displacements=u, stress=env, axial_forces=env * areas,
        max_stress_ratio=(abs_sigma / stress_limit
                          if stress_limit is not None else float("nan")),
        max_displacement_ratio=(
            float(np.max(np.abs(u[..., probe_np])) / displacement_limit)
            if displacement_limit is not None else float("nan")),
        history=np.asarray(hist, dtype=float),
        converged=bool(polish_viol is None or polish_viol <= 1.0 + 1e-6),
        n_iter=len(hist), max_buckling_ratio=buck_ratio,
        fundamental_frequency_hz=f1_hz, fatigue_life_s=fat_life,
        min_fatigue_life_s=min_life, reliability_beta=rel_beta,
        min_reliability_beta=min_rel_beta)


__all__ = ["SizingResult", "fully_stressed_design", "static_response_elem",
           "member_force_frf_sq", "fatigue_life_ratio", "pma_stress_ratios",
           "optimize_compliance_oc", "optimize_sizing", "batched_response",
           "masked_stiffness", "density_values_host"]
