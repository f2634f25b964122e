"""Response-spectrum analysis: peak seismic response by modal combination
(counterpart of pinn_fem_tpu/solvers/spectrum.py).

The standard seismic design method, and a consumer of the modal
machinery (solvers/modal.py: dense float64 on the caller's device, or
the banded subspace iteration on kernels 1-3 above the dense limit): for
ground acceleration in direction d with design spectrum Sa(omega),

    participation  Gamma_j = phi_j^T M r          (phi M-orthonormal)
    peak modal     u_j     = Gamma_j phi_j Sa(omega_j) / omega_j^2
    combination    SRSS    = sqrt(sum_j u_j^2)
                   CQC     = sqrt(sum_ij rho_ij u_i u_j)   (Der Kiureghian
                             correlation; reduces to SRSS for
                             well-separated modes)

where r is the influence vector (unit rigid-body motion of the free DOFs
along d).  Effective modal masses m_j* = Gamma_j^2 report how much of the
structure's mass the retained modes capture — the standard completeness
check (codes require ~90%).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np

import torch

from ..models.problem import TrussProblem
from ..ops.mass import lumped_mass


class SpectrumResult(NamedTuple):
    displacements: np.ndarray     # (ndof,) peak |u| (combined, >= 0)
    modal_peaks: np.ndarray       # (n_modes, ndof) signed per-mode peaks
    omegas: np.ndarray            # (n_modes,)
    participation: np.ndarray     # (n_modes,) Gamma_j
    effective_mass: np.ndarray    # (n_modes,) Gamma_j^2
    mass_fraction: float          # sum(effective_mass) / total direction mass
    combination: str
    modal_ok: bool = True         # the underlying modal solve's trust flag
    # (nelm,) peak |N| per member, combined PER RESPONSE QUANTITY (the
    # textbook rule: modal member forces are combined directly — the
    # force of the combined displacement field would be wrong, since
    # SRSS/CQC destroys the modal sign structure forces depend on).
    axial_forces: np.ndarray = None
    modal_axial_forces: np.ndarray = None   # (n_modes, nelm) signed


def _cqc_rho(omegas: np.ndarray, zeta: float) -> np.ndarray:
    """Der Kiureghian modal correlation coefficients (equal damping).

    zeta = 0 makes every off-diagonal term vanish and the diagonal 0/0 —
    CQC degenerates exactly to SRSS, so return identity instead of NaN."""
    if zeta <= 0.0:
        return np.eye(omegas.size)
    r = omegas[None, :] / omegas[:, None]
    num = 8.0 * zeta**2 * (1.0 + r) * r**1.5
    den = (1.0 - r**2) ** 2 + 4.0 * zeta**2 * r * (1.0 + r) ** 2
    return num / den


def response_spectrum(
    problem: TrussProblem,
    spectrum: Union[Callable[[np.ndarray], np.ndarray], float],
    direction: Optional[Sequence[float]] = None,
    n_modes: int = 6,
    combination: str = "srss",
    damping_ratio: float = 0.05,
    data=None,
    prestress_u=None,
    device=None,
) -> SpectrumResult:
    """Peak response to a ground-acceleration design spectrum.

    Args:
        spectrum: Sa(omega) callable (rad/s -> acceleration), or a
            constant Sa.
        direction: excitation direction (len = problem.dimension;
            default: first axis).
        combination: "srss" or "cqc".
        damping_ratio: modal damping for the CQC correlation.
    The port's own: device, where the modal solve runs when `data` is not
    given ("cuda" when None).
    """
    from . import newton
    from .modal import modal_analysis

    # Small problems take the float64 dense tier (modal_analysis routes
    # there) and the float64 host mass; the others the device's.
    host = data is None and problem.ndof <= newton.DENSE_DOF_LIMIT
    if not host:
        data = data if data is not None else problem.to_device(device)
    dim = problem.dimension
    d = np.zeros(dim)
    if direction is None:
        d[0] = 1.0
    else:
        d[:] = np.asarray(direction, dtype=float)
        n = np.linalg.norm(d)
        if n == 0:
            raise ValueError("direction must be nonzero")
        d /= n

    free_idx, _ = problem.free_fixed()
    n_modes = min(n_modes, free_idx.size)
    res = modal_analysis(problem, n_modes=n_modes,
                         data=None if host else data,
                         prestress_u=prestress_u, device=device)
    phi = res.shapes                                  # (ndof, J), M-orthonormal
    omegas = np.maximum(res.omegas, 1e-30)
    # Mechanism guard: a (near-)zero-frequency mode makes the peak
    # Sa/omega^2 response unbounded — the combination would SILENTLY
    # return astronomically large garbage (measured 1e59 on a lone
    # diagonal truss bar, whose transverse DOF carries no stiffness).
    # Relative-to-omega_max tests cannot see it (with n_modes = 1 the
    # mechanism IS the only mode), so the scale is the Gershgorin bound
    # omega_bound = 2 / dt_crit (stable_dt, host or device path):
    # mechanisms sit at the eigensolve's noise floor, lambda ~
    # eps * lambda_bound, decades below any genuine structural mode.
    from .dynamics import stable_dt

    lam_bound = (2.0 / stable_dt(problem, data=None if host else data,
                                 safety=1.0, device=device)) ** 2
    if omegas.size and float(omegas.min()) ** 2 < 1e-6 * lam_bound:
        raise ValueError(
            "the structure carries a (near-)zero-frequency mechanism "
            f"mode (lambda_min/lambda_bound = "
            f"{omegas.min() ** 2 / lam_bound:.1e}); its Sa/omega^2 "
            "peak response is unbounded — brace the mechanism (a lone "
            "diagonal truss bar has no transverse stiffness)")

    if host:
        from ..ops.host import host_lumped_mass, host_masks

        m = host_lumped_mass(problem)
        mask = host_masks(problem)
    else:
        # One fetch of the mass and the mask.
        m, mask = torch.stack([
            lumped_mass(data, problem.material.to(data.device)),
            data.free_mask]).cpu().numpy()
    # Influence vector: unit ground motion along d on the FREE DOFs.
    r = np.tile(d, problem.ndof // dim) * mask

    gamma = phi.T @ (m * r)                           # (J,)
    sa = (spectrum(omegas) if callable(spectrum)
          else float(spectrum) * np.ones_like(omegas))
    peaks = (gamma * sa / omegas**2)[:, None] * phi.T  # (J, ndof)

    if combination == "srss":
        combined = np.sqrt(np.sum(peaks**2, axis=0))
    elif combination == "cqc":
        rho = _cqc_rho(omegas, float(damping_ratio))
        combined = np.sqrt(np.maximum(
            np.einsum("ij,ik,jk->k", rho, peaks, peaks), 0.0))
    else:
        raise ValueError('combination must be "srss" or "cqc"')

    # Member forces: combine the MODAL member forces (linear in each
    # mode's peak vector), never the force of the combined displacement.
    from ..ops.host import host_axial_forces

    n_modal = np.stack([host_axial_forces(problem, peaks[j])
                        for j in range(peaks.shape[0])]) \
        if peaks.shape[0] else np.zeros((0, problem.nelm))
    if combination == "srss":
        n_comb = np.sqrt(np.sum(n_modal**2, axis=0))
    else:
        n_comb = np.sqrt(np.maximum(
            np.einsum("ij,ik,jk->k", rho, n_modal, n_modal), 0.0))

    total_dir_mass = float(np.sum(m * r * r))
    eff = gamma**2
    return SpectrumResult(
        displacements=combined, modal_peaks=peaks, omegas=omegas,
        participation=gamma, effective_mass=eff,
        mass_fraction=float(eff.sum() / max(total_dir_mass, 1e-30)),
        combination=combination,
        modal_ok=bool(res.ok),
        axial_forces=n_comb,
        modal_axial_forces=n_modal,
    )


class SpectrumCurve(NamedTuple):
    """Response spectra of a ground-acceleration record."""
    omegas: np.ndarray        # (n_w,) rad/s
    sd: np.ndarray            # (n_w,) peak relative displacement
    psv: np.ndarray           # (n_w,) pseudo-velocity  omega * Sd
    psa: np.ndarray           # (n_w,) pseudo-acceleration  omega^2 * Sd
    sa_abs: np.ndarray        # (n_w,) TRUE peak absolute acceleration
    damping_ratio: float
    dt: float


def spectrum_from_history(accel, dt: float, omegas,
                          damping_ratio: float = 0.05) -> SpectrumCurve:
    """Response spectra FROM a ground-motion record — the generation
    side of the spectrum workflow (an accelerogram in, the design curve
    out), so a measured or synthetic quake can drive the modal
    combination above with NO interpolation: `response_spectrum` takes
    Sa as a callable and this integrates exactly at the modal
    frequencies it asks for.

    One unit-mass SDOF per omega, u'' + 2 zeta w u' + w^2 u = -a_g(t),
    all integrated SIMULTANEOUSLY by Newmark average acceleration
    (unconditionally stable: a coarse record never forces sub-stepping
    of the stiff oscillators; Chopra's standard coefficient form),
    tracking running peaks of |u| (Sd) and |u'' + a_g| (true absolute
    Sa).  Pseudo-spectra are PSv = w Sd, PSa = w^2 Sd.

    Float64 numpy on the host, as in the JAX package: the record is
    plain data and the sweep a few thousand vectorized steps over the
    (n_w,) oscillators, too small to pay for device launches.
    """
    a_g = np.asarray(accel, dtype=float).reshape(-1)
    w = np.asarray(omegas, dtype=float).reshape(-1)
    if np.any(w <= 0.0):
        raise ValueError("spectrum omegas must be positive")
    if a_g.size < 2:
        raise ValueError("the acceleration record needs >= 2 samples")
    z = float(damping_ratio)
    dt = float(dt)

    c = 2.0 * z * w
    k = w * w
    beta, gamma = 0.25, 0.5                   # average acceleration
    a0 = 1.0 / (beta * dt * dt)
    a1 = gamma / (beta * dt)
    a2 = 1.0 / (beta * dt)
    a3 = 1.0 / (2.0 * beta) - 1.0
    a4 = gamma / beta - 1.0
    a5 = dt * (gamma / (2.0 * beta) - 1.0)
    khat = k + a0 + a1 * c

    u = np.zeros_like(w)
    v = np.zeros_like(w)
    acc = np.full_like(w, -a_g[0])            # equilibrium at t=0
    sd = np.zeros_like(w)
    sa_abs = np.abs(acc + a_g[0]) * np.ones_like(w)
    for i in range(1, a_g.size):
        phat = (-a_g[i]
                + (a0 * u + a2 * v + a3 * acc)
                + c * (a1 * u + a4 * v + a5 * acc))
        u_new = phat / khat
        v = a1 * (u_new - u) - a4 * v - a5 * acc
        # a_{i+1} from the equation of motion directly (exact; avoids
        # compounding the kinematic update's rounding):
        acc = -a_g[i] - c * v - k * u_new
        u = u_new
        sd = np.maximum(sd, np.abs(u))
        sa_abs = np.maximum(sa_abs, np.abs(acc + a_g[i]))
    return SpectrumCurve(
        omegas=w, sd=sd, psv=w * sd, psa=k * sd, sa_abs=sa_abs,
        damping_ratio=z, dt=dt)


class DirectionalSpectrumResult(NamedTuple):
    """Multi-direction combination (codes: SRSS or the 100-30 rule)."""
    displacements: np.ndarray     # (ndof,) combined over directions
    axial_forces: np.ndarray      # (nelm,) combined over directions
    rule: str
    per_direction: tuple          # the underlying SpectrumResult per dir
    modal_ok: bool


def directional_combination(
    problem: TrussProblem,
    spectrum,
    directions,
    rule: str = "srss",
    **kwargs,
) -> DirectionalSpectrumResult:
    """Seismic combination over SEVERAL excitation directions.

    Codes require the orthogonal components combined — either SRSS over
    directions, R = sqrt(Σ_d R_d²), or the 100-30 percent rule,
    R = max_i (R_i + 0.3 Σ_{j≠i} R_j).  Both are applied PER RESPONSE
    QUANTITY (displacements and member forces separately — same
    principle as the modal combination itself).  Each direction runs
    the full modal combination (`response_spectrum`, kwargs forwarded:
    n_modes / combination / damping_ratio / prestress_u...)."""
    dirs = [np.asarray(d, dtype=float) for d in directions]
    if len(dirs) < 2:
        raise ValueError("directional combination needs >= 2 directions "
                         "(use response_spectrum for one)")
    results = [response_spectrum(problem, spectrum, direction=d, **kwargs)
               for d in dirs]
    u = np.stack([r.displacements for r in results])     # (D, ndof)
    n = np.stack([r.axial_forces for r in results])      # (D, nelm)
    if rule == "srss":
        u_c = np.sqrt(np.sum(u * u, axis=0))
        n_c = np.sqrt(np.sum(n * n, axis=0))
    elif rule in ("100-30", "100_30"):
        def pct(q):
            total = np.sum(q, axis=0)
            # R_i + 0.3 (ΣR - R_i), maximized over the leading direction.
            return np.max(0.7 * q + 0.3 * total[None, :], axis=0)

        u_c, n_c = pct(u), pct(n)
    else:
        raise ValueError('directional rule must be "srss" or "100-30"')
    return DirectionalSpectrumResult(
        displacements=u_c, axial_forces=n_c, rule=rule,
        per_direction=tuple(results),
        modal_ok=all(r.modal_ok for r in results))
