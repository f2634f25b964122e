"""Response-spectrum and random-vibration analysis for the continuum and
frame families (counterpart of pinn_fem_tpu/solvers/continuum_spectrum.py):
the truss seismic and stochastic machinery on the consistent-mass modal
data of the plane, solid, frame, space-frame, plate and shell families.

Response spectrum (one excitation direction d, design spectrum Sa(omega)):

    Gamma_j = phi_j^T M r        (phi M-orthonormal, r the unit rigid
                                  motion along d on the free DOFs)
    peak     u_j = Gamma_j phi_j Sa(omega_j) / omega_j^2
    combined SRSS or CQC (Der Kiureghian rho, equal damping: the truss
    tier's solvers/spectrum._cqc_rho).

Stresses follow the per-quantity rule: each component is combined across
modes, and the reported von Mises (frames: the extreme-fiber |N|/A +
|M|/S) is computed from the combined components, a design-code estimate,
not a bound.

Random vibration: S_u(omega) = |H(omega)|^2 S_p(omega) on the families'
own dense FRF sweeps, the RMS by the trapezoid over the omega grid (which
must resolve the half-power bandwidths); zero damping is refused (the
variance integral diverges).  Spectral fatigue: complex stress FRFs, the
Preumont equivalent von Mises PSD S_eq = sigma^H Q sigma S_p (frames: the
governing of four extreme fibers), through solvers/fatigue.spectral_fatigue.

The family solves (modal, the consistent M, the stress recovery, the
Gershgorin or exact eigenvalue bound, the harmonic and stress-FRF sweeps)
are float64 on the caller's device, the card by default; the combination
algebra on (J, ndof) and (n_freq, n_elm) arrays is numpy, as in the JAX
package.  An undamped stress FRF at a natural frequency is a singular
system: it gives inf or a huge finite value with no diagnostic, as the
JAX module does (ROADMAP fault 3.2).  Shells combine the six centroid
resultants [N, M] and report the governing extreme-fiber von Mises of the
combined ones; their spectral fatigue runs per extreme fiber z = +-t/2
(`shell_fiber_stress_frf`) and keeps the governing one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.runtime import resolve_device
from .spectrum import _cqc_rho

class _Family(NamedTuple):
    dim: int             # spatial dimension of the excitation
    modal: object        # (problem, n_modes) -> (omegas, shapes (J, ndof))
    mass: object         # (problem) -> dense consistent M, a tensor
    stresses: object     # (problem, u) -> (m, q) signed modal quantities
    vm: object           # (problem, comb (m, q)) -> (m,) governing stress
    influence: object    # (problem, d) -> unmasked rigid-motion vector
    lam_bound: object    # (problem) -> upper bound on lambda
    harmonic: object     # (problem, omegas, damping, probe) -> result


def _unpack_modal(res):
    return np.asarray(res.omegas), np.asarray(res.mode_shapes)


def _tile_influence(dim):
    def influence(p, d):
        return np.tile(d, p.ndof // dim)
    return influence


def _on(dev, u) -> torch.Tensor:
    return torch.as_tensor(np.asarray(u, dtype=np.float64), device=dev)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(float)


def _translations(p, d):
    """The rigid translation d on the three translational DOFs of each
    six-DOF node (space frames, shells)."""
    r = np.zeros(p.ndof)
    for ax in range(3):
        r[ax::6] = d[ax]
    return r


def _family_of(problem, device) -> _Family:
    """The family callables of `problem`, each float64 on `device` (a
    torch.device)."""
    from ..models.frame import FrameProblem
    from ..models.frame3d import SpaceFrameProblem
    from ..models.plane import PlaneProblem
    from ..models.plate import PlateProblem
    from ..models.solid import SolidProblem

    dev = device
    if isinstance(problem, PlaneProblem):
        from ..models import plane as P

        return _Family(
            dim=2,
            modal=lambda p, n: _unpack_modal(P.plane_modal(p, n,
                                                           device=dev)),
            mass=lambda p: P.plane_matrices(p, device=dev)[1],
            stresses=lambda p, u: P.recover_stresses(p, _on(dev, u))[0],
            vm=lambda p, s: _vm_of_components(p, 2, s),
            influence=_tile_influence(2),
            lam_bound=lambda p: (2.0 / P.plane_stable_dt(
                p, safety=1.0, device=dev)) ** 2,
            harmonic=lambda p, om, damping, probe_dofs: P.plane_harmonic(
                p, om, damping=damping, probe_dofs=probe_dofs, device=dev))
    if isinstance(problem, SolidProblem):
        from ..models import solid as S

        return _Family(
            dim=3,
            modal=lambda p, n: _unpack_modal(S.solid_modal(p, n,
                                                           device=dev)),
            mass=lambda p: S.solid_matrices(p, device=dev)[1],
            stresses=lambda p, u: S.recover_stresses3(p, _on(dev, u))[0],
            vm=lambda p, s: _vm_of_components(p, 3, s),
            influence=_tile_influence(3),
            lam_bound=lambda p: (2.0 / S.solid_stable_dt(
                p, safety=1.0, device=dev)) ** 2,
            harmonic=lambda p, om, damping, probe_dofs: S.solid_harmonic(
                p, om, damping=damping, probe_dofs=probe_dofs, device=dev))
    if isinstance(problem, FrameProblem):
        from ..models import frame as F

        def frame_end_forces(p, u):
            # Local member end forces [N1, V1, M1, N2, V2, M2] of a modal
            # state (no member loads in a mode shape).
            kl, t = F._local_stiffness(p, dev)
            dm = torch.as_tensor(p.dof_map(), dtype=torch.int64,
                                 device=dev)
            u_loc = torch.einsum("mij,mj->mi", t, _on(dev, u)[dm])
            return _np(torch.einsum("mij,mj->mi", kl, u_loc))

        def frame_stress(p, comb):
            # Extreme-fiber |N|/A + max-end |M|/S of the combined end
            # forces; axial only without a section_modulus.
            sig = np.maximum(comb[:, 0], comb[:, 3]) / p.area
            if p.section_modulus is not None:
                sig = sig + np.maximum(comb[:, 2], comb[:, 5]) \
                    / p.section_modulus
            return sig

        def frame_influence(p, d):
            # Ground motion excites the translations, not the rotations.
            r = np.zeros(p.ndof)
            r[0::3] = d[0]
            r[1::3] = d[1]
            return r

        def frame_lam_bound(p):
            k, _ = F.frame_matrices(p, with_mass=False, device=dev)
            m = F._lumped_mass(p, dev)
            row = _np(k.abs().sum(dim=1) / torch.clamp_min(m, 1e-300))
            mask = p.free_mask() > 0
            return float(row[mask].max() if mask.any() else row.max())

        return _Family(
            dim=2,
            modal=lambda p, n: _unpack_modal(F.frame_modal(p, n,
                                                           device=dev)),
            mass=lambda p: F.frame_matrices(p, device=dev)[1],
            stresses=frame_end_forces, vm=frame_stress,
            influence=frame_influence, lam_bound=frame_lam_bound,
            harmonic=lambda p, om, damping, probe_dofs: F.frame_harmonic(
                p, om, damping=damping, probe_dofs=probe_dofs, device=dev))
    if isinstance(problem, PlateProblem):
        from ..models import plate as PL

        def plate_stress(p, u):
            # Signed extreme-fiber bending stress components 6M/t^2
            # (Voigt [xx, yy, xy]) of a modal state.
            mom, _, _ = PL.recover_moments(p, _on(dev, u))
            return 6.0 * mom / p.thickness[:, None] ** 2

        def plate_vm(p, s):
            sxx, syy, sxy = s[:, 0], s[:, 1], s[:, 2]
            return np.sqrt(sxx ** 2 - sxx * syy + syy ** 2
                           + 3.0 * sxy ** 2)

        def plate_influence(p, d):
            # Transverse (z) base excitation: the w DOFs carry it.
            r = np.zeros(p.ndof)
            r[0::3] = d[0]
            return r

        def plate_lam_bound(p):
            # Gershgorin over the free w rows only: the rotary inertia
            # rho t^3 / 12 pushes the all-rows bound up as 1/t^2, past
            # a thin plate's first bending mode by ~t^4.
            k, m = PL.plate_matrices(p, device=dev)
            md = m.sum(dim=1).abs()
            row = _np(k.abs().sum(dim=1) / torch.clamp_min(md, 1e-300))
            mask = p.free_mask() > 0
            sel = mask.copy()
            sel[1::3] = sel[2::3] = False
            if not sel.any():
                sel = mask if mask.any() else ~mask
            return float(row[sel].max())

        return _Family(
            dim=1,
            modal=lambda p, n: _unpack_modal(PL.plate_modal(p, n,
                                                            device=dev)),
            mass=lambda p: PL.plate_matrices(p, device=dev)[1],
            stresses=plate_stress, vm=plate_vm,
            influence=plate_influence, lam_bound=plate_lam_bound,
            harmonic=lambda p, om, damping, probe_dofs: PL.plate_harmonic(
                p, om, damping=damping, probe_dofs=probe_dofs, device=dev))
    if isinstance(problem, SpaceFrameProblem):
        from ..models import frame3d as F3
        from ..models.plane import _free_index, _general_eigh

        def sf_stress(p, comb):
            # Axial |N|/A at the governing member end (no section
            # modulus on a SpaceFrameProblem).
            return np.maximum(comb[:, 0], comb[:, 6]) / p.area

        def sf_lam_bound(p):
            # The exact top generalized eigenvalue of the dense pencil.
            k, m = F3.space_frame_matrices(p, device=dev)
            free = _free_index(p, dev)
            lam, _ = _general_eigh(k[free][:, free], m[free][:, free])
            return float(lam[-1])

        return _Family(
            dim=3,
            modal=lambda p, n: _unpack_modal(F3.space_frame_modal(
                p, n, device=dev)),
            mass=lambda p: F3.space_frame_matrices(p, device=dev)[1],
            stresses=lambda p, u: F3.space_frame_end_forces(p, u,
                                                            device=dev),
            vm=sf_stress, influence=_translations, lam_bound=sf_lam_bound,
            harmonic=lambda p, om, damping, probe_dofs:
            F3.space_frame_harmonic(p, om, damping=damping,
                                    probe_dofs=probe_dofs, device=dev))
    from ..models.shell import ShellProblem

    if isinstance(problem, ShellProblem):
        from ..models import shell as SH
        from ..models.plane import _free_index, _general_eigh

        def shell_stress(p, u):
            # The six centroid resultants [Nxx, Nyy, Nxy, Mxx, Myy, Mxy]
            # (local facet axes) of a modal state.
            return np.concatenate(SH._recover_shell(p, _on(dev, u)), axis=1)

        def shell_vm(p, comb):
            # The governing extreme-fiber von Mises of the combined
            # resultants.
            return SH.shell_fiber_vm(comb[:, :3], comb[:, 3:], p.thickness)

        def shell_lam_bound(p):
            # The exact top eigenvalue of the ridged dense pencil.
            k, m = SH.shell_matrices(p, device=dev)
            free = _free_index(p, dev)
            m = SH._ridged(m)
            lam, _ = _general_eigh(k[free][:, free], m[free][:, free])
            return float(lam[-1])

        return _Family(
            dim=3,
            modal=lambda p, n: _unpack_modal(SH.shell_modal(p, n,
                                                            device=dev)),
            mass=lambda p: SH.shell_matrices(p, device=dev)[1],
            stresses=shell_stress, vm=shell_vm,
            influence=lambda p, d: _translations(p, d),
            lam_bound=shell_lam_bound,
            harmonic=lambda p, om, damping, probe_dofs: SH.shell_harmonic(
                p, om, damping=damping, probe_dofs=probe_dofs, device=dev))
    raise TypeError("continuum spectrum/random needs a PlaneProblem, "
                    "SolidProblem, FrameProblem, SpaceFrameProblem, "
                    f"ShellProblem or PlateProblem, got "
                    f"{type(problem).__name__}")


class ContinuumSpectrumResult(NamedTuple):
    displacements: np.ndarray    # (ndof,) combined peak |u| (>= 0)
    modal_peaks: np.ndarray      # (J, ndof) signed per-mode peaks
    omegas: np.ndarray           # (J,)
    participation: np.ndarray    # (J,) Gamma_j
    effective_mass: np.ndarray   # (J,) Gamma_j^2
    mass_fraction: float         # sum / total directional mass
    combination: str
    stresses: np.ndarray         # (m, ncomp) per-component combined
    # von Mises of the combined components: the design-code estimate,
    # conservative for in-phase modes, not a strict bound.
    von_mises: np.ndarray        # (m,)
    modal_stresses: np.ndarray   # (J, m, ncomp) signed


def continuum_response_spectrum(
    problem,
    spectrum: Union[Callable[[np.ndarray], np.ndarray], float],
    direction: Optional[Sequence[float]] = None,
    n_modes: int = 6,
    combination: str = "srss",
    damping_ratio: float = 0.05,
    device=None,
) -> ContinuumSpectrumResult:
    """Peak seismic response of a plane, solid, frame, space-frame, plate or
    shell mesh by modal combination (module docstring), the family solves on
    `device` ("cuda" when None)."""
    dev = resolve_device(device)
    fam = _family_of(problem, dev)
    d = np.zeros(fam.dim)
    if direction is None:
        d[0] = 1.0
    else:
        arr = np.asarray(direction, dtype=float).reshape(-1)
        if arr.size != fam.dim:
            raise ValueError(
                f"direction must have {fam.dim} component(s) for "
                f"{type(problem).__name__}"
                + (" (plates are excited transversely — omit "
                   '"direction" or pass [1])' if fam.dim == 1 else ""))
        d[:] = arr
        nrm = np.linalg.norm(d)
        if nrm == 0:
            raise ValueError("direction must be nonzero")
        d /= nrm

    omegas, phi = fam.modal(problem, int(n_modes))
    # Mechanism guard: a near-zero frequency makes Sa/omega^2 unbounded;
    # the absolute scale is the family's eigenvalue bound.
    lam_bound = fam.lam_bound(problem)
    if omegas.size and float(omegas.min()) ** 2 < 1e-6 * lam_bound:
        raise ValueError(
            "the mesh carries a (near-)zero-frequency mechanism mode "
            f"(lambda_min/lambda_bound = "
            f"{omegas.min() ** 2 / lam_bound:.1e}); its Sa/omega^2 "
            "peak response is unbounded — check the supports")

    mask = problem.free_mask()
    r = fam.influence(problem, d) * mask
    mr = _np(fam.mass(problem) @ _on(dev, r))
    gamma = phi @ mr                                  # (J,)
    sa = (spectrum(omegas) if callable(spectrum)
          else float(spectrum) * np.ones_like(omegas))
    peaks = (gamma * sa / omegas ** 2)[:, None] * phi   # (J, ndof)

    sig_modal = np.stack([fam.stresses(problem, peaks[j])
                          for j in range(peaks.shape[0])]) \
        if peaks.shape[0] else np.zeros((0, problem.nelm, 1))

    if combination == "srss":
        combined = np.sqrt(np.sum(peaks ** 2, axis=0))
        sig_comb = np.sqrt(np.sum(sig_modal ** 2, axis=0))
    elif combination == "cqc":
        rho = _cqc_rho(omegas, float(damping_ratio))
        combined = np.sqrt(np.maximum(
            np.einsum("ij,ik,jk->k", rho, peaks, peaks), 0.0))
        sig_comb = np.sqrt(np.maximum(
            np.einsum("ij,ikc,jkc->kc", rho, sig_modal, sig_modal), 0.0))
    else:
        raise ValueError('combination must be "srss" or "cqc"')

    vm = fam.vm(problem, sig_comb)
    total = float(r @ mr)
    eff = gamma ** 2
    return ContinuumSpectrumResult(
        displacements=combined, modal_peaks=peaks, omegas=omegas,
        participation=gamma, effective_mass=eff,
        mass_fraction=float(eff.sum() / max(total, 1e-30)),
        combination=combination, stresses=sig_comb, von_mises=vm,
        modal_stresses=sig_modal)


def _vm_of_components(problem, dim: int, sig: np.ndarray) -> np.ndarray:
    if dim == 2:
        sxx, syy, sxy = sig[:, 0], sig[:, 1], sig[:, 2]
        if problem.plane_strain:
            szz = problem.poisson * (sxx + syy)
            return np.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                                  + (szz - sxx) ** 2) + 3.0 * sxy ** 2)
        return np.sqrt(sxx ** 2 - sxx * syy + syy ** 2 + 3.0 * sxy ** 2)
    sxx, syy, szz = sig[:, 0], sig[:, 1], sig[:, 2]
    syz, sxz, sxy = sig[:, 3], sig[:, 4], sig[:, 5]
    return np.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                          + (szz - sxx) ** 2)
                   + 3.0 * (sxy ** 2 + syz ** 2 + sxz ** 2))


class ContinuumRandomResult(NamedTuple):
    omegas: np.ndarray          # (n_freq,)
    psd: np.ndarray             # (n_freq, n_probe) one-sided S_u
    rms: np.ndarray             # (n_probe,)
    frf_amplitude: np.ndarray   # (n_freq, n_probe) |H|


def _omega_grid(omegas) -> np.ndarray:
    om = np.asarray(omegas, dtype=float).reshape(-1)
    if om.size < 2 or np.any(np.diff(om) <= 0):
        raise ValueError("omegas must be an increasing grid "
                         "(>= 2 points)")
    return om


def _load_psd(load_psd, om: np.ndarray) -> np.ndarray:
    sp = (load_psd(om) if callable(load_psd)
          else float(load_psd) * np.ones_like(om))
    sp = np.broadcast_to(np.asarray(sp, dtype=float), om.shape)
    if np.any(sp < 0):
        raise ValueError("a PSD cannot be negative")
    return sp


def _require_damping(damping, what: str) -> None:
    if float(damping[0]) == 0.0 and float(damping[1]) == 0.0:
        raise ValueError(f"{what} needs nonzero damping — the undamped "
                         "variance integral diverges")


def harmonic_fields(problem, omegas, damping, device=None) -> np.ndarray:
    """(n_freq, ndof) complex response to the load pattern on every DOF:
    the family's harmonic sweep, with continuum_random_response's guards.
    A random document with a fatigue block takes its probes' PSDs and its
    stress FRFs from this one sweep (the `fields` arguments below)."""
    dev = resolve_device(device)
    fam = _family_of(problem, dev)
    om = _omega_grid(omegas)
    _require_damping(damping, "random response")
    h = fam.harmonic(problem, om, damping, None)
    return np.asarray(h.real) + 1j * np.asarray(h.imag)


def _fields_of(fields, om: np.ndarray, ndof: int) -> np.ndarray:
    fields = np.asarray(fields)
    if fields.shape != (om.size, ndof):
        raise ValueError(f"fields must be (n_freq, ndof) = ({om.size}, "
                         f"{ndof}), got {fields.shape}")
    return fields


def continuum_random_response(
    problem,
    load_psd: Union[Callable[[np.ndarray], np.ndarray], float],
    omegas,
    damping=(0.0, 0.0),
    probe_dofs: Optional[np.ndarray] = None,
    device=None,
    fields=None,
) -> ContinuumRandomResult:
    """Displacement PSDs and RMS of a mesh under a stationary random
    multiplier of its load pattern (module docstring), the FRF sweep on
    `device` ("cuda" when None), or read from `fields`, the port's own
    argument: `harmonic_fields` of the same problem, omegas and
    damping."""
    dev = resolve_device(device)
    fam = _family_of(problem, dev)
    om = _omega_grid(omegas)
    _require_damping(damping, "random response")
    if fields is None:
        amp = np.asarray(fam.harmonic(problem, om, damping,
                                      probe_dofs).amplitude, dtype=float)
    else:
        probe = (np.arange(problem.ndof) if probe_dofs is None
                 else np.asarray(probe_dofs, dtype=int).reshape(-1))
        amp = np.abs(_fields_of(fields, om, problem.ndof)[:, probe])
    sp = _load_psd(load_psd, om)
    s_u = amp ** 2 * sp[:, None]
    var = np.trapezoid(s_u, om, axis=0)
    return ContinuumRandomResult(omegas=om, psd=s_u, rms=np.sqrt(var),
                                 frf_amplitude=amp)


# ---------------------------------------------------------------------
# Frequency-domain fatigue: complex stress FRFs and Preumont's equivalent
# von Mises PSD S_eq = sigma^H Q sigma S_p (Q the von Mises quadratic
# form), which reduces to the single-component PSD for a uniaxial state.

_VM_Q6 = np.array([
    [1.0, -0.5, -0.5, 0.0, 0.0, 0.0],
    [-0.5, 1.0, -0.5, 0.0, 0.0, 0.0],
    [-0.5, -0.5, 1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 3.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 3.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 3.0],
])


def _sweep(free_block, ndof: int, om: np.ndarray) -> np.ndarray:
    """(n_freq, ndof) complex full fields of (K - omega^2 M + i omega C) X
    = f on the free block (models/plane.harmonic_solves, on the block's
    device)."""
    from ..models.plane import harmonic_solves

    return harmonic_solves(*free_block, ndof, om, np.arange(ndof))


def _probe_elements(problem, probe_elements) -> np.ndarray:
    return (np.arange(problem.nelm) if probe_elements is None
            else np.asarray(probe_elements, dtype=int).reshape(-1))


def continuum_stress_frf(problem, omegas, damping=(0.0, 0.0),
                         probe_elements=None, device=None,
                         fields=None) -> np.ndarray:
    """Complex centroid stress FRFs to the problem's load pattern: (n_freq,
    n_probe_elm, 6) full Voigt [xx, yy, zz, yz, xz, xy] (plane stress: zz
    = 0; plane strain: zz = nu (xx + yy); plates: the extreme-fiber
    bending stress 6M/t^2).  The complex128 solves on `device` ("cuda"
    when None), or `fields` (`harmonic_fields`), the recovery on the
    host."""
    from ..models.plane import PlaneProblem
    from ..models.plate import PlateProblem
    from ..models.solid import SolidProblem

    dev = resolve_device(device)
    om = np.asarray(omegas, dtype=float).reshape(-1)
    prescribed = getattr(problem, "prescribed", None)  # plates: none
    if prescribed is not None and np.any(prescribed):
        raise ValueError("stress FRFs support homogeneous supports "
                         "only (the harmonic-family guard)")
    dm = problem.dof_map()
    if isinstance(problem, PlaneProblem):
        from ..models import plane as P

        young, nu_t = P._material(problem, dev, "young", "poisson")
        b = _np(P._centroid_b(problem, dev))
        dmat = _np(P._dmat(young, nu_t, problem.plane_strain))
        family = P
        nu = np.broadcast_to(np.asarray(problem.poisson, dtype=float),
                             (problem.nelm,))
        ps = problem.plane_strain

        def sig6_of(u):
            eps = np.einsum("mia,ma->mi", b, u[dm])
            s3 = np.einsum("mij,mj->mi", dmat, eps)
            out = np.zeros((s3.shape[0], 6), dtype=s3.dtype)
            out[:, 0], out[:, 1], out[:, 5] = s3[:, 0], s3[:, 1], s3[:, 2]
            if ps:
                out[:, 2] = nu * (s3[:, 0] + s3[:, 1])
            return out
    elif isinstance(problem, SolidProblem):
        from ..models import solid as S

        b = _np(S._centroid_b3(problem, dev))
        dmat = _np(S._dmat3(*S._material(problem, dev, "young",
                                         "poisson")))
        family = S

        def sig6_of(u):
            eps = np.einsum("mia,ma->mi", b, u[dm])
            return np.einsum("mij,mj->mi", dmat, eps)
    elif isinstance(problem, PlateProblem):
        # The extreme-fiber bending stress 6M/t^2 at z = +-t/2 (where the
        # parabolic transverse shear vanishes): a linear functional of
        # the response, padded to Voigt-6 plane stress.
        from ..models import plate as PL

        PL._require_no_thermal(problem, "stress FRFs")
        coords, _ = PL._elements(problem, dev)
        db, _ = PL._dmats(*PL._material(problem, dev, "young", "poisson",
                                        "thickness"))
        db = _np(db)
        _, dx, dy, _ = PL._shape_grads(coords, 0.0, 0.0)
        bb = _np(PL._bend_b(dx, dy))
        family = PL
        t2 = problem.thickness ** 2

        def sig6_of(u):
            kap = np.einsum("mia,ma->mi", bb, u[dm])
            s3 = 6.0 * np.einsum("mij,mj->mi", db, kap) / t2[:, None]
            out = np.zeros((s3.shape[0], 6), dtype=s3.dtype)
            out[:, 0], out[:, 1], out[:, 5] = s3[:, 0], s3[:, 1], s3[:, 2]
            return out
    else:
        raise TypeError(
            "stress FRFs cover the plane/solid/plate continuum "
            "families; for trusses use random_response's force "
            "PSDs and for frames the member-force FRF path, got "
            f"{type(problem).__name__}")
    probe = _probe_elements(problem, probe_elements)
    full = (_sweep(family._free_block(problem, damping, dev), problem.ndof,
                   om) if fields is None
            else _fields_of(fields, om, problem.ndof))
    out = np.zeros((om.size, probe.size, 6), dtype=complex)
    for i in range(om.size):
        out[i] = sig6_of(full[i])[probe]
    return out


class ContinuumFatigueResult(NamedTuple):
    omegas: np.ndarray        # (n_freq,)
    eq_psd: np.ndarray        # (n_freq, n_elm) equivalent vM PSD
    eq_rms: np.ndarray        # (n_elm,)
    fatigue: object           # solvers.fatigue.SpectralFatigue
    probe_elements: np.ndarray


def continuum_spectral_fatigue(
    problem,
    load_psd,
    omegas,
    damping=(0.0, 0.0),
    probe_elements=None,
    sn_exponent=None,
    sn_coefficient=None,
    method: str = "dirlik",
    duration=None,
    device=None,
    fields=None,
) -> ContinuumFatigueResult:
    """Frequency-domain fatigue of a mesh under a stationary load-multiplier
    PSD: Preumont equivalent von Mises PSDs per element (frames: the
    governing extreme fiber) through spectral_fatigue (Dirlik or
    narrowband), the sweep on `device` ("cuda" when None), or `fields`
    (`harmonic_fields`)."""
    from ..models.frame import FrameProblem
    from .fatigue import spectral_fatigue

    om = _omega_grid(omegas)
    _require_damping(damping, "spectral fatigue")
    sp = _load_psd(load_psd, om)
    probe = _probe_elements(problem, probe_elements)
    dur = None if duration is None else float(duration)
    if isinstance(problem, FrameProblem):
        # The von Mises reduction has no member counterpart: all four
        # extreme-fiber FRFs, the governing fiber kept per member (max
        # damage rate with an S-N curve, max RMS without).
        frf = frame_fiber_stress_frf(problem, om, damping=damping,
                                     probe_elements=probe, device=device,
                                     fields=fields)
        psd4 = np.abs(frf) ** 2 * sp[:, None, None]
        sf4 = spectral_fatigue(om, psd4.reshape(om.size, -1), sn_exponent,
                               sn_coefficient, method=method, duration=dur)
        score = (sf4.damage_rate if sn_exponent is not None
                 else sf4.rms).reshape(probe.size, 4)
        pick = np.argmax(score, axis=1)
        sf = _select_fatigue_rows(sf4, np.arange(probe.size) * 4 + pick)
        eq_psd = psd4[:, np.arange(probe.size), pick]
        return ContinuumFatigueResult(
            omegas=om, eq_psd=eq_psd, eq_rms=np.asarray(sf.rms),
            fatigue=sf, probe_elements=probe)
    from ..models.shell import ShellProblem

    if isinstance(problem, ShellProblem):
        # Both extreme fibers carry a full Voigt stress FRF; the Preumont
        # reduction runs per fiber and the governing fiber is kept per
        # facet (max damage rate with an S-N curve, max RMS without).
        frf = shell_fiber_stress_frf(problem, om, damping=damping,
                                     probe_elements=probe, device=device,
                                     fields=fields)
        quad = np.einsum("fmki,ij,fmkj->fmk", frf.conj(), _VM_Q6, frf).real
        psd2 = quad * sp[:, None, None]
        sf2 = spectral_fatigue(om, psd2.reshape(om.size, -1), sn_exponent,
                               sn_coefficient, method=method, duration=dur)
        score = (sf2.damage_rate if sn_exponent is not None
                 else sf2.rms).reshape(probe.size, 2)
        pick = np.argmax(score, axis=1)
        sf = _select_fatigue_rows(sf2, np.arange(probe.size) * 2 + pick)
        eq_psd = psd2[:, np.arange(probe.size), pick]
        return ContinuumFatigueResult(
            omegas=om, eq_psd=eq_psd, eq_rms=np.asarray(sf.rms),
            fatigue=sf, probe_elements=probe)
    frf = continuum_stress_frf(problem, om, damping=damping,
                               probe_elements=probe, device=device,
                               fields=fields)
    quad = np.einsum("fmi,ij,fmj->fm", frf.conj(), _VM_Q6, frf).real
    eq_psd = quad * sp[:, None]
    sf = spectral_fatigue(om, eq_psd, sn_exponent, sn_coefficient,
                          method=method, duration=dur)
    return ContinuumFatigueResult(
        omegas=om, eq_psd=eq_psd, eq_rms=np.asarray(sf.rms),
        fatigue=sf, probe_elements=probe)


def _select_fatigue_rows(sf_all, sel):
    """The governing-fiber rows of a flat spectral-fatigue result (its
    array fields indexed by sel)."""
    def take(v):
        arr = np.asarray(v)
        return arr.reshape(-1)[sel] if arr.ndim else arr

    return sf_all._replace(**{k: take(v) for k, v in
                              sf_all._asdict().items()
                              if isinstance(v, np.ndarray)})


def shell_fiber_stress_frf(problem, omegas, damping=(0.0, 0.0),
                           probe_elements=None, device=None,
                           fields=None) -> np.ndarray:
    """Complex extreme-fiber stress FRFs of a shell's facets: (n_freq,
    n_probe, 2, 6) full Voigt [xx, yy, zz, yz, xz, xy] (local facet axes, zz
    = 0) for the fibers z = +t/2 and -t/2, sigma+- = N/t +- 6M/t^2, each a
    linear functional of the complex response (the centroid recovery of
    models/shell.py on the complex field, without the thermal case).  The
    complex128 sweep on the ridged pencil on `device` ("cuda" when None),
    or `fields` (`harmonic_fields`), the recovery on the host."""
    from ..models import shell as SH
    from ..models.plane import _q4_point
    from ..models.plate import _bend_b, _shape_grads

    if not isinstance(problem, SH.ShellProblem):
        raise TypeError("shell_fiber_stress_frf needs a "
                        f"ShellProblem, got {type(problem).__name__}")
    SH._require_no_thermal(problem, "stress FRFs")
    dev = resolve_device(device)
    om = np.asarray(omegas, dtype=float).reshape(-1)
    full = (_sweep(SH._free_block(problem, damping, dev), problem.ndof, om)
            if fields is None else _fields_of(fields, om, problem.ndof))
    r, c2, _ = SH._facets(problem, "cpu")
    t24 = _np(SH._transformation(r))
    bmem = _np(_q4_point(c2, 0.0, 0.0)[0])
    young, nu_t, thick = SH._material(problem, "cpu", "young", "poisson",
                                      "thickness")
    dmat = _np(SH._plane_dmat(young, nu_t, False))
    _, dx, dy, _ = _shape_grads(c2, 0.0, 0.0)
    bb = _np(_bend_b(dx, dy))
    dm = problem.dof_map()
    e, nu, tt = problem.young, problem.poisson, problem.thickness
    d0 = e * tt ** 3 / (12.0 * (1.0 - nu * nu))
    probe = _probe_elements(problem, probe_elements)
    out = np.zeros((om.size, probe.size, 2, 6), dtype=complex)
    for i in range(om.size):
        u_loc = np.einsum("mij,mj->mi", t24, full[i][dm])
        eps = np.einsum("mia,ma->mi", bmem, u_loc[:, SH._MEM_IDX])
        nf = tt[:, None] * np.einsum("mij,mj->mi", dmat, eps)
        kap = np.einsum("mia,ma->mi", bb,
                        u_loc[:, SH._BND_IDX] @ SH._Q_BETA.T)
        mom = np.stack([d0 * (kap[:, 0] + nu * kap[:, 1]),
                        d0 * (kap[:, 1] + nu * kap[:, 0]),
                        d0 * (1.0 - nu) / 2.0 * kap[:, 2]], axis=-1)
        sm = (nf / tt[:, None])[probe]
        sb = (6.0 * mom / tt[:, None] ** 2)[probe]
        for fib, sgn in enumerate((1.0, -1.0)):
            s3 = sm + sgn * sb
            out[i, :, fib, 0] = s3[:, 0]
            out[i, :, fib, 1] = s3[:, 1]
            out[i, :, fib, 5] = s3[:, 2]
    return out


def frame_fiber_stress_frf(problem, omegas, damping=(0.0, 0.0),
                           probe_elements=None, device=None,
                           fields=None) -> np.ndarray:
    """Complex extreme-fiber stress FRFs of a frame's members: (n_freq,
    n_probe, 4) for the fibers [end 1 N/A + M1/S, end 1 N/A - M1/S, end 2
    +, end 2 -], each a linear functional of the complex response.  Needs
    the problem's section_modulus.  The complex128 solves on `device`
    ("cuda" when None), or `fields` (`harmonic_fields`), the recovery on
    the host; the member loads oscillate with the same multiplier, so the
    fixed-end correction rides along."""
    from ..models import frame as F

    if not isinstance(problem, F.FrameProblem):
        raise TypeError("frame_fiber_stress_frf needs a FrameProblem, "
                        f"got {type(problem).__name__}")
    if problem.section_modulus is None:
        raise ValueError("fiber stress FRFs need the problem's "
                         "section_modulus (sigma = N/A + M/S)")
    dev = resolve_device(device)
    om = np.asarray(omegas, dtype=float).reshape(-1)
    f_member, f_fixed = F._member_load_vectors(problem, dev)
    kl, t = (_np(a) for a in F._local_stiffness(problem, dev))
    f_fixed = _np(f_fixed)
    dm = problem.dof_map()
    area = np.broadcast_to(np.asarray(problem.area, dtype=float),
                           (problem.nelm,))
    smod = np.broadcast_to(np.asarray(problem.section_modulus,
                                      dtype=float), (problem.nelm,))
    probe = _probe_elements(problem, probe_elements)
    if fields is None:
        k, mm = F.frame_matrices(problem, device=dev)
        f0 = F._t(problem.loads, dev) + f_member
        full = _sweep(F._free_block(k, mm, f0, problem, damping),
                      problem.ndof, om)
    else:
        full = _fields_of(fields, om, problem.ndof)
    out = np.zeros((om.size, probe.size, 4), dtype=complex)
    for i in range(om.size):
        u_loc = np.einsum("mij,mj->mi", t, full[i][dm])
        f_loc = np.einsum("mij,mj->mi", kl, u_loc) - f_fixed
        n_ax = -f_loc[probe, 0] / area[probe]
        m1 = f_loc[probe, 2] / smod[probe]
        m2 = f_loc[probe, 5] / smod[probe]
        out[i, :, 0] = n_ax + m1
        out[i, :, 1] = n_ax - m1
        out[i, :, 2] = n_ax + m2
        out[i, :, 3] = n_ax - m2
    return out
