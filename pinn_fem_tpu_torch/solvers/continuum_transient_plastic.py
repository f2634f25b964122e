"""Explicit elastoplastic transient dynamics for the continuum families:
central difference with the radial return committed every step, over the
plane (CST / Q4, ops/plane_plastic.py) and solid (hex8,
ops/solid_plastic.py) Gauss-point maps (counterpart of
pinn_fem_tpu/solvers/continuum_transient_plastic.py).

The truss integrator (solvers/plasticity.solve_transient_plastic) in 2D and
3D:

  * each explicit step is a committed strain increment: the return map
    runs from the previous step's state and commits unconditionally;
  * the elastic stable-dt bound applies (yielding only lowers the tangent);
  * Rayleigh damping: alpha on the row-sum lumped mass, beta on the
    initial elastic stiffness K0;
  * energy bookkeeping: KE + SE_elastic + W_plastic = W_external to
    integrator accuracy, SE_elastic the compliance form 0.5 sigma : C^-1 :
    sigma at the Gauss points, W_plastic the sum of sigma . d(eps_p).

Tiers, as in the JAX package: float64 below DENSE_DOF_LIMIT (host=True
forces it, on the CPU), the working dtype above it (host=False forces it),
both on the caller's device ("cuda" when None), running the same
recurrence with no host read in the step loop: the records stay on the
device until one fetch.  Where the JAX package builds dense float64 K and
M (ndof^2), the port forms what the recurrence uses from the element
blocks: m_diag as the row sums of the consistent M, the stable step's
Gershgorin sums from the blocks, and beta K0 v as kernel 1 on the
family's DIA diagonals when a banded layout exists (the working-dtype
tier; on a card the CUDA kernel, a float64 CUDA operand refused), the
gather of v, the element blocks and the float64 scatter elsewhere.  The
working-dtype tier gathers and scatters by grid slices on the generators'
canonical rect / box grids (ops/structured.py), by the general gather and
the float64 scatter on other meshes; the float64 tier always by the
latter.  mesh= (element-parallel SPMD) is item 15's multi-device row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..ops.plastic import params_arrays
from ..utils.runtime import default_dtype, require_float32, resolve_device


class ContinuumPlasticTransientResult(NamedTuple):
    times: np.ndarray            # (n_rec,)
    displacements: np.ndarray    # (n_rec, n_probe)
    velocities: np.ndarray       # (n_rec, n_probe)
    kinetic_energy: np.ndarray   # (n_rec,)
    strain_energy: np.ndarray    # (n_rec,) elastic (compliance form)
    plastic_work: np.ndarray     # (n_rec,) cumulative
    external_work: np.ndarray    # (n_rec,) cumulative
    von_mises_envelope: np.ndarray   # (nelm,) max gp vM over all steps
    final_displacement: np.ndarray   # (ndof,)
    final_eq_plastic: np.ndarray     # (nelm,) gp-mean alpha
    dt: float


def _se_compliance_plane(sig3, szz, young, poisson, wq):
    """0.5 sigma : C^-1 : sigma integrated over the elements; plane stress
    and plane strain share it (szz is what the constraint produced)."""
    e = young[:, None]
    nu = poisson[:, None]
    sxx, syy, sxy = sig3[..., 0], sig3[..., 1], sig3[..., 2]
    g = e / (2.0 * (1.0 + nu))
    dens = (sxx ** 2 + syy ** 2 + szz ** 2
            - 2.0 * nu * (sxx * syy + syy * szz + szz * sxx)) \
        / (2.0 * e) + sxy ** 2 / (2.0 * g)
    return torch.sum(dens * wq)


def _se_compliance_solid(sig6, young, poisson, wq):
    e = young[:, None]
    nu = poisson[:, None]
    sxx, syy, szz = sig6[..., 0], sig6[..., 1], sig6[..., 2]
    syz, sxz, sxy = sig6[..., 3], sig6[..., 4], sig6[..., 5]
    g = e / (2.0 * (1.0 + nu))
    dens = (sxx ** 2 + syy ** 2 + szz ** 2
            - 2.0 * nu * (sxx * syy + syy * szz + szz * sxx)) \
        / (2.0 * e) + (sxy ** 2 + syz ** 2 + sxz ** 2) / (2.0 * g)
    return torch.sum(dens * wq)


class _Family:
    """One family's operands in `dtype` on `device` and its closures:
    `force(u_e, state, mats)` -> (fe, stresses, new state), `wp_inc`,
    `se_of`, `vm_of`, `init_state`.  loads and m_diag are float64;
    k_blocks() the float64 elastic blocks (beta damping only); layout()
    the banded layout or None; grid the structured (gather, scatter) or
    None."""

    def __init__(self, problem, dtype, device):
        self.problem = problem
        self.dtype, self.device = dtype, device
        self.ndof, self.nelm = problem.ndof, problem.nelm
        self.dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                                  device=device)
        self.mask = torch.as_tensor(problem.free_mask(), dtype=dtype,
                                    device=device)

    def t(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device).to(self.dtype)


def _plane_family(problem, bbar, dtype, device) -> _Family:
    """The standard or B-bar plane geometry (B-bar by default for
    plane-strain Q4, as the statics)."""
    from ..models import plane as P
    from ..ops.plane_plastic import (gp_geometry, gp_geometry_bbar,
                                     initial_plane_state,
                                     plane_plastic_force,
                                     plane_plastic_force_bbar, von_mises_4)
    from ..ops.structured import make_plane_grid_ops, rect_grid_of

    bbar = _plane_bbar(problem, bbar)
    fam = _Family(problem, dtype, device)
    b, wdet = (gp_geometry_bbar if bbar else gp_geometry)(problem, device)
    young, poisson, thick = (fam.t(a) for a in (
        problem.young, problem.poisson, problem.thickness))
    wq = fam.t(torch.as_tensor(problem.thickness, device=device)[:, None]
               * wdet)
    b, wdet = fam.t(b), fam.t(wdet)
    ngp = wdet.shape[1]
    ps = problem.plane_strain

    def force(u_e, state, mats):
        sy, hi, hk = mats
        if bbar:
            fe, sig3, szz, st = plane_plastic_force_bbar(
                b, wdet, thick, u_e, state, young, poisson, sy, hi, hk)
        else:
            fe, sig3, szz, st = plane_plastic_force(
                b, wdet, thick, u_e, state, young, poisson, sy, hi, hk, ps)
        return fe, (sig3, szz), st

    def wp_inc(sig, st_new, st_old):
        sig3, szz = sig
        sig4 = torch.cat([sig3[..., :2], szz[..., None], sig3[..., 2:]],
                         dim=-1)
        return torch.sum(sig4 * (st_new.eps_p - st_old.eps_p)
                         * wq[..., None])

    def se_of(sig):
        return _se_compliance_plane(*sig, young, poisson, wq)

    def vm_of(sig):
        return von_mises_4(*sig).max(dim=1).values

    fam.force, fam.wp_inc, fam.se_of, fam.vm_of = force, wp_inc, se_of, vm_of
    fam.init_state = lambda: initial_plane_state(problem.nelm, ngp, dtype,
                                                 device)
    fam.loads = P._t(problem.loads, device) + P._body_force_vectors(
        problem, device)
    fam.m_diag = P._mass_row_sums(problem, device)
    fam.k_blocks = lambda: P._stiffness_blocks(problem, device)
    fam.layout = lambda: P.plane_dia_layout(problem)
    grid = (rect_grid_of(problem.elements, problem.nnode)
            if problem.nen == 4 else None)
    fam.grid = None if grid is None else make_plane_grid_ops(*grid)
    return fam


def _plane_bbar(problem, bbar) -> bool:
    if bbar is None:
        bbar = problem.plane_strain and problem.nen == 4
    bbar = bool(bbar) and problem.plane_strain
    if bbar and problem.nen != 4:
        raise ValueError("B-bar needs Q4 elements — use a quad mesh "
                         "for incompressible plane-strain plasticity")
    return bbar


def _solid_family(problem, bbar, dtype, device) -> _Family:
    from ..models import solid as S
    from ..ops.solid_plastic import (gp_geometry3, initial_solid_state,
                                     solid_plastic_force, von_mises_6)
    from ..ops.structured import box_grid_of, make_solid_grid_ops

    del bbar
    fam = _Family(problem, dtype, device)
    b, wdet = (fam.t(a) for a in gp_geometry3(problem, device))
    young, poisson = fam.t(problem.young), fam.t(problem.poisson)

    def force(u_e, state, mats):
        return solid_plastic_force(b, wdet, u_e, state, young, poisson,
                                   *mats)

    def wp_inc(sig6, st_new, st_old):
        return torch.sum(sig6 * (st_new.eps_p - st_old.eps_p)
                         * wdet[..., None])

    def se_of(sig6):
        return _se_compliance_solid(sig6, young, poisson, wdet)

    def vm_of(sig6):
        return von_mises_6(sig6).max(dim=1).values

    fam.force, fam.wp_inc, fam.se_of, fam.vm_of = force, wp_inc, se_of, vm_of
    fam.init_state = lambda: initial_solid_state(problem.nelm, dtype,
                                                 device)
    fam.loads = S._t(problem.loads, device) + S._body_force_vectors3(
        problem, device)
    fam.m_diag = S.mass_row_sums3(problem, device)
    fam.k_blocks = lambda: S._stiffness_blocks3(problem, device)
    fam.layout = lambda: S.solid_dia_layout(problem)
    grid = box_grid_of(problem.elements, problem.nodes.shape[0])
    fam.grid = None if grid is None else make_solid_grid_ops(*grid)
    return fam


def _k0_operator(fam: _Family, structured: bool):
    """K0 v: kernel 1 on the family's DIA diagonals in the working-dtype
    tier when a banded layout exists (its twin on a CPU tensor), else the
    gather of v, the element blocks and the float64 scatter."""
    from ..ops.dia import assemble_dia_blocks
    from ..ops.kernels.dia_kernel import dia_matvec

    blocks = fam.k_blocks()
    if structured:
        try:
            layout = fam.layout()
        except ValueError:          # more diagonals than the layout holds
            layout = None
        if layout is not None:
            if fam.device.type == "cuda":
                require_float32(fam.dtype, "the plastic transient's beta "
                                "K0 v (kernel 1: dia_matvec)")
            diags = assemble_dia_blocks(layout, blocks).to(
                fam.dtype).contiguous()
            return lambda v: dia_matvec(layout, diags, v)
    kb = blocks.to(fam.dtype)
    dm = fam.dm

    def k0_apply(v):
        return scatter_add(fam.ndof, dm, torch.einsum("mab,mb->ma", kb,
                                                      v[dm]))

    return k0_apply


def _run(fam: _Family, mats, dt: float, amp, alpha_c: float, beta_c: float,
         record_every: int, n_rec: int, probe, structured: bool):
    """The explicit elastoplastic recurrence in fam's dtype on its device,
    with no host read:

        u_{n+1} = 2u - u_prev + dt^2 M^-1 (a_n f - f_int(u) - C v_lag)

    the scalars rounded to the dtype first, as the JAX package's traced
    program takes them.  structured: the grid slices (when the mesh has
    them) and kernel 1 for beta K0 v (when a banded layout exists).
    Returns the device tensors (us, vs, kes, ses, wps, wes, env, u,
    final gp-mean alpha)."""
    dtype, dev = fam.dtype, fam.device
    npf = np.float64 if dtype == torch.float64 else np.float32
    dt_w = npf(dt)
    dt2 = float(dt_w * dt_w)
    dt = float(dt_w)
    alpha_c, beta_c = float(npf(alpha_c)), float(npf(beta_c))
    amp = [float(a) for a in np.asarray(amp, dtype=npf)]
    mask = fam.mask
    m = fam.m_diag.to(dtype) * mask + (1.0 - mask)
    inv_m = torch.where(m > 0, 1.0 / m, 0.0)
    dt2_inv_m = dt2 * inv_m
    loads = fam.loads.to(dtype) * mask
    k0_apply = _k0_operator(fam, structured) if beta_c else None
    dm = fam.dm
    if structured and fam.grid is not None:
        gather, scatter = fam.grid
    else:
        def gather(u):
            return u[dm]

        def scatter(fe):
            return scatter_add(fam.ndof, dm, fe)

    def f_int_of(u, state):
        fe, sig, st = fam.force(gather(u), state, mats)
        return scatter(fe), sig, st

    kw = dict(dtype=dtype, device=dev)
    us = torch.empty((n_rec, probe.numel()), **kw)
    vs = torch.empty((n_rec, probe.numel()), **kw)
    kes, ses = torch.empty(n_rec, **kw), torch.empty(n_rec, **kw)
    wps, wes = torch.empty(n_rec, **kw), torch.empty(n_rec, **kw)
    state = fam.init_state()
    u = torch.zeros(fam.ndof, **kw)
    # u_{-1} from the constant-acceleration start (u0 = v0 = 0).
    u_prev = (0.5 * dt2) * (inv_m * (amp[0] * loads) * mask)
    w_p = torch.zeros((), **kw)
    w_ext = torch.zeros((), **kw)
    env = torch.zeros(fam.nelm, **kw)
    n_total, i = len(amp), 0
    for r in range(n_rec):
        for _ in range(record_every):
            f_int, sig, st_new = f_int_of(u, state)
            w_p = w_p + fam.wp_inc(sig, st_new, state)
            env = torch.maximum(env, fam.vm_of(sig))
            v_lag = (u - u_prev) / dt
            cu = alpha_c * (m * v_lag)
            if beta_c:
                cu = cu + beta_c * k0_apply(v_lag)
            fi = amp[min(i, n_total - 1)] * loads
            u_next = (2.0 * u - u_prev + dt2_inv_m * (fi - f_int - cu)) * mask
            w_ext = w_ext + torch.dot(fi, u_next - u)
            u_prev, u, state = u, u_next, st_new
            i += 1
        v = (u - u_prev) / dt
        # The strain energy at the recorded u: one more stress evaluation
        # from the committed state, not committed.
        _, sig_r, _ = f_int_of(u, state)
        us[r] = u[probe]
        vs[r] = v[probe]
        kes[r] = 0.5 * torch.sum(m * v * v)
        ses[r] = fam.se_of(sig_r)
        wps[r] = w_p
        wes[r] = w_ext
    return us, vs, kes, ses, wps, wes, env, u, state.alpha.mean(dim=1)


def _solve(make_family, problem, bbar, sigma_y, hardening_iso,
           hardening_kin, dt, n_steps, amplitude, damping, record_every,
           probe_dofs, host, stable_dt_fn, mesh, device):
    from ..parallel import refuse_mesh
    from . import newton

    refuse_mesh(mesh, "the continuum plastic transient's element batch")
    dense64 = problem.ndof <= newton.DENSE_DOF_LIMIT if host is None \
        else host
    where = torch.device("cpu") if host else resolve_device(device)
    dtype = torch.float64 if dense64 else default_dtype()
    fam = make_family(problem, bbar, dtype, where)
    alpha_c, beta_c = (float(damping[0]), float(damping[1]))
    if dt is None:
        dt = stable_dt_fn(problem, damping=(alpha_c, beta_c), device=where)
    dt = float(dt)
    n_steps = int(n_steps)
    record_every = int(record_every)
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("transient supports homogeneous supports only")
    n_rec = n_steps // record_every
    if amplitude is None:
        amp = np.ones(n_steps)
    else:
        amp = np.asarray(amplitude, dtype=float).reshape(-1)
        if amp.size != n_steps:
            raise ValueError(f"amplitude must have n_steps={n_steps} "
                             f"entries, got {amp.size}")
    sy, hi, hk = params_arrays(problem.nelm, sigma_y, hardening_iso,
                               hardening_kin)
    probe = torch.as_tensor(
        np.arange(problem.ndof) if probe_dofs is None
        else np.asarray(probe_dofs, dtype=int).reshape(-1),
        dtype=torch.int64, device=where)
    times = dt * record_every * (np.arange(n_rec) + 1.0)
    outs = _run(fam, tuple(fam.t(a) for a in (sy, hi, hk)), dt, amp,
                alpha_c, beta_c, record_every, n_rec, probe,
                structured=not dense64)
    (us, vs, kes, ses, wps, wes, env, u_f,
     al_f) = (o.cpu().numpy().astype(float) for o in outs)
    return ContinuumPlasticTransientResult(
        times=times, displacements=us, velocities=vs, kinetic_energy=kes,
        strain_energy=ses, plastic_work=wps, external_work=wes,
        von_mises_envelope=env, final_displacement=u_f,
        final_eq_plastic=al_f, dt=dt)


def solve_plane_transient_plastic(
    problem,
    sigma_y,
    hardening_iso=0.0,
    hardening_kin=0.0,
    dt: Optional[float] = None,
    n_steps: int = 1000,
    amplitude: Optional[np.ndarray] = None,
    damping=(0.0, 0.0),
    record_every: int = 1,
    probe_dofs: Optional[np.ndarray] = None,
    host: Optional[bool] = None,
    bbar: Optional[bool] = None,
    mesh=None,
    device=None,
) -> ContinuumPlasticTransientResult:
    """Explicit elastoplastic transient on the plane continuum (module
    docstring).  The JAX package's arguments: bbar follows the statics
    default (on for plane-strain Q4); dt None is the damped Gershgorin
    step (models/plane.plane_stable_dt); mesh= raises (item 15).  The
    port's own: device, where to run ("cuda" when None; host=True: the
    CPU)."""
    from ..models.plane import plane_stable_dt

    _plane_bbar(problem, bbar)
    return _solve(_plane_family, problem, bbar, sigma_y, hardening_iso,
                  hardening_kin, dt, n_steps, amplitude, damping,
                  record_every, probe_dofs, host, plane_stable_dt, mesh,
                  device)


def solve_solid_transient_plastic(
    problem,
    sigma_y,
    hardening_iso=0.0,
    hardening_kin=0.0,
    dt: Optional[float] = None,
    n_steps: int = 1000,
    amplitude: Optional[np.ndarray] = None,
    damping=(0.0, 0.0),
    record_every: int = 1,
    probe_dofs: Optional[np.ndarray] = None,
    host: Optional[bool] = None,
    mesh=None,
    device=None,
) -> ContinuumPlasticTransientResult:
    """Explicit elastoplastic transient on the 3D solid (module
    docstring; the standard hex8 geometry, as in the JAX package); dt None
    is models/solid.solid_stable_dt; mesh= raises (item 15).  device:
    where to run ("cuda" when None; host=True: the CPU)."""
    from ..models.solid import solid_stable_dt

    return _solve(_solid_family, problem, None, sigma_y, hardening_iso,
                  hardening_kin, dt, n_steps, amplitude, damping,
                  record_every, probe_dofs, host, solid_stable_dt, mesh,
                  device)
