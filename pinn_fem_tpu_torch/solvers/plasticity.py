"""Incremental elastoplastic statics and explicit elastoplastic transients
over the radial-return truss element (counterpart of
pinn_fem_tpu/solvers/plasticity.py; ops/plastic.py for the model).

Statics: load stepping with Newton on the algorithmic tangent.  Within a
step the trial state is the COMMITTED state of the previous step, the
internal variables commit at the step's end.  Residuals are normalized by
the load-PATTERN norm |f_ext|, not the step's |lf f_ext| (an unloading
step ends at lf = 0 with residual self-stress).  Two tiers, as in the
JAX package:

  * float64 (ndof <= DENSE_DOF_LIMIT and no `data`, the default): the
    JAX host tier's algorithm (stop at res <= tol only; np.linalg.solve
    of the masked tangent) in float64 torch on the caller's device, the
    card by default; host=True on the CPU.  The material values come
    from ops/host (`material_values_host`), MLP fields included.
  * device (host=False, a given `data`, or above the limit): the JAX
    device program's algorithm in the working dtype: the tolerance
    floored at 1e-5 in float32, a stall stop once the residual is inside
    sqrt(tol), the masked tangent factored by LU with one refinement
    sweep (`ops.linalg.masked_solve(assume_spd=False)`), one host read of
    the stop flag a Newton iteration.  Unlike the JAX program it counts a
    trial yield function within 16 eps of its dtype of the yield surface
    as elastic (ROADMAP fault 3.18).  The JAX package pads the schedule
    to a power of two (a bucket of its compiled program) and cuts the
    outputs back; the port runs the n steps.

Transients: explicit central difference, one committed return map a step.
The float64 tier is the JAX host loop (a dense K0 for the beta term) in
torch on the caller's device; the device tier (`_plastic_central_run`)
is its scan: torch ops with no host read in the loop, the records kept
on the device and fetched once.  Its internal force is the gather form
(`ops/scatter.segment_sum_dofs`); the Rayleigh term beta K0 v is kernel 1
(ops/kernels/dia_kernel.dia_matvec through solvers/dynamics._operator,
one launch a step) on a banded layout above the dense limit, and the
gather form elsewhere.  A float64 CUDA operand at kernel 1's dispatch
raises the ValueError naming PINN_FEM_TPU_X64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.problem import ProblemData, TrussProblem
from ..ops.assembly import material_values, scatter_add
from ..ops.linalg import masked_solve
from ..ops.plastic import (PlasticParams, PlasticState,
                           assemble_plastic_system, dense_plastic_system,
                           initial_state, params_arrays, return_map)
from ..utils.runtime import resolve_device


class PlasticStaticResult(NamedTuple):
    load_factors: np.ndarray    # (n_steps,)
    displacements: np.ndarray   # (n_steps, ndof)
    stresses: np.ndarray        # (n_steps, nelm) return-mapped axial stress
    plastic_strain: np.ndarray  # (n_steps, nelm) eps_p
    alpha: np.ndarray           # (n_steps, nelm) accumulated plastic strain
    back_stress: np.ndarray     # (n_steps, nelm) kinematic centre q
    iterations: np.ndarray      # (n_steps,) Newton iterations per step
    residuals: np.ndarray       # (n_steps,) final |R|/|f_ext| per step
    converged: bool             # every step converged
    n_plastic: np.ndarray       # (n_steps,) elements actively yielding


def ramp_schedule(target: float, n_steps: int) -> np.ndarray:
    """Proportional ramp 0 -> target in n_steps equal increments."""
    return np.linspace(target / n_steps, target, n_steps)


def _params(sy, hi, hk, dtype, device) -> PlasticParams:
    return PlasticParams(*(torch.as_tensor(a, dtype=dtype).to(device)
                           for a in (sy, hi, hk)))


def _static_result(lfs, rows, iters, residuals, ok) -> PlasticStaticResult:
    """The result from per-step device rows (u, sigma, eps_p, alpha, back,
    n_plastic), fetched once."""
    cols = [torch.stack(c).cpu().numpy().astype(float)
            for c in zip(*rows)]
    u, sigma, eps_p, alpha, back, n_pl = cols
    return PlasticStaticResult(
        load_factors=np.asarray(lfs, dtype=float),
        displacements=u, stresses=sigma, plastic_strain=eps_p, alpha=alpha,
        back_stress=back, iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float), converged=bool(ok),
        n_plastic=n_pl.astype(int))


def _float64_solve(problem: TrussProblem, sy, hi, hk, lfs, tol, max_iter,
                   tangent_floor, min_denom, device) -> PlasticStaticResult:
    """The JAX host tier (_host_solve) in float64 torch on `device`: one
    host read of the residual a Newton iteration."""
    from ..ops import host as H

    f64 = torch.float64
    data = problem.to_device(device, f64)
    mask_h = H.host_masks(problem)
    mask = data.free_mask
    f_ext = torch.as_tensor(np.asarray(problem.loads, dtype=np.float64)
                            * mask_h, dtype=f64).to(device)
    fnorm = max(float(np.linalg.norm(np.asarray(problem.loads, float)
                                     * mask_h)), min_denom)
    km_fix = torch.diag(1.0 - mask)
    params = _params(sy, hi, hk, f64, device)
    u = torch.zeros(problem.ndof, dtype=f64, device=device)
    state = initial_state(problem.nelm, f64, device)
    rows, iters, residuals, all_ok = [], [], [], True
    for lf in lfs:
        young, area = (torch.as_tensor(a, dtype=f64).to(device)
                       for a in H.material_values_host(problem, lf))

        def system(u_now, tangent=True):
            return dense_plastic_system(data, young, area, u_now, state,
                                        params, tangent_floor, tangent)

        ok, res, it_used = False, np.inf, max_iter
        for it in range(max_iter):
            k_t, f_int, sigma, st = system(u)
            r = (lf * f_ext - f_int) * mask
            res = float(torch.linalg.vector_norm(r)) / fnorm
            if res <= tol:
                ok, it_used = True, it
                break
            km = mask[:, None] * k_t * mask[None, :] + km_fix
            u = u + torch.linalg.solve(km, r) * mask
        all_ok &= ok
        if not ok:
            # The loop updates u after assembling: on exhaustion sigma and
            # the state lag the final u by one update, so evaluate them
            # once more there (as the device tier does).
            _, f_int, sigma, st = system(u, tangent=False)
            res = float(torch.linalg.vector_norm(
                (lf * f_ext - f_int) * mask)) / fnorm
        n_pl = torch.count_nonzero(st.alpha > state.alpha)
        state = st
        rows.append((u, sigma, *st, n_pl))
        iters.append(it_used)
        residuals.append(res)
    return _static_result(lfs, rows, iters, residuals, all_ok)


def _device_solve(problem: TrussProblem, data: ProblemData, sy, hi, hk,
                  lfs, tol, max_iter, tangent_floor,
                  min_denom) -> PlasticStaticResult:
    """The JAX device program (_device_core) in the working dtype: Newton
    with the stall stop, one host read of the stop flag an iteration, the
    records kept on the device."""
    dtype, dev = data.loads.dtype, data.device
    npf = np.float64 if dtype == torch.float64 else np.float32
    material = problem.material.to(dev)
    params = _params(sy, hi, hk, dtype, dev)
    mask = data.free_mask
    f_ext = data.loads * mask
    fnorm = torch.clamp(torch.linalg.vector_norm(f_ext),
                        min=float(npf(min_denom)))
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)
    sqrt_tol = torch.sqrt(tol_t)
    floor = float(npf(tangent_floor))
    # The rounding band of the trial yield test (ops/plastic.return_map,
    # ROADMAP fault 3.18).
    band = 16.0 * float(np.finfo(npf).eps)
    u = torch.zeros(data.ndof, dtype=dtype, device=dev)
    state = initial_state(data.nelm, dtype, dev)
    rows, iters, res_rows, conv_rows = [], [], [], []
    for lf in lfs:
        lf = float(npf(lf))
        res_prev = torch.full((), float("inf"), dtype=dtype, device=dev)
        it = 0
        while it < max_iter:
            k_t, f_int, _, _ = assemble_plastic_system(
                data, material, u, state, params, lf, floor, band)
            r = (lf * f_ext - f_int) * mask
            res = torch.linalg.vector_norm(r) / fnorm
            stalled = (res >= res_prev) & (res_prev <= sqrt_tol)
            done = (res <= tol_t) | stalled
            res_prev = torch.minimum(res, res_prev)
            if bool(done):
                break
            # LU, not Cholesky: a near-floor plastic tangent can be
            # numerically indefinite in float32.
            u = u + masked_solve(k_t, r, mask, assume_spd=False)[0]
            it += 1
        # One final evaluation pins (sigma, state) to the final u.
        young, area = material_values(data, material, lf)
        _, f_int, sigma, st = dense_plastic_system(
            data, young, area, u, state, params, floor, tangent=False,
            yield_tol=band)
        res = torch.linalg.vector_norm((lf * f_ext - f_int) * mask) / fnorm
        rows.append((u, sigma, *st,
                     torch.count_nonzero(st.alpha > state.alpha)))
        res_rows.append(res)
        conv_rows.append(res <= tol_t)
        iters.append(it)
        state = st
    residuals = torch.stack(res_rows).cpu().numpy()
    ok = bool(torch.stack(conv_rows).all())
    return _static_result(lfs, rows, iters, residuals, ok)


def solve_elastoplastic(
    problem: TrussProblem,
    sigma_y,
    hardening_iso=0.0,
    hardening_kin=0.0,
    load_factors: Optional[Sequence[float]] = None,
    n_steps: int = 20,
    target_load_factor: float = 1.0,
    tol: float = 1e-9,
    max_iter: int = 30,
    tangent_floor: float = 1e-8,
    min_denom: float = 1e-12,
    host: Optional[bool] = None,
    data: Optional[ProblemData] = None,
    device=None,
) -> PlasticStaticResult:
    """Trace the elastoplastic response along a load-factor history.

    The JAX package's arguments: sigma_y, hardening_iso, hardening_kin
    scalar or (nelm,); load_factors an explicit history (cyclic loading,
    unloading), by default `ramp_schedule(target_load_factor, n_steps)`;
    tol relative to |f_ext|; host (module docstring).  The port's own:
    device, where to solve when `data` is not given ("cuda" when None)."""
    from . import newton

    if load_factors is None:
        load_factors = ramp_schedule(float(target_load_factor), int(n_steps))
    lfs = np.asarray(load_factors, dtype=float).reshape(-1)
    if lfs.size == 0:
        raise ValueError("load_factors must be non-empty")
    sy, hi, hk = params_arrays(problem.nelm, sigma_y, hardening_iso,
                               hardening_kin)
    dense64 = (problem.ndof <= newton.DENSE_DOF_LIMIT and data is None
               if host is None else host)
    if dense64:
        where = torch.device("cpu") if host else resolve_device(device)
        return _float64_solve(problem, sy, hi, hk, lfs, tol, max_iter,
                              tangent_floor, min_denom, where)
    data = data if data is not None else problem.to_device(device)
    # The float32 residual bottoms out near eps32 |K u| / |f| (the JAX
    # package measured ~5e-6 on the 10-bar cyclic history).
    tol_dev = (max(float(tol), 1e-5) if data.loads.dtype == torch.float32
               else float(tol))
    return _device_solve(problem, data, sy, hi, hk, lfs, tol_dev,
                         int(max_iter), tangent_floor, min_denom)


class PlasticTransientResult(NamedTuple):
    times: np.ndarray           # (n_rec,) record instants
    displacements: np.ndarray   # (n_rec, n_probe)
    velocities: np.ndarray      # (n_rec, n_probe)
    kinetic_energy: np.ndarray  # (n_rec,)
    strain_energy: np.ndarray   # (n_rec,) ELASTIC stored energy
    plastic_work: np.ndarray    # (n_rec,) cumulative int sigma deps_p dV
    external_work: np.ndarray   # (n_rec,) cumulative f_ext . du
    stress_envelope: np.ndarray  # (nelm,) max |sigma| over all steps
    final_displacement: np.ndarray   # (ndof,)
    final_plastic_strain: np.ndarray  # (nelm,)
    final_alpha: np.ndarray     # (nelm,)
    dt: float


def _plastic_central_run(data: ProblemData, young, area, mass, loads, amp,
                         params: PlasticParams, dt: float, alpha_c: float,
                         beta_c: float, k0_apply, f_int_of, probe,
                         n_rec: int, record_every: int):
    """The explicit elastoplastic recurrence in data's dtype, on its
    device, with no host read:

        u_{n+1} = 2u - u_prev + dt^2 M^-1 (a_n f - f_int(u) - C v_lag)

    the return map committed every step, C v = alpha M v + beta K0 v
    (k0_apply, used when beta != 0), f_int_of(fe) the scatter of element
    forces.  The scalars are rounded to the working dtype first, as the
    JAX package's traced scan takes them.  Returns the device tensors
    (us, vs, kes, ses, wps, wes, env, u, eps_p, alpha)."""
    dtype, dev = loads.dtype, loads.device
    npf = np.float64 if dtype == torch.float64 else np.float32
    dt_w = npf(dt)
    dt2 = float(dt_w * dt_w)
    dt = float(dt_w)
    alpha_c, beta_c = float(npf(alpha_c)), float(npf(beta_c))
    amp = [float(a) for a in np.asarray(amp, dtype=npf)]
    mask = data.free_mask
    m = mass * mask + (1.0 - mask)
    inv_m = torch.where(m > 0, 1.0 / m, 0.0)
    loads = loads * mask
    vol = area / data.inv_len
    dt2_inv_m = dt2 * inv_m

    def strain(u):
        return torch.sum(data.gvec * u[data.dof_map], dim=-1) * data.inv_len

    n_total = len(amp)
    kw = dict(dtype=dtype, device=dev)
    us = torch.empty((n_rec, probe.numel()), **kw)
    vs = torch.empty((n_rec, probe.numel()), **kw)
    kes, ses = torch.empty(n_rec, **kw), torch.empty(n_rec, **kw)
    wps, wes = torch.empty(n_rec, **kw), torch.empty(n_rec, **kw)
    state = PlasticState(*(torch.zeros(data.nelm, **kw) for _ in range(3)))
    u = torch.zeros(data.ndof, **kw)
    # u_{-1} = u0 - dt v0 + dt^2/2 a0 with u0 = v0 = 0: the first update
    # gives u_1 = dt^2/2 a0, the constant-acceleration start.
    u_prev = (0.5 * dt2) * (inv_m * (amp[0] * loads) * mask)
    w_p = torch.zeros((), **kw)
    w_ext = torch.zeros((), **kw)
    env = torch.zeros(data.nelm, **kw)
    i = 0
    for r in range(n_rec):
        for _ in range(record_every):
            sig, _, st_new = return_map(strain(u), state, young, params)
            f_int = f_int_of((area * sig)[:, None] * data.gvec)
            w_p = w_p + torch.sum(sig * (st_new.eps_p - state.eps_p) * vol)
            env = torch.maximum(env, torch.abs(sig))
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
        us[r] = u[probe]
        vs[r] = v[probe]
        kes[r] = 0.5 * torch.sum(m * v * v)
        ses[r] = 0.5 * torch.sum(young * (strain(u) - state.eps_p) ** 2
                                 * vol)
        wps[r] = w_p
        wes[r] = w_ext
    return us, vs, kes, ses, wps, wes, env, u, state.eps_p, state.alpha


def _k0_operator(problem: TrussProblem, data: ProblemData, material):
    """K0 v of the device tier: kernel 1 on a banded layout above the dense
    limit (solvers/dynamics._operator: the CUDA kernel on a card, its twin
    on the CPU; float64 refused on a card), the gather form elsewhere."""
    from ..ops.cg import stiffness_coefficients
    from ..ops.scatter import segment_sum_dofs
    from . import dynamics, newton

    if (problem.ndof > newton.DENSE_DOF_LIMIT
            and newton._dia_layout_of(problem, data) is not None):
        return dynamics._operator(problem, data, None).apply
    s0 = stiffness_coefficients(data, material, 1.0)
    gather = data.ensure_gather_map()

    def k0_apply(v):
        gu = torch.sum(data.gvec * v[data.dof_map], dim=-1)
        return segment_sum_dofs((s0 * gu)[:, None] * data.gvec, gather)

    return k0_apply


def solve_transient_plastic(
    problem: TrussProblem,
    sigma_y,
    hardening_iso=0.0,
    hardening_kin=0.0,
    dt: Optional[float] = None,
    n_steps: int = 1000,
    amplitude: Optional[np.ndarray] = None,
    damping=(0.0, 0.0),
    record_every: int = 1,
    probe_dofs: Optional[np.ndarray] = None,
    tangent_floor: float = 1e-8,
    host: Optional[bool] = None,
    data: Optional[ProblemData] = None,
    device=None,
) -> PlasticTransientResult:
    """Explicit central-difference transient with elastoplastic elements.

    Each step is a committed strain increment: the return map runs from
    the previous step's state and commits unconditionally.  The elastic
    stable step applies (yielding only lowers the tangent), with the
    damping forwarded to `dynamics.stable_dt`.  Rayleigh damping: alpha on
    the mass, beta on the INITIAL elastic K0.  Energy balance (the test
    invariant): KE + SE_elastic + W_plastic = W_external to integrator
    accuracy, W_external accumulating f(t_n) . (u_{n+1} - u_n) at the
    force of the step being advanced.

    The JAX package's arguments (tiers in the module docstring; the
    tangent floor is not used by the explicit update).  The port's own:
    device, where to run when `data` is not given ("cuda" when None)."""
    from ..ops import host as H
    from ..ops.mass import lumped_mass
    from ..ops.scatter import segment_sum_dofs
    from . import newton
    from .dynamics import stable_dt

    del tangent_floor
    alpha_c, beta_c = (float(damping[0]), float(damping[1]))
    dense64 = (problem.ndof <= newton.DENSE_DOF_LIMIT and data is None
               if host is None else host)
    where = (torch.device("cpu") if host
             else data.device if data is not None
             else resolve_device(device))
    if dt is None:
        dt = stable_dt(problem, data=data, damping=(alpha_c, beta_c),
                       device=where)
    dt = float(dt)
    n_steps = int(n_steps)
    record_every = int(record_every)
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
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
    probe_np = (np.arange(problem.ndof) if probe_dofs is None
                else np.asarray(probe_dofs, dtype=int).reshape(-1))
    times = dt * record_every * (np.arange(n_rec) + 1.0)

    if dense64:
        f64 = torch.float64
        data64 = problem.to_device(where, f64)

        def on(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(where)

        young, area = (on(a) for a in H.material_values_host(problem))
        k0 = on(H.host_stiffness(problem)) if beta_c else None
        outs = _plastic_central_run(
            data64, young, area, on(H.host_lumped_mass(problem)),
            on(H.loads_of(problem, data)), amp,
            _params(sy, hi, hk, f64, where), dt, alpha_c, beta_c,
            (lambda v: k0 @ v),
            lambda fe: scatter_add(problem.ndof, data64.dof_map, fe),
            torch.as_tensor(probe_np).to(where), n_rec, record_every)
    else:
        data = data if data is not None else problem.to_device(device)
        material = problem.material.to(data.device)
        young, area = material_values(data, material, 1.0)
        gather = data.ensure_gather_map()
        k0_apply = (_k0_operator(problem, data, material) if beta_c
                    else None)
        outs = _plastic_central_run(
            data, young, area, lumped_mass(data, material), data.loads, amp,
            _params(sy, hi, hk, data.loads.dtype, data.device), dt,
            alpha_c, beta_c, k0_apply,
            lambda fe: segment_sum_dofs(fe, gather),
            torch.as_tensor(probe_np).to(data.device), n_rec, record_every)
    (us, vs, kes, ses, wps, wes, env, u_f, ep_f,
     al_f) = (o.cpu().numpy().astype(float) for o in outs)
    return PlasticTransientResult(
        times=times, displacements=us, velocities=vs, kinetic_energy=kes,
        strain_energy=ses, plastic_work=wps, external_work=wes,
        stress_envelope=env, final_displacement=u_f,
        final_plastic_strain=ep_f, final_alpha=al_f, dt=dt)
