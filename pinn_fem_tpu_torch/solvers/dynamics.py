"""Transient structural dynamics: M u'' + C u' + f_int(u) = f(t)
(counterpart of pinn_fem_tpu/solvers/dynamics.py).

Explicit central difference and implicit Newmark-beta with the lumped
mass (ops/mass.py) and Rayleigh damping C = alpha M + beta K.  The linear
stiffness is constant, so it is assembled once per (data, material,
prestress):

  * dense (ndof <= DENSE_DOF_LIMIT): K u is a matmul, and Newmark factors
    its masked effective stiffness once (Cholesky) and solves each step
    with it;
  * banded (a DIA layout): K u is kernel 1, the stencil matvec
    (ops/kernels/dia_kernel.dia_matvec: the CUDA kernel on a card, its
    twin on the CPU), and each Newmark step is one warm-started Jacobi-PCG
    on (1 + a1 beta) K + (a0 + a1 alpha) M (ops/dia.dia_cg_solve: on a
    card the fused PCG, kernels 1-3);
  * gather (no banded layout): K u is ops/cg.apply_stiffness, torch ops.

The JAX package runs the whole time loop as one lax.scan program.  Here
the loop is Python over torch ops that never read the device: amplitudes
and moving-load weights are host numbers, snapshots stay on the device
and come to the host once at the end.  The banded Newmark step reads its
PCG's stop flag every CHECK_EVERY iterations, as every fused PCG does.

method="modal" integrates the lowest modes of solvers/modal.py exactly:
each mode is an SDOF with a closed-form 2 x 2 propagator, and because the
recurrence is linear the states at the snapshots come from one einsum of
the amplitudes and a log2(n_rec)-round doubling scan on the device
(`_modal_run`), with no per-step loop.

Boundary conditions by masking, as everywhere else.  Green-Lagrange
kinematics (geometric_nonlinear) take the gather form for f_int; their
Newmark is dense only, a fixed _NL_NEWMARK_NEWTON_ITERS Newton
iterations a step.  The float64 host tier (host=True) is ROADMAP item 17.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.problem import ProblemData, TrussProblem
from ..ops.assembly import assemble_system, material_values, scatter_add
from ..ops.mass import lumped_mass
from ..utils.runtime import require_float32


class TransientResult(NamedTuple):
    times: np.ndarray           # (n_rec,) snapshot times
    displacements: np.ndarray   # (n_rec, n_probe) probed displacements
    velocities: np.ndarray      # (n_rec, n_probe)
    kinetic_energy: np.ndarray  # (n_rec,)
    strain_energy: np.ndarray   # (n_rec,)
    u_final: np.ndarray         # (ndof,) final displacement state
    v_final: np.ndarray         # (ndof,)


class _Operator(NamedTuple):
    apply: Callable             # u -> K u (K + K_g(u0) under prestress)
    matrix: Optional[torch.Tensor]  # dense K, or the (nd, ndof) diagonals
    layout: object              # the DIA layout on the banded path


# Entries kept per problem: the operator, the mass and Newmark's
# factorization, each for one (data, material, prestress).  They let the
# segments of a checkpointed run share one assembly; the oldest goes.
_CACHE_CAP = 4

# Newton iterations per implicit nonlinear step (a fixed count, as in
# the JAX package).
_NL_NEWMARK_NEWTON_ITERS = 8


def _cached(problem: TrussProblem, key, data: ProblemData, prestress_u,
            make):
    """make(), kept on the problem while its data, material and prestress
    are the same objects."""
    cache = problem.__dict__.setdefault("_dynamics_cache", {})
    entry = cache.get(key)
    if (entry is not None and entry[0] is data
            and entry[1] is problem.material and entry[2] is prestress_u):
        return entry[3]
    value = make()
    cache.pop(key, None)
    if len(cache) >= _CACHE_CAP:
        cache.pop(next(iter(cache)))
    cache[key] = (data, problem.material, prestress_u, value)
    return value


def _vector(x, data: ProblemData) -> torch.Tensor:
    """(ndof,) tensor of x (array or tensor) on data's device and dtype."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(device=data.device, dtype=data.loads.dtype)
    return torch.as_tensor(np.asarray(x, dtype=float).reshape(-1),
                           dtype=data.loads.dtype).to(data.device)


def _np_float(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _material(problem: TrussProblem, data: ProblemData):
    return problem.material.to(data.device)


def _build_operator(problem: TrussProblem, data: ProblemData,
                    prestress_u) -> _Operator:
    from ..ops.cg import apply_stiffness, stiffness_coefficients
    from ..ops.dia import assemble_dia
    from ..ops.geometric import (assemble_geometric, assemble_geometric_dia,
                                 element_axial_forces)
    from ..ops.kernels.dia_kernel import dia_matvec
    from . import newton

    material = _material(problem, data)
    n_e = None
    if prestress_u is not None:
        n_e = element_axial_forces(data, material, _vector(prestress_u, data))
    if problem.ndof <= newton.DENSE_DOF_LIMIT:
        k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
        if n_e is not None:
            k = k + assemble_geometric(data, n_e)
        return _Operator(lambda u: k @ u, k, None)
    layout = newton._dia_layout_of(problem, data)
    if layout is None:
        if n_e is not None:
            raise ValueError("large-mesh prestressed dynamics requires a "
                             "banded (DIA) operator; renumber the mesh")
        s = stiffness_coefficients(data, material, 1.0)
        return _Operator(lambda u: apply_stiffness(data, s, u), None, None)
    if data.device.type == "cuda":
        require_float32(data.loads.dtype,
                        "banded transient (kernel 1: dia_matvec)")
    s = stiffness_coefficients(data, material, 1.0)
    diags = assemble_dia(layout, s, data.gvec)
    if n_e is not None:
        diags = diags + assemble_geometric_dia(layout, data, n_e)
    diags = diags.contiguous()
    return _Operator(lambda u: dia_matvec(layout, diags, u), diags, layout)


def _operator(problem, data, prestress_u) -> _Operator:
    from . import newton

    key = ("operator", id(prestress_u), newton.DENSE_DOF_LIMIT)
    return _cached(problem, key, data, prestress_u,
                   lambda: _build_operator(problem, data, prestress_u))


def _nl_apply_fn(problem: TrussProblem, data: ProblemData):
    """(f_int, strain energy) of Green-Lagrange kinematics in gather form:
    the state-dependent force cannot ride the constant banded operator."""
    from ..ops.elements import truss2d_green_lagrange_batch

    if data.dimension not in (2, 3):
        raise ValueError("geometric nonlinearity requires a 2D or 3D truss")
    young, area = material_values(data, _material(problem, data), 1.0)
    dim = data.dimension
    dx0 = data.gvec[:, dim:] / data.inv_len[:, None]
    x0 = torch.stack([data.mid - 0.5 * dx0, data.mid + 0.5 * dx0], dim=1)
    ea_l0 = young * area / data.inv_len

    def element(u):
        return truss2d_green_lagrange_batch(x0, u[data.dof_map],
                                            data.inv_len, young, area)

    def f_apply(u):
        return scatter_add(data.ndof, data.dof_map, element(u).fe_int)

    def se_apply(u):
        strain = element(u).strain          # U = sum 1/2 E A L0 e_gl^2
        return 0.5 * torch.sum(ea_l0 * strain * strain)

    return f_apply, se_apply


def stable_dt(problem: TrussProblem, data: Optional[ProblemData] = None,
              safety: float = 0.9, damping=(0.0, 0.0), prestress_u=None,
              device=None) -> float:
    """Gershgorin bound on the critical explicit step, times `safety`.

    omega_max^2 <= max_i (sum_j |K_ij|) / m_i over the free rows (all rows
    where the free block carries no stiffness); with Rayleigh damping
    dt_crit = (2 / omega_max)(sqrt(1 + zeta^2) - zeta), zeta = alpha /
    (2 omega_max) + beta omega_max / 2.  prestress_u adds K_g(u0).  Up to
    DENSE_DOF_LIMIT DOFs (and `data` None) the bound is computed on the
    host in float64; above it the row sums of |K| are scatter-added per
    element without forming K, on `data`'s device (`device` when data is
    None).
    """
    from . import newton

    alpha, beta = float(damping[0]), float(damping[1])
    if problem.ndof <= newton.DENSE_DOF_LIMIT and data is None:
        from ..ops import host as H

        m_h = H.host_lumped_mass(problem)
        m_h = np.where(m_h > 0, m_h, 1.0)
        k_h = H.host_stiffness(problem)
        if prestress_u is not None:
            pu = (prestress_u.detach().cpu().double().numpy()
                  if isinstance(prestress_u, torch.Tensor)
                  else np.asarray(prestress_u, dtype=float))
            k_h = k_h + H.host_geometric_stiffness(
                problem, H.host_axial_forces(problem, pu))
        free = H.host_masks(problem) > 0.0
        ratio = np.sum(np.abs(k_h), axis=1) / m_h
        r_max = float(np.max(ratio[free])) if np.any(free) else 0.0
        if r_max <= 0.0:
            # Degenerate free block (an unstressed straight chain's
            # transverse DOFs): the all-rows bound still gives a scale.
            r_max = float(np.max(ratio))
        w_max = float(np.sqrt(r_max))
        zeta = alpha / (2.0 * max(w_max, 1e-30)) + 0.5 * beta * w_max
        return float(safety * (2.0 / w_max)
                     * (np.sqrt(1.0 + zeta * zeta) - zeta))

    from ..ops.cg import stiffness_coefficients
    from ..ops.geometric import assemble_geometric, element_axial_forces

    data = data if data is not None else problem.to_device(device)
    material = _material(problem, data)
    m = lumped_mass(data, material)
    m = torch.where(m > 0, m, 1.0)
    n_e = None
    if prestress_u is not None:
        n_e = element_axial_forces(data, material, _vector(prestress_u, data))
    if problem.ndof <= newton.DENSE_DOF_LIMIT:
        k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
        if n_e is not None:
            k = k + assemble_geometric(data, n_e)
        row = torch.sum(torch.abs(k), dim=1)
    else:
        s = stiffness_coefficients(data, material, 1.0)
        g_abs = torch.abs(data.gvec)
        contrib = (torch.abs(s) * torch.sum(g_abs, dim=1))[:, None] * g_abs
        if n_e is not None:
            # Each row of the +-I block pattern has two unit entries.
            contrib = contrib + (2.0 * torch.abs(n_e) * data.inv_len)[:, None]
        row = scatter_add(data.ndof, data.dof_map, contrib)
    ratio = row / m
    bound = torch.max(torch.where(data.free_mask > 0, ratio, 0.0))
    bound = torch.where(bound > 0, bound, torch.max(ratio))
    w_max = float(torch.sqrt(bound))
    zeta = alpha / (2.0 * max(w_max, 1e-30)) + 0.5 * beta * w_max
    return float(safety * (2.0 / w_max)
                 * (np.sqrt(1.0 + zeta * zeta) - zeta))


class _Records:
    """Snapshots kept on the device, fetched once at the end."""

    def __init__(self, n_rec: int, probe: torch.Tensor, like: torch.Tensor):
        kw = dict(dtype=like.dtype, device=like.device)
        self.probe = probe
        self.us = torch.empty((n_rec, probe.numel()), **kw)
        self.vs = torch.empty((n_rec, probe.numel()), **kw)
        self.kes = torch.empty(n_rec, **kw)
        self.ses = torch.empty(n_rec, **kw)

    def put(self, r: int, u, v, ke, se) -> None:
        self.us[r] = u[self.probe]
        self.vs[r] = v[self.probe]
        self.kes[r] = ke
        self.ses[r] = se


def _central_run(k_apply, m, mask, force, dt: float, alpha: float,
                 beta: float, u0, v0, records: _Records, n_rec: int,
                 record_every: int, f_apply=None, se_apply=None,
                 exact_restart: bool = False):
    """Explicit central difference:

        u_{n+1} = 2u - u_prev + dt^2 M^-1 (f_n - f_int(u) - C (u - u_prev)/dt)

    with the damping velocity lagged half a step.  f_int is K u, or the
    Green-Lagrange force f_apply (beta damping then acts through the
    initial K).  dt is a number exact in the working dtype."""
    npf = _np_float(m.dtype)
    dt2 = float(npf(dt) * npf(dt))
    inv_m = torch.where(m > 0, 1.0 / m, 0.0)
    dt2_inv_m = dt2 * inv_m
    f_int = f_apply if f_apply is not None else k_apply
    damped = alpha != 0.0 or beta != 0.0

    def residual(i, u, v_lag):
        r = force(i) - f_int(u)
        if not damped:
            return r
        if beta != 0.0:
            cu = beta * k_apply(v_lag)
            if alpha != 0.0:
                cu = alpha * (m * v_lag) + cu
        else:
            cu = alpha * (m * v_lag)
        return r - cu

    def one_step(i, u, u_prev):
        v_lag = (u - u_prev) / dt if damped else None
        return (2.0 * u - u_prev + dt2_inv_m * residual(i, u, v_lag)) * mask

    if exact_restart:
        # v0 is a previous segment's backward difference (u - u_prev)/dt,
        # so u_prev comes back to an ulp: no seam between segments.
        u_prev = u0 - dt * v0
    else:
        a0 = inv_m * residual(0, u0, v0) * mask
        u_prev = u0 - dt * v0 + (0.5 * dt2) * a0
    u, i = u0, 0
    for r in range(n_rec):
        for _ in range(record_every):
            u, u_prev = one_step(i, u, u_prev), u
            i += 1
        # Centred velocity for the record: one peek step ahead.
        v = (one_step(i, u, u_prev) - u_prev) / (2.0 * dt)
        se = (se_apply(u) if se_apply is not None
              else 0.5 * torch.dot(u, k_apply(u)))
        records.put(r, u, v, 0.5 * torch.sum(m * v * v), se)
    return u, (u - u_prev) / dt


def _newmark_constants(dt: float, nb: float, ng: float, npf):
    """a0..a7 of the Newmark recurrence, in the working precision."""
    dt, nb, ng = npf(dt), npf(nb), npf(ng)
    one, two, half = npf(1.0), npf(2.0), npf(0.5)
    return [float(c) for c in (
        one / (nb * dt * dt), ng / (nb * dt), one / (nb * dt),
        one / (two * nb) - one, ng / nb - one, half * dt * (ng / nb - two),
        dt * (one - ng), ng * dt)]


def _newmark_solver(problem, data, op: _Operator, m, mask, dt, alpha, beta,
                    nb, ng, cg_tol, prestress_u):
    """rhs, u_guess -> u_new: one Cholesky of the masked effective
    stiffness on the dense path; a warm-started Jacobi-PCG on the banded
    (1 + a1 beta) K + (a0 + a1 alpha) M otherwise (ops.dia.dia_cg_solve:
    the fused PCG on a card)."""
    a0 = 1.0 / (nb * dt * dt)
    a1 = ng / (nb * dt)
    if op.layout is None and op.matrix is not None:
        k_eff = (1.0 + a1 * beta) * op.matrix \
            + (a0 + a1 * alpha) * torch.diag(m)
        k_eff = (mask[:, None] * k_eff * mask[None, :]
                 + torch.diag(1.0 - mask))
        chol = torch.linalg.cholesky(k_eff)

        def solve(rhs, _u_guess):
            return torch.cholesky_solve((rhs * mask)[:, None],
                                        chol)[:, 0] * mask
        return solve
    if op.layout is None:
        raise ValueError(
            "newmark on large meshes requires a banded (DIA) operator; "
            "renumber the mesh or use method='central'")
    from ..ops import dia

    layout = op.layout
    if data.device.type == "cuda":
        require_float32(data.loads.dtype, "banded Newmark (kernels 1-3: "
                        "dia_matvec, dia_dir_matvec, cg_update)")
    k0 = int(np.where(np.asarray(layout.offsets) == 0)[0][0])
    eff = (1.0 + a1 * beta) * op.matrix
    eff[k0] += (a0 + a1 * alpha) * m
    eff = eff.contiguous()

    def solve(rhs, u_guess):
        return dia.dia_cg_solve(layout, eff, rhs, mask, tol=cg_tol,
                                max_iter=20 * layout.ndof, x0=u_guess)[0]
    return solve


def _newmark_run(k_apply, solve_eff, m, mask, loads, amp, dt, alpha, beta,
                 nb, ng, u0, v0, records: _Records, n_rec: int,
                 record_every: int):
    """Newmark-beta (average acceleration by default), one effective
    stiffness solve a step."""
    a0, a1, a2, a3, a4, a5, a6, a7 = _newmark_constants(
        dt, nb, ng, _np_float(m.dtype))
    damped = alpha != 0.0 or beta != 0.0

    def c_apply(v):
        cv = alpha * (m * v)
        if beta != 0.0:
            cv = cv + beta * k_apply(v)
        return cv

    n_total = amp.shape[0]
    r0 = float(amp[0]) * loads - k_apply(u0)
    if damped:
        r0 = r0 - c_apply(v0)
    a = torch.where(m > 0, 1.0 / m, 0.0) * (r0 * mask)
    u, v, i = u0, v0, 0
    for r in range(n_rec):
        for _ in range(record_every):
            rhs = (float(amp[min(i + 1, n_total - 1)]) * loads
                   + m * (a0 * u + a2 * v + a3 * a))
            if damped:
                rhs = rhs + c_apply(a1 * u + a4 * v + a5 * a)
            u_new = solve_eff(rhs, u)
            a_new = a0 * (u_new - u) - a2 * v - a3 * a
            v = (v + a6 * a + a7 * a_new) * mask
            u, a = u_new, a_new * mask
            i += 1
        records.put(r, u, v, 0.5 * torch.sum(m * v * v),
                    0.5 * torch.dot(u, k_apply(u)))
    return u, v


def _newmark_nl_run(problem, data, k_mat, m, mask, loads, amp, dt, alpha,
                    beta, nb, ng, u0, v0, records: _Records, n_rec: int,
                    record_every: int):
    """Implicit nonlinear Newmark: _NL_NEWMARK_NEWTON_ITERS Newton
    iterations a step on R(u) = f - f_int(u) - M a(u) - C v(u), with the
    Green-Lagrange tangent and C = alpha M + beta K0.  Dense only."""
    from ..ops.assembly import assemble_system_nonlinear

    material = _material(problem, data)
    _, se_apply = _nl_apply_fn(problem, data)
    a0, a1, a2, a3, _, _, a6, a7 = _newmark_constants(
        dt, nb, ng, _np_float(m.dtype))
    inv_m = torch.where(m > 0, 1.0 / m, 0.0)
    n_total = amp.shape[0]
    eye_free = torch.diag(1.0 - mask)

    def c_apply(w):
        cw = alpha * (m * w)
        if beta != 0.0:
            cw = cw + beta * (k_mat @ w)
        return cw

    c_jac = alpha * torch.diag(m)
    if beta != 0.0:
        c_jac = c_jac + beta * k_mat
    m_a0, c_a1 = a0 * torch.diag(m), a1 * c_jac

    f_int0 = assemble_system_nonlinear(data, material, u0)[1]
    a = inv_m * ((float(amp[0]) * loads - f_int0 - c_apply(v0)) * mask)
    u, v, i = u0, v0, 0
    for r in range(n_rec):
        for _ in range(record_every):
            f = float(amp[min(i + 1, n_total - 1)]) * loads
            u_new = u
            for _ in range(_NL_NEWMARK_NEWTON_ITERS):
                a_new = a0 * (u_new - u) - a2 * v - a3 * a
                v_new = v + a6 * a + a7 * a_new
                kt, f_int, _ = assemble_system_nonlinear(data, material,
                                                         u_new)
                res = (f - f_int - m * a_new - c_apply(v_new)) * mask
                k_eff = kt + m_a0 + c_a1
                k_eff = mask[:, None] * k_eff * mask[None, :] + eye_free
                u_new = (u_new + torch.linalg.solve(k_eff, res)) * mask
            a_new = (a0 * (u_new - u) - a2 * v - a3 * a) * mask
            v = (v + a6 * a + a7 * a_new) * mask
            u, a = u_new, a_new
            i += 1
        records.put(r, u, v, 0.5 * torch.sum(m * v * v), se_apply(u))
    return u, v


def _propagators(omegas: np.ndarray, zetas: np.ndarray,
                 times: np.ndarray) -> np.ndarray:
    """(T, J, 2, 2) exact SDOF propagators e^{M t} for each time t,
    M = [[0, 1], [-w^2, -2 zeta w]].

    With s = zeta w, (M + sI)^2 = -wd^2 I, wd^2 = w^2 (1 - zeta^2), so
    e^{M t} = e^{-s t} (c I + s1 (M + s I)) with c = cos(wd t), s1 =
    sin(wd t) / wd underdamped, cosh / sinh overdamped (written as sums
    of exponentials, finite at any t), and the second-order series near
    critical damping, where an eigendecomposition breaks down."""
    w = np.asarray(omegas, dtype=float)[None, :]
    z = np.asarray(zetas, dtype=float)[None, :]
    t = np.asarray(times, dtype=float).reshape(-1, 1)
    s = z * w
    wd2 = w * w * (1.0 - z * z)
    x2 = wd2 * t * t                        # (wd t)^2, sign carries regime
    trig = x2 > 1e-8
    hyp = x2 < -1e-8
    near = ~(trig | hyp)                    # defective neighbourhood
    wd = np.sqrt(np.abs(wd2)) + 0.0 * t
    ec = np.zeros_like(x2)                  # e^{-s t} c
    es1 = np.zeros_like(x2)                 # e^{-s t} s1
    decay = np.exp(-s * t)
    arg = wd * t
    ec[trig] = (decay * np.cos(arg))[trig]
    es1[trig] = (decay * np.sin(arg))[trig] / wd[trig]
    grow = np.exp(np.where(hyp, (wd - s) * t, 0.0))
    fall = np.exp(np.where(hyp, -(wd + s) * t, 0.0))
    ec[hyp] = (0.5 * (grow + fall))[hyp]
    es1[hyp] = (0.5 * (grow - fall))[hyp] / wd[hyp]
    tt = t + 0.0 * x2
    ec[near] = (decay * (1.0 + 0.5 * x2))[near]
    es1[near] = (decay * tt * (1.0 + x2 / 6.0))[near]
    s = s + 0.0 * t
    out = np.empty(x2.shape + (2, 2))
    out[..., 0, 0] = ec + s * es1
    out[..., 0, 1] = es1
    out[..., 1, 0] = -(w * w) * es1
    out[..., 1, 1] = ec - s * es1
    return out


def _modal_propagators(omegas: np.ndarray, zetas: np.ndarray,
                       dt: float) -> np.ndarray:
    """(J, 2, 2) exact SDOF propagators e^{M dt} (the JAX package's
    function of this name)."""
    return _propagators(omegas, zetas, np.array([dt]))[0]


def _modal_run(omegas, zetas, dt: float, amp: np.ndarray, q_stat, q0, qd0,
               n_rec: int, record_every: int) -> torch.Tensor:
    """Exact modal-superposition integration: (n_rec + 1, J, 2) modal
    states (q, q') after 0, r, 2r, ... steps, r = record_every.

    Each mode's step is s_{n+1} = A (s_n - s_p) + s_p with A = e^{M dt}
    and s_p = (a_n q_stat, 0), the JAX package's recurrence, exact for a
    per-step-constant load at any dt.  It is linear, so a chunk of r steps
    is s -> P s + F_c with P = A^r = e^{M r dt} and F_c = sum_i a_(cr+i)
    e^{M (r-1-i) dt} (I - A) s_p(1): all chunks' F in one einsum, then the
    chunk recurrence as a doubling (Hillis-Steele) scan with the exact
    powers e^{M 2^k r dt}, about log2(n_rec) rounds of three torch ops.
    The propagators come from `_propagators` in float64 and are rounded
    once to the working dtype."""
    dev, dtype = q_stat.device, q_stat.dtype

    def on_device(a):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    a1 = _modal_propagators(omegas, zetas, dt)
    unit = np.stack([1.0 - a1[:, 0, 0], -a1[:, 1, 0]], axis=1)   # (I - A) e1
    powers = _propagators(omegas, zetas,
                          dt * np.arange(record_every - 1, -1, -1))
    g = on_device(np.einsum("rjab,jb->rja", powers, unit)) \
        * q_stat[None, :, None]                                  # (r, J, 2)
    chunks = on_device(amp[:n_rec * record_every].reshape(n_rec,
                                                           record_every))
    x = torch.cat([torch.stack([q0, qd0], dim=1)[None],
                   torch.einsum("ci,ija->cja", chunks, g)])
    shift = 1
    while shift <= n_rec:
        p = on_device(_modal_propagators(omegas, zetas,
                                         shift * record_every * dt))
        x = torch.cat([x[:shift], x[shift:] + torch.einsum(
            "jab,cjb->cja", p, x[:-shift])])
        shift *= 2
    return x


def _modal_transient(problem, data, m, dt: float, amplitude, damping, u0,
                     v0, records: _Records, n_rec: int, record_every: int,
                     n_modes: int, prestress_u):
    """method="modal": the n_modes lowest modes of modal_analysis (dense
    float64 on data's device, or the banded subspace iteration), exact
    modal damping zeta = (alpha / w + beta w) / 2, the M-orthonormal
    projections q = phi^T M u, and `_modal_run`.  Returns (u_final,
    v_final)."""
    from .modal import modal_analysis

    n_modes = min(n_modes, problem.free_fixed()[0].size)
    mres = modal_analysis(problem, n_modes=n_modes, data=data,
                          prestress_u=prestress_u)
    omegas = np.maximum(np.asarray(mres.omegas, dtype=float), 1e-30)
    zetas = 0.5 * (float(damping[0]) / omegas + float(damping[1]) * omegas)
    dtype, dev = data.loads.dtype, data.device
    phi = torch.as_tensor(mres.shapes, dtype=dtype).to(dev)    # (ndof, J)
    w2 = torch.as_tensor(omegas ** 2, dtype=dtype).to(dev)
    q_stat = (phi.T @ (data.loads * data.free_mask)) / w2
    states = _modal_run(omegas, zetas, dt, amplitude, q_stat,
                        phi.T @ (m * u0), phi.T @ (m * v0), n_rec,
                        record_every)
    q, qd = states[1:, :, 0], states[1:, :, 1]
    phi_probe = phi[records.probe]
    records.us.copy_(q @ phi_probe.T)
    records.vs.copy_(qd @ phi_probe.T)
    # M-orthonormal modal coordinates: KE = sum qd^2 / 2, SE = sum w^2 q^2 / 2.
    records.kes.copy_(0.5 * torch.sum(qd * qd, dim=1))
    records.ses.copy_(0.5 * torch.sum(q * q * w2, dim=1))
    return phi @ states[-1, :, 0], phi @ states[-1, :, 1]


def solve_transient(
    problem: TrussProblem,
    dt: float,
    n_steps: int,
    amplitude: Optional[np.ndarray] = None,
    damping=(0.0, 0.0),
    u0: Optional[np.ndarray] = None,
    v0: Optional[np.ndarray] = None,
    method: str = "central",
    record_every: int = 1,
    probe_dofs: Optional[np.ndarray] = None,
    newmark_beta: float = 0.25,
    newmark_gamma: float = 0.5,
    cg_tol: float = 1e-6,
    data: Optional[ProblemData] = None,
    fetch_state: bool = True,
    geometric_nonlinear: bool = False,
    exact_restart: bool = False,
    n_modes: int = 32,
    prestress_u=None,
    force_fn=None,
    host: Optional[bool] = None,
    device=None,
) -> TransientResult:
    """Integrate M u'' + C u' + f_int(u) = amplitude(t) * loads.

    The JAX package's arguments and checks:
        amplitude: (n_steps,) or (n_steps + 1,) load scale (default a unit
            step; the extra sample feeds the last snapshot's peek).
        damping: Rayleigh (alpha, beta).
        method: "central" (explicit, see stable_dt), "newmark"
            (implicit) or "modal" (the n_modes lowest modes of
            solvers/modal.modal_analysis, integrated exactly).
        record_every: snapshot stride; n_steps must be a multiple.
        probe_dofs: DOFs to record (default all).
        exact_restart: (u0, v0) are a previous segment's (u_final,
            v_final): u_prev is recovered exactly (central only).
        geometric_nonlinear: Green-Lagrange f_int (central; newmark dense
            only).  Not with prestress_u.
        prestress_u: linearized initial stress K_g(u0) in the operator.
        force_fn: f(i) -> (ndof,) tensor in place of amplitude * loads
            (central only): moving_load_force_fn, base_excitation_force_fn.
        fetch_state: False keeps u_final / v_final on the device.
        host: True asks for the float64 host tier, ROADMAP item 17; None
            and False take this path (as the JAX package does off a TPU).
    The port's own: device, where to solve when `data` is not given
    ("cuda" when None).
    """
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    amplitude = (np.ones(n_steps) if amplitude is None
                 else np.asarray(amplitude, dtype=float))
    if amplitude.shape not in ((n_steps,), (n_steps + 1,)):
        raise ValueError(
            f"amplitude must have shape ({n_steps},) or ({n_steps + 1},)")
    if prestress_u is not None and geometric_nonlinear:
        raise ValueError("prestress_u is the LINEARIZED initial-stress "
                         "model; geometric_nonlinear already carries the "
                         "full state dependence — use one or the other")
    if geometric_nonlinear and method not in ("central", "newmark"):
        raise ValueError("geometric_nonlinear requires method='central' "
                         "or 'newmark' (modal superposition is a linear "
                         "concept)")
    if force_fn is not None and method != "central":
        raise ValueError("force_fn supports method='central' only")
    if host:
        raise NotImplementedError(
            "the float64 host transient tier (host=True) is not yet ported, "
            "ROADMAP item 17")
    if method not in ("central", "newmark", "modal"):
        raise ValueError("method must be 'central', 'newmark' or 'modal'")

    from . import newton

    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    npf = _np_float(dtype)
    ndof = problem.ndof
    mask = data.free_mask
    u0 = torch.zeros_like(mask) if u0 is None else _vector(u0, data) * mask
    v0 = torch.zeros_like(mask) if v0 is None else _vector(v0, data) * mask
    probe = (torch.arange(ndof, device=dev) if probe_dofs is None
             else torch.as_tensor(np.asarray(probe_dofs, dtype=np.int64)
                                  ).to(dev))
    # Unit mass on fixed DOFs keeps divisions benign; the mask kills motion.
    m = _cached(problem, ("mass",), data, None, lambda: lumped_mass(
        data, _material(problem, data)) * mask + (1.0 - mask))
    alpha, beta = float(npf(damping[0])), float(npf(damping[1]))
    dt_w = float(npf(dt))
    amp = amplitude.astype(npf)
    n_rec = n_steps // record_every
    records = _Records(n_rec, probe, mask)
    op = None if method == "modal" else _operator(problem, data, prestress_u)

    if method == "modal":
        u_f, v_f = _modal_transient(problem, data, m, float(dt), amplitude,
                                    damping, u0, v0, records, n_rec,
                                    record_every, n_modes, prestress_u)
    elif method == "central":
        f_apply = se_apply = None
        if geometric_nonlinear:
            f_apply, se_apply = _nl_apply_fn(problem, data)
        if force_fn is None:
            loads = data.loads

            def force(i):
                return float(amp[min(i, amp.shape[0] - 1)]) * loads
        else:
            force = force_fn
        u_f, v_f = _central_run(
            op.apply, m, mask, force, dt_w, alpha, beta, u0, v0, records,
            n_rec, record_every, f_apply=f_apply, se_apply=se_apply,
            exact_restart=exact_restart)
    elif geometric_nonlinear:
        if ndof > newton.DENSE_DOF_LIMIT:
            raise ValueError("nonlinear Newmark is dense-only (the "
                             "tangent changes every Newton "
                             "iteration); use method='central' for "
                             "large meshes")
        u_f, v_f = _newmark_nl_run(
            problem, data, op.matrix, m, mask, data.loads, amp, dt_w, alpha,
            beta, newmark_beta, newmark_gamma, u0, v0, records, n_rec,
            record_every)
    else:
        key = ("newmark", float(dt), float(damping[0]), float(damping[1]),
               float(newmark_beta), float(newmark_gamma), float(cg_tol),
               id(prestress_u), newton.DENSE_DOF_LIMIT)
        solve_eff = _cached(problem, key, data, prestress_u,
                            lambda: _newmark_solver(
                                problem, data, op, m, mask, float(dt),
                                float(damping[0]), float(damping[1]),
                                float(newmark_beta), float(newmark_gamma),
                                cg_tol, prestress_u))
        u_f, v_f = _newmark_run(
            op.apply, solve_eff, m, mask, data.loads, amp, dt_w, alpha, beta,
            newmark_beta, newmark_gamma, u0, v0, records, n_rec,
            record_every)

    times = dt * record_every * np.arange(1, n_rec + 1)
    if fetch_state:
        u_f, v_f = u_f.cpu().numpy(), v_f.cpu().numpy()
    return TransientResult(
        times=times, displacements=records.us.cpu().numpy(),
        velocities=records.vs.cpu().numpy(),
        kinetic_energy=records.kes.cpu().numpy(),
        strain_energy=records.ses.cpu().numpy(), u_final=u_f, v_final=v_f)


def solve_transient_checkpointed(
    problem: TrussProblem,
    dt: float,
    n_steps: int,
    checkpoint_dir,
    checkpoint_every: int,
    amplitude: Optional[np.ndarray] = None,
    resume: bool = True,
    data: Optional[ProblemData] = None,
    device=None,
    **kw,
) -> TransientResult:
    """Preemption-safe transient run: checkpoint_every-step segments, each
    followed by utils/checkpoint.save_transient_state (the JAX package's
    transient.npz and transient_meta.json).  A run restarted with
    resume=True continues from the last saved segment and returns the
    records of the steps it ran.  The segments share one operator (and
    Newmark's factorization) through the problem's cache."""
    from ..utils.checkpoint import load_transient_state, save_transient_state

    record_every = kw.get("record_every", 1)
    if n_steps % checkpoint_every or checkpoint_every % record_every:
        raise ValueError("need n_steps % checkpoint_every == 0 and "
                         "checkpoint_every % record_every == 0")
    if "u0" in kw or "v0" in kw:
        raise ValueError("initial conditions come from the checkpoint; "
                         "run the first segment unchekpointed instead")
    if kw.get("force_fn") is not None:
        # force_fn(i) counts steps from each segment's start.
        raise ValueError("checkpointed transients support the amplitude "
                         "contract only, not force_fn")
    data = data if data is not None else problem.to_device(device)
    amplitude = (np.ones(n_steps) if amplitude is None
                 else np.asarray(amplitude, dtype=float))
    if amplitude.shape != (n_steps,):
        raise ValueError(f"amplitude must have shape ({n_steps},)")

    start_step = 0
    u = v = None
    if resume:
        state = load_transient_state(checkpoint_dir)
        if state is not None:
            start_step, u, v, _ = state
            if start_step % checkpoint_every:
                raise ValueError(
                    f"checkpoint at step {start_step} does not align with "
                    f"checkpoint_every={checkpoint_every}")

    segments = []
    for seg_start in range(start_step, n_steps, checkpoint_every):
        # The next segment's first amplitude sample feeds this segment's
        # last peek, as in an uninterrupted run.
        res = solve_transient(
            problem, dt, checkpoint_every,
            amplitude=amplitude[seg_start:min(
                seg_start + checkpoint_every + 1, n_steps)],
            u0=u, v0=v, data=data, exact_restart=seg_start > 0, **kw)
        u, v = res.u_final, res.v_final
        save_transient_state(checkpoint_dir, seg_start + checkpoint_every,
                             u, v, meta={"dt": float(dt),
                                         "n_steps": n_steps})
        segments.append(res._replace(times=res.times + seg_start * dt))

    if not segments:
        raise ValueError("checkpoint already covers all n_steps; delete "
                         "the directory to rerun")
    return TransientResult(
        times=np.concatenate([s.times for s in segments]),
        displacements=np.concatenate([s.displacements for s in segments]),
        velocities=np.concatenate([s.velocities for s in segments]),
        kinetic_energy=np.concatenate([s.kinetic_energy for s in segments]),
        strain_energy=np.concatenate([s.strain_energy for s in segments]),
        u_final=segments[-1].u_final, v_final=segments[-1].v_final)


def _force_target(problem: TrussProblem, data, device):
    """(dtype, device) of a force function's vectors: data's, or the
    working dtype on `device` ("cuda" when None)."""
    if data is not None:
        return data.loads.dtype, data.device
    from ..utils.runtime import default_dtype, resolve_device

    return default_dtype(), resolve_device(device)


def moving_load_force_fn(problem: TrussProblem, path_nodes, speed: float,
                         magnitude: float, dt: float, component: int = 1,
                         data: Optional[ProblemData] = None, device=None):
    """force_fn for a point load crossing the structure at constant speed
    along the polyline of `path_nodes`, split linearly between the two
    nodes of the segment it is on, on DOF component `component`; zero
    before entry and after exit.  Its segment and weight come from
    speed * dt * i on the host, in the working precision (as the JAX
    package computes them on the device), and each call writes two
    entries of a zero vector.  `.host_eval(i)` is the float64 numpy
    form."""
    dtype, dev = _force_target(problem, data, device)
    npf = _np_float(dtype)
    nodes = np.atleast_2d(np.asarray(problem.nodes, dtype=float).T).T
    path = np.asarray(path_nodes, dtype=int)
    seg = np.linalg.norm(np.diff(nodes[path], axis=0), axis=1)
    s_cum = np.concatenate([[0.0], np.cumsum(seg)]).astype(npf)
    s_total = s_cum[-1]
    dofs = (problem.dimension * path + component).astype(np.int64)
    ndof = problem.ndof
    step = npf(speed * dt)
    mag = npf(magnitude)

    def force_fn(i):
        pos = step * npf(i)
        inside = npf(npf(0.0) <= pos <= s_total)
        k = int(np.clip(np.searchsorted(s_cum, pos, side="right") - 1,
                        0, path.size - 2))
        w = (pos - s_cum[k]) / max(s_cum[k + 1] - s_cum[k], npf(1e-30))
        w = min(max(w, npf(0.0)), npf(1.0))
        f = torch.zeros(ndof, dtype=dtype, device=dev)
        f[int(dofs[k])] += float(mag * (npf(1.0) - w) * inside)
        f[int(dofs[k + 1])] += float(mag * w * inside)
        return f

    s_cum64 = s_cum.astype(float)

    def host_eval(i):
        pos = speed * dt * i
        inside = 1.0 if (0.0 <= pos <= float(s_total)) else 0.0
        k = int(np.clip(np.searchsorted(s_cum64, pos, side="right") - 1,
                        0, path.size - 2))
        w = (pos - s_cum64[k]) / max(s_cum64[k + 1] - s_cum64[k], 1e-30)
        w = float(np.clip(w, 0.0, 1.0))
        f = np.zeros(ndof)
        f[dofs[k]] += magnitude * (1.0 - w) * inside
        f[dofs[k + 1]] += magnitude * w * inside
        return f

    force_fn.host_eval = host_eval
    return force_fn


def base_excitation_force_fn(problem: TrussProblem, accel_history,
                             direction=None,
                             data: Optional[ProblemData] = None,
                             device=None):
    """force_fn for uniform support acceleration a_g(t) in relative
    coordinates: f = -M iota a_g(t_i), iota the shaking direction tiled
    over the nodes, M the float64 host lumped mass (ops/host.py) rounded
    once.  `.host_eval(i)` is the float64 numpy form."""
    from ..ops.host import host_lumped_mass

    accel_np = np.asarray(accel_history, dtype=float).reshape(-1)
    dim = problem.dimension
    dir_np = (np.asarray(direction, dtype=float).reshape(-1)
              if direction is not None else np.eye(dim)[0])
    if dir_np.size != dim:
        raise ValueError(f"direction must have {dim} components, "
                         f"got {dir_np.size}")
    dtype, dev = _force_target(problem, data, device)
    miota_np = -(host_lumped_mass(problem)
                 * np.tile(dir_np, problem.ndof // dim))
    miota = torch.as_tensor(miota_np, dtype=dtype).to(dev)
    acc = accel_np.astype(_np_float(dtype))
    n_hist = accel_np.size

    def force_fn(i):
        return miota * float(acc[min(int(i), n_hist - 1)])

    def host_eval(i):
        return miota_np * accel_np[min(int(i), n_hist - 1)]

    force_fn.host_eval = host_eval
    return force_fn
