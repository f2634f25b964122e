"""Geometrically nonlinear shallow-shell statics (counterpart of
pinn_fem_tpu/solvers/shell_nonlinear.py): Marguerre / von Karman
kinematics on the projected midsurface, load-stepped Newton and Crisfield
arc-length (Riks) continuation.

The midsurface is an elevation z = w0(x, y) over the x-y base plane; the
membrane strain picks up the quadratic transverse terms

    eps_m = B_m u_m + 1/2 (grad(w0 + w) (x) grad(w0 + w) - grad w0 (x) grad w0)

while the curvature (MITC4 Mindlin), the assumed shear and the drilling
stabilization stay linear.  Internal force and consistent tangent per 2 x 2
Gauss point, N = t D_m eps_m:

    f_u = int B_m^T N     f_w = int B_w(G)^T N,   B_w(G) = A(G) G_w
    K_uu = int B_m^T D B_m    K_uw = int B_m^T D B_w
    K_ww = int B_w^T D B_w + int G_w^T N^ G_w

All blocks are evaluated on the projected corner coordinates (global axes,
no facet frames); a slope |grad w0| above 0.45 is refused.

Three tiers, as in the JAX package:

  * `solve_shell_nonlinear`: float64 damped Newton (Armijo, 12 halvings,
    the best trial kept) on the dense tangent, torch on the caller's
    device, the card by default.  The JAX host tier commits the best trial
    even where it makes the residual worse (ROADMAP fault 3.2), and so
    does this one;
  * `solve_shell_riks`: Crisfield cylindrical arc length, float64, one LU
    of the masked tangent a corrector iteration for both right-hand sides;
    a step whose corrector fails is retried at a quarter of the arc length
    from the last converged state, up to 4 shrinks, never committed.  With
    disc < 0 and b = 0 the corrector takes x = 0 (the JAX package's
    fallback, ROADMAP fault 3.2);
  * `solve_shell_nonlinear_banded`: the large-mesh tier in the working
    dtype.  A Newton iteration rebuilds the (m, 24, 24) tangent blocks
    (batched torch matmuls: no repo kernel), scatters them into DIA diagonals (one
    float64 scatter rounded once) and runs one Jacobi-PCG
    (ops/dia.dia_cg_solve, components=6: on a card the fused kernels 2 and
    3), then reads (residual, PCG residual, |du|) once; a trial state of
    the line search reads (residual, |u|) once.  Converged by the residual
    tol, the increment du_tol or the stall acceptance (three iterations
    without a 10% improvement under stall_accept); a PCG that does not
    reach 100 cg_tol raises (an indefinite tangent).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.shell import (_BND_IDX, _DRILL_ALPHA, _DRILL_EPS, _DRL_IDX,
                            _GP, _MEM_IDX, _Q_BETA, ShellProblem,
                            _facet_area, _q4_point, _t)
from ..ops.assembly import scatter_add
from ..ops.dia import assemble_dia_blocks, dia_cg_solve
from ..utils.runtime import default_dtype, resolve_device

__all__ = ["ShellNonlinearResult", "solve_shell_nonlinear",
           "solve_shell_nonlinear_banded", "solve_shell_riks",
           "marguerre_energy"]

# Positions of the w DOFs inside the 12-wide (w, theta_x, theta_y)-per-node
# bending sub-vector, and in the 24-wide element vector.
_W_IN_BND = np.array([0, 3, 6, 9])
_WB = _BND_IDX[_W_IN_BND]
# The Marguerre validity bound on the midsurface slope |grad w0|.
_MAX_SLOPE = 0.45
_F64 = torch.float64


class ShellNonlinearResult(NamedTuple):
    load_factors: np.ndarray      # (n_steps,)
    displacements: np.ndarray     # (n_steps, ndof)
    membrane_forces: np.ndarray   # (n_steps, m, 3) centroid N
    moments: np.ndarray           # (n_steps, m, 3) centroid M
    iterations: np.ndarray        # (n_steps,)
    residuals: np.ndarray         # (n_steps,) |R|/max(|f_ext|,1)
    converged: bool


class _Geometry(NamedTuple):
    c2: torch.Tensor        # (m, 4, 2) projected corner coordinates
    bm: torch.Tensor        # (m, 4, 3, 8) membrane B per Gauss point
    gw: torch.Tensor        # (m, 4, 2, 4) gradient on the w nodes
    g0: torch.Tensor        # (m, 4, 2) initial slope grad w0
    det: torch.Tensor       # (m, 4) Jacobians
    kb: torch.Tensor        # (m, 12, 12) linear bending + shear (theta)
    kd: torch.Tensor        # (m, 4, 4) drilling stabilization
    dm: torch.Tensor        # (m, 3, 3) t D_m membrane rigidity
    db: torch.Tensor        # (m, 3, 3) bending rigidity D_b
    dof_map: torch.Tensor   # (m, 24) int64


def _marguerre_geometry(problem: ShellProblem, drill_eps: float = _DRILL_EPS,
                        device=None) -> _Geometry:
    """The hoisted projected geometry, float64 on `device` (CPU when None);
    refuses a non-positive projected Jacobian and a slope above 0.45."""
    from ..models.plane import _dmat
    from ..models.plate import _dmats, _k_blocks_plate, _shape_grads

    xe = problem.nodes[problem.elements]
    c2 = _t(xe[:, :, :2], device)
    w0e = _t(xe[:, :, 2], device)
    young, poisson, thick = (_t(getattr(problem, n), device) for n in
                             ("young", "poisson", "thickness"))
    bms, gws, g0s, dets = [], [], [], []
    for xi, eta in _GP:
        bmem, det = _q4_point(c2, xi, eta)
        _, dx, dy, _ = _shape_grads(c2, xi, eta)
        gw = torch.stack([dx, dy], dim=1)                   # (m, 2, 4)
        bms.append(bmem)
        gws.append(gw)
        g0s.append(torch.einsum("mca,ma->mc", gw, w0e))
        dets.append(det)
    det = torch.stack(dets, dim=1)
    if bool(torch.any(det <= 0.0)):
        raise ValueError(
            "shallow-shell projection is degenerate (a facet "
            "projects with non-positive area onto the x-y base "
            "plane) — the Marguerre formulation needs a one-to-one "
            "elevation z = w0(x, y); use the faceted linear shell "
            "for deep midsurfaces")
    g0 = torch.stack(g0s, dim=1)
    slope = (float(torch.linalg.vector_norm(g0, dim=-1).max())
             if g0.numel() else 0.0)
    if slope > _MAX_SLOPE:
        raise ValueError(
            f"midsurface slope |∇w0| = {slope:.3f} exceeds the "
            f"Marguerre shallow-shell validity bound {_MAX_SLOPE} — "
            "the dropped O(slope²) membrane terms are no longer "
            "negligible; this solver serves shallow panels/arches "
            "(use the linear faceted shell for deep geometry)")
    q = _t(_Q_BETA, device)
    kb = q.T @ _k_blocks_plate(c2, young, poisson, thick) @ q
    area = _t(_facet_area(xe[:, :, :2]), device)
    g = young / (2.0 * (1.0 + poisson))
    pen = _t((np.eye(4) - 0.25) + drill_eps * np.eye(4), device)
    kd = (_DRILL_ALPHA * g * thick * area)[:, None, None] * pen
    db, _ = _dmats(young, poisson, thick)
    return _Geometry(c2=c2, bm=torch.stack(bms, dim=1),
                     gw=torch.stack(gws, dim=1), g0=g0, det=det, kb=kb,
                     kd=kd, dm=_dmat(young, poisson, False)
                     * thick[:, None, None], db=db,
                     dof_map=torch.as_tensor(problem.dof_map(),
                                             dtype=torch.int64,
                                             device=device))


def _f_ext_marguerre(problem: ShellProblem, device=None) -> torch.Tensor:
    """(6n,) float64 nodal loads + vertical pressure / body force per unit
    projected area (the shallow-shell load convention)."""
    from ..models.plate import _shape_grads

    if problem.temperature is not None \
            or problem.temperature_gradient is not None:
        raise ValueError(
            "the nonlinear shallow-shell solver does not carry the "
            "thermoelastic load case — drop temperature/"
            "temperature_gradient (run thermoelasticity on the "
            'linear "static" analysis)')
    f = _t(problem.loads, device)
    if problem.pressure is None and problem.body_force is None:
        return f
    c2 = _t(problem.nodes[problem.elements][:, :, :2], device)
    fe = torch.zeros((problem.nelm, 4), dtype=_F64, device=device)
    for xi, eta in _GP:
        n, _, _, det = _shape_grads(c2, xi, eta)
        fe += det[:, None] * _t(n, device)[None, :]
    enodes = torch.as_tensor(problem.elements, dtype=torch.int64,
                             device=device)
    if problem.pressure is not None:
        f = f + scatter_add(problem.ndof, 6 * enodes + 2,
                            _t(problem.pressure, device)[:, None] * fe)
    if problem.body_force is not None:
        for d in range(3):
            f = f + scatter_add(problem.ndof, 6 * enodes + d,
                                float(problem.body_force[d]) * fe)
    return f


def _marguerre_blocks(bm_g, gw_g, g0_g, det_g, kb, kd, dm, u_e,
                      tangent: bool = True):
    """Batched Marguerre element tangent and internal force at element
    displacements u_e (m, 24), in u_e's dtype on its device: (ke (m, 24,
    24) or None without tangent, fe (m, 24), the membrane forces per Gauss
    point (m, 4, 3), the strain energy)."""
    m = u_e.shape[0]
    dev = u_e.device
    mem, bnd, drl, wb = (torch.as_tensor(i, device=dev) for i in
                         (_MEM_IDX, _BND_IDX, _DRL_IDX, _WB))
    u_m, u_b, u_d = u_e[:, mem], u_e[:, bnd], u_e[:, drl]
    w_e = u_e[:, wb]
    f_m = f_w = k_mm = k_mw = k_ww = None
    energy = torch.zeros((), dtype=u_e.dtype, device=dev)
    n_gp = []

    def acc(total, part):
        return part if total is None else total + part

    for g in range(bm_g.shape[1]):
        bm, gw, g0, det = bm_g[:, g], gw_g[:, g], g0_g[:, g], det_g[:, g]
        gt = g0 + (gw @ w_e[:, :, None])[..., 0]            # total slope
        eps = (bm @ u_m[:, :, None])[..., 0] + 0.5 * torch.stack(
            [gt[:, 0] ** 2 - g0[:, 0] ** 2, gt[:, 1] ** 2 - g0[:, 1] ** 2,
             2.0 * (gt[:, 0] * gt[:, 1] - g0[:, 0] * g0[:, 1])], dim=-1)
        nf = (dm @ eps[:, :, None])[..., 0]
        n_gp.append(nf)
        energy = energy + 0.5 * torch.sum(eps * nf * det[:, None])
        zr = torch.zeros_like(gt[:, 0])
        a_g = torch.stack([torch.stack([gt[:, 0], zr], dim=-1),
                           torch.stack([zr, gt[:, 1]], dim=-1),
                           torch.stack([gt[:, 1], gt[:, 0]], dim=-1)], dim=1)
        bw = a_g @ gw                                       # (m, 3, 4)
        f_m = acc(f_m, det[:, None] * (nf[:, None, :] @ bm)[:, 0])
        f_w = acc(f_w, det[:, None] * (nf[:, None, :] @ bw)[:, 0])
        if tangent:
            nhat = torch.stack([torch.stack([nf[:, 0], nf[:, 2]], dim=-1),
                                torch.stack([nf[:, 2], nf[:, 1]], dim=-1)],
                               dim=1)
            d3 = det[:, None, None]
            dm_bw = dm @ bw
            k_mm = acc(k_mm, d3 * (bm.transpose(1, 2) @ (dm @ bm)))
            k_mw = acc(k_mw, d3 * (bm.transpose(1, 2) @ dm_bw))
            k_ww = acc(k_ww, d3 * (bw.transpose(1, 2) @ dm_bw
                                   + gw.transpose(1, 2) @ (nhat @ gw)))
    fe = torch.zeros((m, 24), dtype=u_e.dtype, device=dev)
    fe[:, mem] = f_m
    f_b = (kb @ u_b[:, :, None])[..., 0]
    f_d = (kd @ u_d[:, :, None])[..., 0]
    fe[:, bnd] = f_b
    fe[:, drl] = f_d
    fe[:, wb] += f_w
    energy = energy + 0.5 * (torch.sum(u_b * f_b) + torch.sum(u_d * f_d))
    ke = None
    if tangent:
        ke = torch.zeros((m, 24, 24), dtype=u_e.dtype, device=dev)
        ke[:, mem[:, None], mem[None, :]] = k_mm
        ke[:, mem[:, None], wb[None, :]] = k_mw
        ke[:, wb[:, None], mem[None, :]] = k_mw.transpose(1, 2)
        ke[:, bnd[:, None], bnd[None, :]] = kb
        ke[:, wb[:, None], wb[None, :]] += k_ww
        ke[:, drl[:, None], drl[None, :]] = kd
    return ke, fe, torch.stack(n_gp, dim=1), energy


def _element_state(geo: _Geometry, u: torch.Tensor, tangent: bool = True):
    """(ke, fe, centroid N (m, 3), centroid M (m, 3), energy) at u."""
    from ..models.plate import _bend_b, _shape_grads

    u_e = u[geo.dof_map]
    ke, fe, n_gp, energy = _marguerre_blocks(
        geo.bm, geo.gw, geo.g0, geo.det, geo.kb, geo.kd, geo.dm, u_e,
        tangent)
    _, dx, dy, _ = _shape_grads(geo.c2, 0.0, 0.0)
    u_b = u_e[:, torch.as_tensor(_BND_IDX, device=u.device)]
    kap = torch.einsum("mia,ma->mi", _bend_b(dx, dy),
                       u_b @ _t(_Q_BETA, u.device, u.dtype).T)
    return ke, fe, n_gp.mean(dim=1), torch.einsum("mij,mj->mi", geo.db,
                                                  kap), energy


def _assemble(problem: ShellProblem, geo: _Geometry, u: torch.Tensor,
              tangent: bool = True):
    """(dense K or None, f_int, centroid N, centroid M, energy)."""
    ke, fe, n_c, m_c, energy = _element_state(geo, u, tangent)
    n = problem.ndof
    k = None
    if tangent:
        flat = geo.dof_map[:, :, None] * n + geo.dof_map[:, None, :]
        k = scatter_add(n * n, flat, ke).reshape(n, n)
    return k, scatter_add(n, geo.dof_map, fe), n_c, m_c, energy


def marguerre_energy(problem: ShellProblem, u, device=None) -> float:
    """Total strain energy at state u (membrane von Karman + linear
    bending / shear / drilling), float64 on `device` ("cuda" when None):
    the functional whose exact gradient the internal force is."""
    dev = resolve_device(device)
    geo = _marguerre_geometry(problem, device=dev)
    return float(_assemble(problem, geo, _t(u, dev), tangent=False)[4])


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x))


def _numpy_rows(rows):
    return np.asarray(torch.stack(rows).cpu().numpy(), dtype=float)


def solve_shell_nonlinear(
    problem: ShellProblem,
    load_factors: Optional[Sequence[float]] = None,
    n_steps: int = 10,
    target_load_factor: float = 1.0,
    tol: float = 1e-9,
    max_iter: int = 40,
    min_denom: float = 1e-12,
    device=None,
) -> ShellNonlinearResult:
    """Load-controlled von Karman / Marguerre statics: full Newton with the
    consistent tangent and an Armijo backtracking guard per load step,
    float64 on `device` ("cuda" when None).  Fails (converged=False) at a
    limit point: snap-through is solve_shell_riks's."""
    from .plane_plasticity import _schedule

    dev = resolve_device(device)
    lfs = _schedule(load_factors, target_load_factor, n_steps)
    geo = _marguerre_geometry(problem, device=dev)
    mask = _t(problem.free_mask(), dev)
    f_ext = _f_ext_marguerre(problem, dev) * mask
    fnorm = max(_norm(f_ext), min_denom)
    km_fix = torch.diag(1.0 - mask)

    u = torch.zeros(problem.ndof, dtype=_F64, device=dev)
    rows = {k: [] for k in ("u", "nf", "mom")}
    iters, residuals, all_ok = [], [], True
    for lf in lfs:
        lf = float(lf)
        ok, res, it_used = False, np.inf, max_iter
        for it in range(max_iter):
            k_t, f_int, n_c, m_c, _ = _assemble(problem, geo, u)
            r = (lf * f_ext - f_int) * mask
            res = _norm(r) / fnorm
            if res <= tol:
                ok, it_used = True, it
                break
            km = mask[:, None] * k_t * mask[None, :] + km_fix
            du = torch.linalg.solve(km, r) * mask
            s, best_s, best_res = 1.0, 1.0, np.inf
            for _ in range(12):
                f_try = _assemble(problem, geo, u + s * du, False)[1]
                res_try = _norm((lf * f_ext - f_try) * mask) / fnorm
                if res_try < best_res:
                    best_s, best_res = s, res_try
                if res_try <= (1.0 - 1e-4 * s) * res:
                    break
                s *= 0.5
            # The best trial is committed even where it raises the
            # residual (the JAX host tier's rule, ROADMAP fault 3.2).
            u = u + best_s * du
        all_ok &= ok
        if not ok:
            _, f_int, n_c, m_c, _ = _assemble(problem, geo, u, False)
            res = _norm((lf * f_ext - f_int) * mask) / fnorm
        rows["u"].append(u.clone())
        rows["nf"].append(n_c)
        rows["mom"].append(m_c)
        iters.append(it_used)
        residuals.append(res)
    return ShellNonlinearResult(
        load_factors=np.asarray(lfs, dtype=float),
        displacements=_numpy_rows(rows["u"]),
        membrane_forces=_numpy_rows(rows["nf"]),
        moments=_numpy_rows(rows["mom"]),
        iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float),
        converged=bool(all_ok))


def solve_shell_riks(
    problem: ShellProblem,
    n_steps: int = 60,
    dl0: float = 0.1,
    tol: float = 1e-8,
    max_arc_iter: int = 25,
    desired_iters: int = 5,
    max_dl: Optional[float] = None,
    min_denom: float = 1e-12,
    device=None,
) -> ShellNonlinearResult:
    """Crisfield cylindrical arc-length continuation on the Marguerre
    assembly, float64 on `device` ("cuda" when None): LU on the masked
    tangent (indefinite past the fold), the constraint |du + du_r + dlam
    du_t|^2 = dl^2 with the root that continues the increment, the step
    adapting as dl <- dl sqrt(desired / used) up to max_dl (10 dl0 when
    None).  A failed step is retried at a quarter of the arc length from
    the last converged state, up to 4 shrinks; then the trace stops with
    converged=False and the path points collected so far."""
    dev = resolve_device(device)
    geo = _marguerre_geometry(problem, device=dev)
    mask = _t(problem.free_mask(), dev)
    f_ext = _f_ext_marguerre(problem, dev) * mask
    fnorm = max(_norm(f_ext), min_denom)
    km_fix = torch.diag(1.0 - mask)

    def tangent_and_resid(u, lam):
        k_t, f_int, n_c, m_c, _ = _assemble(problem, geo, u)
        km = mask[:, None] * k_t * mask[None, :] + km_fix
        return km, (lam * f_ext - f_int) * mask, n_c, m_c

    def dot(a, b) -> float:
        return float(a @ b)

    u = torch.zeros(problem.ndof, dtype=_F64, device=dev)
    lam = 0.0
    dl = float(dl0)
    max_dl = float(max_dl) if max_dl is not None else 10.0 * dl
    prev_du, prev_dlam = None, 1.0
    rows = {k: [] for k in ("lam", "u", "nf", "mom", "it", "res")}
    all_ok = True
    # (lam, iterations, residual) of the committed step whose centroid
    # recovery the next step's tangent assembly provides.
    pending = None

    def commit_row(n_c, m_c):
        lam_c, it_c, res_c = pending
        rows["lam"].append(lam_c)
        rows["u"].append(u.clone())
        rows["nf"].append(n_c)
        rows["mom"].append(m_c)
        rows["it"].append(it_c)
        rows["res"].append(res_c)

    def corrector(du_t, dl_try):
        """One predictor + corrector attempt from the committed (u, lam)
        at arc length dl_try: (ok, delta_u, delta_lam, iterations,
        residual)."""
        dlam = dl_try / np.sqrt(1.0 + dot(du_t, du_t))
        if prev_du is not None:
            sign = np.sign(dot(prev_du, du_t) + prev_dlam)
            dlam *= 1.0 if sign == 0 else sign
        delta_u, delta_lam = dlam * du_t, dlam
        res = np.inf
        for it in range(int(max_arc_iter)):
            km, r, _, _ = tangent_and_resid(u + delta_u, lam + delta_lam)
            res = _norm(r) / fnorm
            if res <= tol:
                return True, delta_u, delta_lam, it, res
            lu, piv = torch.linalg.lu_factor(km)
            sol = torch.linalg.lu_solve(
                lu, piv, torch.stack([r, f_ext], dim=1)) * mask[:, None]
            du_r, du_c = sol[:, 0], sol[:, 1]
            base = delta_u + du_r
            a, b, c = (float(v) for v in torch.stack(
                [du_c @ du_c, 2.0 * (base @ du_c), base @ base]).tolist())
            c -= dl_try * dl_try
            disc = b * b - 4.0 * a * c
            if disc < 0.0 or a <= 0.0:
                # The normal-plane linearized constraint; x = 0 when b is 0
                # too (the JAX package's fallback, ROADMAP fault 3.2).
                x = -c / b if b != 0.0 else 0.0
            else:
                r1 = (-b + np.sqrt(disc)) / (2.0 * a)
                r2 = (-b - np.sqrt(disc)) / (2.0 * a)
                t1 = dot(base + r1 * du_c, delta_u)
                t2 = dot(base + r2 * du_c, delta_u)
                x = r1 if t1 >= t2 else r2
            delta_u = base + x * du_c
            delta_lam = delta_lam + x
        return False, delta_u, delta_lam, int(max_arc_iter), res

    for _ in range(int(n_steps)):
        km, r, n_c, m_c = tangent_and_resid(u, lam)
        if pending is not None:
            commit_row(n_c, m_c)
            pending = None
        du_t = torch.linalg.solve(km, f_ext) * mask
        ok = False
        for _attempt in range(4):
            ok, delta_u, delta_lam, it_used, res = corrector(du_t, dl)
            if ok:
                break
            dl *= 0.25
        if not ok:
            all_ok = False
            break
        u = u + delta_u
        lam = lam + delta_lam
        prev_du, prev_dlam = delta_u, delta_lam
        pending = (lam, it_used, res)
        dl = min(max_dl, dl * np.sqrt(desired_iters / max(it_used, 1)))
    if pending is not None:
        _, _, n_c, m_c = tangent_and_resid(u, lam)
        commit_row(n_c, m_c)
    empty = np.zeros((0, problem.ndof))
    return ShellNonlinearResult(
        load_factors=np.asarray(rows["lam"], dtype=float),
        displacements=(_numpy_rows(rows["u"]) if rows["u"] else empty),
        membrane_forces=(_numpy_rows(rows["nf"]) if rows["nf"]
                         else np.zeros((0, problem.nelm, 3))),
        moments=(_numpy_rows(rows["mom"]) if rows["mom"]
                 else np.zeros((0, problem.nelm, 3))),
        iterations=np.asarray(rows["it"], dtype=int),
        residuals=np.asarray(rows["res"], dtype=float),
        converged=bool(all_ok))


# ---------------------------------------------------------------------
# The banded tier: the tangent blocks rebuilt a Newton iteration, one
# scatter into DIA diagonals, one Jacobi-PCG.  PCG needs an SPD tangent,
# so this tier serves pre-limit analyses; at or past a limit point the
# PCG stalls and the solver raises, naming the dense arc-length tier.


def _tangent_blocks(geo, u_e):
    """(ke, fe) of the Marguerre tangent at element displacements u_e, the
    block build of a banded Newton iteration."""
    ke, fe, _, _ = _marguerre_blocks(*geo, u_e)
    return ke, fe


def _internal_force(geo, dmap, ndof: int, u) -> torch.Tensor:
    _, fe, _, _ = _marguerre_blocks(*geo, u[dmap], tangent=False)
    return scatter_add(ndof, dmap, fe)


def _newton_iter(layout, geo, dmap, u, lf, f_ext, mask, fnorm, cg_tol,
                 max_cg):
    """One banded Newton iteration: (du, relative residual, PCG
    iterations, PCG relative residual, |du|), all on the device."""
    ke, fe = _tangent_blocks(geo, u[dmap])
    r = (lf * f_ext - scatter_add(layout.ndof, dmap, fe)) * mask
    res = torch.linalg.vector_norm(r) / fnorm
    diags = assemble_dia_blocks(layout, ke)
    du, iters, rel = dia_cg_solve(layout, diags, r, mask, tol=cg_tol,
                                  max_iter=max_cg, precond="jacobi",
                                  components=6)
    du = du * mask
    return du, res, iters, rel, torch.linalg.vector_norm(du)


def _resid_only(geo, dmap, ndof: int, u, lf, f_ext, mask, fnorm):
    """(relative residual, |u|) at a trial state, as floats from one
    read."""
    r = (lf * f_ext - _internal_force(geo, dmap, ndof, u)) * mask
    return torch.stack([torch.linalg.vector_norm(r) / fnorm,
                        torch.linalg.vector_norm(u)]).tolist()


def solve_shell_nonlinear_banded(
    problem: ShellProblem,
    load_factors: Optional[Sequence[float]] = None,
    n_steps: int = 5,
    target_load_factor: float = 1.0,
    tol: float = 5e-4,
    du_tol: float = 2e-4,
    stall_accept: float = 1e-2,
    max_iter: int = 20,
    cg_tol: float = 1e-6,
    max_cg: int = 40000,
    min_denom: float = 1e-12,
    use_pallas: bool = False,
    mesh=None,
    dtype=None,
    device=None,
) -> ShellNonlinearResult:
    """Large-mesh load-controlled von Karman / Marguerre statics on the
    banded tier, on `device` ("cuda" when None) in `dtype` (the working
    dtype when None): per Newton iteration the (m, 24, 24) tangent blocks
    (banded drilling eps 1e-3), one scatter into DIA diagonals and one
    Jacobi-PCG (on a card the fused kernels 2 and 3).

    Convergence (the JAX package's three criteria): the relative force
    residual reaching `tol`; the scale-free increment |s du| / |u| reaching
    `du_tol` (in float32 the residual stalls at a problem-dependent floor
    eps32 x element force scale / |f_ext|); three consecutive non-growth
    iterations without a 10% improvement, accepted while the stalled
    residual is under `stall_accept`.  A full step is accepted while the
    residual grows at most 100-fold, at most 4 times in a row; otherwise
    Armijo backtracking (7 halvings).  The loop breaks when no step length
    improves the residual.  A PCG that does not reach 100 cg_tol raises
    (the tangent is indefinite: at or past a limit point).  use_pallas is
    the JAX package's switch for its TPU kernels and has no effect; mesh=
    (a device mesh) is ROADMAP item 15's multi-device row and raises.  The
    resultants are recovered in float64 on the host from the fetched
    fields."""
    from ..models.shell import _DRILL_EPS_BANDED, shell_dia_layout
    from ..parallel import refuse_mesh
    from .plane_plasticity import _schedule

    del use_pallas
    refuse_mesh(mesh, "the banded shell Newton")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    npf = np.float64 if dtype == torch.float64 else np.float32
    lfs = _schedule(load_factors, target_load_factor, n_steps)
    geo64 = _marguerre_geometry(problem, _DRILL_EPS_BANDED, dev)
    geo = tuple(a.to(dtype) for a in (geo64.bm, geo64.gw, geo64.g0,
                                      geo64.det, geo64.kb, geo64.kd,
                                      geo64.dm))
    dmap = geo64.dof_map
    del geo64
    layout = shell_dia_layout(problem)
    mask64 = _t(problem.free_mask(), dev)
    f_ext64 = _f_ext_marguerre(problem, dev) * mask64
    fnorm = torch.tensor(max(_norm(f_ext64), min_denom), dtype=dtype,
                         device=dev)
    f_ext, mask = f_ext64.to(dtype), mask64.to(dtype)
    ndof = problem.ndof

    u = torch.zeros(ndof, dtype=dtype, device=dev)
    rows, iters, residuals, all_ok = [], [], [], True
    for lf_val in lfs:
        lf = float(npf(lf_val))
        ok, res_val, it_used = False, np.inf, max_iter
        growth_left, res_min, no_prog = 4, np.inf, 0
        for it in range(max_iter):
            du, res, _, cg_rel, du_norm = _newton_iter(
                layout, geo, dmap, u, lf, f_ext, mask, fnorm, cg_tol,
                max_cg)
            res_val, cg_rel_val, du_norm_val = torch.stack(
                [res, cg_rel.to(res.dtype), du_norm]).tolist()
            if res_val <= tol:
                ok, it_used = True, it
                break
            if not np.isfinite(cg_rel_val) \
                    or cg_rel_val > 100.0 * float(cg_tol):
                raise ValueError(
                    f"banded PCG stalled (rel={cg_rel_val:.2e}) — the "
                    "tangent is likely indefinite (at/past a limit "
                    "point).  The banded tier serves PRE-LIMIT "
                    "stiffening analyses; trace snap-through with the "
                    "dense arc-length tier (solve_shell_riks) on a "
                    "mesh under DENSE_DOF_LIMIT")
            # Nonmonotone acceptance with a growth budget: the Marguerre
            # residual along the Newton path is not monotone.
            res1, un1 = _resid_only(geo, dmap, ndof, u + du, lf, f_ext,
                                    mask, fnorm)
            u_norm_val, grew = un1, False
            if res1 <= (1.0 - 1e-4) * res_val:
                best_s, best_res = 1.0, res1
                growth_left = 4
            elif res1 <= 100.0 * res_val and growth_left > 0:
                best_s, best_res = 1.0, res1
                growth_left -= 1
                grew = True
            else:
                s, best_s, best_res = 0.5, 1.0, res1
                for _ in range(7):
                    res_try, un_try = _resid_only(geo, dmap, ndof,
                                                  u + s * du, lf, f_ext,
                                                  mask, fnorm)
                    if res_try < best_res:
                        best_s, best_res = s, res_try
                        u_norm_val = un_try
                    if res_try <= (1.0 - 1e-4 * s) * res_val:
                        break
                    s *= 0.5
                growth_left = 4
            if best_res < res_val or grew:
                u = u + best_s * du
                if not grew:
                    du_rel = best_s * du_norm_val / max(u_norm_val,
                                                        min_denom)
                    if du_rel <= du_tol:
                        ok, it_used, res_val = True, it + 1, best_res
                        break
                if grew:
                    no_prog = 0
                elif best_res > 0.9 * res_min:
                    no_prog += 1
                else:
                    no_prog = 0
                res_min = min(res_min, best_res)
                if no_prog >= 3:
                    ok = res_min <= stall_accept
                    it_used, res_val = it + 1, res_min
                    break
            else:
                # No step length improves the residual: the floor.
                it_used = it + 1
                ok = best_res <= tol or res_val <= tol
                res_val = min(res_val, best_res)
                break
        all_ok &= ok
        if not ok:
            res_val = _resid_only(geo, dmap, ndof, u, lf, f_ext, mask,
                                  fnorm)[0]
        rows.append(u.double().cpu())
        iters.append(it_used)
        residuals.append(res_val)
    # Centroid recovery in float64 on the host from the fetched fields.
    geo_host = _marguerre_geometry(problem)
    nf, mom = zip(*(_element_state(geo_host, u_h, False)[2:4]
                    for u_h in rows))
    return ShellNonlinearResult(
        load_factors=np.asarray(lfs, dtype=float),
        displacements=_numpy_rows(rows), membrane_forces=_numpy_rows(nf),
        moments=_numpy_rows(mom), iterations=np.asarray(iters, dtype=int),
        residuals=np.asarray(residuals, dtype=float),
        converged=bool(all_ok))
