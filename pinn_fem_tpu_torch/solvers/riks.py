"""Arc-length (Riks / Crisfield) continuation for geometrically nonlinear
trusses, through limit points (counterpart of
pinn_fem_tpu/solvers/riks.py).

Load control fails at a limit point, where the tangent goes singular.
Arc length makes the load factor lambda an unknown and constrains the
step instead (cylindrical constraint |Delta u|^2 = dl^2), so the path
walks over the fold: the von Mises two-bar snap-through is traced through
both folds to the inverted stress-free state.  Crisfield's quadratic
corrector: each iteration solves K_t du_r = r and K_t du_t = f_ext and
picks the root of |Delta u + du_r + dlam du_t|^2 = dl^2 that best
continues the current increment; the step adapts as dl <- dl
sqrt(desired_iters / iters) inside [dl_min, dl_max].

Tiers (the JAX package's): below DENSE_DOF_LIMIT with no `data` (the
default) the JAX host tier's float64 algebra (the Green-Lagrange tangent
of ops/host.host_nonlinear_system, in torch, with the material values of
`material_values_host`; one LU without refinement) on the caller's
device, the card by default, host=True on the CPU; host=False, a given
`data` or a larger problem the device tier in the working dtype (one LU,
`ops.linalg.factor_masked(assume_spd=False)`, and one refinement sweep).
Both factor the tangent ONCE an iteration and solve du_r and du_t from
it; the JAX device tier factors it twice (the same numbers).  The path
algebra stays on the host in float64 on both tiers: each corrector
iteration fetches (du_r, du_t, |r|) in one transfer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.problem import TrussProblem
from ..ops.assembly import (_assemble_dense, assemble_system_nonlinear,
                            scatter_add)
from ..ops.linalg import factor_masked, solve_factored
from ..utils.runtime import resolve_device


class RiksResult(NamedTuple):
    load_factors: np.ndarray    # (n_steps,) lambda along the path
    displacements: np.ndarray   # (n_steps, ndof)
    iterations: np.ndarray      # (n_steps,) corrector iterations
    converged: bool             # every step converged
    residuals: np.ndarray       # (n_steps,) final |r| per step


def _float64_system(problem: TrussProblem, device):
    """u -> (K_t, f_int) of the Green-Lagrange truss in float64 torch on
    `device`: ops/host.host_nonlinear_system's algebra (the element of
    ops/elements.truss2d_green_lagrange_batch)."""
    from ..ops import host as H
    from ..ops.elements import truss2d_green_lagrange_batch

    if problem.dimension not in (2, 3):
        raise ValueError("geometric nonlinearity requires a 2D or 3D truss")
    data = problem.to_device(device, torch.float64)
    young, area = (torch.as_tensor(a).to(device)
                   for a in H.material_values_host(problem))
    dim = problem.dimension
    dx0 = data.gvec[:, dim:] / data.inv_len[:, None]
    x0 = torch.stack([data.mid - 0.5 * dx0, data.mid + 0.5 * dx0], dim=1)

    def system(u):
        elem = truss2d_green_lagrange_batch(x0, u[data.dof_map],
                                            data.inv_len, young, area)
        return (_assemble_dense(data, elem.ke),
                scatter_add(data.ndof, data.dof_map, elem.fe_int))

    return data, system


def solve_riks(
    problem: TrussProblem,
    n_steps: int = 100,
    initial_dlambda: float = 0.05,
    max_arc_iter: int = 20,
    tol: float = 1e-8,
    desired_iters: int = 4,
    max_dl_growth: float = 4.0,
    stop_fn=None,
    data=None,
    host=None,
    device=None,
) -> RiksResult:
    """Trace the nonlinear equilibrium path lambda(u) by arc length.

    The JAX package's arguments: initial_dlambda sets the first arc length
    (dl = |dlam| |du_t|), to be picked well below the expected limit
    load; desired_iters the corrector-iteration target of the step
    adaptation; stop_fn an optional (u, lam) -> bool host callback that
    ends the continuation; host the tier (module docstring).  The port's
    own: device, where to solve when `data` is not given ("cuda" when
    None)."""
    from . import newton

    dense64 = (problem.ndof <= newton.DENSE_DOF_LIMIT and data is None
               if host is None else host)
    if dense64:
        where = torch.device("cpu") if host else resolve_device(device)
        data, system = _float64_system(problem, where)
        refine = 0
    else:
        data = data if data is not None else problem.to_device(device)
        material = problem.material.to(data.device)

        def system(u):
            return assemble_system_nonlinear(data, material, u)[:2]

        refine = 1
    dtype, dev = data.loads.dtype, data.device
    mask = data.free_mask
    f_ext = data.loads * mask
    fnorm = float(torch.linalg.vector_norm(f_ext))
    if fnorm == 0:
        raise ValueError("riks continuation needs a nonzero load pattern")

    def factor(u_np):
        # LU, not Cholesky: past a limit point the tangent is indefinite.
        k, f_int = system(torch.as_tensor(u_np, dtype=dtype).to(dev))
        k_bc, lu, _ = factor_masked(k, mask, assume_spd=False)
        return k_bc, lu, f_int

    def tangent_fn(u_np):
        k_bc, lu, _ = factor(u_np)
        du_t = solve_factored(k_bc, lu, f_ext[None], mask, refine)[0]
        return du_t.cpu().double().numpy()

    def corrector_fn(u_np, lam_v):
        k_bc, lu, f_int = factor(u_np)
        r = (float(lam_v) * f_ext - f_int) * mask
        du = solve_factored(k_bc, lu, torch.stack([r, f_ext]), mask, refine)
        # One transfer: du_r, du_t and |r|.
        out = torch.cat([du.reshape(-1),
                         torch.linalg.vector_norm(r)[None]])
        out = out.cpu().double().numpy()
        n = problem.ndof
        return out[:n], out[n:2 * n], float(out[-1])

    u = np.zeros(problem.ndof)
    lam = 0.0
    # The first tangent fixes the initial arc length and direction.
    du_t0 = tangent_fn(u)
    dl = float(initial_dlambda) * float(np.linalg.norm(du_t0))
    # Global bounds keep the path resolved: unbounded growth doubles dl
    # every easy step, and one adapted step could then leap a fold.
    dl_max = dl * max_dl_growth
    dl_min = dl * 1e-4
    prev_du = None
    lams, us, iters, rnorms = [], [], [], []
    all_ok = True
    for _ in range(n_steps):
        # Predictor du = dlam du_t with |du| = dl; its sign continues the
        # previous increment (past a fold du_t flips relative to the path
        # tangent, and this makes lambda descend).
        du_t = tangent_fn(u)
        nt = float(np.linalg.norm(du_t))
        dlam = dl / max(nt, 1e-30)
        if prev_du is not None and float(prev_du @ du_t) < 0:
            dlam = -dlam
        d_u = dlam * du_t
        u_new = u + d_u
        lam_new = lam + dlam

        ok = False
        it = max_arc_iter
        rn = np.inf
        for k_it in range(max_arc_iter):
            du_r, du_t, rn = corrector_fn(u_new, lam_new)
            if rn <= tol * max(fnorm, 1e-30) * max(abs(lam_new), 1.0):
                ok = True
                it = k_it
                break
            # Cylindrical constraint |d_u + du_r + x du_t|^2 = dl^2.
            base = d_u + du_r
            a = float(du_t @ du_t)
            b = 2.0 * float(base @ du_t)
            c = float(base @ base) - dl * dl
            disc = b * b - 4.0 * a * c
            if disc < 0.0 or a == 0.0:
                break  # constraint unreachable: cut the step
            sq = np.sqrt(disc)
            roots = ((-b + sq) / (2 * a), (-b - sq) / (2 * a))
            # Anti-doubling-back: the increment best aligned with the
            # current one.
            best = max(roots, key=lambda x: float(d_u @ (base + x * du_t)))
            d_u = base + best * du_t
            lam_new = lam_new + best
            u_new = u + d_u
        if not ok:
            # Quarter the arc and retry the step.
            dl *= 0.25
            if dl < dl_min:
                all_ok = False
                break
            continue

        prev_du = d_u
        u, lam = u_new, lam_new
        lams.append(lam)
        us.append(u.copy())
        iters.append(it)
        rnorms.append(rn)
        if stop_fn is not None and stop_fn(u, lam):
            break
        dl = float(np.clip(
            dl * np.sqrt(desired_iters / max(it, 1)), dl_min, dl_max))

    return RiksResult(
        load_factors=np.asarray(lams),
        displacements=np.asarray(us) if us else np.zeros((0, problem.ndof)),
        iterations=np.asarray(iters, dtype=int),
        converged=all_ok and len(lams) > 0,
        residuals=np.asarray(rnorms),
    )
