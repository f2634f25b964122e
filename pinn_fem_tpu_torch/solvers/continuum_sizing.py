"""Thickness sizing for the continuum families (counterpart of
pinn_fem_tpu/solvers/continuum_sizing.py): minimum-weight per-element
thickness of plane membranes, plates and shells under von Mises stress
and / or displacement limits.

The augmented-Lagrangian ADAM of models/frame._al_minimize (Rockafellar
multipliers, a fresh Adam state and a halved learning rate each round) on
log(t - min_thickness), through each family's differentiable dense statics
(`plane_static_response`, `plate_static_response`,
`shell_static_response`) on the caller's device.  Then a feasibility
polish by uniform scaling on the float64 dense statics: exact 1 / s for
the membrane (every stress and displacement ratio falls together), the
cube-root scale s = r^(1/3), re-measured, for plates and shells; the best
evaluated iterate is kept.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.runtime import default_dtype, resolve_device


def _probe(probe_dofs, ndof: int) -> np.ndarray:
    probe_np = np.asarray(probe_dofs, dtype=int).reshape(-1)
    if probe_np.size == 0 or probe_np.min() < 0 or probe_np.max() >= ndof:
        raise ValueError("probe_dofs out of range")
    return probe_np


def _design(problem, min_thickness: float, areas_np: np.ndarray, dtype,
            dev):
    """(t0 = log(t_start - min), w0 = sum t_start A_e, areas tensor)."""
    t_start = np.maximum(np.asarray(problem.thickness) * np.ones(
        problem.nelm), min_thickness * (1.0 + 1e-9))
    t0 = torch.log(torch.as_tensor(t_start, dtype=dtype, device=dev)
                   - min_thickness)
    return t0, float(np.sum(t_start * areas_np)), torch.as_tensor(
        areas_np, dtype=dtype, device=dev)


def _limits_g(u, vm, stress_limit, displacement_limit, probe):
    gs = []
    if stress_limit is not None:
        gs.append(vm / stress_limit - 1.0)
    if displacement_limit is not None:
        gs.append(torch.abs(u[probe]) / displacement_limit - 1.0)
    return torch.cat(gs)


def optimize_plane_thickness(problem, stress_limit: Optional[float] = None,
                             displacement_limit: Optional[float] = None,
                             probe_dofs=None, min_thickness: float = 1e-6,
                             n_iter: int = 300, outer_rounds: int = 4,
                             penalty: float = 10.0,
                             learning_rate: float = 0.05, device=None):
    """Minimum-weight thickness field of a plane membrane: weight sum t_e
    A_e (plan areas), centroid von Mises <= stress_limit on every element
    and / or |u| <= displacement_limit on probe_dofs; the uniform 1 / s
    polish and one tightening pass onto the boundary.  device: "cuda" when
    None.  Returns (thickness (m,), weight, history)."""
    from ..models.frame import _al_minimize
    from ..models.plane import (PlaneProblem, plane_static_response,
                                solve_plane_static)
    from ..ops.plane_plastic import gp_geometry

    if stress_limit is None and displacement_limit is None:
        raise ValueError("thickness sizing needs stress_limit and/or "
                         "displacement_limit")
    if stress_limit is not None and stress_limit <= 0.0:
        raise ValueError("stress_limit must be positive")
    probe_np = probe = None
    dev = resolve_device(device)
    dtype = default_dtype()
    if displacement_limit is not None:
        if displacement_limit <= 0.0:
            raise ValueError("displacement_limit must be positive")
        if probe_dofs is None:
            raise ValueError("a displacement limit needs probe_dofs")
        probe_np = _probe(probe_dofs, problem.ndof)
        probe = torch.as_tensor(probe_np, dtype=torch.int64, device=dev)
    # Plan areas from the quadrature weights.
    areas_np = gp_geometry(problem)[1].sum(dim=1).numpy()
    t0, w0, areas = _design(problem, min_thickness, areas_np, dtype, dev)
    n_con = (problem.nelm if stress_limit is not None else 0) \
        + (int(probe_np.size) if displacement_limit is not None else 0)

    def obj_g(logt):
        t_e = min_thickness + torch.exp(logt)
        u, _, vm = plane_static_response(problem, thickness_e=t_e,
                                         dtype=dtype, device=dev)
        return torch.sum(t_e * areas) / w0, _limits_g(
            u, vm, stress_limit, displacement_limit, probe)

    logt, hist = _al_minimize(obj_g, t0, n_con, n_iter, outer_rounds,
                              penalty, learning_rate)
    t_e = (min_thickness + torch.exp(logt)).double().cpu().numpy()

    def ratios_of(t_arr):
        st = solve_plane_static(PlaneProblem(
            nodes=problem.nodes, elements=problem.elements,
            young=problem.young, poisson=problem.poisson, thickness=t_arr,
            density=problem.density, loads=problem.loads,
            fixed_dofs=problem.fixed_dofs,
            plane_strain=problem.plane_strain), device=dev)
        r = 0.0
        if stress_limit is not None:
            r = max(r, float(np.max(st.von_mises)) / stress_limit)
        if displacement_limit is not None:
            r = max(r, float(np.max(np.abs(
                st.displacements[probe_np]))) / displacement_limit)
        return r

    best_t, best_w = None, np.inf
    for _ in range(20):
        ratio = ratios_of(t_e)
        if ratio <= 1.0 + 1e-9:
            w = float(np.sum(t_e * areas_np))
            if w < best_w:
                best_t, best_w = t_e.copy(), w
            break
        t_e = t_e * ratio
    else:
        raise ValueError(
            f"limits unreachable by thickness scaling (residual ratio "
            f"{ratio:.3f}) — this cannot happen for fixed nodal loads "
            "(sigma and u scale exactly 1/s); check for zero loads")
    # One tightening pass onto the boundary along the same ray.
    ratio = ratios_of(best_t)
    if ratio < 1.0 - 1e-9 and ratio > 0.0:
        cand = np.maximum(best_t * ratio, min_thickness)
        if ratios_of(cand) <= 1.0 + 1e-9:
            w = float(np.sum(cand * areas_np))
            if w < best_w:
                best_t, best_w = cand, w
    return best_t, best_w, hist


def _cube_root_polish(ratio_of, t_e, areas_np, min_thickness: float,
                      passes: int):
    """Uniform s = r^(1/3) scaling, re-measured each pass, tightening onto
    the boundary once feasible; (best t, best weight, last ratio), best t
    None when no pass was feasible."""
    best_t, best_w = None, np.inf
    ratio = np.inf
    for _ in range(passes):
        ratio = ratio_of(t_e)
        if ratio <= 1.0 + 1e-9:
            w = float(np.sum(t_e * areas_np))
            if w < best_w:
                best_t, best_w = t_e.copy(), w
            if ratio < 1.0 - 1e-6:
                t_e = np.maximum(t_e * ratio ** (1.0 / 3.0), min_thickness)
                continue
            break
        t_e = t_e * ratio ** (1.0 / 3.0)
    else:
        return best_t, best_w, ratio, False
    return best_t, best_w, ratio, True


def optimize_plate_thickness(problem, displacement_limit: float,
                             probe_dofs=None, probe_nodes=None,
                             min_thickness: float = 1e-6,
                             n_iter: int = 300, outer_rounds: int = 4,
                             penalty: float = 10.0,
                             learning_rate: float = 0.05, device=None):
    """Minimum-weight plate thickness under a deflection limit (|u| <=
    displacement_limit on the probe DOFs; probe_nodes expands to each
    node's w DOF), then the cube-root polish (up to 30 passes).  device:
    "cuda" when None.  Returns (thickness (m,), weight, history)."""
    from ..models.frame import _al_minimize
    from ..models.plane import _GP
    from ..models.plate import (PlateProblem, _shape_grads,
                                plate_static_response, solve_plate_static)

    if displacement_limit <= 0.0:
        raise ValueError("displacement_limit must be positive")
    if probe_dofs is None and probe_nodes is not None:
        pn = np.asarray(probe_nodes, dtype=int).reshape(-1)
        probe_dofs = 3 * pn
    if probe_dofs is None:
        raise ValueError("plate sizing needs probe_dofs or "
                         "probe_nodes")
    probe_np = _probe(probe_dofs, problem.ndof)
    dev = resolve_device(device)
    dtype = default_dtype()
    probe = torch.as_tensor(probe_np, dtype=torch.int64, device=dev)
    # Plan areas: 2 x 2 Gauss |J| sums (unit weights).
    coords = torch.as_tensor(problem.coords(), dtype=torch.float64)
    areas_np = np.zeros(problem.nelm)
    for xi, eta in _GP:
        areas_np += _shape_grads(coords, xi, eta)[3].numpy()
    t0, w0, areas = _design(problem, min_thickness, areas_np, dtype, dev)

    def obj_g(logt):
        t_e = min_thickness + torch.exp(logt)
        u, _, _ = plate_static_response(problem, thickness_e=t_e,
                                        dtype=dtype, device=dev)
        return torch.sum(t_e * areas) / w0, \
            torch.abs(u[probe]) / displacement_limit - 1.0

    logt, hist = _al_minimize(obj_g, t0, int(probe_np.size), n_iter,
                              outer_rounds, penalty, learning_rate)
    t_e = (min_thickness + torch.exp(logt)).double().cpu().numpy()

    def ratio_of(t_arr):
        st = solve_plate_static(PlateProblem(
            nodes=problem.nodes, elements=problem.elements,
            young=problem.young, poisson=problem.poisson, thickness=t_arr,
            density=problem.density, loads=problem.loads,
            fixed_dofs=problem.fixed_dofs, pressure=problem.pressure,
            point_masses=problem.point_masses), device=dev)
        return float(np.max(np.abs(
            st.displacements[probe_np]))) / displacement_limit

    best_t, best_w, ratio, _ = _cube_root_polish(ratio_of, t_e, areas_np,
                                                 min_thickness, 30)
    if best_t is None:
        raise ValueError(
            f"displacement_limit {displacement_limit} unreachable "
            f"(residual ratio {ratio:.3f}) after 30 thickness-"
            "scaling passes — check for zero transverse loads")
    return best_t, best_w, hist


def optimize_shell_thickness(problem, stress_limit: Optional[float] = None,
                             displacement_limit: Optional[float] = None,
                             probe_dofs=None, min_thickness: float = 1e-6,
                             n_iter: int = 300, outer_rounds: int = 4,
                             penalty: float = 10.0,
                             learning_rate: float = 0.05, device=None):
    """Minimum-weight facet thickness on a shell midsurface: extreme-fiber
    von Mises of N / t +- 6M / t^2 <= stress_limit per facet and / or |u|
    <= displacement_limit on probe_dofs, then the cube-root polish (up to
    40 passes).  device: "cuda" when None.  Returns (thickness (m,),
    weight, history)."""
    from ..models.frame import _al_minimize
    from ..models.shell import (ShellProblem, _facet_area, _facet_frames,
                                shell_fiber_vm, shell_static_response,
                                solve_shell_static)

    if stress_limit is None and displacement_limit is None:
        raise ValueError("thickness sizing needs stress_limit and/or "
                         "displacement_limit")
    if stress_limit is not None and stress_limit <= 0.0:
        raise ValueError("stress_limit must be positive")
    dev = resolve_device(device)
    dtype = default_dtype()
    probe_np = probe = None
    if displacement_limit is not None:
        if displacement_limit <= 0.0:
            raise ValueError("displacement_limit must be positive")
        if probe_dofs is None:
            raise ValueError("a displacement limit needs probe_dofs")
        probe_np = _probe(probe_dofs, problem.ndof)
        probe = torch.as_tensor(probe_np, dtype=torch.int64, device=dev)
    areas_np = _facet_area(_facet_frames(problem)[1])
    t0, w0, areas = _design(problem, min_thickness, areas_np, dtype, dev)
    n_con = (problem.nelm if stress_limit is not None else 0) \
        + (int(probe_np.size) if probe_np is not None else 0)

    def obj_g(logt):
        t_e = min_thickness + torch.exp(logt)
        u, _, vm = shell_static_response(problem, thickness_e=t_e,
                                         dtype=dtype, device=dev)
        return torch.sum(t_e * areas) / w0, _limits_g(
            u, vm, stress_limit, displacement_limit, probe)

    logt, hist = _al_minimize(obj_g, t0, n_con, n_iter, outer_rounds,
                              penalty, learning_rate)
    t_e = (min_thickness + torch.exp(logt)).double().cpu().numpy()

    def ratio_of(t_arr):
        st = solve_shell_static(ShellProblem(
            nodes=problem.nodes, elements=problem.elements,
            young=problem.young, poisson=problem.poisson, thickness=t_arr,
            density=problem.density, loads=problem.loads,
            fixed_dofs=problem.fixed_dofs, pressure=problem.pressure,
            body_force=problem.body_force,
            point_masses=problem.point_masses), device=dev)
        r = 0.0
        if stress_limit is not None:
            vm = shell_fiber_vm(st.membrane_forces, st.moments, t_arr)
            r = max(r, float(np.max(vm)) / stress_limit)
        if displacement_limit is not None:
            r = max(r, float(np.max(np.abs(
                st.displacements[probe_np]))) / displacement_limit)
        return r

    best_t, best_w, ratio, _ = _cube_root_polish(ratio_of, t_e, areas_np,
                                                 min_thickness, 40)
    if best_t is None:
        raise ValueError(
            f"limits unreachable (residual ratio {ratio:.3f}) "
            "after 40 thickness-scaling passes — check for zero "
            "loads")
    return best_t, best_w, hist


__all__ = ["optimize_plane_thickness", "optimize_plate_thickness",
           "optimize_shell_thickness"]
