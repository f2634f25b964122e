"""Shared helpers of the analysis-JSON runners: the part of
pinn_fem_tpu/io/_common.py that a transient document needs (the amplitude
and probe parsers and the prestress state).  The strict-JSON sanitizer
and the omega, fatigue and element-area helpers come with the runners
that call them, ROADMAP item 17.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Shapes above this DOF count are omitted from JSON output unless
# explicitly requested (payload size, not compute, is the constraint).
_SHAPES_JSON_DOF_LIMIT = 4096


def _amplitude_array(spec, n_steps: int, dt: float) -> np.ndarray:
    """Load-scale history a(t_i), i = 0..n_steps-1."""
    if spec is None or spec == "step":
        return np.ones(n_steps)
    if isinstance(spec, (list, tuple)):
        arr = np.asarray(spec, dtype=float)
        if arr.shape != (n_steps,):
            raise ValueError(
                f"amplitude list must have n_steps={n_steps} entries, "
                f"got {arr.shape}")
        return arr
    if isinstance(spec, dict):
        kind = spec.get("type", "step")
        t = dt * np.arange(n_steps)
        if kind == "step":
            return np.ones(n_steps)
        if kind == "sine":
            f = float(spec["frequency_hz"])
            phase = float(spec.get("phase", 0.0))
            return np.sin(2.0 * np.pi * f * t + phase)
        if kind == "pulse":
            return (t < float(spec["t_end"])).astype(float)
        if kind == "trapezoid":
            # 0 -> peak over t_rise, hold, back to 0 over t_fall, then 0.
            t1 = float(spec["t_rise"])
            t2 = t1 + float(spec.get("t_hold", 0.0))
            t3 = t2 + float(spec["t_fall"])
            if t1 <= 0.0 or t3 <= t2:
                raise ValueError("trapezoid needs t_rise > 0 and "
                                 "t_fall > 0")
            peak = float(spec.get("peak", 1.0))
            up = np.clip(t / t1, 0.0, 1.0)
            down = np.clip((t3 - t) / (t3 - t2), 0.0, 1.0)
            return peak * np.minimum(up, down)
        raise ValueError(f"unknown amplitude type: {kind!r}")
    raise ValueError(f"bad amplitude spec: {spec!r}")


def _probe_dofs(analysis: Dict, problem) -> np.ndarray:
    if "probe_dofs" in analysis:
        return np.asarray(analysis["probe_dofs"], dtype=int)
    if "probe_nodes" in analysis:
        nodes = np.asarray(analysis["probe_nodes"], dtype=int)
        d = problem.dimension
        return (d * nodes[:, None] + np.arange(d)[None, :]).reshape(-1)
    return np.arange(problem.ndof)


def _prestress_state(problem, spec, device=None):
    """Resolve a "prestress" spec to a static displacement state u0:

        true                      static solve at the problem's loads
        {"scale": s}              s times that state
        {"loads": [..]}           static solve at these loads instead
        {"fix_dofs": [..]}        extra DOFs held during the static solve
                                  only (a taut string's transverse DOFs
                                  have no stiffness before the tension)
        {"u": [..]}               an explicit state

    The static solve is the float64 host solve up to DENSE_DOF_LIMIT DOFs
    and solve_nr on the banded path (on `device`) above it; in float32
    that Newton stops at its floor before 1e-10, as in the JAX package.
    """
    if spec in (None, False):
        return None
    loads = None
    scale = 1.0
    fix_extra = None
    if isinstance(spec, dict):
        if "u" in spec:
            u = np.asarray(spec["u"], dtype=float).reshape(-1)
            if u.size != problem.ndof:
                raise ValueError(f"prestress.u must have {problem.ndof} "
                                 f"entries, got {u.size}")
            return float(spec.get("scale", 1.0)) * u
        if "loads" in spec:
            loads = np.asarray(spec["loads"], dtype=float).reshape(-1)
            if loads.size != problem.ndof:
                raise ValueError(f"prestress.loads must have "
                                 f"{problem.ndof} entries")
        if "fix_dofs" in spec:
            fix_extra = np.asarray(spec["fix_dofs"], dtype=int)
        scale = float(spec.get("scale", 1.0))
    elif spec is not True:
        raise ValueError(f"bad prestress spec: {spec!r}")

    from ..models.problem import TrussProblem
    from ..solvers import newton

    p = problem
    if fix_extra is not None:
        fixed = np.union1d(problem.fixed_dofs, fix_extra)
        p = TrussProblem(problem.nodes, problem.elements,
                         problem.material, problem.loads, fixed,
                         problem.dimension)
    if problem.ndof <= newton.DENSE_DOF_LIMIT:
        from ..ops.host import host_static_solve

        u = host_static_solve(p, loads=loads)
    else:
        from ..config import SolverConfig

        if loads is not None:
            p = TrussProblem(p.nodes, p.elements, p.material, loads,
                             p.fixed_dofs, p.dimension)
        res = newton.solve_nr(p, SolverConfig(max_iterations=30,
                                              tolerance=1e-10), 1.0,
                              device=device)
        u = np.asarray(res.displacements).reshape(-1)
    return scale * u
