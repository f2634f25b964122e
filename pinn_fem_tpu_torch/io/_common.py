"""Shared helpers of the analysis-JSON runners: the part of
pinn_fem_tpu/io/_common.py that the truss runners call (the amplitude,
probe, omega and spectrum parsers, the prestress state, the S-N
parameters, the element areas) and the strict-JSON sanitizer
(`_json_finite`).  The continuum runners' helpers come with those runners.
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


def _omega_array(spec) -> np.ndarray:
    if isinstance(spec, (list, tuple)):
        return np.asarray(spec, dtype=float)
    if isinstance(spec, dict):
        num = int(spec.get("num", 50))
        start, stop = float(spec["start"]), float(spec["stop"])
        if spec.get("spacing", "linear") == "log":
            return np.logspace(np.log10(start), np.log10(stop), num)
        return np.linspace(start, stop, num)
    raise ValueError(f"bad omegas spec: {spec!r}")


def _sn_params(fat: Dict):
    """Basquin S-N parameters from a "fatigue" spec: {"sn": {"exponent":
    m, "coefficient": C}} with N S^m = C, S = stress amplitude."""
    sn = fat.get("sn")
    if not isinstance(sn, dict) or "exponent" not in sn \
            or "coefficient" not in sn:
        raise ValueError('fatigue spec needs "sn": {"exponent": m, '
                         '"coefficient": C} (Basquin N S^m = C)')
    m = float(sn["exponent"])
    c = float(sn["coefficient"])
    if m <= 0.0 or c <= 0.0:
        raise ValueError("S-N exponent and coefficient must be positive")
    return m, c


def _element_areas(problem, elm_sel):
    """Cross-section areas of the selected elements (stress = N/A)."""
    from ..ops.host import material_values_host

    return material_values_host(problem, 1.0)[1][elm_sel]


def _history_record(analysis: Dict):
    """(a_g, dt, zeta) of a "sa": {"history": ..} spec: the scaled
    acceleration record, its step and the oscillators' damping ratio."""
    sa = analysis["sa"]
    if "dt" not in sa:
        raise ValueError('a history spectrum needs its record "dt"')
    dt_h = float(sa["dt"])
    hist_spec = sa["history"]
    n = int(sa.get("n_steps",
                   len(hist_spec)
                   if isinstance(hist_spec, (list, tuple)) else 0))
    if n <= 0:
        raise ValueError('a synthetic history spectrum needs "n_steps"')
    accel = _amplitude_array(hist_spec, n, dt_h) * float(sa.get("scale", 1.0))
    zeta_g = float(sa.get("damping_ratio",
                          analysis.get("damping_ratio", 0.05)))
    return accel, dt_h, zeta_g


def _sa_callable(analysis: Dict):
    """Resolve the "sa" spectrum spec to Sa(omega): a flat float, a
    tabulated curve (interpolated), or {"history": <amplitude contract>,
    "dt": .., "n_steps": .., "scale": .., "damping_ratio": ..}, whose
    spectrum is generated from the record and evaluated exactly at the
    asked frequencies (spectrum_from_history's pseudo-acceleration)."""
    sa = analysis.get("sa", 1.0)
    if isinstance(sa, dict) and "history" in sa:
        from ..solvers.spectrum import spectrum_from_history

        accel, dt_h, zeta_g = _history_record(analysis)

        def spectrum(om):
            return spectrum_from_history(accel, dt_h, om, zeta_g).psa

        return spectrum
    if isinstance(sa, dict):
        om_tab = np.asarray(sa["omegas"], dtype=float)
        val_tab = np.asarray(sa["values"], dtype=float)

        def spectrum(om):
            return np.interp(om, om_tab, val_tab)

        return spectrum
    return float(sa)


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


def _json_finite(obj):
    """Non-finite floats replaced by None, recursively: json.dump would
    write NaN / Infinity tokens, which strict JSON parsers (the backend's,
    the browser UIs') reject."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_finite(v) for v in obj]
    return obj
