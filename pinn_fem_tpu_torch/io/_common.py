"""Shared helpers of the analysis-JSON runners: the part of
pinn_fem_tpu/io/_common.py that the truss runners call (the amplitude,
probe, omega and spectrum parsers, the prestress state, the S-N
parameters, the element areas) and the strict-JSON sanitizer
(`_json_finite`), with the continuum families' prestress state and
reduction runner (`_continuum_prestress_u`, `run_continuum_reduction`).
The other continuum runners come with their element families.
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


def _continuum_prestress_u(problem, spec, static_solver):
    """Resolve a modal block's "prestress" spec to a displacement state for
    the continuum families (the truss _prestress_state contract without
    fix_dofs):

        true                 static solve at the problem's own loads
        {"scale": s}         s times that state
        {"u": [..]}          an explicit state (optional scale)
    """
    if spec in (None, False):
        return None
    scale = 1.0
    if isinstance(spec, dict):
        scale = float(spec.get("scale", 1.0))
        if "u" in spec:
            u = np.asarray(spec["u"], dtype=float).reshape(-1)
            if u.size != problem.ndof:
                raise ValueError(f"prestress.u must have "
                                 f"{problem.ndof} entries, got "
                                 f"{u.size}")
            return scale * u
    elif spec is not True:
        raise ValueError(f"bad prestress spec: {spec!r}")
    return scale * np.asarray(static_solver(problem), dtype=float)


# ROADMAP items of the continuum families not yet ported.
_FAMILY_ITEMS = {"SolidProblem": 19, "FrameProblem": 20,
                 "SpaceFrameProblem": 20, "PlateProblem": 21,
                 "ShellProblem": 22}


def _family_modal(problem, n_modes: int, device=None):
    """(omegas, shapes) of the problem's own dense modal analysis: the plane
    branch of the JAX package's continuum_spectrum._family_of; the other
    families raise, naming their ROADMAP item."""
    from ..models.plane import PlaneProblem, plane_modal

    if isinstance(problem, PlaneProblem):
        res = plane_modal(problem, n_modes, device=device)
        return np.asarray(res.omegas), np.asarray(res.mode_shapes)
    kind = type(problem).__name__
    if kind in _FAMILY_ITEMS:
        raise NotImplementedError(
            f"the modal analysis of a {kind} is not yet ported, ROADMAP "
            f"item {_FAMILY_ITEMS[kind]}")
    raise TypeError(f"no continuum family for {kind}")


def run_continuum_reduction(problem, analysis: Dict, element_type: str,
                            device=None) -> Dict:
    """A model-order-reduction block on a continuum document
    (solvers/reduction.reduce_model's dense consistent-mass cores, on
    `device`); the truss run_reduction contract.  The reduced pencil is
    solved by float64 LAPACK on the host."""
    import scipy.linalg

    from ..solvers.reduction import reduce_model

    method = analysis.get("method", "guyan")
    dpn = {"plane": 2, "solid": 3, "frame": 3, "plate": 3,
           "frame3d": 6, "shell": 6}[element_type]
    if "master_dofs" in analysis:
        masters = np.asarray(analysis["master_dofs"], dtype=int)
    elif "master_nodes" in analysis:
        nodes = np.asarray(analysis["master_nodes"], dtype=int)
        cand = (dpn * nodes[:, None]
                + np.arange(dpn)[None, :]).reshape(-1)
        free = set(np.setdiff1d(np.arange(problem.ndof),
                                problem.fixed_dofs).tolist())
        masters = np.asarray([c for c in cand if int(c) in free],
                             dtype=int)
        if masters.size == 0:
            raise ValueError("master_nodes resolve to no free DOFs")
    else:
        raise ValueError("reduction needs master_nodes or master_dofs")

    model = reduce_model(problem, masters, method=method,
                         n_modes=int(analysis.get("n_modes", 4)),
                         device=device)
    w2 = scipy.linalg.eigh(model.k_red, model.m_red, eigvals_only=True)
    omegas = np.sqrt(np.maximum(w2, 0.0))
    n_red = int(model.k_red.shape[0])
    out = {
        "success": True,
        "analysis": "reduction",
        "element_type": element_type,
        "method": method,
        "master_dofs": masters.tolist(),
        "n_reduced_dofs": n_red,
        "reduced_omegas": omegas.tolist(),
        "reduced_frequencies_hz": (omegas / (2.0 * np.pi)).tolist(),
    }
    if analysis.get("include_matrices", n_red <= 64):
        out["k_red"] = model.k_red.tolist()
        out["m_red"] = model.m_red.tolist()
    if analysis.get("compare_full", True):
        n_cmp = min(n_red, int(analysis.get("n_compare", 4)))
        om_full, _ = _family_modal(problem, n_cmp, device)
        ok = om_full > 0
        rel = np.abs(omegas[:n_cmp][ok] - om_full[ok]) \
            / np.maximum(om_full[ok], 1e-30)
        out["full_omegas"] = om_full.tolist()
        out["frequency_rel_errors"] = rel.tolist()
    return _json_finite(out)


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
