"""Sizing ("analysis": {"type": "sizing"}) JSON runner (counterpart of
pinn_fem_tpu/io/sizing_io.py): member areas from load paths through
solvers/sizing.py, with the JAX package's contract (keys, defaults,
errors and result keys; its run_sizing docstring is the full reference).

"adam" (default) is the augmented-Lagrangian ADAM on the dense traced
solve, dense-only; "fsd" the fully-stressed-design fixpoint on the float64
host; "oc" the banded optimality-criteria compliance path (on a card the
fused PCG kernels 1-3), the only method past DENSE_DOF_LIMIT.  The JAX
package runs "adam" on its local CPU backend unless the document says
"on_device": true; the port reads the key and ignores it: every method
runs on its device ("cuda" when None).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ._common import (_SHAPES_JSON_DOF_LIMIT, _json_finite, _omega_array,
                      _probe_dofs)


def run_sizing(problem, analysis: Dict, device=None) -> Dict:
    """Execute a sizing block on `device`; a JSON-serializable dict."""
    from ..solvers.newton import DENSE_DOF_LIMIT
    from ..solvers.sizing import (fully_stressed_design,
                                  optimize_compliance_oc, optimize_sizing)

    method = analysis.get("method", "adam")
    if problem.ndof > DENSE_DOF_LIMIT and method != "oc":
        raise ValueError(
            f"sizing methods adam/fsd are dense-only ({problem.ndof} "
            f"DOFs > {DENSE_DOF_LIMIT}); use method \"oc\" (banded "
            f"optimality-criteria compliance) or size on a coarser "
            f"model")
    objective = analysis.get("objective", "mass")

    def opt_float(key):
        v = analysis.get(key)
        return None if v is None else float(v)

    stress_limit = opt_float("stress_limit")
    buckling_c = opt_float("buckling_shape_factor")
    disp_limit = opt_float("displacement_limit")
    volume = opt_float("volume")
    min_area = float(analysis.get("min_area", 1e-6))
    max_area = opt_float("max_area")
    probe = None
    if "probe_dofs" in analysis or "probe_nodes" in analysis:
        probe = _probe_dofs(analysis, problem)
    initial_areas = analysis.get("initial_areas")
    if initial_areas is not None:
        initial_areas = np.asarray(initial_areas, dtype=float)
    load_cases = analysis.get("load_cases")
    if load_cases is not None:
        load_cases = np.asarray(load_cases, dtype=float)
    fatigue = analysis.get("fatigue")
    if fatigue is not None:
        if method != "adam":
            raise ValueError('a fatigue life floor needs method "adam" '
                             '(it differentiates the member-force FRF '
                             'sweep)')
        fatigue = dict(fatigue)
        if "omegas" in fatigue:
            fatigue["omegas"] = _omega_array(fatigue["omegas"])
        if fatigue.get("min_life_s") is None \
                and fatigue.get("min_life_hours") is not None:
            fatigue["min_life_s"] = \
                3600.0 * float(fatigue.pop("min_life_hours"))
    reliability = analysis.get("reliability")
    if reliability is not None and method != "adam":
        raise ValueError('an RBDO reliability target needs method '
                         '"adam" (the PMA constraint rides the '
                         'differentiable solve)')

    if method == "fsd":
        if objective != "mass" or disp_limit is not None \
                or volume is not None:
            raise ValueError(
                'method "fsd" solves the stress-constrained mass '
                'problem only; use method "adam" for displacement '
                'limits or compliance objectives')
        if stress_limit is None:
            raise ValueError('method "fsd" needs stress_limit')
        res = fully_stressed_design(
            problem, stress_limit, min_area=min_area, max_area=max_area,
            n_iter=int(analysis.get("n_iter", 50)), load_cases=load_cases,
            buckling_shape_factor=buckling_c)
    elif method == "oc":
        if objective != "compliance":
            raise ValueError('method "oc" is the compliance path; set '
                             '"objective": "compliance" (use "adam"/'
                             '"fsd" for stress/displacement-constrained '
                             'mass)')
        if volume is None:
            raise ValueError('method "oc" needs the volume budget '
                             '("volume": ...)')
        if load_cases is not None:
            raise ValueError('method "oc" sizes for the problem\'s own '
                             'load vector; load_cases needs method '
                             '"adam"')
        if buckling_c is not None \
                or analysis.get("min_frequency_hz") is not None:
            raise ValueError('method "oc" solves the pure compliance/'
                             'volume problem; buckling and frequency '
                             'constraints need method "adam"')
        res = optimize_compliance_oc(
            problem, volume, min_area=min_area, max_area=max_area,
            initial_areas=initial_areas,
            n_iter=int(analysis.get("n_iter", 40)),
            move=float(analysis.get("move", 0.2)),
            tol=float(analysis.get("tolerance", 1e-3)),
            cg_tol=float(analysis.get("cg_tol", 1e-6)),
            use_pallas=bool(analysis.get("use_pallas", False)),
            precond=analysis.get("precond", "jacobi"), device=device)
    elif method == "adam":
        res = optimize_sizing(
            problem, objective=objective, stress_limit=stress_limit,
            buckling_shape_factor=buckling_c,
            displacement_limit=disp_limit, probe_dofs=probe,
            min_frequency_hz=opt_float("min_frequency_hz"),
            fatigue=fatigue, reliability=reliability,
            volume=volume, min_area=min_area, max_area=max_area,
            initial_areas=initial_areas, load_cases=load_cases,
            case_weights=analysis.get("case_weights"),
            n_iter=int(analysis.get("n_iter", 300)),
            outer_rounds=int(analysis.get("outer_rounds", 4)),
            penalty=float(analysis.get("penalty", 10.0)),
            learning_rate=float(analysis.get("learning_rate", 0.05)),
            polish=bool(analysis.get("polish", True)), device=device)
    else:
        raise ValueError(f'sizing method must be "adam" or "fsd", '
                         f'got {method!r}')

    out = {
        "success": True,
        "analysis": "sizing",
        "method": method,
        "objective": objective,
        "converged": bool(res.converged),
        "mass": float(res.mass),
        "mass_initial": float(res.mass_initial),
        "mass_reduction": float(1.0 - res.mass / res.mass_initial)
        if res.mass_initial else 0.0,
        "n_iter": int(res.n_iter),
    }
    # Per-element tables can be huge on the OC large-mesh path.
    if analysis.get("include_areas",
                    res.areas.size <= 4 * _SHAPES_JSON_DOF_LIMIT):
        out["areas"] = res.areas.tolist()
        out["stress"] = res.stress.tolist()
        out["axial_forces"] = res.axial_forces.tolist()
    out["area_range"] = [float(res.areas.min()), float(res.areas.max())]
    if load_cases is not None:
        out["n_load_cases"] = int(load_cases.shape[0])
    if stress_limit is not None:
        out["stress_limit"] = stress_limit
        out["max_stress_ratio"] = float(res.max_stress_ratio)
    if buckling_c is not None:
        out["buckling_shape_factor"] = buckling_c
        out["max_buckling_ratio"] = float(res.max_buckling_ratio)
    if analysis.get("min_frequency_hz") is not None:
        out["min_frequency_hz"] = float(analysis["min_frequency_hz"])
        out["fundamental_frequency_hz"] = \
            float(res.fundamental_frequency_hz)
    if reliability is not None:
        out["target_beta"] = float(reliability["target_beta"])
        out["min_reliability_beta"] = float(res.min_reliability_beta)
        out["reliability_beta"] = [
            None if not np.isfinite(v) else float(v)
            for v in res.reliability_beta]   # None = never stressed
    if fatigue is not None:
        out["fatigue_min_life_s"] = float(fatigue["min_life_s"])
        out["min_fatigue_life_s"] = float(res.min_fatigue_life_s)
        life = np.asarray(res.fatigue_life_s, dtype=float)
        out["fatigue_life_s"] = [
            None if not np.isfinite(v) else float(v) for v in life]
        out["fatigue_critical_element"] = int(np.argmin(life))
        out["fatigue_method"] = fatigue.get("method", "dirlik")
    if disp_limit is not None:
        out["displacement_limit"] = disp_limit
        out["max_displacement_ratio"] = float(res.max_displacement_ratio)
    if volume is not None:
        out["volume"] = volume
    if analysis.get("include_history", True):
        out["history"] = res.history.tolist()
    if analysis.get("include_displacements",
                    problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["displacements"] = res.displacements.tolist()
    return _json_finite(out)
