"""JSON tier of the Mindlin plate family (counterpart of
pinn_fem_tpu/io/plate_io.py): documents with `"element_type": "plate"`.

    {"element_type": "plate",
     "nodes": [[x, y], ..], "elements": [[i, j, k, l], ..]   # Q4, CCW
       | "mesh": {"type": "rect", "width": W, "height": H, "nx", "ny"},
     "material": {"young", "poisson", "thickness", "density"},
     "loads": [Fz0, Mx0, My0, ..],          # 3 per node
     "pressure": q,                         # uniform transverse
     "supports": {"clamped": [edges], "simply_supported": [edges],
                  "free": [edges]}          # "left" / "right" / ...
       | "fixed_dofs": [..] | "fixed_nodes": [..],
     "point_masses": [[node, m], ..] | [..per node..],
     "thermal": {"alpha", "delta_t"} | material "alpha" + "temperature",
     "analysis": {"type": "static" | "modal" | "buckling" | "transient"
                  | "harmonic" | "plastic" | "spectrum" | "random"
                  | "reduction", ..}}

Statics at or below DENSE_DOF_LIMIT DOFs is the dense float64 solve with
the full field in the result; above it the banded tier ("tier": "banded",
kernels 1-3 on a card) with probes and summaries.  Modal (with an
optional "membrane_force" prestress), buckling ("membrane_force"
required), Newmark, harmonic, spectrum (transverse base excitation),
random (with "fatigue") and reduction are dense float64, refused above
8192 DOFs; "plastic" is the layered J2 statics (solvers/plate_plasticity);
"identification" recovers Young's modulus from measured deflections
(io/identification_io.run_young_identification: the banded adjoint past
DENSE_DOF_LIMIT or with zones, else the dense traced solve);
"reliability" is FORM on the dense traced statics
(io/_common.run_continuum_reliability) and "sizing" the minimum-weight
thickness under a deflection limit (solvers/continuum_sizing.py), both
refused above 8192 DOFs.  Every analysis runs on the caller's device
("cuda" when None).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.plate import (PlateProblem, plate_buckling, plate_harmonic,
                            plate_modal, plate_supports, rect_mesh,
                            solve_plate_static, solve_plate_static_banded,
                            solve_plate_transient)

# The dense analyses' DOF budget (the JAX package's 4 * 2048).
_DENSE_BUDGET = 4 * 2048
_DENSE_KINDS = ("modal", "transient", "harmonic", "buckling", "spectrum",
                "random", "reduction")


def is_plate_document(doc: Dict) -> bool:
    return isinstance(doc, dict) and doc.get("element_type") == "plate"


def _probe_dofs(analysis: Dict, problem: PlateProblem):
    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        pn = np.asarray(analysis["probe_nodes"], dtype=int).reshape(-1)
        probe = 3 * pn                       # the w DOF of each node
    return probe


def parse_plate_document(doc: Dict) -> Tuple[PlateProblem, Dict]:
    from .plane_io import _thermal_block

    mesh = doc.get("mesh")
    if mesh is not None:
        if mesh.get("type", "rect") != "rect":
            raise ValueError('plate mesh.type must be "rect"')
        nodes, elements = rect_mesh(
            float(mesh["width"]), float(mesh["height"]),
            int(mesh["nx"]), int(mesh["ny"]), "quad")
    else:
        if "nodes" not in doc or "elements" not in doc:
            raise ValueError('plate document needs "nodes" + '
                             '"elements" or a "mesh" spec')
        nodes = np.asarray(doc["nodes"], dtype=float)
        elements = np.asarray(doc["elements"], dtype=int)
    mat = doc.get("material", {})
    for key in ("poisson", "thickness"):
        if mat.get(key) is None:
            raise ValueError(f'plate material needs "{key}" — the '
                             "bending rigidity Et³/12(1−ν²) is the "
                             "point")
    nnode = nodes.shape[0]
    loads = np.asarray(doc.get("loads", np.zeros(3 * nnode)),
                       dtype=float).reshape(-1)

    fixed_parts = []
    sup = doc.get("supports")
    if sup is not None:
        for kind, edges in sup.items():
            fixed_parts.append(plate_supports(nodes, edges, kind))
    if "fixed_dofs" in doc:
        fixed_parts.append(np.asarray(doc["fixed_dofs"], dtype=int))
    if "fixed_nodes" in doc:
        fn = np.asarray(doc["fixed_nodes"], dtype=int).reshape(-1)
        fixed_parts.append(np.concatenate([3 * fn, 3 * fn + 1,
                                           3 * fn + 2]))
    fixed_parts = [f for f in fixed_parts if np.asarray(f).size]
    if not fixed_parts:
        raise ValueError('plate document needs supports: "supports" '
                         '(clamped/simply_supported edge lists), '
                         '"fixed_nodes" or "fixed_dofs"')
    fixed = np.unique(np.concatenate(fixed_parts))

    pm = doc.get("point_masses")
    if pm is not None:
        arr = np.asarray(pm, dtype=float)
        if arr.ndim == 2:                        # [[node, mass], ...]
            pm = np.zeros(nnode)
            for node, mass in arr:
                pm[int(node)] += float(mass)
        else:
            pm = arr

    # The shared thermal contract, "delta_t" / "temperature" read as the
    # top-minus-bottom face difference.
    th_alpha, th_temp = _thermal_block(doc, mat)
    problem = PlateProblem(
        nodes=nodes, elements=elements,
        young=mat.get("young", 1.0), poisson=mat["poisson"],
        thickness=mat["thickness"], density=mat.get("density", 1.0),
        loads=loads, fixed_dofs=fixed, pressure=doc.get("pressure"),
        point_masses=pm, alpha_cte=th_alpha, temperature=th_temp)
    return problem, dict(doc.get("analysis") or {"type": "static"})


def _amplitude(analysis: Dict, n_steps: int, dt: float):
    amp = analysis.get("amplitude")
    if amp is None or isinstance(amp, (list, tuple, np.ndarray)):
        return None if amp is None else np.asarray(amp, dtype=float)
    kind = amp.get("type", "step")
    t = (np.arange(n_steps) + 1) * dt
    if kind == "step":
        return np.ones(n_steps)
    if kind == "sine":
        return np.sin(float(amp["omega"]) * t)
    raise ValueError('plate amplitude type must be "step" or "sine"')


def _static(problem: PlateProblem, analysis: Dict, device) -> Dict:
    from ..solvers.newton import DENSE_DOF_LIMIT

    large = problem.ndof > DENSE_DOF_LIMIT
    if large:
        # The banded tier; the payload carries probes and summaries.
        res, iterations, residual = solve_plate_static_banded(
            problem, tol=float(analysis.get("tolerance", 1e-7)),
            max_iter=int(analysis.get("max_iterations", 50000)),
            use_pallas=bool(analysis.get("use_pallas", False)),
            precond=analysis.get("precond", "auto"), device=device)
    else:
        res = solve_plate_static(problem, device=device)
    worst = int(np.argmax(res.von_mises)) if res.von_mises.size else -1
    w = res.displacements[0::3]
    out = {
        "success": True,
        "analysis": "static",
        "element_type": "plate",
        "max_deflection": float(np.abs(w).max()),
        "max_deflection_node": int(np.argmax(np.abs(w))),
        "max_von_mises": (float(res.von_mises[worst]) if worst >= 0
                          else None),
        "max_von_mises_element": worst,
    }
    if not large:
        out.update({
            "displacements": res.displacements.tolist(),
            "moments": res.moments.tolist(),
            "shear_forces": res.shear_forces.tolist(),
            "von_mises": res.von_mises.tolist(),
            "reactions": res.reactions.tolist(),
        })
        return out
    out.update({
        "tier": "banded",
        "iterations": int(iterations),
        "relative_residual": float(residual),
        "moment_range": [float(res.moments.min()),
                         float(res.moments.max())],
    })
    probe = _probe_dofs(analysis, problem)
    if probe is not None:
        probe = np.asarray(probe, dtype=int).reshape(-1)
        out["probe_dofs"] = probe.tolist()
        out["displacements"] = res.displacements[probe].tolist()
    return out


def _spectrum(problem: PlateProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_spectrum

    return run_continuum_spectrum(problem, analysis, "plate", device)


def _random(problem: PlateProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_random

    return run_continuum_random(problem, analysis, "plate",
                                _probe_dofs(analysis, problem), device)


def _reduction(problem: PlateProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reduction

    return run_continuum_reduction(problem, analysis, "plate", device)


def _plastic(problem: PlateProblem, analysis: Dict, device) -> Dict:
    from ..solvers.plate_plasticity import solve_plate_plastic

    if "sigma_y" not in analysis:
        raise ValueError('plastic analysis requires "sigma_y"')
    kwargs = dict(
        sigma_y=analysis["sigma_y"],
        hardening_iso=analysis.get("hardening", 0.0),
        hardening_kin=analysis.get("kinematic_hardening", 0.0),
        n_layers=int(analysis.get("n_layers", 20)),
        tol=float(analysis.get("tolerance", 1e-9)),
        max_iter=int(analysis.get("max_iterations", 30)),
    )
    if "load_factors" in analysis:
        kwargs["load_factors"] = np.asarray(analysis["load_factors"],
                                            dtype=float)
    else:
        kwargs["target_load_factor"] = float(analysis.get("target", 1.0))
        kwargs["n_steps"] = int(analysis.get("n_steps", 20))
    res = solve_plate_plastic(problem, device=device, **kwargs)
    probe = _probe_dofs(analysis, problem)
    if probe is None:
        probe = np.arange(problem.ndof)
    probe = np.asarray(probe, dtype=int).reshape(-1)
    out = {
        "success": bool(res.converged),
        "analysis": "plastic",
        "element_type": "plate",
        "n_layers": int(kwargs["n_layers"]),
        "n_steps": int(res.load_factors.size),
        "load_factors": res.load_factors.tolist(),
        "probe_dofs": probe.tolist(),
        "displacements": res.displacements[:, probe].tolist(),
        "iterations": res.iterations.tolist(),
        "max_residual": float(res.residuals.max()),
        "n_plastic": res.n_plastic.tolist(),
        "yielded_elements": np.flatnonzero(res.eq_plastic[-1] > 0.0
                                           ).tolist(),
        "max_von_mises": res.von_mises.max(axis=1).tolist(),
        "final": {
            "moments": res.moments[-1].tolist(),
            "von_mises": res.von_mises[-1].tolist(),
            "eq_plastic_strain": res.eq_plastic[-1].tolist(),
            "displacements": res.displacements[-1].tolist(),
        },
    }
    if analysis.get("include_history"):
        out["history"] = {
            "von_mises": res.von_mises.tolist(),
            "eq_plastic_strain": res.eq_plastic.tolist(),
        }
    return out


def _modal(problem: PlateProblem, analysis: Dict, device) -> Dict:
    nf = analysis.get("membrane_force")
    res = plate_modal(problem, n_modes=int(analysis.get("n_modes", 6)),
                      membrane_force=nf, device=device)
    out = {
        "success": True,
        "analysis": "modal",
        "element_type": "plate",
        "prestressed": nf is not None,
        "frequencies_hz": res.frequencies_hz.tolist(),
        "omegas": res.omegas.tolist(),
    }
    if analysis.get("include_shapes"):
        out["mode_shapes"] = res.mode_shapes.tolist()
    return out


def _buckling(problem: PlateProblem, analysis: Dict, device) -> Dict:
    if "membrane_force" not in analysis:
        raise ValueError(
            'plate buckling needs "membrane_force": [Nxx, Nyy, '
            "Nxy] (force/length, tension positive; scalars or "
            "per-element rows) — the bending model carries no "
            "membrane DOFs, so the in-plane state is an input")
    res = plate_buckling(problem, analysis["membrane_force"],
                         n_modes=int(analysis.get("n_modes", 4)),
                         device=device)
    out = {
        "success": True,
        "analysis": "buckling",
        "element_type": "plate",
        "load_factors": res.load_factors.tolist(),
    }
    if analysis.get("include_shapes", True):
        out["buckling_modes"] = res.modes.tolist()
    return out


def _transient(problem: PlateProblem, analysis: Dict, device) -> Dict:
    dt = float(analysis["dt"])
    n_steps = int(analysis["n_steps"])
    res = solve_plate_transient(
        problem, dt, n_steps, damping=analysis.get("damping", (0.0, 0.0)),
        amplitude=_amplitude(analysis, n_steps, dt),
        probe_dofs=_probe_dofs(analysis, problem),
        record_every=int(analysis.get("record_every", 1)), device=device)
    return {
        "success": True,
        "analysis": "transient",
        "element_type": "plate",
        "method": "newmark",
        "dt": res.dt,
        "n_steps": res.n_steps,
        "times": res.times.tolist(),
        "displacements": res.displacements.tolist(),
        "velocities": res.velocities.tolist(),
    }


def _harmonic(problem: PlateProblem, analysis: Dict, device) -> Dict:
    om = analysis.get("omegas")
    if om is None:
        raise ValueError('plate harmonic needs "omegas"')
    if isinstance(om, dict):
        om = np.linspace(float(om["start"]), float(om["stop"]),
                         int(om.get("num", 50)))
    res = plate_harmonic(problem, om,
                         damping=analysis.get("damping", (0.0, 0.0)),
                         probe_dofs=_probe_dofs(analysis, problem),
                         device=device)
    return {
        "success": True,
        "analysis": "harmonic",
        "element_type": "plate",
        "method": "direct",
        "omegas": res.omegas.tolist(),
        "amplitude": res.amplitude.tolist(),
    }


def _identification(problem: PlateProblem, analysis: Dict, device) -> Dict:
    """Young's modulus from measured deflections (the plane family's
    contract; E at known thickness: bending data sees D ~ E t^3)."""
    from ..models.plate import (identify_plate_young,
                                identify_plate_young_banded,
                                solve_plate_static_banded)
    from .identification_io import adam_options, run_young_identification
    from .plane_io import _resolve_zones

    def true_solve(true_young):
        p_true = PlateProblem(
            nodes=problem.nodes, elements=problem.elements,
            young=true_young, poisson=problem.poisson,
            thickness=problem.thickness, density=problem.density,
            loads=problem.loads, fixed_dofs=problem.fixed_dofs,
            pressure=problem.pressure, point_masses=problem.point_masses)
        tol = float(analysis.get("tolerance", 1e-7)) * 0.01
        return solve_plate_static_banded(p_true, tol=tol,
                                         device=device)[0].displacements

    def banded(a, zones):
        return identify_plate_young_banded(
            problem, a["measured_dofs"], a["measured_u"], zones=zones,
            device=device, **adam_options(a, True))

    def dense(a, zones):
        return identify_plate_young(problem, a["measured_dofs"],
                                    a["measured_u"], device=device,
                                    **adam_options(a, False))

    return run_young_identification(
        problem, analysis, "plate", resolve_zones=_resolve_zones,
        probe_dofs=_probe_dofs, true_solve=true_solve,
        identify_banded=banded, identify_dense=dense,
        centroids=problem.coords().mean(axis=1))


def _reliability(problem: PlateProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reliability

    return run_continuum_reliability(problem, analysis, "plate", device)


def _sizing(problem: PlateProblem, analysis: Dict, device) -> Dict:
    """Minimum-weight slab depth under a deflection limit
    (solvers/continuum_sizing.optimize_plate_thickness)."""
    from ..solvers.continuum_sizing import optimize_plate_thickness

    if analysis.get("displacement_limit") is None:
        raise ValueError('plate sizing needs "displacement_limit" '
                         '(deflection-governed slab depth)')
    t_e, weight, hist = optimize_plate_thickness(
        problem, float(analysis["displacement_limit"]),
        probe_dofs=analysis.get("probe_dofs"),
        probe_nodes=analysis.get("probe_nodes"),
        min_thickness=float(analysis.get("min_thickness", 1e-6)),
        n_iter=int(analysis.get("n_iter", 300)),
        outer_rounds=int(analysis.get("outer_rounds", 4)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        device=device)
    return {"success": True, "analysis": "sizing", "element_type": "plate",
            "thickness": t_e.tolist(), "weight": weight,
            "displacement_limit": float(analysis["displacement_limit"]),
            "history": hist.tolist()}


_RUNNERS = {"static": _static, "spectrum": _spectrum, "random": _random,
            "reduction": _reduction, "plastic": _plastic, "modal": _modal,
            "buckling": _buckling, "transient": _transient,
            "harmonic": _harmonic, "identification": _identification,
            "reliability": _reliability, "sizing": _sizing}


def run_plate_analysis(problem: PlateProblem, analysis: Dict,
                       device=None) -> Dict:
    """One analysis of a parsed plate document on `device` ("cuda" when
    None), with the JAX package's checks in its order (the budget of the
    dense kinds first; reliability and sizing refuse above it with their
    own words)."""
    kind = analysis.get("type", "static")
    if kind == "plate":
        # The backend's /api/fem/plate route sends type "plate" for a
        # document without an analysis block: statics.
        kind = "static"
    if kind in _DENSE_KINDS and problem.ndof > _DENSE_BUDGET:
        raise ValueError(
            f"plate {kind} runs on the dense host tier; "
            f"{problem.ndof} DOFs exceeds its 8192-DOF budget — "
            "coarsen the mesh; only statics has a banded large-mesh "
            "path so far")
    if kind in ("reliability", "sizing") and problem.ndof > _DENSE_BUDGET:
        what = ("HL-RF iteration" if kind == "reliability"
                else "ADAM iteration")
        raise ValueError(
            f"plate {kind} runs dense traced solves per {what}; "
            f"{problem.ndof} DOFs exceeds its 8192-DOF budget — "
            "coarsen the mesh")
    runner = _RUNNERS.get(kind)
    if runner is None:
        raise ValueError(f"unknown plate analysis type: {kind!r} — "
                         'supported: "static", "modal", "buckling", '
                         '"transient", "harmonic", "spectrum", "random", '
                         '"reduction", "identification", "plastic", '
                         '"reliability", "sizing"')
    return runner(problem, analysis, device)


def run_plate_document(doc: Dict, device=None) -> Dict:
    problem, analysis = parse_plate_document(doc)
    return run_plate_analysis(problem, analysis, device)
