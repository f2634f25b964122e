"""JSON tier of the plane-stress / plane-strain family (counterpart of
pinn_fem_tpu/io/plane_io.py): documents with `"element_type": "plane"`.

    {"element_type": "plane",
     "nodes": [[x, y], ..], "elements": [[i, j, k(, l)], ..]
       | "mesh": {"type": "rect", "width": W, "height": H, "nx": 8,
                  "ny": 4, "element": "quad" | "tri"}
       | "mesh": {"type": "annulus", "r_inner": a, "r_outer": b,
                  "nr": 8, "nt": 12, "sweep": 1.5707963},
     "material": {"young", "poisson", "thickness", "density", "alpha"},
     "plane_strain": false,
     "loads": [..2 per node..],
     "edge_loads": [{"nodes": [..path..], "traction": [tx, ty]}
                  | {"nodes": [..path..], "pressure": p}, ..],
     "body_force": [bx, by],
     "fixed_nodes" | "fixed_dofs" | "fixed_x_nodes" | "fixed_y_nodes",
     "prescribed": [[dof, value], ..],
     "point_masses": [[node, m], ..] | [..per node..],
     "temperature": dT | [..] (or the "thermal" block),
     "analysis": {"type": "static" | "modal" | "buckling" | "transient"
                  | "harmonic" | "plastic" | "spectrum" | "random"
                  | "reduction" | "identification", ..}}

Every node-selecting key also takes a named boundary edge "left",
"right", "bottom" or "top" (path-ordered).  Statics at or below
DENSE_DOF_LIMIT DOFs is the dense float64 solve with the full field in
the result; above it, the banded tier (kernels 1-3 on a card) with probes
and summaries.  The other analyses are dense float64, refused above 8192
DOFs; a transient with "plasticity" is the explicit elastoplastic
transient (solvers/continuum_transient_plastic); "spectrum" and "random"
(with "fatigue") are io/_common's continuum runners; "identification"
recovers Young's modulus from measured displacements
(io/identification_io.run_young_identification: twin data from the
banded tier, named edges, centroid-box zones, the banded adjoint past
DENSE_DOF_LIMIT or with zones, else the dense traced solve); "sizing" is
the minimum-weight thickness field (solvers/continuum_sizing.py) and
"reliability" FORM on the dense traced statics
(io/_common.run_continuum_reliability).  Every analysis runs on the
caller's device ("cuda" when None).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.plane import (PlaneProblem, annulus_mesh, edge_load,
                            plane_buckling, plane_harmonic, plane_modal,
                            pressure_load, rect_mesh,
                            solve_plane_static, solve_plane_static_banded,
                            solve_plane_transient)


def is_plane_document(doc: Dict) -> bool:
    return isinstance(doc, dict) and doc.get("element_type") == "plane"


def _named_nodes(nodes: np.ndarray, name):
    """"left" / "right" (x extreme) or "bottom" / "top" (y extreme) -> the
    node ids on that edge, ordered along it; id lists pass through."""
    if not isinstance(name, str):
        return np.asarray(name, dtype=int).reshape(-1)
    axis, pick = {"left": (0, np.min), "right": (0, np.max),
                  "bottom": (1, np.min), "top": (1, np.max)}.get(
                      name, (None, None))
    if axis is None:
        raise ValueError(f'named node selector must be "left", '
                         f'"right", "bottom" or "top", got {name!r}')
    coord = nodes[:, axis]
    span = max(float(coord.max() - coord.min()), 1.0)
    ids = np.flatnonzero(np.abs(coord - pick(coord)) <= 1e-9 * span)
    return ids[np.argsort(nodes[ids, 1 - axis])]


def _thermal_block(doc, mat):
    """(alpha, temperature) from the "thermal" block or from material
    "alpha" + "temperature"; both forms at once are refused."""
    th = doc.get("thermal")
    if th is None:
        return mat.get("alpha"), doc.get("temperature")
    if "temperature" in doc or "alpha" in mat:
        raise ValueError('give EITHER the "thermal" block OR '
                         'material "alpha" + "temperature", not both')
    if "delta_t" not in th:
        raise ValueError('"thermal" block needs "delta_t"')
    return th.get("alpha", 1.0), th["delta_t"]


def _mesh(doc):
    mesh = doc.get("mesh")
    if mesh is None:
        if "nodes" not in doc or "elements" not in doc:
            raise ValueError('plane document needs "nodes" + '
                             '"elements" or a "mesh" spec')
        return (np.asarray(doc["nodes"], dtype=float),
                np.asarray(doc["elements"], dtype=int))
    mtype = mesh.get("type", "rect")
    if mtype == "rect":
        return rect_mesh(float(mesh["width"]), float(mesh["height"]),
                         int(mesh["nx"]), int(mesh["ny"]),
                         mesh.get("element", "quad"))
    if mtype == "annulus":
        return annulus_mesh(float(mesh["r_inner"]), float(mesh["r_outer"]),
                            int(mesh["nr"]), int(mesh["nt"]),
                            sweep=float(mesh.get("sweep", 0.5 * np.pi)))
    raise ValueError('mesh.type must be "rect" or "annulus"')


def parse_plane_document(doc: Dict) -> Tuple[PlaneProblem, Dict]:
    nodes, elements = _mesh(doc)
    mat = doc.get("material", {})
    if mat.get("poisson") is None:
        raise ValueError('plane material needs "poisson" — the 2D '
                         "constitutive law is the point")
    nnode = nodes.shape[0]
    loads = np.asarray(doc.get("loads", np.zeros(2 * nnode)),
                       dtype=float).reshape(-1)
    thickness = mat.get("thickness", 1.0)
    for spec in doc.get("edge_loads", []):
        has_traction = "traction" in spec
        if "nodes" not in spec or has_traction == ("pressure" in spec):
            raise ValueError('edge_loads entries need "nodes" (path '
                             'order) and exactly one of "traction" '
                             '[tx, ty] or "pressure" p (normal, '
                             'material on the path\'s left)')
        t_arr = np.asarray(thickness, dtype=float).reshape(-1)
        if t_arr.size != 1:
            raise ValueError("edge_loads need a scalar material "
                             "thickness (per-element thickness makes "
                             "the edge share ambiguous)")
        path = _named_nodes(nodes, spec["nodes"])
        if has_traction:
            loads = loads + edge_load(nodes, path, spec["traction"],
                                      float(t_arr[0]), ndof=2 * nnode)
        else:
            loads = loads + pressure_load(nodes, path,
                                          float(spec["pressure"]),
                                          float(t_arr[0]), ndof=2 * nnode)

    fixed_parts = []
    if "fixed_dofs" in doc:
        fixed_parts.append(np.asarray(doc["fixed_dofs"], dtype=int))
    if "fixed_nodes" in doc:
        fn = _named_nodes(nodes, doc["fixed_nodes"])
        fixed_parts.append(np.concatenate([2 * fn, 2 * fn + 1]))
    if "fixed_x_nodes" in doc:
        fixed_parts.append(2 * _named_nodes(nodes, doc["fixed_x_nodes"]))
    if "fixed_y_nodes" in doc:
        fixed_parts.append(2 * _named_nodes(nodes, doc["fixed_y_nodes"])
                           + 1)
    prescribed_pairs = doc.get("prescribed")
    if prescribed_pairs is not None:
        arr = np.asarray(prescribed_pairs, dtype=float)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError('prescribed must be [[dof, value], ..]')
        fixed_parts.append(arr[:, 0].astype(int))
    if not fixed_parts:
        raise ValueError('plane document needs supports: "fixed_nodes",'
                         ' "fixed_dofs", "fixed_x_nodes"/"fixed_y_nodes"'
                         ' or "prescribed"')
    fixed = np.unique(np.concatenate(fixed_parts))
    prescribed = None
    if prescribed_pairs is not None:
        arr = np.asarray(prescribed_pairs, dtype=float)
        prescribed = np.zeros(fixed.size)
        prescribed[np.searchsorted(fixed, arr[:, 0].astype(int))] = arr[:, 1]

    pm = doc.get("point_masses")
    if pm is not None:
        arr = np.asarray(pm, dtype=float)
        if arr.ndim == 2:                       # [[node, mass], ...]
            pm = np.zeros(nnode)
            for node, mass in arr:
                pm[int(node)] += float(mass)
        else:
            pm = arr

    alpha, temperature = _thermal_block(doc, mat)
    problem = PlaneProblem(
        nodes=nodes, elements=elements,
        young=mat.get("young", 1.0), poisson=mat["poisson"],
        thickness=thickness, density=mat.get("density", 1.0),
        loads=loads, fixed_dofs=fixed,
        plane_strain=bool(doc.get("plane_strain", False)),
        prescribed=prescribed, body_force=doc.get("body_force"),
        point_masses=pm, alpha_cte=alpha, temperature=temperature)
    return problem, dict(doc.get("analysis") or {"type": "static"})


def _probe_dofs(analysis: Dict, problem: PlaneProblem):
    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        pn = _named_nodes(problem.nodes, analysis["probe_nodes"])
        probe = np.stack([2 * pn, 2 * pn + 1], axis=1).reshape(-1)
    return probe


def _static(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ..solvers.newton import DENSE_DOF_LIMIT

    large = problem.ndof > DENSE_DOF_LIMIT
    if large:
        # The banded tier; the payload carries probes and summaries.
        res, iterations, residual = solve_plane_static_banded(
            problem, tol=float(analysis.get("tolerance", 1e-7)),
            max_iter=int(analysis.get("max_iterations", 20000)),
            use_pallas=bool(analysis.get("use_pallas", False)),
            precond=analysis.get("precond", "auto"), device=device)
    else:
        res = solve_plane_static(problem, device=device)
    worst = int(np.argmax(res.von_mises)) if res.von_mises.size else -1
    out = {
        "success": True,
        "analysis": "static",
        "element_type": "plane",
        "plane_strain": bool(problem.plane_strain),
        "max_von_mises": (float(res.von_mises[worst]) if worst >= 0
                          else None),
        "max_von_mises_element": worst,
    }
    if not large:
        out.update({
            "displacements": res.displacements.tolist(),
            "stresses": res.stresses.tolist(),
            "von_mises": res.von_mises.tolist(),
            "principal": res.principal.tolist(),
            "strains": res.strains.tolist(),
            "reactions": res.reactions.tolist(),
        })
        return out
    u = res.displacements
    i_max = int(np.argmax(np.abs(u)))
    out.update({
        "tier": "banded",
        "iterations": int(iterations),
        "relative_residual": float(residual),
        "max_abs_displacement": float(np.abs(u[i_max])),
        "max_abs_displacement_dof": i_max,
        "principal_range": [float(res.principal[:, 1].min()),
                            float(res.principal[:, 0].max())],
    })
    probe = _probe_dofs(analysis, problem)
    if probe is not None:
        probe = np.asarray(probe, dtype=int).reshape(-1)
        out["probe_dofs"] = probe.tolist()
        out["displacements"] = u[probe].tolist()
    return out


def _plastic(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ..solvers.plane_plasticity import solve_plane_plastic

    if "sigma_y" not in analysis:
        raise ValueError('plastic analysis requires "sigma_y"')
    kwargs = dict(
        sigma_y=analysis["sigma_y"],
        hardening_iso=analysis.get("hardening", 0.0),
        hardening_kin=analysis.get("kinematic_hardening", 0.0),
        tol=float(analysis.get("tolerance", 1e-9)),
        max_iter=int(analysis.get("max_iterations", 30)),
    )
    if analysis.get("bbar") is not None:
        kwargs["bbar"] = bool(analysis["bbar"])
    if "load_factors" in analysis:
        kwargs["load_factors"] = np.asarray(analysis["load_factors"],
                                            dtype=float)
    else:
        kwargs["target_load_factor"] = float(analysis.get("target", 1.0))
        kwargs["n_steps"] = int(analysis.get("n_steps", 20))
    res = solve_plane_plastic(problem, device=device, **kwargs)
    probe = _probe_dofs(analysis, problem)
    if probe is None:
        probe = np.arange(problem.ndof)
    probe = np.asarray(probe, dtype=int).reshape(-1)
    out = {
        "success": bool(res.converged),
        "analysis": "plastic",
        "element_type": "plane",
        "plane_strain": bool(problem.plane_strain),
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
            "stresses": res.stresses[-1].tolist(),
            "sigma_zz": res.sigma_zz[-1].tolist(),
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


def _modal(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    pres = None
    if analysis.get("prestress") is not None:
        from ._common import _continuum_prestress_u

        pres = _continuum_prestress_u(
            problem, analysis["prestress"],
            lambda pp: solve_plane_static(pp, device=device).displacements)
    res = plane_modal(problem, n_modes=int(analysis.get("n_modes", 6)),
                      prestress_u=pres, device=device)
    out = {
        "success": True,
        "analysis": "modal",
        "element_type": "plane",
        "prestressed": pres is not None,
        "frequencies_hz": res.frequencies_hz.tolist(),
        "omegas": res.omegas.tolist(),
        "eigenvalues": res.eigenvalues.tolist(),
    }
    if analysis.get("include_shapes", True):
        out["mode_shapes"] = res.mode_shapes.tolist()
    return out


def _transient(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    if "plasticity" in analysis:
        from ..solvers.continuum_transient_plastic import \
            solve_plane_transient_plastic
        from ._common import run_continuum_transient_plastic

        if analysis.get("n_steps") is None:
            raise ValueError('plane transient needs "n_steps"')
        extra = {}
        if analysis.get("bbar") is not None:
            extra["bbar"] = bool(analysis["bbar"])
        out = run_continuum_transient_plastic(
            problem, analysis, "plane", solve_plane_transient_plastic,
            _probe_dofs(analysis, problem), device, **extra)
        out["plane_strain"] = bool(problem.plane_strain)
        return out
    if analysis.get("dt") is None or analysis.get("n_steps") is None:
        raise ValueError('plane transient needs "dt" and "n_steps"')
    n_steps = int(analysis["n_steps"])
    amp = analysis.get("amplitude")
    if isinstance(amp, dict):
        t = np.arange(n_steps) * float(analysis["dt"])
        if amp.get("type", "step") == "step":
            amp = np.ones(n_steps)
        elif amp.get("type") == "sine":
            f_hz = float(amp.get("frequency_hz", 1.0))
            amp = np.sin(2.0 * np.pi * f_hz * t)
        else:
            raise ValueError('plane amplitude type must be '
                             '"step" or "sine" (or a list)')
    res = solve_plane_transient(
        problem, float(analysis["dt"]), n_steps,
        damping=analysis.get("damping", (0.0, 0.0)), amplitude=amp,
        probe_dofs=_probe_dofs(analysis, problem),
        record_every=int(analysis.get("record_every", 1)), device=device)
    return {
        "success": True,
        "analysis": "transient",
        "element_type": "plane",
        "times": res.times.tolist(),
        "displacements": res.displacements.tolist(),
        "velocities": res.velocities.tolist(),
        "dt": res.dt,
        "n_steps": res.n_steps,
    }


def _harmonic(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    om = analysis.get("omegas")
    if om is None:
        raise ValueError('plane harmonic needs "omegas"')
    if isinstance(om, dict):
        om = np.linspace(float(om["start"]), float(om["stop"]),
                         int(om.get("num", 50)))
    res = plane_harmonic(problem, om,
                         damping=analysis.get("damping", (0.0, 0.0)),
                         probe_dofs=_probe_dofs(analysis, problem),
                         device=device)
    return {
        "success": True,
        "analysis": "harmonic",
        "element_type": "plane",
        "omegas": res.omegas.tolist(),
        "amplitude": res.amplitude.tolist(),
    }


def _buckling(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    res = plane_buckling(problem, n_modes=int(analysis.get("n_modes", 4)),
                         device=device)
    out = {
        "success": True,
        "analysis": "buckling",
        "element_type": "plane",
        "load_factors": res.load_factors.tolist(),
        "von_mises": res.von_mises.tolist(),
    }
    if analysis.get("include_shapes", True):
        out["buckling_modes"] = res.modes.tolist()
    return out


def _reduction(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reduction

    return run_continuum_reduction(problem, analysis, "plane", device)


def _spectrum(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_spectrum

    return run_continuum_spectrum(problem, analysis, "plane", device)


def _random(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_random

    return run_continuum_random(problem, analysis, "plane",
                                _probe_dofs(analysis, problem), device)


def _resolve_zones(problem: PlaneProblem, zones):
    """Zone specs -> element-id arrays: explicit id lists or centroid boxes
    {"x_min", "x_max", "y_min", "y_max"} (any subset)."""
    from .identification_io import centroid_zones

    return centroid_zones(problem, zones, problem.coords().mean(axis=1),
                          "xy")


def _identification(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ..models.plane import (identify_plane_young,
                                identify_plane_young_banded)
    from .identification_io import adam_options, run_young_identification

    def true_solve(true_young):
        p_true = PlaneProblem(nodes=problem.nodes, elements=problem.elements,
                              young=true_young, poisson=problem.poisson,
                              thickness=problem.thickness,
                              density=problem.density, loads=problem.loads,
                              fixed_dofs=problem.fixed_dofs,
                              plane_strain=problem.plane_strain,
                              body_force=problem.body_force)
        tol = float(analysis.get("tolerance", 1e-7)) * 0.01
        return solve_plane_static_banded(p_true, tol=tol,
                                         device=device)[0].displacements

    def banded(a, zones):
        return identify_plane_young_banded(
            problem, a["measured_dofs"], a["measured_u"], zones=zones,
            device=device, **adam_options(a, True))

    def dense(a, zones):
        return identify_plane_young(problem, a["measured_dofs"],
                                    a["measured_u"], device=device,
                                    **adam_options(a, False))

    return run_young_identification(
        problem, analysis, "plane", resolve_zones=_resolve_zones,
        probe_dofs=_probe_dofs, true_solve=true_solve,
        identify_banded=banded, identify_dense=dense,
        centroids=problem.coords().mean(axis=1))


def _reliability(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reliability

    return run_continuum_reliability(problem, analysis, "plane", device)


def _sizing(problem: PlaneProblem, analysis: Dict, device) -> Dict:
    """Minimum-weight thickness field under stress and / or displacement
    limits (solvers/continuum_sizing.optimize_plane_thickness)."""
    from ..solvers.continuum_sizing import optimize_plane_thickness

    t_e, weight, hist = optimize_plane_thickness(
        problem,
        stress_limit=(None if analysis.get("stress_limit") is None
                      else float(analysis["stress_limit"])),
        displacement_limit=(
            None if analysis.get("displacement_limit") is None
            else float(analysis["displacement_limit"])),
        probe_dofs=_probe_dofs(analysis, problem),
        min_thickness=float(analysis.get("min_thickness", 1e-6)),
        n_iter=int(analysis.get("n_iter", 300)),
        outer_rounds=int(analysis.get("outer_rounds", 4)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        device=device)
    out = {"success": True, "analysis": "sizing", "element_type": "plane",
           "thickness": t_e.tolist(), "weight": weight,
           "history": hist.tolist()}
    for key in ("stress_limit", "displacement_limit"):
        if analysis.get(key) is not None:
            out[key] = float(analysis[key])
    return out


_RUNNERS = {"reduction": _reduction, "buckling": _buckling,
            "plastic": _plastic, "modal": _modal, "transient": _transient,
            "harmonic": _harmonic, "spectrum": _spectrum,
            "random": _random, "identification": _identification,
            "reliability": _reliability, "sizing": _sizing}


def run_plane_analysis(problem: PlaneProblem, analysis: Dict,
                       device=None) -> Dict:
    """One analysis of a parsed plane document on `device` ("cuda" when
    None), with the JAX package's checks in its order."""
    kind = analysis.get("type", "static")
    if kind == "plane":
        # The backend's /api/fem/plane route sends type "plane" for a
        # document without an analysis block: statics.
        kind = "static"
    if kind == "static":
        return _static(problem, analysis, device)
    if kind in ("modal", "transient", "harmonic", "identification",
                "plastic", "buckling", "spectrum", "random",
                "reduction", "reliability", "sizing") \
            and problem.ndof > 4 * 2048:
        raise ValueError(
            f"plane {kind} runs on the dense host tier; {problem.ndof} "
            "DOFs exceeds its 8192-DOF budget (minutes of O(n^3) work "
            "on one core) — coarsen the mesh; only statics has a "
            "banded large-mesh path so far")
    runner = _RUNNERS.get(kind)
    if runner is None:
        raise ValueError(f'plane analysis.type must be "static", "modal", '
                         f'"transient", "harmonic", "buckling", "plastic", '
                         f'"spectrum", "random", "reduction", '
                         f'"reliability", "sizing" or "identification", '
                         f'got {kind!r}')
    return runner(problem, analysis, device)


def run_plane_document(doc: Dict, device=None) -> Dict:
    problem, analysis = parse_plane_document(doc)
    return run_plane_analysis(problem, analysis, device)
