"""JSON tier of the 3D space-frame family (counterpart of
pinn_fem_tpu/io/frame3d_io.py): documents with
`"element_type": "frame3d"`.

    {"element_type": "frame3d",
     "nodes": [[x, y, z], ..], "elements": [[i, j], ..],
     "material": {"young", "shear_modulus" | "poisson", "area",
                  "inertia_y", "inertia_z", "torsion", "polar_inertia",
                  "density", "alpha"},
     "loads": [Fx0, Fy0, Fz0, Mx0, My0, Mz0, Fx1, ..],   # 6 per node
     "fixed_nodes": [..] | "fixed_dofs": [..],
     "point_masses": [[node, m], ..] | [..per node..],
     "member_loads": [[elem, wx, wy, wz], ..] | [[wx, wy, wz] per element],
     "temperature", "temperature_gradient_y", "temperature_gradient_z",
     "ref_vectors": [[elem, ax, ay, az], ..],
     "analysis": {"type": "static" | "modal" | "transient" | "harmonic"
                  | "buckling" | "spectrum" | "random" | "reduction", ..}}

Statics and modal above DENSE_DOF_LIMIT DOFs take the banded tier
(kernels 1-3 on a card) with probe and summary payloads; everything else
is dense float64 ("spectrum" and "random": io/_common's continuum
runners, member end forces for the stresses).  Every analysis runs on the
caller's device ("cuda" when None).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.frame3d import (SpaceFrameProblem, solve_space_frame_static,
                              solve_space_frame_transient,
                              space_frame_harmonic, space_frame_modal)


def is_frame3d_document(doc: Dict) -> bool:
    return isinstance(doc, dict) and doc.get("element_type") == "frame3d"


def _optional(value):
    return None if value is None else np.asarray(value, dtype=float)


def parse_frame3d_document(doc: Dict) -> Tuple[SpaceFrameProblem, Dict]:
    nodes = np.asarray(doc["nodes"], dtype=float)
    elements = np.asarray(doc["elements"], dtype=int)
    mat = doc.get("material", {})
    for key in ("inertia_y", "inertia_z", "torsion"):
        if mat.get(key) is None:
            raise ValueError(f'space-frame material needs "{key}"')
    nnode = nodes.shape[0]
    nelm = elements.shape[0]
    loads = np.asarray(doc.get("loads", np.zeros(6 * nnode)), dtype=float)
    if "fixed_dofs" in doc:
        fixed = np.asarray(doc["fixed_dofs"], dtype=int)
    elif "fixed_nodes" in doc:
        fn = np.asarray(doc["fixed_nodes"], dtype=int).reshape(-1)
        fixed = (6 * fn[:, None] + np.arange(6)).reshape(-1)
    else:
        raise ValueError('space-frame document needs "fixed_nodes" '
                         'or "fixed_dofs"')
    pm = doc.get("point_masses")
    if pm is not None:
        arr = np.asarray(pm, dtype=float)
        if arr.ndim == 2:                      # [[node, mass], ...]
            pm = np.zeros(nnode)
            for node, mass in arr:
                pm[int(node)] += float(mass)
        else:
            pm = arr
    ml = doc.get("member_loads")
    if ml is not None:
        arr = np.asarray(ml, dtype=float)
        if arr.ndim != 2:
            raise ValueError("member_loads must be a table")
        if arr.shape[1] == 4:              # [[elem, wx, wy, wz], ...]
            ml = np.zeros((nelm, 3))
            for e, wx, wy, wz in arr:
                ml[int(e)] += (wx, wy, wz)
        elif arr.shape[1] == 3:
            ml = arr
        else:
            raise ValueError("member_loads rows must be "
                             "[elem, wx, wy, wz] or [wx, wy, wz]")
    rv = doc.get("ref_vectors")
    if rv is not None:
        arr = np.asarray(rv, dtype=float)
        if arr.ndim != 2 or arr.shape[1] != 4:
            raise ValueError("ref_vectors rows must be "
                             "[elem, ax, ay, az]")
        rv = np.zeros((nelm, 3))               # zero row = default
        for row in arr:
            rv[int(row[0])] = row[1:]
    problem = SpaceFrameProblem(
        nodes=nodes, elements=elements,
        young=np.asarray(mat.get("young", 1.0), dtype=float),
        area=np.asarray(mat.get("area", 1.0), dtype=float),
        inertia_y=np.asarray(mat["inertia_y"], dtype=float),
        inertia_z=np.asarray(mat["inertia_z"], dtype=float),
        torsion_j=np.asarray(mat["torsion"], dtype=float),
        density=np.asarray(mat.get("density", 1.0), dtype=float),
        loads=loads, fixed_dofs=fixed,
        shear_modulus=_optional(mat.get("shear_modulus")),
        poisson=(None if mat.get("poisson") is None
                 else float(mat["poisson"])),
        point_masses=pm, ref_vector=rv,
        polar_inertia=_optional(mat.get("polar_inertia")),
        member_loads=ml, alpha_cte=_optional(mat.get("alpha")),
        temperature=_optional(doc.get("temperature")),
        temperature_gradient_y=_optional(doc.get("temperature_gradient_y")),
        temperature_gradient_z=_optional(doc.get("temperature_gradient_z")))
    return problem, (doc.get("analysis") or {"type": "static"})


def _probe_dofs6(analysis: Dict, problem: SpaceFrameProblem):
    if "probe_dofs" in analysis:
        return np.asarray(analysis["probe_dofs"], dtype=int).reshape(-1)
    if "probe_nodes" in analysis:
        pn = np.asarray(analysis["probe_nodes"], dtype=int).reshape(-1)
        return (6 * pn[:, None] + np.arange(6)).reshape(-1)
    return np.arange(problem.ndof)


def _large(problem: SpaceFrameProblem) -> bool:
    from ..solvers.newton import DENSE_DOF_LIMIT

    return problem.ndof > DENSE_DOF_LIMIT


def _static(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    if _large(problem):
        from ..models.frame3d import solve_space_frame_static_banded

        res, iterations, residual = solve_space_frame_static_banded(
            problem, tol=float(analysis.get("tolerance", 1e-7)),
            max_iter=int(analysis.get("max_iterations", 20000)),
            use_pallas=bool(analysis.get("use_pallas", False)),
            precond=analysis.get("precond", "auto"), device=device)
        u = res.displacements
        i_max = int(np.argmax(np.abs(u)))
        out = {
            "success": True,
            "analysis": "static",
            "element_type": "frame3d",
            "tier": "banded",
            "iterations": int(iterations),
            "relative_residual": float(residual),
            "max_abs_displacement": float(np.abs(u[i_max])),
            "max_abs_displacement_dof": i_max,
            "max_abs_axial": float(np.abs(res.axial).max()),
            "max_abs_torque": float(np.abs(res.torque).max()),
            "max_abs_moment": float(max(np.abs(res.moments_y).max(),
                                        np.abs(res.moments_z).max())),
        }
        probe = analysis.get("probe_dofs")
        if probe is None and analysis.get("probe_nodes") is not None:
            probe = _probe_dofs6(analysis, problem)
        if probe is not None:
            probe = np.asarray(probe, dtype=int).reshape(-1)
            out["probe_dofs"] = probe.tolist()
            out["displacements"] = u[probe].tolist()
        return out
    res = solve_space_frame_static(problem, device=device)
    u = res.displacements
    i_max = int(np.argmax(np.abs(u)))
    return {
        "success": True,
        "analysis": "static",
        "element_type": "frame3d",
        "displacements": u.tolist(),
        "member_end_forces": res.member_end_forces.tolist(),
        "axial_forces": res.axial.tolist(),
        "torques": res.torque.tolist(),
        "end_moments_y": res.moments_y.tolist(),
        "end_moments_z": res.moments_z.tolist(),
        "reactions": res.reactions.tolist(),
        "max_displacement": float(np.abs(u[i_max])),
        "max_displacement_dof": i_max,
    }


def _modal(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    if _large(problem):
        from ..models.frame3d import space_frame_modal_banded

        res = space_frame_modal_banded(
            problem, n_modes=int(analysis.get("n_modes", 4)),
            n_iter=int(analysis.get("n_iter", 30)),
            cg_tol=float(analysis.get("cg_tolerance", 1e-7)),
            device=device)
        out = {
            "success": True,
            "analysis": "modal",
            "element_type": "frame3d",
            "tier": "banded",
            "mass": "lumped",
            "frequencies_hz": res.frequencies_hz.tolist(),
            "omegas": res.omegas.tolist(),
            "eigenvalues": res.eigenvalues.tolist(),
        }
        pn = analysis.get("probe_nodes")
        if pn is not None:
            dofs = _probe_dofs6(analysis, problem)
            out["probe_nodes"] = np.asarray(pn, dtype=int).reshape(-1
                                                                   ).tolist()
            out["mode_shapes"] = res.mode_shapes[:, dofs].tolist()
        return out
    res = space_frame_modal(problem, n_modes=int(analysis.get("n_modes", 6)),
                            device=device)
    return {
        "success": True,
        "analysis": "modal",
        "element_type": "frame3d",
        "n_modes": int(res.frequencies_hz.size),
        "frequencies_hz": res.frequencies_hz.tolist(),
        "omegas": res.omegas.tolist(),
        "eigenvalues": res.eigenvalues.tolist(),
        "mode_shapes": res.mode_shapes.tolist(),
    }


def _transient(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    dt = float(analysis["dt"])
    n_steps = int(analysis["n_steps"])
    damping = analysis.get("damping", [0.0, 0.0])
    amp = analysis.get("amplitude")
    if isinstance(amp, dict):
        if amp.get("type") != "step":
            raise ValueError('space-frame amplitude dict supports '
                             '{"type": "step"}; give an explicit '
                             'array otherwise')
        amp = None                          # the unit step is the default
    probe = _probe_dofs6(analysis, problem)
    res = solve_space_frame_transient(
        problem, dt, n_steps,
        damping=(float(damping[0]), float(damping[1])), amplitude=amp,
        probe_dofs=probe, record_every=int(analysis.get("record_every", 1)),
        device=device)
    return {
        "success": True,
        "analysis": "transient",
        "element_type": "frame3d",
        "dt": res.dt,
        "n_steps": res.n_steps,
        "times": res.times.tolist(),
        "probe_dofs": probe.tolist(),
        "displacements": res.displacements.tolist(),
    }


def _harmonic(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    om = analysis["omegas"]
    if isinstance(om, dict):
        om = np.linspace(float(om["start"]), float(om["stop"]),
                         int(om["num"]))
    om = np.asarray(om, dtype=float).reshape(-1)
    damping = analysis.get("damping", [0.0, 0.0])
    probe = _probe_dofs6(analysis, problem)
    res = space_frame_harmonic(
        problem, om, damping=(float(damping[0]), float(damping[1])),
        probe_dofs=probe, device=device)
    return {
        "success": True,
        "analysis": "harmonic",
        "element_type": "frame3d",
        "omegas": res.omegas.tolist(),
        "probe_dofs": probe.tolist(),
        "amplitude": res.amplitude.tolist(),
        "real": res.real.tolist(),
        "imag": res.imag.tolist(),
    }


def _buckling(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    from ..models.frame3d import space_frame_buckling

    res = space_frame_buckling(problem,
                               n_modes=int(analysis.get("n_modes", 2)),
                               device=device)
    return {
        "success": True,
        "analysis": "buckling",
        "element_type": "frame3d",
        "n_modes": int(res.load_factors.size),
        "load_factors": res.load_factors.tolist(),
        "axial_forces": res.axial.tolist(),
        "buckling_modes": res.modes.tolist(),
    }


def _reduction(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reduction

    return run_continuum_reduction(problem, analysis, "frame3d", device)


def _spectrum(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_spectrum

    return run_continuum_spectrum(problem, analysis, "frame3d", device)


def _random(problem: SpaceFrameProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_random

    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        probe = _probe_dofs6(analysis, problem)
    return run_continuum_random(problem, analysis, "frame3d", probe, device)


_RUNNERS = {"static": _static, "modal": _modal, "transient": _transient,
            "harmonic": _harmonic, "buckling": _buckling,
            "spectrum": _spectrum, "random": _random,
            "reduction": _reduction}


def run_frame3d_analysis(problem: SpaceFrameProblem, analysis: Dict,
                         device=None) -> Dict:
    """One analysis of a parsed space-frame document on `device` ("cuda"
    when None)."""
    kind = analysis.get("type", "static")
    if kind == "frame3d":
        # A route-injected type (the backend's convention) means statics.
        kind = "static"
    runner = _RUNNERS.get(kind)
    if runner is None:
        raise ValueError('space-frame analysis type must be "static", '
                         '"modal", "transient", "harmonic", "buckling", '
                         '"spectrum", "random" or "reduction"')
    return runner(problem, analysis, device)


def run_frame3d_document(doc: Dict, device=None) -> Dict:
    problem, analysis = parse_frame3d_document(doc)
    return run_frame3d_analysis(problem, analysis, device)
