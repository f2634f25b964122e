"""JSON tier of the flat-facet shell family (counterpart of
pinn_fem_tpu/io/shell_io.py): documents with `"element_type": "shell"`.

    {"element_type": "shell",
     "nodes": [[x, y, z], ..], "elements": [[a, b, c, d], ..]
       | "mesh": {"type": "cylinder_panel", "radius", "length",
                  "half_angle_deg", "nx", "ny"}
               | {"type": "hemisphere", "radius", "hole_deg", "n"}
               | {"type": "arch_strip", "length", "width", "rise", "nx"},
     "material": {"young", "poisson", "thickness", "density", "alpha"},
     "loads": [6 per node ..], "point_loads": [[node, dof, value], ..],
     "sine_load": Q,                  # arch_strip only: half-sine pattern
     "fixed_nodes": [..] | "fixed_dofs": [..],
     "supports": [{"nodes": [..] | "x_min" .. "z_max", "dofs": [..]}, ..],
     "pressure": q, "body_force": [gx, gy, gz],
     "point_masses": [[node, m], ..] | [..per node..],
     "temperature": dT, "temperature_gradient": dTg,
     "analysis": {"type": "static" | "modal" | "buckling" | "transient"
                  | "harmonic" | "spectrum" | "random" | "reduction"
                  | "plastic" | "nonlinear" | "continuation", ..}}

Statics at or below DENSE_DOF_LIMIT DOFs is the dense float64 solve; above
it the banded tier ("tier": "banded", kernels 1-3 on a card) with probes
and summaries.  Modal and buckling refuse above the limit with the JAX
package's words (the thin-shell pencil sits below the float32 eigen floor
of a banded tier).  "nonlinear" is the float64 Marguerre Newton, or the
banded tier above the limit or with "banded": true; "continuation" the
float64 arc length; "plastic" the layered J2 statics; "identification"
recovers Young's modulus from measured displacements
(io/identification_io.run_young_identification: the banded adjoint past
DENSE_DOF_LIMIT or with zones, else the dense traced solve);
"sizing" is the minimum-weight plating thickness
(solvers/continuum_sizing.py) and "reliability" FORM on the dense traced
statics (io/_common.run_continuum_reliability), both refused above 8192
DOFs.  Every analysis runs on the caller's device ("cuda" when None).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.shell import (ShellProblem, arch_strip_mesh,
                            cylinder_panel_mesh, hemisphere_mesh,
                            shell_buckling, shell_harmonic, shell_modal,
                            solve_shell_static, solve_shell_static_banded,
                            solve_shell_transient)

# The field payloads' size guard (the JAX package's 6 * 600 DOFs).
_FIELD_DOFS = 6 * 600


def is_shell_document(doc: Dict) -> bool:
    return isinstance(doc, dict) and doc.get("element_type") == "shell"


def _resolve_nodes(nodes: np.ndarray, spec) -> np.ndarray:
    """Support-group node spec: an index list, or a named coordinate
    extreme "x_min" .. "z_max" of the (generated) midsurface."""
    if isinstance(spec, str):
        axis = {"x": 0, "y": 1, "z": 2}.get(spec[:1])
        if axis is None or spec[1:] not in ("_min", "_max"):
            raise ValueError(f'unknown shell node group {spec!r} '
                             '(use "x_min" .. "z_max" or indices)')
        coord = nodes[:, axis]
        ref = coord.min() if spec.endswith("_min") else coord.max()
        span = max(coord.max() - coord.min(), 1e-300)
        return np.flatnonzero(np.abs(coord - ref) < 1e-9 * span)
    return np.asarray(spec, dtype=int).reshape(-1)


def _mesh(mesh: Dict):
    kind = mesh.get("type")
    if kind == "cylinder_panel":
        return cylinder_panel_mesh(
            float(mesh["radius"]), float(mesh["length"]),
            float(mesh["half_angle_deg"]), int(mesh["nx"]), int(mesh["ny"]))
    if kind == "hemisphere":
        return hemisphere_mesh(float(mesh["radius"]),
                               float(mesh.get("hole_deg", 18.0)),
                               int(mesh["n"]))
    if kind == "arch_strip":
        return arch_strip_mesh(float(mesh["length"]),
                               float(mesh.get("width", 1.0)),
                               float(mesh["rise"]), int(mesh["nx"]))
    raise ValueError('shell mesh.type must be "cylinder_panel", '
                     '"hemisphere" or "arch_strip"')


def _sine_load(loads: np.ndarray, mesh, amp: float) -> None:
    """Add the downward half-sine load of amplitude `amp` per unit
    projected area on an arch_strip midsurface (trapezoid nodal pattern)."""
    if mesh is None or mesh.get("type") != "arch_strip":
        raise ValueError('"sine_load" needs the arch_strip generated mesh '
                         "(x-fastest two-row numbering)")
    nx = int(mesh["nx"])
    length = float(mesh["length"])
    width = float(mesh.get("width", 1.0))
    h = length / nx
    for i, x in enumerate(np.linspace(0.0, length, nx + 1)):
        wt = h if 0 < i < nx else h / 2.0
        val = -amp * np.sin(np.pi * x / length) * wt * (width / 2)
        for row_off in (0, nx + 1):
            loads[6 * (i + row_off) + 2] += val


def parse_shell_document(doc: Dict) -> Tuple[ShellProblem, Dict]:
    mesh = doc.get("mesh")
    if mesh is not None:
        nodes, elements = _mesh(mesh)
    else:
        nodes = np.asarray(doc["nodes"], dtype=float)
        elements = np.asarray(doc["elements"], dtype=int)
    nnode = nodes.shape[0]
    mat = doc.get("material", {})
    if mat.get("thickness") is None:
        raise ValueError('shell material needs "thickness"')
    loads = np.asarray(doc.get("loads", np.zeros(6 * nnode)), dtype=float)
    for node, dof, value in doc.get("point_loads", ()):
        loads[6 * int(node) + int(dof)] += float(value)
    if "sine_load" in doc:
        _sine_load(loads, mesh, float(doc["sine_load"]))
    fixed = []
    if "fixed_dofs" in doc:
        fixed.append(np.asarray(doc["fixed_dofs"], dtype=int).reshape(-1))
    if "fixed_nodes" in doc:
        fn = np.asarray(doc["fixed_nodes"], dtype=int).reshape(-1)
        fixed.append((6 * fn[:, None] + np.arange(6)[None, :]).reshape(-1))
    for grp in doc.get("supports", ()):
        gn = _resolve_nodes(nodes, grp["nodes"])
        gd = np.asarray(grp["dofs"], dtype=int).reshape(-1)
        if gd.size and (gd.min() < 0 or gd.max() > 5):
            raise ValueError("supports dofs index 0..5 per node")
        fixed.append((6 * gn[:, None] + gd[None, :]).reshape(-1))
    if not fixed:
        raise ValueError('shell document needs "fixed_nodes", '
                         '"fixed_dofs" or "supports"')
    pm = doc.get("point_masses")
    if pm is not None:
        arr = np.asarray(pm, dtype=float)
        if arr.ndim == 2:
            pm = np.zeros(nnode)
            for node, mass in arr:
                pm[int(node)] += float(mass)
        else:
            pm = arr

    def optional(value):
        return None if value is None else np.asarray(value, dtype=float)

    problem = ShellProblem(
        nodes=nodes, elements=elements,
        young=np.asarray(mat.get("young", 1.0), dtype=float),
        poisson=np.asarray(mat.get("poisson", 0.3), dtype=float),
        thickness=np.asarray(mat["thickness"], dtype=float),
        density=np.asarray(mat.get("density", 1.0), dtype=float),
        loads=loads, fixed_dofs=np.unique(np.concatenate(fixed)),
        pressure=optional(doc.get("pressure")),
        body_force=optional(doc.get("body_force")), point_masses=pm,
        alpha_cte=optional(mat.get("alpha")),
        temperature=optional(doc.get("temperature")),
        temperature_gradient=optional(doc.get("temperature_gradient")))
    return problem, (doc.get("analysis") or {"type": "static"})


def _probe6(analysis: Dict, problem: ShellProblem) -> np.ndarray:
    if "probe_dofs" in analysis:
        return np.asarray(analysis["probe_dofs"], dtype=int).reshape(-1)
    if "probe_nodes" in analysis:
        pn = np.asarray(analysis["probe_nodes"], dtype=int).reshape(-1)
        return (6 * pn[:, None] + np.arange(6)[None, :]).reshape(-1)
    return np.arange(problem.ndof)


def _explicit_probe(analysis: Dict, problem: ShellProblem):
    """The probe DOFs of "probe_dofs" / "probe_nodes", or None."""
    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        probe = _probe6(analysis, problem)
    return (None if probe is None
            else np.asarray(probe, dtype=int).reshape(-1))


def _large(problem: ShellProblem) -> bool:
    from ..solvers.newton import DENSE_DOF_LIMIT

    return problem.ndof > DENSE_DOF_LIMIT


def _static(problem: ShellProblem, analysis: Dict, device) -> Dict:
    if _large(problem):
        res, iterations, residual = solve_shell_static_banded(
            problem, tol=float(analysis.get("tolerance", 1e-7)),
            max_iter=int(analysis.get("max_iterations", 40000)),
            use_pallas=bool(analysis.get("use_pallas", False)),
            precond=analysis.get("precond", "auto"), device=device)
    else:
        res = solve_shell_static(problem, device=device)
    u = res.displacements
    i_max = int(np.argmax(np.abs(u)))
    out = {"success": True, "analysis": "static", "element_type": "shell"}
    if _large(problem):
        out.update({
            "tier": "banded",
            "iterations": int(iterations),
            "relative_residual": float(residual),
            "max_displacement": float(np.abs(u[i_max])),
            "max_displacement_dof": i_max,
            "max_abs_membrane_force": float(
                np.abs(res.membrane_forces).max()),
            "max_abs_moment": float(np.abs(res.moments).max()),
        })
    else:
        out.update({
            "max_displacement": float(np.abs(u[i_max])),
            "max_displacement_dof": i_max,
            "membrane_forces": res.membrane_forces.tolist(),
            "moments": res.moments.tolist(),
        })
    probe = _explicit_probe(analysis, problem)
    if probe is not None:
        out["probe_dofs"] = probe.tolist()
        out["probe_displacements"] = u[probe].tolist()
    if not _large(problem) and problem.ndof <= _FIELD_DOFS:
        out["displacements"] = u.tolist()
        out["reactions"] = res.reactions.tolist()
    return out


def _buckling(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ..solvers.newton import DENSE_DOF_LIMIT

    if _large(problem):
        raise ValueError(
            f"shell buckling is dense-host-only ({problem.ndof} "
            f"DOFs > {DENSE_DOF_LIMIT}): the thin-shell "
            "eigen-pencil sits below the f32 floor of the banded "
            "device tier (the shell-modal rationale, "
            "models/shell.py); reduce the mesh")
    res = shell_buckling(problem,
                         membrane_force=analysis.get("membrane_force"),
                         n_modes=int(analysis.get("n_modes", 4)),
                         device=device)
    out = {
        "success": True,
        "analysis": "buckling",
        "element_type": "shell",
        "load_factors": res.load_factors.tolist(),
        "max_abs_membrane_force": float(np.abs(res.membrane_forces).max()),
    }
    if analysis.get("include_shapes", True) and problem.ndof <= _FIELD_DOFS:
        out["buckling_modes"] = res.modes.tolist()
    return out


def _modal(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ..solvers.newton import DENSE_DOF_LIMIT

    if _large(problem):
        raise ValueError(
            f"shell modal is dense-host-only ({problem.ndof} "
            f"DOFs > {DENSE_DOF_LIMIT}): the thin-shell pencil's "
            "lambda_1/lambda_max ~ 3e-7 sits below the f32 "
            "eigen-pencil floor of the banded device tier "
            "(measured 3-10% Ritz noise); reduce the mesh or "
            "condense a substructure")
    res = shell_modal(problem, n_modes=int(analysis.get("n_modes", 6)),
                      device=device)
    out = {
        "success": True,
        "analysis": "modal",
        "element_type": "shell",
        "n_modes": int(res.frequencies_hz.size),
        "frequencies_hz": res.frequencies_hz.tolist(),
        "omegas": res.omegas.tolist(),
        "eigenvalues": res.eigenvalues.tolist(),
    }
    if problem.ndof <= _FIELD_DOFS:
        out["mode_shapes"] = res.mode_shapes.tolist()
    return out


def _steps(analysis: Dict, n_steps: int) -> Dict:
    """The load-factor history of a nonlinear or plastic block."""
    if "load_factors" in analysis:
        return {"load_factors": np.asarray(analysis["load_factors"],
                                           dtype=float)}
    return {"target_load_factor": float(analysis.get("target", 1.0)),
            "n_steps": int(analysis.get("n_steps", n_steps))}


def _nonlinear(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ..solvers.shell_nonlinear import (solve_shell_nonlinear,
                                           solve_shell_nonlinear_banded)

    kwargs = dict(max_iter=int(analysis.get("max_iterations", 40)),
                  **_steps(analysis, 10))
    banded = analysis.get("banded")
    if banded is None:
        banded = _large(problem)
    if banded:
        res = solve_shell_nonlinear_banded(
            problem, tol=float(analysis.get("tolerance", 5e-4)),
            cg_tol=float(analysis.get("cg_tolerance", 1e-6)),
            device=device, **kwargs)
    else:
        res = solve_shell_nonlinear(
            problem, tol=float(analysis.get("tolerance", 1e-9)),
            device=device, **kwargs)
    probe = _probe6(analysis, problem)
    explicit = "probe_dofs" in analysis or "probe_nodes" in analysis
    out = {
        "success": bool(res.converged),
        "analysis": "nonlinear",
        "element_type": "shell",
        "tier": "banded" if banded else "dense",
        "n_steps": int(res.load_factors.size),
        "load_factors": res.load_factors.tolist(),
        "iterations": res.iterations.tolist(),
        "max_residual": float(res.residuals.max()),
        "max_displacement": float(np.abs(res.displacements[-1]).max()),
        "max_abs_membrane_force": float(
            np.abs(res.membrane_forces[-1]).max()),
        "max_abs_moment": float(np.abs(res.moments[-1]).max()),
    }
    if explicit or problem.ndof <= _FIELD_DOFS:
        out["probe_dofs"] = probe.tolist()
        out["displacements"] = res.displacements[:, probe].tolist()
    if problem.ndof <= _FIELD_DOFS:
        out["final"] = {
            "membrane_forces": res.membrane_forces[-1].tolist(),
            "moments": res.moments[-1].tolist(),
            "displacements": res.displacements[-1].tolist(),
        }
    return out


def _continuation(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ..solvers.shell_nonlinear import solve_shell_riks

    res = solve_shell_riks(
        problem, n_steps=int(analysis.get("n_steps", 60)),
        dl0=float(analysis.get("dl0", analysis.get("initial_dlambda",
                                                   0.05))),
        tol=float(analysis.get("tolerance", 1e-8)),
        max_arc_iter=int(analysis.get("max_iterations", 25)),
        max_dl=(float(analysis["max_dl"]) if "max_dl" in analysis
                else None), device=device)
    probe = _probe6(analysis, problem)
    return {
        "success": bool(res.converged),
        "analysis": "continuation",
        "element_type": "shell",
        "n_points": int(res.load_factors.size),
        "load_factors": res.load_factors.tolist(),
        "probe_dofs": probe.tolist(),
        "displacements": res.displacements[:, probe].tolist(),
        "iterations": res.iterations.tolist(),
        "max_residual": (float(res.residuals.max()) if res.residuals.size
                         else None),
    }


def _plastic(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ..solvers.shell_plasticity import solve_shell_plastic

    if "sigma_y" not in analysis:
        raise ValueError('plastic analysis requires "sigma_y"')
    n_layers = int(analysis.get("n_layers", 20))
    res = solve_shell_plastic(
        problem, sigma_y=analysis["sigma_y"],
        hardening_iso=analysis.get("hardening", 0.0),
        hardening_kin=analysis.get("kinematic_hardening", 0.0),
        n_layers=n_layers, tol=float(analysis.get("tolerance", 1e-9)),
        max_iter=int(analysis.get("max_iterations", 30)), device=device,
        **_steps(analysis, 20))
    probe = _probe6(analysis, problem)
    out = {
        "success": bool(res.converged),
        "analysis": "plastic",
        "element_type": "shell",
        "n_layers": n_layers,
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
            "membrane_forces": res.membrane_forces[-1].tolist(),
            "moments": res.moments[-1].tolist(),
            "von_mises": res.von_mises[-1].tolist(),
            "eq_plastic_strain": res.eq_plastic[-1].tolist(),
            "displacements": res.displacements[-1].tolist(),
        },
    }
    if analysis.get("include_history"):
        out["membrane_forces"] = res.membrane_forces.tolist()
        out["moments"] = res.moments.tolist()
        out["von_mises"] = res.von_mises.tolist()
    return out


def _transient(problem: ShellProblem, analysis: Dict, device) -> Dict:
    dt = float(analysis["dt"])
    n_steps = int(analysis["n_steps"])
    damping = analysis.get("damping", [0.0, 0.0])
    amp = analysis.get("amplitude")
    if isinstance(amp, dict):
        if amp.get("type") != "step":
            raise ValueError('shell amplitude dict supports '
                             '{"type": "step"}; give an explicit '
                             'array otherwise')
        amp = None
    probe = _probe6(analysis, problem)
    res = solve_shell_transient(
        problem, dt, n_steps, damping=(float(damping[0]),
                                       float(damping[1])),
        amplitude=amp, probe_dofs=probe,
        record_every=int(analysis.get("record_every", 1)), device=device)
    return {
        "success": True,
        "analysis": "transient",
        "element_type": "shell",
        "dt": res.dt,
        "n_steps": res.n_steps,
        "times": res.times.tolist(),
        "probe_dofs": probe.tolist(),
        "displacements": res.displacements.tolist(),
    }


def _harmonic(problem: ShellProblem, analysis: Dict, device) -> Dict:
    om = analysis["omegas"]
    if isinstance(om, dict):
        om = np.linspace(float(om["start"]), float(om["stop"]),
                         int(om["num"]))
    damping = analysis.get("damping", [0.0, 0.0])
    probe = _probe6(analysis, problem)
    res = shell_harmonic(problem, np.asarray(om, dtype=float).reshape(-1),
                         damping=(float(damping[0]), float(damping[1])),
                         probe_dofs=probe, device=device)
    return {
        "success": True,
        "analysis": "harmonic",
        "element_type": "shell",
        "omegas": res.omegas.tolist(),
        "probe_dofs": probe.tolist(),
        "amplitude": res.amplitude.tolist(),
        "real": res.real.tolist(),
        "imag": res.imag.tolist(),
    }


def _spectrum(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_spectrum

    return run_continuum_spectrum(problem, analysis, "shell", device)


def _random(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_random

    return run_continuum_random(problem, analysis, "shell",
                                _explicit_probe(analysis, problem), device)


def _reduction(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reduction

    return run_continuum_reduction(problem, analysis, "shell", device)


def _resolve_zones(problem: ShellProblem, zones):
    """Zone specs -> facet-id arrays: explicit id lists or 3D centroid
    boxes {"x_min" .. "z_max"} (any subset)."""
    from .identification_io import centroid_zones

    return centroid_zones(problem, zones,
                          problem.nodes[problem.elements].mean(axis=1),
                          "xyz", "facets")


def _identification(problem: ShellProblem, analysis: Dict, device) -> Dict:
    """Young's modulus from measured shell displacements (the plane /
    plate contract on curved midsurfaces, E at known thickness); twin
    data from the banded tier past DENSE_DOF_LIMIT, else the dense
    float64 solve."""
    from ..models.shell import (identify_shell_young,
                                identify_shell_young_banded,
                                solve_shell_static, solve_shell_static_banded)
    from ..solvers.newton import DENSE_DOF_LIMIT
    from .identification_io import adam_options, run_young_identification

    def probe_dofs(a, problem):
        md = a.get("probe_nodes")
        return None if md is None else _probe6({"probe_nodes": md}, problem)

    def true_solve(true_young):
        p_true = ShellProblem(
            nodes=problem.nodes, elements=problem.elements,
            young=true_young, poisson=problem.poisson,
            thickness=problem.thickness, density=problem.density,
            loads=problem.loads, fixed_dofs=problem.fixed_dofs,
            pressure=problem.pressure, body_force=problem.body_force,
            point_masses=problem.point_masses)
        if problem.ndof > DENSE_DOF_LIMIT:
            tol = float(analysis.get("tolerance", 1e-7)) * 0.01
            return solve_shell_static_banded(p_true, tol=tol,
                                             device=device)[0].displacements
        return solve_shell_static(p_true, device=device).displacements

    def banded(a, zones):
        return identify_shell_young_banded(
            problem, a["measured_dofs"], a["measured_u"], zones=zones,
            device=device, **adam_options(a, True))

    def dense(a, zones):
        return identify_shell_young(problem, a["measured_dofs"],
                                    a["measured_u"], device=device,
                                    **adam_options(a, False))

    return run_young_identification(
        problem, analysis, "shell", resolve_zones=_resolve_zones,
        probe_dofs=probe_dofs, true_solve=true_solve,
        identify_banded=banded, identify_dense=dense,
        centroids=problem.nodes[problem.elements].mean(axis=1),
        report_truth=False, finite=True)


def _sizing(problem: ShellProblem, analysis: Dict, device) -> Dict:
    """Minimum-weight plating thickness under extreme-fiber stress and /
    or displacement limits (solvers/continuum_sizing.
    optimize_shell_thickness)."""
    from ..solvers.continuum_sizing import optimize_shell_thickness

    if analysis.get("stress_limit") is None \
            and analysis.get("displacement_limit") is None:
        raise ValueError('shell sizing needs "stress_limit" '
                         'and/or "displacement_limit"')
    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        probe = _probe6(analysis, problem).tolist()
    sl = analysis.get("stress_limit")
    dl = analysis.get("displacement_limit")
    t_e, weight, hist = optimize_shell_thickness(
        problem, stress_limit=None if sl is None else float(sl),
        displacement_limit=None if dl is None else float(dl),
        probe_dofs=probe,
        min_thickness=float(analysis.get("min_thickness", 1e-6)),
        n_iter=int(analysis.get("n_iter", 300)),
        outer_rounds=int(analysis.get("outer_rounds", 4)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        device=device)
    out = {"success": True, "analysis": "sizing", "element_type": "shell",
           "thickness": t_e.tolist(), "weight": weight,
           "history": hist.tolist()}
    if sl is not None:
        out["stress_limit"] = float(sl)
    if dl is not None:
        out["displacement_limit"] = float(dl)
    return out


def _reliability(problem: ShellProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reliability

    return run_continuum_reliability(problem, analysis, "shell", device)


_RUNNERS = {"static": _static, "buckling": _buckling, "modal": _modal,
            "nonlinear": _nonlinear, "continuation": _continuation,
            "plastic": _plastic, "transient": _transient,
            "harmonic": _harmonic, "spectrum": _spectrum,
            "random": _random, "reduction": _reduction,
            "identification": _identification, "sizing": _sizing,
            "reliability": _reliability}


def run_shell_analysis(problem: ShellProblem, analysis: Dict,
                       device=None) -> Dict:
    """One analysis of a parsed shell document on `device` ("cuda" when
    None), with the JAX package's checks in its order (sizing and
    reliability refuse above their 8192-DOF budget with its words)."""
    kind = analysis.get("type", "static")
    if kind == "shell":
        # A route-injected type (the backend's convention) means statics.
        kind = "static"
    if kind in ("sizing", "reliability") and problem.ndof > 8192:
        what = "HL-RF" if kind == "reliability" else "ADAM"
        raise ValueError(
            f"shell {kind} runs dense traced solves per {what} "
            f"iteration; {problem.ndof} DOFs exceeds its 8192-DOF "
            "budget — coarsen the midsurface")
    runner = _RUNNERS.get(kind)
    if runner is None:
        raise ValueError('shell analysis type must be "static", "modal", '
                         '"buckling", "transient", "harmonic", '
                         '"spectrum", "random", "reduction", "plastic", '
                         '"nonlinear", "continuation", '
                         '"identification", "sizing" or "reliability"')
    return runner(problem, analysis, device)


def run_shell_document(doc: Dict, device=None) -> Dict:
    problem, analysis = parse_shell_document(doc)
    return run_shell_analysis(problem, analysis, device)
