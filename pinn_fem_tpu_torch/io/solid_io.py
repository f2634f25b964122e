"""JSON tier of the 3D solid hex8 family (counterpart of
pinn_fem_tpu/io/solid_io.py): documents with `"element_type": "solid"`.

    {"element_type": "solid",
     "nodes": [[x, y, z], ..], "elements": [[n0..n7], ..]
       | "mesh": {"type": "box", "lx", "ly", "lz", "nx", "ny", "nz"},
     "material": {"young", "poisson", "density", "alpha"},
     "loads": [..3 per node..],
     "surface_loads": [{"face": "z_max" | [[quad node ids], ..],
                        "traction": [tx, ty, tz]}, ..],
     "body_force": [bx, by, bz],
     "fixed_nodes" | "fixed_dofs" | "fixed_x_nodes" | "fixed_y_nodes"
       | "fixed_z_nodes",
     "prescribed": [[dof, value], ..],
     "point_masses": [[node, m], ..] | [..per node..],
     "temperature": dT | [..] (or the "thermal" block),
     "analysis": {"type": "static" | "modal" | "transient" | "buckling"
                  | "harmonic" | "plastic" | "spectrum" | "random"
                  | "reduction", ..}}

Every node-selecting key also takes a named boundary face "x_min",
"x_max", "y_min", "y_max", "z_min" or "z_max".  Statics and modal at or
below DENSE_DOF_LIMIT DOFs are the dense float64 analyses; above it (or
with "banded": true) the banded tier: kernels 1-3 on a card.  A transient
is dense Newmark, or central difference on the banded tier (kernel 1 a
step); with "plasticity" the explicit elastoplastic transient
(solvers/continuum_transient_plastic).  Buckling, harmonic, plastic,
spectrum, random (io/_common's continuum runners) and reduction are dense,
refused above 8192 DOFs; "identification" recovers Young's modulus from
measured displacements on the banded adjoint
(io/identification_io.run_young_identification); "reliability" is FORM
on the dense traced statics (io/_common.run_continuum_reliability),
refused above 8192 DOFs.  A solid has no "sizing" analysis, as in the JAX
package.  Every analysis runs on the caller's device ("cuda" when None).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.solid import (SolidProblem, boundary_quads, box_mesh,
                            solid_modal, solve_solid_static,
                            solve_solid_static_banded,
                            solve_solid_transient, surface_load)

_FACE_NAMES = {"x_min": (0, -1), "x_max": (0, +1),
               "y_min": (1, -1), "y_max": (1, +1),
               "z_min": (2, -1), "z_max": (2, +1)}
# The dense analyses' DOF budget (the JAX package's 4 * 2048).
_DENSE_BUDGET = 4 * 2048


def is_solid_document(doc: Dict) -> bool:
    return isinstance(doc, dict) and doc.get("element_type") == "solid"


def _named_face_nodes(nodes: np.ndarray, name):
    """Node ids on a named boundary plane (or an id list verbatim)."""
    if not isinstance(name, str):
        return np.asarray(name, dtype=int).reshape(-1)
    if name not in _FACE_NAMES:
        raise ValueError(f"named face must be one of "
                         f"{sorted(_FACE_NAMES)}, got {name!r}")
    axis, side = _FACE_NAMES[name]
    coord = nodes[:, axis]
    target = coord.min() if side < 0 else coord.max()
    span = max(float(coord.max() - coord.min()), 1.0)
    return np.flatnonzero(np.abs(coord - target) <= 1e-9 * span)


def parse_solid_document(doc: Dict) -> Tuple[SolidProblem, Dict]:
    mesh = doc.get("mesh")
    if mesh is not None:
        if mesh.get("type", "box") != "box":
            raise ValueError('solid mesh.type must be "box"')
        nodes, elements = box_mesh(
            float(mesh["lx"]), float(mesh["ly"]), float(mesh["lz"]),
            int(mesh["nx"]), int(mesh["ny"]), int(mesh["nz"]))
    else:
        if "nodes" not in doc or "elements" not in doc:
            raise ValueError('solid document needs "nodes" + '
                             '"elements" or a "mesh" spec')
        nodes = np.asarray(doc["nodes"], dtype=float)
        elements = np.asarray(doc["elements"], dtype=int)
    mat = doc.get("material", {})
    if mat.get("poisson") is None:
        raise ValueError('solid material needs "poisson"')
    nnode = nodes.shape[0]
    loads = np.asarray(doc.get("loads", np.zeros(3 * nnode)),
                       dtype=float).reshape(-1)

    fixed_parts = []
    if "fixed_dofs" in doc:
        fixed_parts.append(np.asarray(doc["fixed_dofs"], dtype=int))
    if "fixed_nodes" in doc:
        fn = _named_face_nodes(nodes, doc["fixed_nodes"])
        fixed_parts.append((3 * fn[:, None] + np.arange(3)).reshape(-1))
    for key, comp in (("fixed_x_nodes", 0), ("fixed_y_nodes", 1),
                      ("fixed_z_nodes", 2)):
        if key in doc:
            fixed_parts.append(3 * _named_face_nodes(nodes, doc[key]) + comp)
    prescribed_pairs = doc.get("prescribed")
    if prescribed_pairs is not None:
        arr = np.asarray(prescribed_pairs, dtype=float)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError('prescribed must be [[dof, value], ..]')
        fixed_parts.append(arr[:, 0].astype(int))
    if not fixed_parts:
        raise ValueError('solid document needs supports: '
                         '"fixed_nodes", "fixed_dofs", '
                         '"fixed_*_nodes" or "prescribed"')
    fixed = np.unique(np.concatenate(fixed_parts))
    prescribed = None
    if prescribed_pairs is not None:
        arr = np.asarray(prescribed_pairs, dtype=float)
        prescribed = np.zeros(fixed.size)
        prescribed[np.searchsorted(fixed, arr[:, 0].astype(int))] = arr[:, 1]

    pm = doc.get("point_masses")
    if pm is not None:
        arr = np.asarray(pm, dtype=float)
        if arr.ndim == 2:
            pm = np.zeros(nnode)
            for node, mass in arr:
                pm[int(node)] += float(mass)
        else:
            pm = arr

    from .plane_io import _thermal_block

    alpha, temperature = _thermal_block(doc, mat)
    problem = SolidProblem(
        nodes=nodes, elements=elements,
        young=mat.get("young", 1.0), poisson=mat["poisson"],
        density=mat.get("density", 1.0), loads=loads, fixed_dofs=fixed,
        prescribed=prescribed, body_force=doc.get("body_force"),
        point_masses=pm, alpha_cte=alpha, temperature=temperature)

    # Surface loads resolve after the problem exists (named faces need
    # the element boundary quads).
    for spec in doc.get("surface_loads", []):
        if "face" not in spec or "traction" not in spec:
            raise ValueError('surface_loads entries need "face" (a '
                             'named plane or explicit quads) and '
                             '"traction" [tx, ty, tz]')
        face = spec["face"]
        if isinstance(face, str):
            if face not in _FACE_NAMES:
                raise ValueError(f"named face must be one of "
                                 f"{sorted(_FACE_NAMES)}, got {face!r}")
            quads = boundary_quads(problem, *_FACE_NAMES[face])
        else:
            quads = np.asarray(face, dtype=int)
        problem.loads = problem.loads + surface_load(
            nodes, quads, spec["traction"], ndof=3 * nnode)
    return problem, dict(doc.get("analysis") or {"type": "static"})


def _probe_dofs(analysis: Dict, problem: SolidProblem):
    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        pn = _named_face_nodes(problem.nodes, analysis["probe_nodes"])
        probe = (3 * pn[:, None] + np.arange(3)).reshape(-1)
    return probe


def _banded(analysis: Dict, problem: SolidProblem) -> bool:
    from ..solvers.newton import DENSE_DOF_LIMIT

    banded = analysis.get("banded")
    return problem.ndof > DENSE_DOF_LIMIT if banded is None else banded


def _budget(problem: SolidProblem, what: str, why: str = "") -> None:
    """The JAX package's 8192-DOF refusal of a dense analysis."""
    if problem.ndof > _DENSE_BUDGET:
        raise ValueError(f"solid {what}; {problem.ndof} DOFs exceeds its "
                         f"8192-DOF budget{why} — coarsen the mesh")


def _static(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ._common import _SHAPES_JSON_DOF_LIMIT, _json_finite

    banded = _banded(analysis, problem)
    if banded:
        res, iters, rel = solve_solid_static_banded(
            problem, tol=float(analysis.get("tolerance", 1e-7)),
            max_iter=int(analysis.get("max_iter", 50000)), device=device)
    else:
        res = solve_solid_static(problem, device=device)
    out = {
        "success": True,
        "analysis": "static",
        "element_type": "solid",
        "method": "banded" if banded else "dense",
        "max_displacement": float(np.abs(res.displacements).max()),
        "max_von_mises": float(res.von_mises.max()),
    }
    if banded:
        out["iterations"] = iters
        out["relative_residual"] = rel
    # Full fields only below the JSON size limit unless asked for.
    if analysis.get("include_fields",
                    problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["displacements"] = res.displacements.tolist()
        out["stresses"] = res.stresses.tolist()
        out["von_mises"] = res.von_mises.tolist()
        out["principal"] = res.principal.tolist()
        out["reactions"] = res.reactions.tolist()
    return _json_finite(out)


def _modal(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ._common import _SHAPES_JSON_DOF_LIMIT

    n_modes = int(analysis.get("n_modes", 6))
    banded = _banded(analysis, problem)
    pres = None
    if analysis.get("prestress") is not None:
        if banded:
            raise ValueError("prestressed solid modal runs on the dense "
                             "host tier; drop banded")
        from ._common import _continuum_prestress_u

        pres = _continuum_prestress_u(
            problem, analysis["prestress"],
            lambda pp: solve_solid_static(pp, device=device).displacements)
    if banded:
        from ..models.solid import solid_modal_banded

        res = solid_modal_banded(
            problem, n_modes=n_modes, n_iter=int(analysis.get("n_iter", 30)),
            cg_tol=float(analysis.get("cg_tol", 1e-7)), device=device)
    else:
        res = solid_modal(problem, n_modes=n_modes, prestress_u=pres,
                          device=device)
    out = {
        "success": True,
        "analysis": "modal",
        "element_type": "solid",
        "method": "banded" if banded else "dense",
        "prestressed": pres is not None,
        "frequencies_hz": res.frequencies_hz.tolist(),
        "omegas": res.omegas.tolist(),
        "eigenvalues": res.eigenvalues.tolist(),
    }
    if analysis.get("include_shapes", problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["mode_shapes"] = res.mode_shapes.tolist()
    return out


def _transient(problem: SolidProblem, analysis: Dict, device) -> Dict:
    if "plasticity" in analysis:
        from ..solvers.continuum_transient_plastic import \
            solve_solid_transient_plastic
        from ._common import run_continuum_transient_plastic

        if analysis.get("banded"):
            raise ValueError('"plasticity" carries committed '
                             'Gauss-point state through its own '
                             'scan — it does not compose with the '
                             'linear banded tier; drop "banded"')
        if analysis.get("n_steps") is None:
            raise ValueError('solid transient needs "n_steps"')
        return run_continuum_transient_plastic(
            problem, analysis, "solid", solve_solid_transient_plastic,
            _probe_dofs(analysis, problem), device)
    if "dt" not in analysis or "n_steps" not in analysis:
        raise ValueError('solid transient needs "dt" and "n_steps"')
    n_steps = int(analysis["n_steps"])
    damping = tuple(analysis.get("damping", (0.0, 0.0)))
    banded = _banded(analysis, problem)
    if analysis["dt"] == "auto":
        if not banded:
            raise ValueError('dt="auto" (Gershgorin critical step) '
                             'applies to the banded explicit tier; '
                             'the dense Newmark path is '
                             'unconditionally stable — give dt')
        from ..models.solid import solid_stable_dt

        dt = solid_stable_dt(problem, damping=damping, device=device)
    else:
        dt = float(analysis["dt"])
    amp = None
    if analysis.get("amplitude") is not None:
        from ._common import _amplitude_array

        amp = _amplitude_array(analysis["amplitude"], n_steps, dt)
    kw = dict(damping=damping, amplitude=amp,
              probe_dofs=_probe_dofs(analysis, problem),
              record_every=int(analysis.get("record_every", 1)),
              device=device)
    if banded:
        from ..models.solid import solve_solid_transient_banded

        res = solve_solid_transient_banded(problem, dt, n_steps, **kw)
    else:
        res = solve_solid_transient(problem, dt, n_steps, **kw)
    return {
        "success": True,
        "analysis": "transient",
        "element_type": "solid",
        "method": "central-banded" if banded else "newmark",
        "dt": res.dt,
        "n_steps": res.n_steps,
        "times": res.times.tolist(),
        "displacements": res.displacements.tolist(),
        "velocities": res.velocities.tolist(),
    }


def _buckling(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ..models.solid import solid_buckling

    _budget(problem, "buckling runs a dense symmetric pencil")
    res = solid_buckling(problem, n_modes=int(analysis.get("n_modes", 4)),
                         device=device)
    out = {
        "success": True,
        "analysis": "buckling",
        "element_type": "solid",
        "load_factors": res.load_factors.tolist(),
        "von_mises": res.von_mises.tolist(),
    }
    if analysis.get("include_shapes", True):
        out["buckling_modes"] = res.modes.tolist()
    return out


def _harmonic(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ..models.solid import solid_harmonic

    _budget(problem, "harmonic runs dense complex solves per frequency")
    om = analysis.get("omegas")
    if om is None:
        raise ValueError('solid harmonic needs "omegas"')
    if isinstance(om, dict):
        om = np.linspace(float(om["start"]), float(om["stop"]),
                         int(om.get("num", 50)))
    res = solid_harmonic(problem, om,
                         damping=analysis.get("damping", (0.0, 0.0)),
                         probe_dofs=_probe_dofs(analysis, problem),
                         device=device)
    return {
        "success": True,
        "analysis": "harmonic",
        "element_type": "solid",
        "omegas": res.omegas.tolist(),
        "amplitude": res.amplitude.tolist(),
    }


def _plastic(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ..solvers.solid_plasticity import solve_solid_plastic

    _budget(problem, "plastic runs dense Newton per load step",
            " (dense LU per iteration)")
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
    res = solve_solid_plastic(problem, device=device, **kwargs)
    probe = _probe_dofs(analysis, problem)
    if probe is None:
        probe = np.arange(problem.ndof)
    probe = np.asarray(probe, dtype=int).reshape(-1)
    out = {
        "success": bool(res.converged),
        "analysis": "plastic",
        "element_type": "solid",
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


def _reduction(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reduction

    if problem.ndof > _DENSE_BUDGET:
        raise ValueError(
            f"solid reduction condenses a dense (K, M) pair; "
            f"{problem.ndof} DOFs exceeds its 8192-DOF budget — "
            "condense a substructure, not the full large mesh")
    return run_continuum_reduction(problem, analysis, "solid", device)


def _spectrum(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_spectrum

    _budget(problem, "spectrum runs on the dense host modal/FRF tier")
    return run_continuum_spectrum(problem, analysis, "solid", device)


def _random(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_random

    _budget(problem, "random runs on the dense host modal/FRF tier")
    return run_continuum_random(problem, analysis, "solid",
                                _probe_dofs(analysis, problem), device)


def _resolve_zones(problem: SolidProblem, zones):
    """Zone specs -> element-id arrays: explicit id lists or centroid boxes
    {"x_min" .. "z_max"} (any subset)."""
    from .identification_io import centroid_zones

    return centroid_zones(problem, zones, problem.coords().mean(axis=1),
                          "xyz")


def _identification(problem: SolidProblem, analysis: Dict, device) -> Dict:
    """Young's modulus from measured displacements on the banded adjoint
    (always banded, as in the JAX package)."""
    from ..models.solid import identify_solid_young_banded
    from .identification_io import adam_options, run_young_identification

    def true_solve(true_young):
        p_true = SolidProblem(nodes=problem.nodes, elements=problem.elements,
                              young=true_young, poisson=problem.poisson,
                              density=problem.density, loads=problem.loads,
                              fixed_dofs=problem.fixed_dofs,
                              body_force=problem.body_force)
        tol = float(analysis.get("tolerance", 1e-7)) * 0.01
        return solve_solid_static_banded(p_true, tol=tol,
                                         device=device)[0].displacements

    def banded(a, zones):
        return identify_solid_young_banded(
            problem, a["measured_dofs"], a["measured_u"], zones=zones,
            device=device, **adam_options(a, True))

    return run_young_identification(
        problem, analysis, "solid", resolve_zones=_resolve_zones,
        probe_dofs=_probe_dofs, true_solve=true_solve,
        identify_banded=banded, finite=True)


def _reliability(problem: SolidProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reliability

    _budget(problem, "reliability runs dense traced solves per HL-RF "
            "iteration")
    return run_continuum_reliability(problem, analysis, "solid", device)


_RUNNERS = {
    "static": _static, "modal": _modal, "transient": _transient,
    "reduction": _reduction,
    "spectrum": _spectrum, "random": _random,
    "buckling": _buckling, "harmonic": _harmonic, "plastic": _plastic,
    "reliability": _reliability,
    "identification": _identification,
}


def run_solid_analysis(problem: SolidProblem, analysis: Dict,
                       device=None) -> Dict:
    """One analysis of a parsed solid document on `device` ("cuda" when
    None), with the JAX package's checks in its order."""
    kind = analysis.get("type", "static")
    if kind == "solid":
        # The backend's /api/fem/solid route sends type "solid" for a
        # document without an analysis block: statics.
        kind = "static"
    runner = _RUNNERS.get(kind)
    if runner is None:
        raise ValueError(f'solid analysis.type must be "static", "modal", '
                         f'"transient", "harmonic", "buckling", "plastic", '
                         f'"spectrum", "random", "reduction", '
                         f'"reliability" or "identification", got '
                         f'{kind!r}')
    return runner(problem, analysis, device)


def run_solid_document(doc: Dict, device=None) -> Dict:
    problem, analysis = parse_solid_document(doc)
    return run_solid_analysis(problem, analysis, device)
