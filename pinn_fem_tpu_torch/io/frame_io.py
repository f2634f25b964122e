"""JSON tier of the 2D frame family (counterpart of
pinn_fem_tpu/io/frame_io.py): documents with `"element_type": "frame"`.

    {"element_type": "frame",
     "nodes": [[x, y], ..], "elements": [[i, j], ..],
     "material": {"young", "area", "inertia", "density", "alpha",
                  "section_modulus"},      # scalars or per element
     "loads": [Fx0, Fy0, M0, Fx1, ..],     # 3 per node
     "fixed_nodes": [..] | "fixed_dofs": [..],
     "point_masses": [[node, m], ..] | [..per node..],
     "member_loads": [[elem, wx, wy], ..] | [[wx, wy] per element],
     "temperature": dT | [..], "temperature_gradient": g | [..],
     "analysis": {"type": "static" | "modal" | "buckling" | "transient"
                  | "harmonic" | "spectrum" | "random" | "reduction"
                  | "plastic", ..}}

Statics at or below DENSE_DOF_LIMIT DOFs is the dense float64 solve with
the full field and member forces in the result; above it the banded tier
("tier": "banded", kernels 1-3 on a card) with probes and summaries.
Modal is dense (with "prestress") up to the limit and banded above it.
Buckling, Newmark, harmonic, spectrum, random (io/_common's continuum
runners; fatigue on the governing extreme fiber), reduction and the
plastic-hinge pushover are dense float64; "identification" recovers a
per-member I (or E) profile from measured displacements
(models/frame.identify_frame_properties); "reliability" is FORM on the
dense traced statics (models/frame.frame_reliability) and "sizing" the
minimum-weight inertia profile under a deflection limit, deterministic or
RBDO with a "reliability" sub-block (optimize_frame_inertia,
optimize_frame_inertia_rbdo).  Every analysis runs on the caller's device
("cuda" when None).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models.frame import (FrameProblem, frame_buckling, frame_harmonic,
                            frame_modal, solve_frame_static,
                            solve_frame_transient)


def is_frame_document(doc: Dict) -> bool:
    return isinstance(doc, dict) and doc.get("element_type") == "frame"


def parse_frame_document(doc: Dict) -> Tuple[FrameProblem, Dict]:
    nodes = np.asarray(doc["nodes"], dtype=float)
    elements = np.asarray(doc["elements"], dtype=int)
    mat = doc.get("material", {})
    if mat.get("inertia") is None:
        raise ValueError('frame material needs "inertia" (second '
                         'moment I) — bending is the point')
    nnode = nodes.shape[0]
    loads = np.asarray(doc.get("loads", np.zeros(3 * nnode)), dtype=float)
    if "fixed_dofs" in doc:
        fixed = np.asarray(doc["fixed_dofs"], dtype=int)
    elif "fixed_nodes" in doc:
        fn = np.asarray(doc["fixed_nodes"], dtype=int).reshape(-1)
        fixed = np.concatenate([3 * fn, 3 * fn + 1, 3 * fn + 2])
    else:
        raise ValueError('frame document needs "fixed_nodes" or '
                         '"fixed_dofs"')
    ml = doc.get("member_loads")
    if ml is not None:
        arr = np.asarray(ml, dtype=float)
        if arr.ndim != 2:
            raise ValueError("member_loads must be a table")
        if arr.shape[1] == 3:                  # [[elem, wx, wy], ...]
            ml = np.zeros((elements.shape[0], 2))
            for e, wx, wy in arr:
                ml[int(e)] += (wx, wy)
        elif arr.shape[1] == 2:
            ml = arr
        else:
            raise ValueError("member_loads rows must be "
                             "[elem, wx, wy] or [wx, wy]")
    pm = doc.get("point_masses")
    if pm is not None:
        arr = np.asarray(pm, dtype=float)
        if arr.ndim == 2:                      # [[node, mass], ...]
            pm = np.zeros(nnode)
            for node, mass in arr:
                pm[int(node)] += float(mass)
        else:
            pm = arr
    from .plane_io import _thermal_block

    alpha, temperature = _thermal_block(doc, mat)
    problem = FrameProblem(
        nodes=nodes, elements=elements,
        young=mat.get("young", 1.0), area=mat.get("area", 1.0),
        inertia=mat["inertia"], density=mat.get("density", 1.0),
        loads=loads, fixed_dofs=np.sort(np.unique(fixed)),
        point_masses=pm, member_loads=ml,
        section_modulus=mat.get("section_modulus"),
        alpha_cte=alpha, temperature=temperature,
        temperature_gradient=doc.get("temperature_gradient"))
    return problem, dict(doc.get("analysis") or {"type": "static"})


def _node_dofs(analysis: Dict, per_node: int = 3):
    """probe_dofs, else the first `per_node` DOFs of each probe node, else
    None."""
    probe = analysis.get("probe_dofs")
    if probe is None and analysis.get("probe_nodes") is not None:
        pn = np.asarray(analysis["probe_nodes"], dtype=int).reshape(-1)
        probe = np.stack([3 * pn + d for d in range(per_node)],
                         axis=1).reshape(-1)
    return probe


def _large(problem: FrameProblem) -> bool:
    from ..solvers.newton import DENSE_DOF_LIMIT

    return problem.ndof > DENSE_DOF_LIMIT


def _static(problem: FrameProblem, analysis: Dict, device) -> Dict:
    if _large(problem):
        from ..models.frame import solve_frame_static_banded

        res, iterations, residual = solve_frame_static_banded(
            problem, tol=float(analysis.get("tolerance", 1e-7)),
            max_iter=int(analysis.get("max_iterations", 20000)),
            use_pallas=bool(analysis.get("use_pallas", False)),
            precond=analysis.get("precond", "auto"), device=device)
        u = res.displacements
        i_max = int(np.argmax(np.abs(u)))
        out = {
            "success": True,
            "analysis": "static",
            "element_type": "frame",
            "tier": "banded",
            "iterations": int(iterations),
            "relative_residual": float(residual),
            "max_abs_displacement": float(np.abs(u[i_max])),
            "max_abs_displacement_dof": i_max,
            "max_abs_axial": float(np.abs(res.axial).max()),
            "max_abs_moment": float(np.abs(res.moments).max()),
        }
        if res.max_stress is not None:
            out["max_stress"] = float(res.max_stress.max())
            out["max_stress_element"] = int(np.argmax(res.max_stress))
        probe = _node_dofs(analysis)
        if probe is not None:
            probe = np.asarray(probe, dtype=int).reshape(-1)
            out["probe_dofs"] = probe.tolist()
            out["displacements"] = u[probe].tolist()
        return out
    res = solve_frame_static(problem, device=device)
    return {
        "success": True,
        "analysis": "static",
        "element_type": "frame",
        "displacements": res.displacements.tolist(),
        "member_end_forces": res.member_end_forces.tolist(),
        "axial_forces": res.axial.tolist(),
        "end_moments": res.moments.tolist(),
        "reactions": res.reactions.tolist(),
        **({"max_stress": res.max_stress.tolist()}
           if res.max_stress is not None else {}),
    }


def _modal(problem: FrameProblem, analysis: Dict, device) -> Dict:
    if _large(problem):
        from ..models.frame import frame_modal_banded

        res = frame_modal_banded(
            problem, n_modes=int(analysis.get("n_modes", 4)),
            n_iter=int(analysis.get("n_iter", 30)),
            cg_tol=float(analysis.get("cg_tolerance", 1e-7)),
            device=device)
        out = {
            "success": True,
            "analysis": "modal",
            "element_type": "frame",
            "tier": "banded",
            "mass": "lumped",
            "frequencies_hz": res.frequencies_hz.tolist(),
            "omegas": res.omegas.tolist(),
            "eigenvalues": res.eigenvalues.tolist(),
        }
        # Full (n_modes, 3n) shapes would dwarf the payload at banded
        # sizes; the probe nodes' rows instead.
        pn = analysis.get("probe_nodes")
        if pn is not None:
            pn = np.asarray(pn, dtype=int).reshape(-1)
            dofs = np.stack([3 * pn, 3 * pn + 1, 3 * pn + 2],
                            axis=1).reshape(-1)
            out["probe_nodes"] = pn.tolist()
            out["mode_shapes"] = res.mode_shapes[:, dofs].tolist()
        return out
    pres = None
    if analysis.get("prestress") is not None:
        from ._common import _continuum_prestress_u

        pres = _continuum_prestress_u(
            problem, analysis["prestress"],
            lambda pp: solve_frame_static(pp, device=device).displacements)
    res = frame_modal(problem, n_modes=int(analysis.get("n_modes", 4)),
                      prestress_u=pres, device=device)
    out = {
        "success": True,
        "prestressed": pres is not None,
        "analysis": "modal",
        "element_type": "frame",
        "frequencies_hz": res.frequencies_hz.tolist(),
        "omegas": res.omegas.tolist(),
        "eigenvalues": res.eigenvalues.tolist(),
    }
    if analysis.get("include_shapes", True):
        out["mode_shapes"] = res.mode_shapes.tolist()
    return out


def _buckling(problem: FrameProblem, analysis: Dict, device) -> Dict:
    res = frame_buckling(problem, n_modes=int(analysis.get("n_modes", 2)),
                         device=device)
    out = {
        "success": True,
        "analysis": "buckling",
        "element_type": "frame",
        "load_factors": res.load_factors.tolist(),
        "axial_forces": res.axial.tolist(),
    }
    if analysis.get("include_shapes", True):
        out["buckling_modes"] = res.modes.tolist()
    return out


def _transient(problem: FrameProblem, analysis: Dict, device) -> Dict:
    if analysis.get("dt") is None or analysis.get("n_steps") is None:
        raise ValueError('frame transient needs "dt" and "n_steps"')
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
            raise ValueError('frame amplitude type must be '
                             '"step" or "sine" (or a list)')
    res = solve_frame_transient(
        problem, float(analysis["dt"]), n_steps,
        damping=analysis.get("damping", (0.0, 0.0)), amplitude=amp,
        probe_dofs=_node_dofs(analysis, 2),        # u, v per node
        record_every=int(analysis.get("record_every", 1)), device=device)
    return {
        "success": True,
        "analysis": "transient",
        "element_type": "frame",
        "times": res.times.tolist(),
        "displacements": res.displacements.tolist(),
        "dt": res.dt,
        "n_steps": res.n_steps,
    }


def _harmonic(problem: FrameProblem, analysis: Dict, device) -> Dict:
    om = analysis.get("omegas")
    if om is None:
        raise ValueError('frame harmonic needs "omegas"')
    if isinstance(om, dict):
        om = np.linspace(float(om["start"]), float(om["stop"]),
                         int(om.get("num", 50)))
    res = frame_harmonic(problem, om,
                         damping=analysis.get("damping", (0.0, 0.0)),
                         probe_dofs=_node_dofs(analysis, 2), device=device)
    return {
        "success": True,
        "analysis": "harmonic",
        "element_type": "frame",
        "omegas": res.omegas.tolist(),
        "amplitude": res.amplitude.tolist(),
    }


def _reduction(problem: FrameProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_reduction

    return run_continuum_reduction(problem, analysis, "frame", device)


def _plastic(problem: FrameProblem, analysis: Dict, device) -> Dict:
    """The plastic-hinge pushover: {"plastic_moment": Mp | [per member],
    "max_load_factor": cap, "probe_nodes" | "probe_dofs": [..],
    "max_hinges": n}."""
    from ..solvers.frame_plastic import frame_pushover

    mp_spec = analysis.get("plastic_moment")
    if mp_spec is None:
        raise ValueError('frame plastic needs "plastic_moment" '
                         "(the section's Mp, scalar or per-member)")
    cap = analysis.get("max_load_factor")
    res = frame_pushover(
        problem, mp_spec,
        max_load_factor=(None if cap is None else float(cap)),
        probe_dofs=_node_dofs(analysis),
        max_hinges=analysis.get("max_hinges"), device=device)
    return {
        "success": True,
        "analysis": "plastic",
        "element_type": "frame",
        "mechanism": bool(res.mechanism),
        "collapse_factor": (None if res.collapse_factor is None
                            else float(res.collapse_factor)),
        "hinges": [
            {"member": int(m), "end": int(e), "load_factor": float(f)}
            for m, e, f in zip(res.hinge_members, res.hinge_ends,
                               res.hinge_factors)],
        "load_factors": res.load_factors.tolist(),
        "displacements": res.displacements.tolist(),
        "end_moments": res.end_moments.tolist(),
        "axial_forces": res.axial.tolist(),
    }


def _spectrum(problem: FrameProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_spectrum

    return run_continuum_spectrum(problem, analysis, "frame", device)


def _random(problem: FrameProblem, analysis: Dict, device) -> Dict:
    from ._common import run_continuum_random

    return run_continuum_random(problem, analysis, "frame",
                                _node_dofs(analysis), device)


def _identification(problem: FrameProblem, analysis: Dict, device) -> Dict:
    """The bending inverse: "parameter" "inertia" recovers the per-member
    I profile at known E (bending sees only EI), "young" E at known A and
    I; "measured_dofs" + "measured_u", or "synthetic" twin data from the
    dense float64 statics."""
    import dataclasses

    from ..models.frame import identify_frame_properties
    from ._common import _json_finite

    param = analysis.get("parameter", "inertia")
    if param not in ("inertia", "young"):
        raise ValueError('frame identification "parameter" must '
                         'be "inertia" or "young"')
    synthetic = analysis.get("synthetic")
    true_vals = None
    if synthetic is not None:
        if "measured_u" in analysis:
            raise ValueError('give "measured_u" or "synthetic", '
                             'not both')
        md = analysis.get("measured_dofs")
        if md is None:
            raise ValueError('synthetic frame identification '
                             'needs "measured_dofs"')
        measured_dofs = np.asarray(md, dtype=int).reshape(-1)
        tv = synthetic.get(param)
        if tv is None:
            raise ValueError(f'synthetic frame identification '
                             f'needs "{param}" (the identified '
                             f'parameter) in the synthetic block')
        true_vals = (np.full(problem.nelm, float(tv)) if np.isscalar(tv)
                     else np.asarray(tv, dtype=float))
        p_true = dataclasses.replace(problem, **{param: true_vals})
        measured_u = solve_frame_static(
            p_true, device=device).displacements[measured_dofs]
        noise = float(synthetic.get("noise", 0.0))
        if noise:
            rng = np.random.default_rng(int(synthetic.get("seed", 0)))
            measured_u = measured_u + noise * np.max(
                np.abs(measured_u)) * rng.standard_normal(measured_u.shape)
        analysis = dict(analysis, measured_dofs=measured_dofs.tolist(),
                        measured_u=np.asarray(measured_u).tolist())
    if "measured_dofs" not in analysis or "measured_u" not in analysis:
        raise ValueError('frame identification needs '
                         '"measured_dofs" and "measured_u" (or '
                         '"synthetic" twin data)')
    vals, hist = identify_frame_properties(
        problem, analysis["measured_dofs"], analysis["measured_u"],
        param=param, n_iter=int(analysis.get("n_iter", 400)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        device=device)
    out = {
        "success": True,
        "analysis": "identification",
        "element_type": "frame",
        "parameter": param,
        param: vals.tolist(),
        "centroids": problem.nodes[problem.elements].mean(axis=1).tolist(),
        "loss_history": hist[:: max(1, hist.size // 200)].tolist(),
        "final_loss": float(hist[-1]) if hist.size else None,
    }
    if true_vals is not None:
        out["synthetic"] = True
        rel = np.abs(vals - true_vals) / np.abs(true_vals)
        out["max_rel_error"] = float(rel.max())
    return _json_finite(out)


def _reliability(problem: FrameProblem, analysis: Dict, device) -> Dict:
    from ..models.frame import frame_reliability
    from ._common import _json_finite

    res = frame_reliability(
        problem, analysis.get("variables"), analysis.get("limit_state"),
        n_iter=int(analysis.get("n_iter", 50)),
        mc_samples=int(analysis.get("validate_mc", 0)),
        mc_seed=int(analysis.get("seed", 0)),
        correlation=analysis.get("correlation"), device=device)
    worst = int(np.argmin(res.beta)) if res.beta.size else -1
    out = {
        "success": True,
        "analysis": "reliability",
        "element_type": "frame",
        "labels": res.labels,
        "variables": res.variables,
        "beta": [None if not np.isfinite(v) else float(v)
                 for v in res.beta],
        "pf": res.pf.tolist(),
        "alpha": res.alpha.tolist(),
        "converged": [bool(v) for v in res.converged],
        "critical_limit_state": worst,
        "beta_min": (None if worst < 0 or not np.isfinite(res.beta[worst])
                     else float(res.beta[worst])),
        "system_pf_bounds": [res.system_pf_lower, res.system_pf_upper],
        "system_pf_ditlevsen_bounds": [res.system_pf_ditlevsen_lower,
                                       res.system_pf_ditlevsen_upper],
    }
    if res.mc_pf is not None:
        out["mc"] = {"pf": res.mc_pf, "std_error": res.mc_std_error,
                     "n_samples": res.mc_n, "method": res.mc_method}
    return _json_finite(out)


def _sizing(problem: FrameProblem, analysis: Dict, device) -> Dict:
    """The minimum-weight inertia profile under a deflection limit,
    deterministic or RBDO (a "reliability" sub-block)."""
    from ..models.frame import (optimize_frame_inertia,
                                optimize_frame_inertia_rbdo)
    from ._common import _json_finite

    if analysis.get("displacement_limit") is None \
            or analysis.get("probe_dofs") is None:
        raise ValueError('frame sizing needs "displacement_limit" '
                         'and "probe_dofs"')
    rel = analysis.get("reliability")
    common = dict(
        weight_exponent=float(analysis.get("weight_exponent", 0.5)),
        min_inertia=float(analysis.get("min_inertia", 1e-8)),
        n_iter=int(analysis.get("n_iter", 300)),
        outer_rounds=int(analysis.get("outer_rounds", 4)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        device=device)
    limit = float(analysis["displacement_limit"])
    if rel is not None:
        # RBDO: downgrading it to the deterministic design would ship an
        # unmargined structure as if beta held.
        if rel.get("target_beta") is None or rel.get("variables") is None:
            raise ValueError('frame RBDO needs reliability '
                             '{"variables": [..], "target_beta": b}')
        i_e, weight, betas, hist = optimize_frame_inertia_rbdo(
            problem, rel["variables"], limit, analysis["probe_dofs"],
            float(rel["target_beta"]), **common)
        return _json_finite({
            "success": True, "analysis": "sizing", "element_type": "frame",
            "inertia": i_e.tolist(), "weight": weight,
            "displacement_limit": limit,
            "target_beta": float(rel["target_beta"]),
            "reliability_beta": betas.tolist(),
            "min_reliability_beta": float(np.min(betas)),
            "history": hist.tolist()})
    i_e, weight, hist = optimize_frame_inertia(
        problem, limit, analysis["probe_dofs"], **common)
    return {"success": True, "analysis": "sizing", "element_type": "frame",
            "inertia": i_e.tolist(), "weight": weight,
            "displacement_limit": limit, "history": hist.tolist()}


_RUNNERS = {"static": _static, "modal": _modal, "buckling": _buckling,
            "transient": _transient, "harmonic": _harmonic,
            "spectrum": _spectrum, "random": _random,
            "reduction": _reduction, "plastic": _plastic,
            "identification": _identification,
            "reliability": _reliability, "sizing": _sizing}


def run_frame_analysis(problem: FrameProblem, analysis: Dict,
                       device=None) -> Dict:
    """One analysis of a parsed frame document on `device` ("cuda" when
    None)."""
    kind = analysis.get("type", "static")
    if kind == "frame":
        # The backend's /api/fem/frame route sends type "frame" for a
        # document without an analysis block: statics.
        kind = "static"
    runner = _RUNNERS.get(kind)
    if runner is None:
        raise ValueError('frame analysis type must be "static", "modal", '
                         '"buckling", "transient", "harmonic", "spectrum", '
                         '"random", "reduction", "plastic", "reliability", '
                         '"sizing" or "identification"')
    return runner(problem, analysis, device)


def run_frame_document(doc: Dict, device=None) -> Dict:
    problem, analysis = parse_frame_document(doc)
    return run_frame_analysis(problem, analysis, device)
