"""Transient ("analysis": {"type": "transient"}) JSON runner (counterpart
of pinn_fem_tpu/io/transient_io.py).

Central-difference or Newmark integration of the document's truss
(solvers/dynamics.py) with its amplitude, damping, prestress, moving-load
or base-excitation load and checkpoint specs; the result dict has the JAX
package's keys.  Not yet ported, and refused by name: "plasticity"
(solvers/plasticity.py) and "probe_elements" / "fatigue"
(solvers/harmonic.py, solvers/fatigue.py), ROADMAP item 17; the ensemble
"amplitudes" and "include_stress_envelope" (parallel/batched.py), ROADMAP
item 15.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..solvers.dynamics import (base_excitation_force_fn,
                                moving_load_force_fn, solve_transient,
                                solve_transient_checkpointed, stable_dt)
from ._common import (_SHAPES_JSON_DOF_LIMIT, _amplitude_array,
                      _prestress_state, _probe_dofs)

# Transient keys whose modules are not yet ported, by ROADMAP item.
_NOT_PORTED = (
    ("plasticity", "solvers/plasticity.py", 17),
    ("amplitudes", "the ensemble, parallel/batched.py", 15),
    ("include_stress_envelope", "parallel/batched.py", 15),
    ("probe_elements", "solvers/harmonic.py", 17),
    ("fatigue", "solvers/fatigue.py", 17),
)


def _refuse_unported(analysis: Dict) -> None:
    for key, module, item in _NOT_PORTED:
        if key in analysis and (key != "include_stress_envelope"
                                or analysis[key]):
            raise NotImplementedError(
                f'transient "{key}" ({module}) is not yet ported, ROADMAP '
                f"item {item}")


def _transient_force_fn(problem, analysis, dt, device=None):
    """Resolve a "load" spec to a force_fn:

        {"type": "moving", "path_nodes": [..], "speed": v,
         "magnitude": F, "component": 1}
        {"type": "base_acceleration", "history": [..] | {"type": ...},
         "direction": [1, 0], "scale": 1.0}

    (central method only; base acceleration solves in coordinates
    relative to the ground, f = -M iota a_g)."""
    spec = analysis.get("load")
    if spec is None:
        return None
    kind = spec.get("type") if isinstance(spec, dict) else None
    if kind not in ("moving", "base_acceleration"):
        raise ValueError('load spec must be {"type": "moving", ...} or '
                         '{"type": "base_acceleration", ...}')
    if "amplitude" in analysis or "amplitudes" in analysis:
        raise ValueError(f"a {kind} load replaces the amplitude "
                         "contract; give one or the other")
    if kind == "moving":
        return moving_load_force_fn(
            problem,
            path_nodes=np.asarray(spec["path_nodes"], dtype=int),
            speed=float(spec["speed"]),
            magnitude=float(spec["magnitude"]),
            dt=float(dt),
            component=int(spec.get("component",
                                   1 if problem.dimension > 1 else 0)),
            device=device)
    history = _amplitude_array(spec.get("history"),
                               int(analysis["n_steps"]), float(dt))
    history = float(spec.get("scale", 1.0)) * history
    return base_excitation_force_fn(
        problem, history, direction=spec.get("direction"), device=device)


def run_transient(problem, analysis: Dict, device=None) -> Dict:
    """Execute a transient analysis block on `device` ("cuda" when None);
    JSON-serializable result dict."""
    _refuse_unported(analysis)
    n_steps = int(analysis["n_steps"])
    method = analysis.get("method", "central")
    dt_spec = analysis.get("dt", "auto")
    damping = analysis.get("damping", [0.0, 0.0])
    # Prestress before the "auto" bound: tension raises omega_max.
    prestress_u = _prestress_state(problem, analysis.get("prestress"),
                                   device)
    if dt_spec == "auto":
        if method not in ("central",):
            raise ValueError('dt="auto" (Gershgorin critical step) is for '
                             'method="central"; give dt explicitly')
        dt = stable_dt(problem,
                       damping=(float(damping[0]), float(damping[1])),
                       prestress_u=prestress_u, device=device)
    else:
        dt = float(dt_spec)
    record_every = int(analysis.get("record_every", 1))
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    probe = _probe_dofs(analysis, problem)
    if (probe.size * (n_steps // record_every) > 4 * _SHAPES_JSON_DOF_LIMIT
            and "probe_dofs" not in analysis
            and "probe_nodes" not in analysis):
        raise ValueError(
            "transient history would serialize "
            f"{probe.size} DOFs x {n_steps // record_every} snapshots to "
            "JSON; give probe_nodes/probe_dofs (or a larger record_every) "
            "to bound the payload")
    force_fn = _transient_force_fn(problem, analysis, dt, device)
    checkpoint = analysis.get("checkpoint")
    amplitude = _amplitude_array(analysis.get("amplitude"), n_steps, dt)
    kw = dict(
        amplitude=amplitude,
        damping=(float(damping[0]), float(damping[1])),
        method=method, record_every=record_every, probe_dofs=probe,
        newmark_beta=float(analysis.get("newmark_beta", 0.25)),
        newmark_gamma=float(analysis.get("newmark_gamma", 0.5)),
        geometric_nonlinear=bool(analysis.get("geometric_nonlinear",
                                              False)),
        n_modes=int(analysis.get("n_modes", 32)),
        prestress_u=prestress_u,
        force_fn=force_fn,
        device=device,
    )
    if checkpoint is not None:
        # {"dir": path, "every": steps, "resume": true}: a rerun of the
        # same request continues from the last persisted segment.
        if not isinstance(checkpoint, dict) or "dir" not in checkpoint \
                or "every" not in checkpoint:
            raise ValueError('checkpoint spec must be {"dir": ..., '
                             '"every": ..., "resume": bool?}')
        res = solve_transient_checkpointed(
            problem, dt, n_steps,
            checkpoint_dir=checkpoint["dir"],
            checkpoint_every=int(checkpoint["every"]),
            resume=bool(checkpoint.get("resume", True)), **kw)
    else:
        res = solve_transient(problem, dt=dt, n_steps=n_steps, **kw)
    out = {
        "success": True,
        "analysis": "transient",
        "method": method,
        "dt": float(dt),
        "n_steps": n_steps,
        "record_every": record_every,
        "prestressed": prestress_u is not None,
        "load_type": (analysis["load"].get("type")
                      if force_fn is not None else None),
        "moving_load": (force_fn is not None
                        and analysis["load"].get("type") == "moving"),
        "checkpointed": checkpoint is not None,
        "probe_dofs": probe.tolist(),
        "times": res.times.tolist(),
        "kinetic_energy": res.kinetic_energy.tolist(),
        "strain_energy": res.strain_energy.tolist(),
        "displacements": np.asarray(res.displacements, dtype=float).tolist(),
        "velocities": np.asarray(res.velocities, dtype=float).tolist(),
    }
    if analysis.get("include_final",
                    problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["u_final"] = res.u_final.tolist()
    return out
