"""Transient ("analysis": {"type": "transient"}) JSON runner (counterpart
of pinn_fem_tpu/io/transient_io.py).

Central-difference, Newmark or modal-superposition integration of the
document's truss (solvers/dynamics.py) with its amplitude, damping, prestress, moving-load
or base-excitation load and checkpoint specs, the ensemble of (B, n_steps)
"amplitudes" and the "include_stress_envelope" of a single run
(parallel/batched.solve_transient_batched), and the member-force
histories of "probe_elements" with their rainflow "fatigue" summary
(solvers/fatigue.py), and the elastoplastic central transient of a
"plasticity" spec (solvers/plasticity.solve_transient_plastic); the
result dict has the JAX package's keys.

    "plasticity": {"sigma_y": s | [..], "hardening": H_iso,
                   "kinematic_hardening": H_kin}   # central, amplitude only

    "probe_elements": [..],            # member forces N_e(t), recovered
                                       # from the recorded element DOFs
    "include_force_histories": bool,   # default: when the payload fits
    "fatigue": {"sn": {"exponent": m, "coefficient": C},
                "method": "rainflow"}  # needs probe_elements
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..solvers.dynamics import (base_excitation_force_fn,
                                moving_load_force_fn, solve_transient,
                                solve_transient_checkpointed, stable_dt)
from ._common import (_SHAPES_JSON_DOF_LIMIT, _amplitude_array,
                      _element_areas, _json_finite, _prestress_state,
                      _probe_dofs, _sn_params)


def _transient_fatigue(problem, fat: Dict, elm_sel, n_hist, times) -> Dict:
    """Rainflow / Miner damage per probed element from its force history:
    stress N_e(t) / A_e, ASTM E1049 rainflow cycles through the Basquin
    curve (solvers/fatigue.py)."""
    from ..solvers.fatigue import rainflow_damage

    m, c = _sn_params(fat)
    if fat.get("method", "rainflow") != "rainflow":
        raise ValueError('transient fatigue is time-domain: method must '
                         'be "rainflow" (spectral methods live on the '
                         'random block)')
    t = np.asarray(times, dtype=float)
    duration = float(t[-1] - t[0])
    if duration <= 0.0:
        raise ValueError("fatigue needs a transient spanning > 0 s")
    areas = _element_areas(problem, elm_sel)
    stress = np.asarray(n_hist, dtype=float) / areas[None, :]
    rates, counts = zip(*(rainflow_damage(stress[:, e], duration, m, c)
                          for e in range(stress.shape[1])))
    rates = np.asarray(rates, dtype=float)
    with np.errstate(divide="ignore"):
        life = np.where(rates > 0.0, 1.0 / np.maximum(rates, 1e-300),
                        np.inf)
    return {
        "method": "rainflow",
        "sn": {"exponent": m, "coefficient": c},
        "duration": duration,
        "probe_elements": elm_sel.tolist(),
        "stress_rms": np.std(stress, axis=0).tolist(),
        "cycle_count": list(counts),
        "damage_rate": rates.tolist(),
        "life_s": [None if not np.isfinite(v) else float(v) for v in life],
    }


def _element_force_histories(problem, disp, rec_probe, constants,
                             geometric_nonlinear: bool = False):
    """(n_rec, n_elm) member forces N_e(t) = (EA/L) g . u_e(t) from
    displacement records `disp` (n_rec, n_probe) of the sorted DOFs
    `rec_probe`, in float64 on the host; `constants` are the elements'
    (sel, EA/L, g, DOFs) rows (harmonic._element_frf_constants).  With
    geometric_nonlinear the Green-Lagrange term (EA/L) |du|^2 / (2 L) is
    added, the force the integrator applied."""
    from ..ops.host import _geometry

    elm_sel, s_sel, gvec_sel, dm_sel = constants
    u_e = np.asarray(disp, dtype=float)[:, np.searchsorted(rec_probe,
                                                           dm_sel)]
    n_hist = s_sel[None, :] * np.sum(gvec_sel[None] * u_e, axis=-1)
    if geometric_nonlinear:
        d = problem.dimension
        inv_len_sel = _geometry(problem)[2][elm_sel]
        du_rel = u_e[:, :, d:] - u_e[:, :, :d]
        n_hist = n_hist + 0.5 * s_sel[None, :] * inv_len_sel[None, :] \
            * np.sum(du_rel * du_rel, axis=-1)
    return n_hist


def _run_transient_ensemble(problem, analysis, dt, n_steps, method,
                            damping, record_every, probe, device) -> Dict:
    """(B, n_steps) amplitude histories as one batched integration
    (parallel/batched.solve_transient_batched): per-row probe records and
    whole-history per-element |stress| envelopes."""
    from ..parallel.batched import solve_transient_batched

    if method != "central":
        raise ValueError("ensemble transient supports method='central'")
    amps = np.asarray(analysis["amplitudes"], dtype=float)
    if amps.ndim != 2 or amps.shape[1] != n_steps:
        raise ValueError(f"amplitudes must be (B, n_steps={n_steps})")
    nonlinear = bool(analysis.get("geometric_nonlinear", False))
    out = solve_transient_batched(
        problem, dt, n_steps, amplitudes=amps,
        damping=(float(damping[0]), float(damping[1])),
        probe_dofs=np.asarray(probe), record_every=record_every,
        geometric_nonlinear=nonlinear, device=device)
    return {
        "success": True,
        "analysis": "transient",
        "ensemble": True,
        "geometric_nonlinear": nonlinear,
        "batch": int(amps.shape[0]),
        "dt": float(dt),
        "n_steps": n_steps,
        "record_every": record_every,
        "probe_dofs": np.asarray(probe).tolist(),
        "times": (dt * record_every
                  * np.arange(1, n_steps // record_every + 1)).tolist(),
        "displacements": out["displacements"].cpu().numpy().astype(
            float).tolist(),
        "max_stress": out["max_stress"].cpu().numpy().astype(
            float).tolist(),
    }


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


def _guard_history(analysis: Dict, probe, n_rec: int) -> None:
    """The JSON payload guard of the probe histories."""
    if (probe.size * n_rec > 4 * _SHAPES_JSON_DOF_LIMIT
            and "probe_dofs" not in analysis
            and "probe_nodes" not in analysis):
        raise ValueError(
            "transient history would serialize "
            f"{probe.size} DOFs x {n_rec} snapshots to "
            "JSON; give probe_nodes/probe_dofs (or a larger record_every) "
            "to bound the payload")


def _run_transient_plastic(problem, analysis: Dict, device=None) -> Dict:
    """A transient block with a "plasticity" spec on `device`: explicit
    central difference with the radial return committed every step.

    Plain amplitude contract only: the integrator carries committed
    internal state, so prestress K_g(u0), moving loads, checkpoint /
    resume, ensembles and linear member-force recovery (which would
    misreport a yielded member's force) are refused rather than returned
    wrong; the integrator reports its own |stress| envelope instead."""
    from ..solvers.plasticity import solve_transient_plastic

    spec = analysis["plasticity"]
    if not isinstance(spec, dict) or "sigma_y" not in spec:
        raise ValueError('transient "plasticity" spec must be a dict '
                         'with "sigma_y"')
    for key, why in (
            ("prestress", "initial-stress K_g"),
            ("load", "moving/base-acceleration loads"),
            ("checkpoint", "checkpoint/resume"),
            ("amplitudes", "ensemble mode"),
            ("probe_elements", "linear member-force recovery"),
            ("include_stress_envelope", "the linear batched envelope — "
                                        "stress_envelope is always "
                                        "reported"),
            ("geometric_nonlinear", "the Green-Lagrange kernel")):
        if analysis.get(key):
            raise ValueError(f'"plasticity" does not compose with '
                             f'"{key}" ({why})')
    if analysis.get("method", "central") != "central":
        raise ValueError('"plasticity" supports method="central" only '
                         "(explicit integration commits one radial "
                         "return per step)")
    n_steps = int(analysis["n_steps"])
    damping = analysis.get("damping", [0.0, 0.0])
    dt_spec = analysis.get("dt", "auto")
    if dt_spec == "auto":
        # The elastic damped bound: yielding only lowers the tangent.
        dt = stable_dt(problem, damping=(float(damping[0]),
                                         float(damping[1])), device=device)
    else:
        dt = float(dt_spec)
    record_every = int(analysis.get("record_every", 1))
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    probe = _probe_dofs(analysis, problem)
    _guard_history(analysis, probe, n_steps // record_every)
    amplitude = _amplitude_array(analysis.get("amplitude"), n_steps, dt)
    res = solve_transient_plastic(
        problem,
        sigma_y=spec["sigma_y"],
        hardening_iso=spec.get("hardening", 0.0),
        hardening_kin=spec.get("kinematic_hardening", 0.0),
        dt=dt, n_steps=n_steps, amplitude=amplitude,
        damping=(float(damping[0]), float(damping[1])),
        record_every=record_every, probe_dofs=probe, device=device)
    yielded = np.flatnonzero(res.final_alpha > 0.0)
    return _json_finite({
        "success": True,
        "analysis": "transient",
        "plastic": True,
        "method": "central",
        "dt": float(res.dt),
        "n_steps": n_steps,
        "record_every": record_every,
        "probe_dofs": probe.tolist(),
        "times": res.times.tolist(),
        "displacements": res.displacements.tolist(),
        "velocities": res.velocities.tolist(),
        "kinetic_energy": res.kinetic_energy.tolist(),
        "strain_energy": res.strain_energy.tolist(),
        "plastic_work": res.plastic_work.tolist(),
        "external_work": res.external_work.tolist(),
        "stress_envelope": res.stress_envelope.tolist(),
        "yielded_elements": yielded.tolist(),
        "final": {
            "displacements": res.final_displacement.tolist(),
            "plastic_strain": res.final_plastic_strain.tolist(),
            "accumulated_plastic_strain": res.final_alpha.tolist(),
        },
    })


def run_transient(problem, analysis: Dict, device=None) -> Dict:
    """Execute a transient analysis block on `device` ("cuda" when None);
    JSON-serializable result dict."""
    if "plasticity" in analysis:
        return _run_transient_plastic(problem, analysis, device)
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
    _guard_history(analysis, probe, n_steps // record_every)
    # Member-force histories: record the probed elements' DOFs beside
    # the user's probe and recover N_e(t) on the host afterwards.
    probe_elements = analysis.get("probe_elements")
    elm_sel = None
    rec_probe = probe
    if probe_elements is not None:
        from ..solvers.harmonic import _element_frf_constants

        elm_sel = np.asarray(probe_elements, dtype=int).reshape(-1)
        # The guard protects the JSON, not the compute: fatigue wants the
        # full-rate history, so "include_force_histories": false computes
        # damage on the full record and serializes only the summary.
        hist_fits = (elm_sel.size * (n_steps // record_every)
                     <= 4 * _SHAPES_JSON_DOF_LIMIT)
        include_hist = analysis.get("include_force_histories")
        if include_hist is None:
            include_hist = hist_fits
            if not hist_fits and "fatigue" not in analysis:
                raise ValueError(
                    f"member-force histories would serialize "
                    f"{elm_sel.size} elements x "
                    f"{n_steps // record_every} snapshots to JSON; "
                    "probe fewer elements, raise record_every, or add a "
                    '"fatigue" block (the summary serializes without '
                    "the histories)")
        else:
            include_hist = bool(include_hist)    # explicit is trusted
        if "amplitudes" in analysis:
            raise ValueError("probe_elements composes with single-run "
                             "transients; the ensemble path reports the "
                             "stress envelope instead "
                             "(include_stress_envelope)")
        constants = _element_frf_constants(problem, elm_sel)
        rec_probe = np.unique(np.concatenate([probe,
                                              constants[3].reshape(-1)]))
    force_fn = _transient_force_fn(problem, analysis, dt, device)
    checkpoint = analysis.get("checkpoint")
    if analysis.get("include_stress_envelope", False):
        # Validated before integrating: the batched envelope core carries
        # neither K_g(u0) nor a moving load, and a checkpointed response
        # holds only the resumed segments.
        if method != "central":
            raise ValueError("include_stress_envelope supports the "
                             "central method")
        if prestress_u is not None or force_fn is not None \
                or checkpoint is not None:
            raise ValueError("include_stress_envelope supports the plain "
                             "amplitude contract only (no prestress, "
                             "moving load or checkpointing — the batched "
                             "envelope core integrates K u under "
                             "amplitude * loads)")
    if "amplitudes" in analysis:         # ensemble mode
        if prestress_u is not None or force_fn is not None or checkpoint:
            raise ValueError("ensemble transient composes with "
                             "geometric_nonlinear only; run prestress/"
                             "moving-load/checkpoint cases unbatched")
        b = len(analysis["amplitudes"])
        if (b * probe.size * (n_steps // record_every)
                > 4 * _SHAPES_JSON_DOF_LIMIT):
            raise ValueError(
                f"ensemble history would serialize {b} x {probe.size} "
                f"DOFs x {n_steps // record_every} snapshots to JSON; "
                "reduce the batch, give probe_nodes/probe_dofs, or raise "
                "record_every")
        return _run_transient_ensemble(problem, analysis, dt, n_steps,
                                       method, damping, record_every, probe,
                                       device)
    amplitude = _amplitude_array(analysis.get("amplitude"), n_steps, dt)
    kw = dict(
        amplitude=amplitude,
        damping=(float(damping[0]), float(damping[1])),
        method=method, record_every=record_every, probe_dofs=rec_probe,
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
    }
    disp = np.asarray(res.displacements, dtype=float)
    velo = np.asarray(res.velocities, dtype=float)
    if probe_elements is None:
        out["displacements"] = disp.tolist()
        out["velocities"] = velo.tolist()
    else:
        # The solver recorded the union of the user's probe and the
        # elements' DOFs: slice the user's view back out, and recover the
        # member forces from the element columns.
        pos = np.searchsorted(rec_probe, probe)
        out["displacements"] = disp[:, pos].tolist()
        out["velocities"] = velo[:, pos].tolist()
        n_hist = _element_force_histories(
            problem, disp, rec_probe, constants,
            bool(analysis.get("geometric_nonlinear", False)))
        out["probe_elements"] = elm_sel.tolist()
        if include_hist:
            out["force_histories"] = n_hist.tolist()
        fat = analysis.get("fatigue")
        if fat is not None:
            out["fatigue"] = _transient_fatigue(problem, fat, elm_sel,
                                                n_hist, res.times)
    if analysis.get("include_stress_envelope", False):
        # Per-element |stress| envelope over every step (the design-check
        # quantity) by the batched core with B = 1.
        from ..parallel.batched import solve_transient_batched

        env = solve_transient_batched(
            problem, dt, n_steps, amplitudes=amplitude[None, :n_steps],
            damping=(float(damping[0]), float(damping[1])),
            probe_dofs=probe, record_every=record_every,
            geometric_nonlinear=bool(analysis.get("geometric_nonlinear",
                                                  False)),
            device=device)["max_stress"]
        out["max_stress"] = env[0].cpu().numpy().astype(float).tolist()
    if analysis.get("include_final",
                    problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["u_final"] = res.u_final.tolist()
    return out
