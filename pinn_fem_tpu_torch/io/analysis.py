"""Dispatch of a document's "analysis" block (counterpart of
pinn_fem_tpu/io/analysis.py).  "transient" (io/transient_io.py), "modal",
"buckling", "harmonic", "random", "spectrum", "continuation", "plastic",
"reduction", "identification" (io/identification_io.py), "sizing"
(io/sizing_io.py) and "reliability" (io/reliability_io.py) run: every
analysis type of the JAX package.

    "analysis": {"type": "modal", "n_modes": 6, "lumped": true,
                 "n_iter": 25, "include_shapes": true,
                 "prestress": true | {"loads": [..], "scale": s}
                            | {"u": [..]},    # initial-stress K_g(u0)
                 "damping_calibration": {"zeta": z | [z1, z2],
                                         "modes": [1, n]},
                 "compare_shapes": [[..ndof..], ..]}   # MAC rows

    "analysis": {"type": "buckling", "n_modes": 4, "include_shapes": true}

    "analysis": {"type": "harmonic", "damping": [alpha, beta],
                 "method": "direct" | "modal", "n_modes": 12,
                 "omegas": [..] | {"start": w0, "stop": w1, "num": 100,
                                   "spacing": "linear" | "log"},
                 "prestress": .., "residual_tol": 1e-3,
                 "probe_nodes": [..] | "probe_dofs": [..],
                 "probe_elements": [..]}      # member-force FRFs

    "analysis": {"type": "random", "psd": S0 | {"omegas": [..],
                                                "values": [..]},
                 "omegas": {..}, "damping": [alpha, beta],
                 "method": .., "n_modes": .., "prestress": ..,
                 "probe_nodes": [..], "probe_elements": [..],
                 "first_passage": {"barrier": b | [..], "duration": T,
                                   "two_sided": true},  # Rice / Poisson
                 "fatigue": {"sn": {"exponent": m, "coefficient": C},
                             "method": "dirlik" | "narrowband",
                             "duration": T}}  # spectral fatigue

    "analysis": {"type": "spectrum", "sa": 2.5 | {"omegas": [..],
                                                  "values": [..]}
                     | {"history": <amplitude contract>, "dt": 0.01,
                        "n_steps": 4000, "scale": 1.0,
                        "damping_ratio": 0.05, "curve_omegas": [..]},
                 "direction": [1, 0] | "directions": [[1, 0], [0, 1]],
                 "directional_rule": "srss" | "100-30", "n_modes": 6,
                 "combination": "srss" | "cqc", "damping_ratio": 0.05,
                 "prestress": ..}

    "analysis": {"type": "continuation", "n_steps": 200,
                 "initial_dlambda": 0.02, "tolerance": 1e-8,
                 "stop_lambda_abs": 0.5, "probe_nodes": [..]}  # Riks

    "analysis": {"type": "plastic", "sigma_y": s | [..],
                 "hardening": H_iso, "kinematic_hardening": H_kin,
                 "load_factors": [..] | {"target": 1.0, "n_steps": 20},
                 "tolerance": 1e-9, "max_iterations": 30,
                 "probe_nodes": [..], "include_history": bool}

    "analysis": {"type": "reduction", "method": "guyan" | "craig_bampton",
                 "master_nodes": [..] | "master_dofs": [..],
                 "n_modes": 4, "compare_full": true,
                 "compare_modes": 6, "include_matrices": bool}

Every runner takes `device` ("cuda" when None), as run_analysis does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ._common import (_SHAPES_JSON_DOF_LIMIT, _element_areas,
                      _history_record, _json_finite, _omega_array,
                      _prestress_state, _probe_dofs, _sa_callable,
                      _sn_params)


def run_modal(problem, analysis: Dict, device=None) -> Dict:
    """A modal analysis block on `device`; a JSON-serializable dict."""
    from ..solvers.modal import mac, modal_analysis, rayleigh_coefficients

    # Clamp to the free-DOF count (UIs ask for a fixed mode count that
    # small models cannot supply).
    n_modes = min(int(analysis.get("n_modes", 6)),
                  problem.free_fixed()[0].size)
    lumped = bool(analysis.get("lumped", True))
    prestress_u = _prestress_state(problem, analysis.get("prestress"),
                                   device)
    res = modal_analysis(problem, n_modes=n_modes, lumped=lumped,
                         n_iter=int(analysis.get("n_iter", 25)),
                         prestress_u=prestress_u, device=device)
    out = {
        "success": True,
        "analysis": "modal",
        "n_modes": n_modes,
        "lumped": lumped,
        "prestressed": prestress_u is not None,
        # False: float32 could not resolve these modes (solvers/modal.py)
        # — consumers must not trust the frequencies.
        "ok": bool(res.ok),
        "eigenvalues": res.eigenvalues.tolist(),
        "omegas": res.omegas.tolist(),
        "frequencies_hz": res.frequencies.tolist(),
        "residuals": res.residuals.tolist(),
    }
    if analysis.get("include_shapes", problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["mode_shapes"] = res.shapes.T.tolist()     # (n_modes, ndof)
    cal = analysis.get("damping_calibration")
    if cal is not None:
        # Rayleigh (alpha, beta) from target damping ratios at two of the
        # computed modes: {"zeta": z} for one ratio, {"zeta": [z1, z2],
        # "modes": [1, 4]} per mode.
        zeta = cal.get("zeta", 0.05)
        if isinstance(zeta, (list, tuple)):
            if len(zeta) != 2:
                raise ValueError("damping_calibration.zeta must be a "
                                 "number or a [zeta_1, zeta_2] pair")
            z1, z2 = float(zeta[0]), float(zeta[1])
        else:
            z1 = z2 = float(zeta)
        modes = cal.get("modes", [1, n_modes])
        if (not isinstance(modes, (list, tuple)) or len(modes) != 2
                or any(int(m) != m for m in modes)):
            raise ValueError("damping_calibration.modes must be two "
                             "integer 1-based mode indices")
        m1, m2 = int(modes[0]), int(modes[1])
        if not (1 <= m1 < m2 <= n_modes):
            raise ValueError("damping_calibration.modes must be two "
                             f"distinct 1-based indices within the "
                             f"{n_modes} computed modes")
        w1, w2 = float(res.omegas[m1 - 1]), float(res.omegas[m2 - 1])
        alpha, beta = rayleigh_coefficients(w1, z1, w2, z2)
        out["rayleigh_damping"] = {
            "alpha": alpha, "beta": beta,
            "calibrated_at": {"omegas": [w1, w2], "zeta": [z1, z2]},
        }
    ref_shapes = analysis.get("compare_shapes")
    if ref_shapes is not None:
        # Test-vs-model shape correlation: the MAC matrix between the
        # computed shapes and supplied (n_ref, ndof) rows.
        ref = np.asarray(ref_shapes, dtype=float)
        if ref.ndim != 2 or ref.shape[1] != problem.ndof:
            raise ValueError(f"compare_shapes must be (n_ref, "
                             f"{problem.ndof}) rows")
        out["mac"] = mac(res.shapes, ref.T).tolist()
    return out


def run_buckling(problem, analysis: Dict, device=None) -> Dict:
    """A linearized-buckling block on `device`: the problem's loads define
    the base pattern and load_factors scale it (solvers/buckling.py)."""
    from ..solvers.buckling import buckling_analysis

    res = buckling_analysis(problem, n_modes=int(analysis.get("n_modes", 4)),
                            device=device)
    lam = [None if not np.isfinite(v) else float(v)
           for v in res.load_factors]    # inf -> null in JSON
    out = {
        "success": True,
        "analysis": "buckling",
        "n_modes": len(lam),
        # False: the banded float32 path could not converge the Ritz
        # values — consumers must not trust the factors.
        "ok": bool(res.ok),
        "load_factors": lam,
        "axial_forces": res.axial_forces.tolist(),
        "u_base": res.u_base.tolist(),
    }
    if analysis.get("include_shapes", problem.ndof <= _SHAPES_JSON_DOF_LIMIT):
        out["buckling_modes"] = res.modes.T.tolist()
    return out


def _probe_elements(analysis: Dict, omegas, what: str):
    """The block's probe_elements as an int array (None when absent),
    with the JSON payload guard of the member-force quantities."""
    elms = analysis.get("probe_elements")
    if elms is None:
        return None
    elms = np.asarray(elms, dtype=int)
    if elms.size * omegas.size > 4 * _SHAPES_JSON_DOF_LIMIT:
        raise ValueError(
            f"member-force {what} would serialize {elms.size} elements x "
            f"{omegas.size} frequencies to JSON; probe fewer elements")
    return elms


def _guard_probe(analysis: Dict, probe, omegas, head: str) -> None:
    """The JSON payload guard of the probe-DOF quantities; `head` opens
    the message."""
    if (probe.size * omegas.size > 4 * _SHAPES_JSON_DOF_LIMIT
            and "probe_dofs" not in analysis
            and "probe_nodes" not in analysis):
        raise ValueError(
            f"{head} {probe.size} DOFs x {omegas.size} "
            "frequencies to JSON; give probe_nodes/probe_dofs to bound "
            "the payload")


def run_harmonic(problem, analysis: Dict, device=None) -> Dict:
    """A harmonic (frequency-response) block on `device`."""
    from ..solvers.harmonic import harmonic_response

    omegas = _omega_array(analysis["omegas"])
    damping = analysis.get("damping", [0.0, 0.0])
    method = analysis.get("method", "direct")
    probe = _probe_dofs(analysis, problem)
    _guard_probe(analysis, probe, omegas,
                 "harmonic response would serialize 4 x")
    prestress_u = _prestress_state(problem, analysis.get("prestress"),
                                   device)
    probe_elements = _probe_elements(analysis, omegas, "FRFs")
    residual_tol = float(analysis.get("residual_tol", 1e-3))
    res = harmonic_response(
        problem, omegas, damping=(float(damping[0]), float(damping[1])),
        method=method, n_modes=int(analysis.get("n_modes", 12)),
        probe_dofs=probe, probe_elements=probe_elements,
        prestress_u=prestress_u, residual_tol=residual_tol, device=device)
    flagged = np.flatnonzero(res.flagged)
    out = {
        "success": True,
        "analysis": "harmonic",
        "method": method,
        "prestressed": prestress_u is not None,
        "omegas": res.omegas.tolist(),
        "probe_dofs": probe.tolist(),
        "real": res.real.tolist(),
        "imag": res.imag.tolist(),
        "amplitude": res.amplitude.tolist(),
        "phase": res.phase.tolist(),
        # Honesty guard: the per-frequency relative residual of the
        # returned solution and the points above residual_tol.
        "residual": res.residual.tolist(),
        "flagged_indices": flagged.tolist(),
        "flagged_omegas": res.omegas[flagged].tolist(),
        "residual_tol": residual_tol,
    }
    if probe_elements is not None:
        out["probe_elements"] = probe_elements.tolist()
        out["force_real"] = res.force_real.tolist()
        out["force_imag"] = res.force_imag.tolist()
        out["force_amplitude"] = res.force_amplitude.tolist()
    return out


def run_random(problem, analysis: Dict, device=None) -> Dict:
    """A random-vibration block on `device` (solvers/random_response.py),
    with its first-passage and spectral-fatigue summaries
    (solvers/fatigue.py)."""
    from ..solvers.fatigue import (first_passage_probability,
                                   spectral_fatigue)
    from ..solvers.random_response import random_response

    omegas = _omega_array(analysis["omegas"])
    damping = analysis.get("damping", [0.0, 0.0])
    probe = _probe_dofs(analysis, problem)
    _guard_probe(analysis, probe, omegas,
                 "random-response PSDs would serialize")
    psd_spec = analysis.get("psd", 1.0)
    if isinstance(psd_spec, dict):
        om_tab = np.asarray(psd_spec["omegas"], dtype=float)
        val_tab = np.asarray(psd_spec["values"], dtype=float)

        def load_psd(om):
            return np.interp(om, om_tab, val_tab)
    else:
        load_psd = float(psd_spec)
    prestress_u = _prestress_state(problem, analysis.get("prestress"),
                                   device)
    probe_elements = _probe_elements(analysis, omegas, "PSDs")
    res = random_response(
        problem, load_psd, omegas,
        damping=(float(damping[0]), float(damping[1])),
        method=analysis.get("method", "direct"),
        n_modes=int(analysis.get("n_modes", 12)),
        probe_dofs=probe, probe_elements=probe_elements,
        prestress_u=prestress_u, device=device)
    out = {
        "success": True,
        "analysis": "random",
        "prestressed": prestress_u is not None,
        "omegas": res.omegas.tolist(),
        "probe_dofs": probe.tolist(),
        "psd": res.psd.tolist(),
        "rms": res.rms.tolist(),
    }
    if probe_elements is not None:
        out["probe_elements"] = probe_elements.tolist()
        out["force_psd"] = res.force_psd.tolist()
        out["force_rms"] = res.force_rms.tolist()
    fp = analysis.get("first_passage")
    if fp is not None:
        # Barrier crossing of the probe-DOF displacements: Rice rate and
        # the Poisson approximation.
        if fp.get("barrier") is None or fp.get("duration") is None:
            raise ValueError('first_passage needs "barrier" and '
                             '"duration"')
        two_sided = bool(fp.get("two_sided", True))
        nu_b, pf_fp = first_passage_probability(
            res.omegas, np.asarray(res.psd, dtype=float), fp["barrier"],
            float(fp["duration"]), two_sided=two_sided)
        out["first_passage"] = {
            "barrier": np.broadcast_to(
                np.asarray(fp["barrier"], dtype=float),
                np.atleast_1d(nu_b).shape).tolist(),
            "duration": float(fp["duration"]),
            "two_sided": two_sided,
            "crossing_rate_hz": np.atleast_1d(nu_b).tolist(),
            "pf": np.atleast_1d(pf_fp).tolist(),
        }
    fat = analysis.get("fatigue")
    if fat is not None:
        # Stress PSDs S_sigma = S_N / A^2 through Dirlik (default) or the
        # narrow-band bound; without "sn" the summary is statistics only.
        if probe_elements is None:
            raise ValueError("random-block fatigue needs probe_elements "
                             "(damage is computed from member-STRESS "
                             "PSDs)")
        m = c = None
        if fat.get("sn") is not None:
            m, c = _sn_params(fat)
        duration = fat.get("duration")
        areas = _element_areas(problem, probe_elements)
        stress_psd = (np.asarray(res.force_psd, dtype=float)
                      / (areas ** 2)[None, :])
        sf = spectral_fatigue(
            res.omegas, stress_psd, m, c,
            method=fat.get("method", "dirlik"),
            duration=None if duration is None else float(duration))
        out["fatigue"] = {
            "method": sf.method,
            "probe_elements": probe_elements.tolist(),
            "stress_rms": sf.rms.tolist(),
            "nu0_hz": sf.nu0.tolist(),
            "nu_peak_hz": sf.nu_peak.tolist(),
            "alpha2": sf.alpha2.tolist(),
        }
        if m is not None:
            out["fatigue"]["sn"] = {"exponent": m, "coefficient": c}
            out["fatigue"]["damage_rate"] = sf.damage_rate.tolist()
            out["fatigue"]["life_s"] = [
                None if not np.isfinite(v) else float(v) for v in sf.life]
        if duration is not None:
            out["fatigue"]["duration"] = float(duration)
            out["fatigue"]["peak_factor"] = sf.peak_factor.tolist()
            out["fatigue"]["expected_peak_stress"] = \
                sf.expected_peak.tolist()
    return out


def run_spectrum(problem, analysis: Dict, device=None) -> Dict:
    """A response-spectrum block on `device` (solvers/spectrum.py).  The
    "history" form of Sa generates the spectrum from the record and
    evaluates it exactly at the modal frequencies."""
    from ..solvers.spectrum import (directional_combination,
                                    response_spectrum, spectrum_from_history)

    sa = analysis.get("sa", 1.0)
    history = isinstance(sa, dict) and "history" in sa
    spectrum = _sa_callable(analysis)
    prestress_u = _prestress_state(problem, analysis.get("prestress"),
                                   device)
    kw = dict(n_modes=int(analysis.get("n_modes", 6)),
              combination=analysis.get("combination", "srss"),
              damping_ratio=float(analysis.get("damping_ratio", 0.05)),
              prestress_u=prestress_u, device=device)
    if "directions" in analysis:
        # SRSS over orthogonal components or the 100-30 rule, per
        # response quantity.
        if "direction" in analysis:
            raise ValueError('give "direction" (single) or '
                             '"directions" (combined), not both')
        mres = directional_combination(
            problem, spectrum, analysis["directions"],
            rule=analysis.get("directional_rule", "srss"), **kw)
        first = mres.per_direction[0]
        return {
            "success": True,
            "analysis": "spectrum",
            "prestressed": prestress_u is not None,
            "combination": first.combination,
            "directional_rule": mres.rule,
            "modal_ok": bool(mres.modal_ok),
            "omegas": first.omegas.tolist(),
            "displacements": mres.displacements.tolist(),
            "axial_forces": mres.axial_forces.tolist(),
            "per_direction": [
                {"direction": list(map(float, np.asarray(d).reshape(-1))),
                 "participation": r.participation.tolist(),
                 "effective_mass": r.effective_mass.tolist(),
                 "mass_fraction": r.mass_fraction}
                for d, r in zip(analysis["directions"],
                                mres.per_direction)],
            **({"sa_at_modes": np.asarray(
                spectrum(first.omegas), dtype=float).tolist()}
               if callable(spectrum) else {}),
        }
    res = response_spectrum(problem, spectrum,
                            direction=analysis.get("direction"), **kw)
    out = {
        "success": True,
        "analysis": "spectrum",
        "prestressed": prestress_u is not None,
        "combination": res.combination,
        "modal_ok": bool(res.modal_ok),
        "omegas": res.omegas.tolist(),
        "participation": res.participation.tolist(),
        "effective_mass": res.effective_mass.tolist(),
        "mass_fraction": res.mass_fraction,
        "displacements": res.displacements.tolist(),
        # Modal member forces combined directly, per response quantity.
        "axial_forces": res.axial_forces.tolist(),
    }
    if callable(spectrum):
        out["sa_at_modes"] = np.asarray(spectrum(res.omegas),
                                        dtype=float).tolist()
    if history:
        out["sa_source"] = "history"
        if sa.get("curve_omegas") is not None:
            accel, dt_h, zeta_g = _history_record(analysis)
            om_c = _omega_array(sa["curve_omegas"])
            curve = spectrum_from_history(accel, dt_h, om_c, zeta_g)
            out["spectrum_curve"] = {
                "omegas": om_c.tolist(),
                "sd": curve.sd.tolist(),
                "psv": curve.psv.tolist(),
                "psa": curve.psa.tolist(),
                "sa_abs": curve.sa_abs.tolist(),
                "damping_ratio": curve.damping_ratio,
            }
    return out


def run_continuation(problem, analysis: Dict, device=None) -> Dict:
    """An arc-length continuation block on `device` (solvers/riks.py): the
    equilibrium path lambda(u), traced through limit points."""
    from ..solvers.riks import solve_riks

    stop_lam = analysis.get("stop_lambda_abs")
    stop_fn = ((lambda u, lam: abs(lam) > float(stop_lam))
               if stop_lam is not None else None)
    res = solve_riks(
        problem,
        n_steps=int(analysis.get("n_steps", 200)),
        initial_dlambda=float(analysis.get("initial_dlambda", 0.02)),
        tol=float(analysis.get("tolerance", 1e-8)),
        stop_fn=stop_fn, device=device)
    probe = _probe_dofs(analysis, problem)
    return {
        "success": bool(res.converged),
        "analysis": "continuation",
        "n_points": int(res.load_factors.size),
        "load_factors": res.load_factors.tolist(),
        "probe_dofs": probe.tolist(),
        "displacements": res.displacements[:, probe].tolist(),
        "iterations": res.iterations.tolist(),
        "max_residual": float(res.residuals.max()) if res.residuals.size
        else None,
    }


def run_plastic(problem, analysis: Dict, device=None) -> Dict:
    """An elastoplastic-statics block on `device` (solvers/plasticity.py):
    the incremental radial-return solve along a load-factor history."""
    from ..solvers.plasticity import solve_elastoplastic

    if "sigma_y" not in analysis:
        raise ValueError('plastic analysis requires "sigma_y"')
    kwargs = dict(
        sigma_y=analysis["sigma_y"],
        hardening_iso=analysis.get("hardening", 0.0),
        hardening_kin=analysis.get("kinematic_hardening", 0.0),
        tol=float(analysis.get("tolerance", 1e-9)),
        max_iter=int(analysis.get("max_iterations", 30)),
    )
    if "load_factors" in analysis:
        kwargs["load_factors"] = np.asarray(analysis["load_factors"],
                                            dtype=float)
    else:
        kwargs["target_load_factor"] = float(analysis.get("target", 1.0))
        kwargs["n_steps"] = int(analysis.get("n_steps", 20))
    res = solve_elastoplastic(problem, device=device, **kwargs)

    probe = _probe_dofs(analysis, problem)
    yielded = np.flatnonzero(res.alpha[-1] > 0.0)
    out = {
        "success": bool(res.converged),
        "analysis": "plastic",
        "n_steps": int(res.load_factors.size),
        "load_factors": res.load_factors.tolist(),
        "probe_dofs": probe.tolist(),
        "displacements": res.displacements[:, probe].tolist(),
        "iterations": res.iterations.tolist(),
        "max_residual": float(res.residuals.max()),
        "n_plastic": res.n_plastic.tolist(),
        "yielded_elements": yielded.tolist(),
        "max_abs_stress": np.abs(res.stresses).max(axis=1).tolist(),
        "final": {
            "stresses": res.stresses[-1].tolist(),
            "plastic_strain": res.plastic_strain[-1].tolist(),
            "accumulated_plastic_strain": res.alpha[-1].tolist(),
            "back_stress": res.back_stress[-1].tolist(),
            "displacements": res.displacements[-1].tolist(),
        },
    }
    if analysis.get("include_history"):
        out["history"] = {
            "stresses": res.stresses.tolist(),
            "plastic_strain": res.plastic_strain.tolist(),
        }
    return _json_finite(out)


def run_reduction(problem, analysis: Dict, device=None) -> Dict:
    """A model-order-reduction block on `device` (solvers/reduction.py):
    the reduced natural frequencies, the reduced matrices when small
    (n_red <= 64), and with compare_full the full model's frequencies
    (modal_analysis) and the per-mode relative errors."""
    import scipy.linalg

    from ..solvers.modal import modal_analysis
    from ..solvers.reduction import craig_bampton, guyan_reduce

    method = analysis.get("method", "guyan")
    if "master_dofs" in analysis:
        masters = np.asarray(analysis["master_dofs"], dtype=int)
    elif "master_nodes" in analysis:
        nodes = np.asarray(analysis["master_nodes"], dtype=int)
        d = problem.dimension
        cand = (d * nodes[:, None] + np.arange(d)[None, :]).reshape(-1)
        free = set(problem.free_fixed()[0].tolist())
        masters = np.asarray([c for c in cand if int(c) in free],
                             dtype=int)
        if masters.size == 0:
            raise ValueError("master_nodes resolve to no free DOFs")
    else:
        raise ValueError("reduction needs master_nodes or master_dofs")

    if method == "guyan":
        model = guyan_reduce(problem, masters, device=device)
    elif method == "craig_bampton":
        model = craig_bampton(problem, masters,
                              n_modes=int(analysis.get("n_modes", 4)),
                              device=device)
    else:
        raise ValueError('reduction method must be "guyan" or '
                         '"craig_bampton"')

    # The n_red x n_red pencil: float64 LAPACK on the host.
    w2 = scipy.linalg.eigh(model.k_red, model.m_red, eigvals_only=True)
    omegas = np.sqrt(np.maximum(w2, 0.0))
    n_red = int(model.k_red.shape[0])
    out = {
        "success": True,
        "analysis": "reduction",
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
        n_cmp = min(n_red, problem.free_fixed()[0].size,
                    int(analysis.get("compare_modes", min(n_red, 6))))
        full = modal_analysis(problem, n_modes=n_cmp, device=device)
        rel = np.abs(omegas[:n_cmp] - full.omegas)
        rel = rel / np.maximum(full.omegas, 1e-30)
        out["full_omegas"] = full.omegas.tolist()
        out["full_frequencies_hz"] = full.frequencies.tolist()
        out["frequency_rel_error"] = rel.tolist()
    return out


def run_analysis(problem, analysis: Dict, device=None) -> Dict:
    """Run an "analysis" block on `device` ("cuda" when None)."""
    kind = analysis.get("type")
    if kind == "transient":
        from .transient_io import run_transient

        return run_transient(problem, analysis, device)
    if kind == "modal":
        return run_modal(problem, analysis, device)
    if kind == "buckling":
        return run_buckling(problem, analysis, device)
    if kind == "harmonic":
        return run_harmonic(problem, analysis, device)
    if kind == "spectrum":
        return run_spectrum(problem, analysis, device)
    if kind == "random":
        return run_random(problem, analysis, device)
    if kind == "continuation":
        return run_continuation(problem, analysis, device)
    if kind == "plastic":
        return run_plastic(problem, analysis, device)
    if kind == "reduction":
        return run_reduction(problem, analysis, device)
    if kind == "identification":
        from .identification_io import run_identification

        return run_identification(problem, analysis, device)
    if kind == "sizing":
        from .sizing_io import run_sizing

        return run_sizing(problem, analysis, device)
    if kind == "reliability":
        from .reliability_io import run_reliability

        return run_reliability(problem, analysis, device)
    raise ValueError(f'analysis.type must be "modal", "transient", '
                     f'"buckling", "harmonic", "spectrum", '
                     f'"continuation", "plastic", "random", "reduction", '
                     f'"identification", "sizing" or "reliability", '
                     f'got {kind!r}')
