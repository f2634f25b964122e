"""Identification ("analysis": {"type": "identification"}) JSON runners
(counterpart of pinn_fem_tpu/io/identification_io.py).

Truss documents: the time-domain discrete adjoint (`run_identification`),
its spatial MLP field mode, the modal-domain fit (frequencies plus phi^2,
scalar or field) and the FRF model-updating fit, over
solvers/transient_inverse.py, solvers/modal_inverse.py and
solvers/frequency_inverse.py.  The contracts (keys, defaults, errors and
result keys) are the JAX package's; each runner's docstring there is the
full reference.

Continuum families: `run_young_identification` is the plane, solid, plate
and shell families' shared Young-modulus runner (twin data from the banded
tier, named zones, the dense or banded adjoint tier) over
solvers/banded_inverse.py.

Device: every runner takes `device` ("cuda" when None) and runs there.
The JAX package runs identification on its local CPU backend unless the
document says "on_device": true (`_local_cpu_ctx`), plumbing for its TPU
attachment whose remote compiles would outlast an HTTP request.  The port
reads the key and ignores it: it always runs on its device, and its
results carry the same keys as the JAX package's, which do not include
"on_device".
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np
import torch

from ..models.fields import (ScalarField, make_mlp_field,
                             point_inputs_dict_order)
from ..models.problem import TrussProblem
from ..ops.host import _assembly_inputs, eval_field_host
from ..solvers.dynamics import stable_dt
from ..utils import prng
from ..utils.runtime import resolve_device
from ._common import (_SHAPES_JSON_DOF_LIMIT, _amplitude_array,
                      _json_finite, _omega_array, _probe_dofs)


def _numpy(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def _field_spec(analysis: Dict, default: str, param_order) -> Dict:
    """The "field" block as a dict, checked as the JAX package checks it."""
    spec = analysis["field"]
    if isinstance(spec, str):
        spec = {"name": spec}
    if not isinstance(spec, dict):
        raise ValueError('"field" must be an object (or a field name)')
    name = spec.get("name", default)
    if name not in param_order:
        raise ValueError(f'field.name must be among {list(param_order)}, '
                         f'got {name!r}')
    unknown = set(spec) - {"name", "hidden_layers", "neurons_per_layer",
                           "input_dim", "scale", "seed"}
    if unknown:
        raise ValueError(f"unknown field keys: {sorted(unknown)}")
    return dict(spec, name=name)


def _current_values(problem, param_order) -> Dict:
    x_mid = _assembly_inputs(problem, 1.0)
    return {p: np.asarray(eval_field_host(getattr(problem.material, p),
                                          x_mid), dtype=float)
            for p in param_order}


def _true_profile(spec: Dict, name: str, nelm: int) -> np.ndarray:
    tv = spec[name]
    true_e = (np.full(nelm, float(tv)) if np.isscalar(tv)
              else np.asarray(tv, dtype=float))
    if true_e.shape != (nelm,):
        raise ValueError(f"true {name} profile must have one value "
                         f"per element ({nelm}), got {true_e.shape}")
    if not (np.all(np.isfinite(true_e)) and np.all(true_e > 0)):
        raise ValueError(f"true {name} values must be positive finite")
    return true_e


def _start_field(spec: Dict, problem, cur: Dict, device):
    """The MLPField to train: the spec's architecture, jax.random's weights
    for its seed (utils/prng), scale the mean of the current field."""
    name = spec["name"]
    return make_mlp_field(
        prng.PRNGKey(int(spec.get("seed", 0))),
        hidden_layers=int(spec.get("hidden_layers", 1)),
        neurons_per_layer=int(spec.get("neurons_per_layer", 8)),
        input_dim=int(spec.get("input_dim", problem.dimension)),
        scale=float(spec.get("scale",
                             max(float(np.mean(cur[name])), 1e-12))),
        device=device)


def _field_result(problem, trained, nn) -> Dict:
    """The identified_field block: the trained net at the nodes and the
    element centroids, with the assembly's (load_factor, x[, y]) rows."""
    dim = problem.dimension
    centroids = problem.element_midpoints()
    node_coords = problem.node_coords_2d
    dev = trained.scale.device
    with torch.no_grad():
        vals_e = _numpy(trained.eval_batch(point_inputs_dict_order(
            centroids, dim, 1.0, trained.scale.dtype, dev)))
        vals_n = _numpy(trained.eval_batch(point_inputs_dict_order(
            node_coords, dim, 1.0, trained.scale.dtype, dev)))

    def coords(c):
        c = np.asarray(c)
        return c.reshape(-1).tolist() if dim == 1 else c.tolist()

    return {
        "at_nodes": {"coords": coords(problem.nodes if dim == 1
                                      else node_coords),
                     "values": vals_n.tolist()},
        "at_elements": {"centroids": coords(centroids),
                        "values": vals_e.tolist()},
        "type": "nn",
        "input_dim": nn.input_dim,
    }, vals_e


def _truth_errors(out: Dict, vals_e, true_e, noise_rel: float) -> None:
    rel = np.abs(vals_e - true_e) / np.abs(true_e)
    out["synthetic"] = True
    out["true_values"] = true_e.tolist()
    out["noise"] = noise_rel
    out["field_max_rel_error"] = float(np.max(rel))
    out["field_rmse_rel"] = float(np.sqrt(np.mean(rel * rel)))


def _with_scalars(problem, values: Dict, names) -> "object":
    """problem.material with the entries of `values` among `names` as
    ScalarFields."""
    return replace(problem.material,
                   **{k: ScalarField(value=float(v))
                      for k, v in values.items() if k in names})


def _true_problem(problem, material) -> TrussProblem:
    """The JAX package's twin problem: nodes, elements, material, loads,
    supports and dimension (no point masses)."""
    return TrussProblem(problem.nodes, problem.elements, material,
                        problem.loads, problem.fixed_dofs,
                        problem.dimension)


def _initial_values(problem, analysis: Dict, params, param_order) -> Dict:
    """"initial", with a non-scalar base field's mean over the element
    midpoints for each identified material parameter it does not name."""
    initial = {k: float(v)
               for k, v in (analysis.get("initial") or {}).items()}
    for p in params:
        if p not in param_order:
            continue
        if p not in initial and not isinstance(
                getattr(problem.material, p), ScalarField):
            vals = eval_field_host(getattr(problem.material, p),
                                   _assembly_inputs(problem, 1.0))
            initial[p] = max(float(np.mean(vals)), 1e-12)
    return initial or None


def _relative_errors(ident: Dict, true_vals: Dict) -> Dict:
    return {k: abs(ident[k] - true_vals[k]) / abs(true_vals[k])
            for k in ident if k in true_vals}


def _run_field_identification(problem, analysis: Dict, n_steps: int,
                              record_every: int, n_rec: int, damping,
                              synthetic_spec, device) -> Dict:
    """Field mode of the time-domain block: a spatial MLP profile trained
    against the transient probe history (identify_field_from_transient);
    twin data from a per-element truth (transient_probe_response_elem)."""
    from ..solvers.transient_inverse import (
        _PARAM_ORDER, identify_field_from_transient,
        transient_probe_response, transient_probe_response_elem)

    spec = _field_spec(analysis, "young", _PARAM_ORDER)
    name = spec["name"]
    nelm = len(problem.elements)
    cur = _current_values(problem, _PARAM_ORDER)
    measured = analysis.get("measured")
    if (measured is None) == (synthetic_spec is None):
        raise ValueError('identification needs exactly one of "measured" '
                         'or "synthetic"')
    true_e = None
    if synthetic_spec is not None:
        unknown = set(synthetic_spec) - {name, "noise", "seed"}
        if unknown:
            raise ValueError(
                f'field-mode synthetic takes only "{name}", "noise" and '
                f'"seed"; got {sorted(unknown)}')
        if name not in synthetic_spec:
            raise ValueError(f'field-mode synthetic must provide the true '
                             f'"{name}" profile (per-element values or a '
                             f'constant)')
        true_e = _true_profile(synthetic_spec, name, nelm)

    dt_spec = analysis["dt"]
    if dt_spec == "auto":
        if true_e is None:
            raise ValueError('dt="auto" needs "synthetic" twin data; a '
                             'measured history fixes its own dt')
        # The stiffest / lightest element bounds the critical step.
        bound = (np.max if name in ("young", "area") else np.min)(true_e)
        true_problem = _true_problem(problem, replace(
            problem.material, **{name: ScalarField(value=float(bound))}))
        dt = stable_dt(true_problem, damping=damping, safety=0.45,
                       device=device)
    else:
        dt = float(dt_spec)
    probe = _probe_dofs(analysis, problem)
    amplitude = _amplitude_array(analysis.get("amplitude"), n_steps, dt)

    noise_rel = 0.0
    if true_e is not None:
        vals = dict(cur)
        vals[name] = true_e
        with torch.no_grad():
            meas = _numpy(transient_probe_response_elem(
                problem, vals["young"], vals["area"], vals["density"], dt,
                n_steps, amplitude, probe, record_every=record_every,
                damping=damping, device=device))
        noise_rel = float(synthetic_spec.get("noise", 0.0))
        if noise_rel:
            rng = np.random.default_rng(int(synthetic_spec.get("seed", 0)))
            meas = meas + noise_rel * np.max(np.abs(meas)) \
                * rng.standard_normal(meas.shape)
    else:
        meas = np.asarray(measured, dtype=float)
        if meas.ndim != 2 or meas.shape != (n_rec, probe.size):
            raise ValueError(
                f"measured must be (n_steps/record_every={n_rec}, "
                f"n_probe={probe.size}) rows, got {meas.shape}")

    nn = _start_field(spec, problem, cur, resolve_device(device))
    trained, hist = identify_field_from_transient(
        problem, meas, dt, n_steps, probe, field=name, nn_field=nn,
        amplitude=amplitude, record_every=record_every, damping=damping,
        n_iter=int(analysis.get("n_iter", 600)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        device=device)
    identified, vals_e = _field_result(problem, trained, nn)
    out = {
        "success": True,
        "analysis": "identification",
        "mode": "field",
        "field": name,
        "identified_field": identified,
        "dt": dt,
        "n_steps": n_steps,
        "record_every": record_every,
        "probe_dofs": probe.tolist(),
        "n_iter": len(hist),
        "final_loss": float(hist[-1]),
        "loss_history": hist.tolist(),
    }
    if true_e is not None:
        _truth_errors(out, vals_e, true_e, noise_rel)
    if analysis.get("include_fit",
                    probe.size * n_rec <= 4 * _SHAPES_JSON_DOF_LIMIT):
        with torch.no_grad():
            fit = _numpy(transient_probe_response(
                problem, replace(problem.material, **{name: trained}), dt,
                n_steps, amplitude, probe, record_every=record_every,
                damping=damping, device=device))
        scale = max(float(np.max(np.abs(meas))), 1e-30)
        out["fitted_displacements"] = fit.tolist()
        out["measured_displacements"] = meas.tolist()
        out["fit_rmse_rel"] = float(np.sqrt(np.mean((fit - meas) ** 2))
                                    / scale)
    return out


def _sensors(analysis: Dict, problem):
    if "sensor_dofs" in analysis or "sensor_nodes" in analysis:
        return _probe_dofs({"probe_dofs": analysis["sensor_dofs"]}
                           if "sensor_dofs" in analysis
                           else {"probe_nodes": analysis["sensor_nodes"]},
                           problem)
    return None


def _frequencies_hz(lam: torch.Tensor) -> np.ndarray:
    return np.sqrt(np.maximum(_numpy(lam), 0.0)) / (2.0 * np.pi)


def _fitted_spectrum(out: Dict, problem, material, f_meas, device) -> None:
    """The fitted spectrum with the identified material, and its relative
    error against the measured frequencies."""
    from ..solvers.modal_inverse import modal_observables

    with torch.no_grad():
        lam_fit, _ = modal_observables(problem, material, len(f_meas),
                                       sensor_dofs=None, device=device)
    f_fit = _frequencies_hz(lam_fit)
    out["fitted_frequencies_hz"] = f_fit.tolist()
    out["frequency_rel_error"] = (
        np.abs(f_fit - f_meas) / np.maximum(np.abs(f_meas), 1e-30)
    ).tolist()


def _noisy_modal(f_meas, shapes2, synthetic: Dict):
    noise_rel = float(synthetic.get("noise", 0.0))
    if noise_rel:
        rng = np.random.default_rng(int(synthetic.get("seed", 0)))
        f_meas = f_meas * (1.0 + noise_rel
                           * rng.standard_normal(f_meas.shape))
        if shapes2 is not None:
            shapes2 = np.abs(shapes2 * (
                1.0 + noise_rel * rng.standard_normal(shapes2.shape)))
    return f_meas, shapes2, noise_rel


def _run_modal_field_identification(problem, analysis: Dict,
                                    device) -> Dict:
    """Field mode of the modal-domain block (identify_field_from_modal):
    a spatial MLP profile, canonically rho(x), from natural frequencies
    plus phi^2 sensor rows."""
    from ..solvers.modal_inverse import (identify_field_from_modal,
                                         modal_observables_elem)
    from ..solvers.transient_inverse import _PARAM_ORDER

    spec = _field_spec(analysis, "density", _PARAM_ORDER)
    name = spec["name"]
    sensors = _sensors(analysis, problem)
    if sensors is None:
        raise ValueError(
            "modal field identification needs sensor_nodes/sensor_dofs "
            "(frequencies alone underdetermine a spatial profile)")
    nelm = len(problem.elements)
    cur = _current_values(problem, _PARAM_ORDER)
    measured = analysis.get("measured_frequencies_hz")
    synthetic = analysis.get("synthetic")
    if synthetic is not None and not isinstance(synthetic, dict):
        raise ValueError('"synthetic" must be an object of true '
                         'parameter values')
    if (measured is None) == (synthetic is None):
        raise ValueError('modal identification needs exactly one of '
                         '"measured_frequencies_hz" or "synthetic"')
    true_e = None
    if synthetic is not None:
        unknown = set(synthetic) - {name, "n_modes", "noise", "seed"}
        if unknown:
            raise ValueError(
                f'field-mode synthetic takes only "{name}", "n_modes", '
                f'"noise" and "seed"; got {sorted(unknown)}')
        if name not in synthetic:
            raise ValueError(f'field-mode synthetic must provide the '
                             f'true "{name}" profile')
        true_e = _true_profile(synthetic, name, nelm)

    noise_rel = 0.0
    if true_e is not None:
        vals = dict(cur)
        vals[name] = true_e
        with torch.no_grad():
            lam, s2 = modal_observables_elem(
                problem, vals["young"], vals["area"], vals["density"],
                int(synthetic.get("n_modes", 6)), sensor_dofs=sensors,
                device=device)
        f_meas, shapes2, noise_rel = _noisy_modal(
            _frequencies_hz(lam), _numpy(s2), synthetic)
    else:
        f_meas = np.asarray(measured, dtype=float).reshape(-1)
        shapes2 = analysis.get("measured_shapes2")
        if shapes2 is None:
            raise ValueError('modal field identification needs '
                             '"measured_shapes2" alongside the '
                             'measured frequencies')
        shapes2 = np.asarray(shapes2, dtype=float)

    nn = _start_field(spec, problem, cur, resolve_device(device))
    trained, hist = identify_field_from_modal(
        problem, f_meas, sensor_dofs=sensors, measured_shapes2=shapes2,
        field=name, nn_field=nn, n_iter=int(analysis.get("n_iter", 800)),
        learning_rate=float(analysis.get("learning_rate", 0.02)),
        device=device)
    identified, vals_e = _field_result(problem, trained, nn)
    out = {
        "success": True,
        "analysis": "identification",
        "domain": "modal",
        "mode": "field",
        "field": name,
        "identified_field": identified,
        "measured_frequencies_hz": np.asarray(f_meas).tolist(),
        "sensor_dofs": sensors.tolist(),
        "n_iter": len(hist),
        "final_loss": float(hist[-1]),
        "loss_history": hist.tolist(),
    }
    if true_e is not None:
        _truth_errors(out, vals_e, true_e, noise_rel)
    _fitted_spectrum(out, problem,
                     replace(problem.material, **{name: trained}), f_meas,
                     device)
    return out


def _dense_only(problem, what: str) -> None:
    from ..solvers.newton import DENSE_DOF_LIMIT

    if problem.ndof > DENSE_DOF_LIMIT:
        raise ValueError(
            f"{what} identification is dense-only "
            f"({problem.ndof} DOFs > {DENSE_DOF_LIMIT}); identify on a "
            f"coarser model of the structure")


def _run_modal_identification(problem, analysis: Dict, device) -> Dict:
    """Modal-domain block (solvers/modal_inverse.py): parameters fitted to
    extracted natural frequencies, with optional phi^2 sensor rows."""
    from ..solvers.modal_inverse import identify_from_modal, \
        modal_observables
    from ..solvers.transient_inverse import _PARAM_ORDER

    _dense_only(problem, "modal-domain")
    if analysis.get("field") is not None:
        if "params" in analysis:
            raise ValueError('"params" and "field" are mutually '
                             'exclusive: field mode recovers one spatial '
                             'profile, not scalar parameters')
        return _run_modal_field_identification(problem, analysis, device)
    params = tuple(analysis.get("params", ["young"]))
    for p in params:
        if p not in _PARAM_ORDER:
            raise ValueError(
                f"modal identification params must be among "
                f"{list(_PARAM_ORDER)} (damping is invisible to "
                f"undamped frequencies), got {p!r}")
    sensors = _sensors(analysis, problem)
    measured = analysis.get("measured_frequencies_hz")
    synthetic = analysis.get("synthetic")
    if synthetic is not None and not isinstance(synthetic, dict):
        raise ValueError('"synthetic" must be an object of true '
                         'parameter values')
    if (measured is None) == (synthetic is None):
        raise ValueError('modal identification needs exactly one of '
                         '"measured_frequencies_hz" or "synthetic" '
                         '(true parameter values for twin data)')
    shapes2 = analysis.get("measured_shapes2")
    if shapes2 is not None and sensors is None:
        raise ValueError('"measured_shapes2" needs "sensor_nodes" or '
                         '"sensor_dofs"')

    noise_rel = 0.0
    true_vals = None
    if synthetic is not None:
        true_vals = {k: float(v) for k, v in synthetic.items()
                     if k in _PARAM_ORDER}
        unknown = (set(synthetic) - set(_PARAM_ORDER)
                   - {"n_modes", "noise", "seed"})
        if unknown:
            raise ValueError(f"unknown synthetic keys: {sorted(unknown)}")
        with torch.no_grad():
            lam, s2 = modal_observables(
                problem, _with_scalars(problem, true_vals, _PARAM_ORDER),
                int(synthetic.get("n_modes", 4)), sensor_dofs=sensors,
                device=device)
        f_meas = _frequencies_hz(lam)
        if sensors is not None:
            shapes2 = _numpy(s2)
        f_meas, shapes2, noise_rel = _noisy_modal(f_meas, shapes2,
                                                  synthetic)
    else:
        f_meas = np.asarray(measured, dtype=float).reshape(-1)
        if shapes2 is not None:
            shapes2 = np.asarray(shapes2, dtype=float)

    ident, hist = identify_from_modal(
        problem, f_meas, sensor_dofs=sensors, measured_shapes2=shapes2,
        params=params, n_iter=int(analysis.get("n_iter", 300)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        initial=_initial_values(problem, analysis, params, _PARAM_ORDER),
        device=device)
    out = {
        "success": True,
        "analysis": "identification",
        "domain": "modal",
        "params": list(params),
        "identified": ident,
        "measured_frequencies_hz": np.asarray(f_meas).tolist(),
        "n_iter": len(hist),
        "final_loss": float(hist[-1]),
        "loss_history": hist.tolist(),
    }
    if sensors is not None:
        out["sensor_dofs"] = sensors.tolist()
    if true_vals is not None:
        out["synthetic"] = True
        out["true_values"] = true_vals
        out["noise"] = noise_rel
        out["relative_errors"] = _relative_errors(ident, true_vals)
    _fitted_spectrum(out, problem, _with_scalars(problem, ident,
                                                 _PARAM_ORDER),
                     f_meas, device)
    return out


def _run_frf_identification(problem, analysis: Dict, device) -> Dict:
    """Frequency-domain block (solvers/frequency_inverse.py): material and
    Rayleigh damping fitted to measured FRF amplitudes.  Twin-data noise
    is multiplicative, amp * (1 + noise * randn)."""
    from ..solvers.frequency_inverse import (frf_probe_amplitudes,
                                             identify_from_frf)
    from ..solvers.transient_inverse import _DAMP_PARAMS, _PARAM_ORDER

    _dense_only(problem, "frequency-domain")
    omegas = _omega_array(analysis["omegas"])
    damping = analysis.get("damping", [0.0, 0.0])
    damping = (float(damping[0]), float(damping[1]))
    params = tuple(analysis.get("params", ["young", "density"]))
    for p in params:
        if p not in _PARAM_ORDER + _DAMP_PARAMS:
            raise ValueError(f"identification params must be among "
                             f"{list(_PARAM_ORDER + _DAMP_PARAMS)}, "
                             f"got {p!r}")
    probe = _probe_dofs(analysis, problem)
    measured = analysis.get("measured_amplitude")
    synthetic = analysis.get("synthetic")
    if synthetic is not None and not isinstance(synthetic, dict):
        raise ValueError('"synthetic" must be an object of true '
                         'parameter values')
    if (measured is None) == (synthetic is None):
        raise ValueError('frequency-domain identification needs exactly '
                         'one of "measured_amplitude" (an '
                         '(n_freq, n_probe) |X| table) or "synthetic" '
                         '(true parameter values for twin data)')

    noise_rel = 0.0
    true_vals = None
    if synthetic is not None:
        true_vals = {k: float(v) for k, v in synthetic.items()
                     if k in _PARAM_ORDER + _DAMP_PARAMS}
        unknown = (set(synthetic) - set(_PARAM_ORDER)
                   - set(_DAMP_PARAMS) - {"noise", "seed"})
        if unknown:
            raise ValueError(f"unknown synthetic keys: {sorted(unknown)}")
        true_damp = (true_vals.get("alpha", damping[0]),
                     true_vals.get("beta", damping[1]))
        with torch.no_grad():
            meas = _numpy(frf_probe_amplitudes(
                problem, _with_scalars(problem, true_vals, _PARAM_ORDER),
                omegas, true_damp, probe, device=device))
        noise_rel = float(synthetic.get("noise", 0.0))
        if noise_rel:
            rng = np.random.default_rng(int(synthetic.get("seed", 0)))
            meas = np.abs(meas * (1.0 + noise_rel
                                  * rng.standard_normal(meas.shape)))
    else:
        meas = np.asarray(measured, dtype=float)
        if meas.ndim != 2 or meas.shape != (omegas.size, probe.size):
            raise ValueError(
                f"measured_amplitude must be (n_freq={omegas.size}, "
                f"n_probe={probe.size}), got {meas.shape}")

    ident, hist = identify_from_frf(
        problem, meas, omegas, probe, params=params, damping=damping,
        n_iter=int(analysis.get("n_iter", 400)),
        learning_rate=float(analysis.get("learning_rate", 0.08)),
        initial=_initial_values(problem, analysis, params, _PARAM_ORDER),
        restarts=int(analysis.get("restarts", 3)), device=device)
    out = {
        "success": True,
        "analysis": "identification",
        "domain": "frequency",
        "params": list(params),
        "identified": ident,
        "omegas": omegas.tolist(),
        "probe_dofs": probe.tolist(),
        "n_iter": len(hist),
        "final_loss": float(hist[-1]),
        "loss_history": hist.tolist(),
    }
    if true_vals is not None:
        out["synthetic"] = True
        out["true_values"] = true_vals
        out["noise"] = noise_rel
        out["relative_errors"] = _relative_errors(ident, true_vals)
    if analysis.get("include_fit",
                    probe.size * omegas.size <= 4 * _SHAPES_JSON_DOF_LIMIT):
        fit_damp = (ident.get("alpha", damping[0]),
                    ident.get("beta", damping[1]))
        with torch.no_grad():
            fit = _numpy(frf_probe_amplitudes(
                problem, _with_scalars(problem, ident, _PARAM_ORDER),
                omegas, fit_damp, probe, device=device))
        floor = 1e-12 * max(float(np.max(meas)), 1e-30)
        out["fitted_amplitude"] = fit.tolist()
        out["measured_amplitude"] = meas.tolist()
        out["fit_rms_log"] = float(np.sqrt(np.mean(
            (np.log(fit + floor) - np.log(meas + floor)) ** 2)))
    return out


def run_identification(problem, analysis: Dict, device=None) -> Dict:
    """Execute an identification block on `device` ("cuda" when None): the
    time domain (scalar parameters and Rayleigh damping recovered from a
    probe history by reverse mode through the central-difference
    integrator; "field" for a spatial MLP profile), "domain": "modal" or
    "domain": "frequency" (the JAX package's run_identification contract,
    checks in its order)."""
    from ..solvers.transient_inverse import (_DAMP_PARAMS, _PARAM_ORDER,
                                             identify_from_transient,
                                             transient_probe_response)

    domain = analysis.get("domain", "time")
    if domain == "frequency":
        if analysis.get("field") is not None:
            raise ValueError("field mode supports the time and modal "
                             "domains, not FRF fitting")
        return _run_frf_identification(problem, analysis, device)
    if domain == "modal":
        return _run_modal_identification(problem, analysis, device)
    if domain != "time":
        raise ValueError(f'identification domain must be "time", '
                         f'"frequency" or "modal", got {domain!r}')

    n_steps = int(analysis["n_steps"])
    record_every = int(analysis.get("record_every", 1))
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    n_rec = n_steps // record_every
    damping = analysis.get("damping", [0.0, 0.0])
    damping = (float(damping[0]), float(damping[1]))
    _dense_only(problem, "time-domain")
    synthetic_spec = analysis.get("synthetic")
    if synthetic_spec is not None and not isinstance(synthetic_spec, dict):
        raise ValueError('"synthetic" must be an object of true '
                         'parameter values')
    if analysis.get("field") is not None:
        if "params" in analysis:
            raise ValueError('"params" and "field" are mutually exclusive: '
                             'field mode recovers one spatial profile, not '
                             'scalar parameters')
        return _run_field_identification(problem, analysis, n_steps,
                                         record_every, n_rec, damping,
                                         synthetic_spec, device)
    dt_spec = analysis["dt"]
    if dt_spec == "auto":
        # Only in twin-data mode: the critical step of the true material
        # and damping, at safety 0.45 (the optimizer integrates at every
        # value it visits, overshoots included).
        if synthetic_spec is None:
            raise ValueError('dt="auto" needs "synthetic" twin data; a '
                             'measured history fixes its own dt')
        syn = {k: float(v) for k, v in synthetic_spec.items()
               if k in _PARAM_ORDER}
        dt_damp = (float(synthetic_spec.get("alpha", damping[0])),
                   float(synthetic_spec.get("beta", damping[1])))
        dt = stable_dt(_true_problem(problem, _with_scalars(
            problem, syn, _PARAM_ORDER)), damping=dt_damp, safety=0.45,
            device=device)
    else:
        dt = float(dt_spec)
    params = tuple(analysis.get("params", ["young", "density"]))
    for p in params:
        if p not in _PARAM_ORDER + _DAMP_PARAMS:
            raise ValueError(f"identification params must be among "
                             f"{list(_PARAM_ORDER + _DAMP_PARAMS)}, "
                             f"got {p!r}")
    probe = _probe_dofs(analysis, problem)
    amplitude = _amplitude_array(analysis.get("amplitude"), n_steps, dt)
    measured = analysis.get("measured")
    synthetic = synthetic_spec
    if (measured is None) == (synthetic is None):
        raise ValueError('identification needs exactly one of "measured" '
                         '(a (n_rec, n_probe) history) or "synthetic" '
                         '(true parameter values for twin data)')

    noise_rel = 0.0
    true_vals = None
    if synthetic is not None:
        true_vals = {k: float(v) for k, v in synthetic.items()
                     if k in _PARAM_ORDER + _DAMP_PARAMS}
        unknown = (set(synthetic) - set(_PARAM_ORDER)
                   - set(_DAMP_PARAMS) - {"noise", "seed"})
        if unknown:
            raise ValueError(f"unknown synthetic keys: {sorted(unknown)}")
        # The truth integrates with its own damping.
        true_damp = (true_vals.get("alpha", damping[0]),
                     true_vals.get("beta", damping[1]))
        with torch.no_grad():
            meas = _numpy(transient_probe_response(
                problem, _with_scalars(problem, true_vals, _PARAM_ORDER),
                dt, n_steps, amplitude, probe, record_every=record_every,
                damping=true_damp, device=device))
        noise_rel = float(synthetic.get("noise", 0.0))
        if noise_rel:
            rng = np.random.default_rng(int(synthetic.get("seed", 0)))
            meas = meas + noise_rel * np.max(np.abs(meas)) \
                * rng.standard_normal(meas.shape)
    else:
        meas = np.asarray(measured, dtype=float)
        if meas.ndim != 2 or meas.shape != (n_rec, probe.size):
            raise ValueError(
                f"measured must be (n_steps/record_every={n_rec}, "
                f"n_probe={probe.size}) rows, got {meas.shape}")

    ident, hist = identify_from_transient(
        problem, meas, dt, n_steps, probe, amplitude=amplitude,
        params=params, record_every=record_every, damping=damping,
        n_iter=int(analysis.get("n_iter", 300)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        initial=_initial_values(problem, analysis, params, _PARAM_ORDER),
        device=device)
    out = {
        "success": True,
        "analysis": "identification",
        "params": list(params),
        "identified": ident,
        "dt": dt,
        "n_steps": n_steps,
        "record_every": record_every,
        "probe_dofs": probe.tolist(),
        "n_iter": len(hist),
        "final_loss": float(hist[-1]),
        "loss_history": hist.tolist(),
    }
    if true_vals is not None:
        out["synthetic"] = True
        out["true_values"] = true_vals
        out["noise"] = noise_rel
        out["relative_errors"] = _relative_errors(ident, true_vals)
    if analysis.get("include_fit",
                    probe.size * n_rec <= 4 * _SHAPES_JSON_DOF_LIMIT):
        fit_damp = (ident.get("alpha", damping[0]),
                    ident.get("beta", damping[1]))
        with torch.no_grad():
            fit = _numpy(transient_probe_response(
                problem, _with_scalars(problem, ident, _PARAM_ORDER), dt,
                n_steps, amplitude, probe, record_every=record_every,
                damping=fit_damp, device=device))
        scale = max(float(np.max(np.abs(meas))), 1e-30)
        out["fitted_displacements"] = fit.tolist()
        out["measured_displacements"] = meas.tolist()
        out["fit_rmse_rel"] = float(np.sqrt(np.mean((fit - meas) ** 2))
                                    / scale)
    return out


# --------------------------------------------------------------------
# The continuum families' Young-modulus identification


def _twin_truth(problem, analysis: Dict, zones, family: str, probe_dofs):
    """(measured DOFs, true per-element E) of the "synthetic" block
    ("zone_young" over the zones, or "young"), or (None, None) without
    one; checked before any solve."""
    synthetic = analysis.get("synthetic")
    if synthetic is None:
        return None, None
    if "measured_u" in analysis:
        raise ValueError('give "measured_u" or "synthetic", not both')
    md = analysis.get("measured_dofs")
    if md is None:
        md = probe_dofs(analysis, problem)
    if md is None:
        raise ValueError(f'synthetic {family} identification needs '
                         f'"measured_dofs" or "probe_nodes"')
    measured_dofs = np.asarray(md, dtype=int).reshape(-1)
    if "zone_young" in synthetic:
        if zones is None:
            raise ValueError('"zone_young" needs "zones"')
        true_young = np.broadcast_to(np.asarray(problem.young, dtype=float),
                                     (problem.nelm,)).copy()
        for ids, e in zip(zones, synthetic["zone_young"]):
            true_young[ids] = float(e)
    else:
        tv = synthetic["young"]
        true_young = (np.full(problem.nelm, float(tv)) if np.isscalar(tv)
                      else np.asarray(tv, dtype=float))
    return measured_dofs, true_young


def _twin_measurement(analysis: Dict, measured_dofs, true_young,
                      true_solve) -> Dict:
    """The analysis with measured_dofs / measured_u: the truth solved by
    true_solve(true_young), plus the block's relative noise."""
    synthetic = analysis["synthetic"]
    measured_u = true_solve(true_young)[measured_dofs]
    noise = float(synthetic.get("noise", 0.0))
    if noise:
        rng = np.random.default_rng(int(synthetic.get("seed", 0)))
        measured_u = measured_u + noise * np.max(np.abs(measured_u)) \
            * rng.standard_normal(measured_u.shape)
    return dict(analysis, measured_dofs=measured_dofs.tolist(),
                measured_u=measured_u.tolist())


def run_young_identification(problem, analysis: Dict, family: str, *,
                             resolve_zones, probe_dofs, true_solve,
                             identify_banded, identify_dense=None,
                             centroids=None, report_truth: bool = True,
                             finite: bool = False) -> Dict:
    """The plane / solid / plate / shell identification block (the JAX
    package's per-family runners, one contract): "measured_dofs" +
    "measured_u", or "synthetic" twin data ("zone_young" or "young", with
    "noise" / "seed") measured at "measured_dofs" or the probe nodes;
    "zones" (id lists or centroid boxes); "field", "seed",
    "hidden_layers", "neurons_per_layer"; "banded" (default: past
    DENSE_DOF_LIMIT or with zones; a family without identify_dense is
    always banded); "tolerance", "max_iter", "n_iter", "learning_rate".

    identify_banded / identify_dense(analysis, zones) -> (young, hist,
    field); true_solve(true_young) -> (ndof,) displacements; centroids
    (m, d) or None for the result; report_truth adds the twin-data errors;
    finite maps non-finite numbers to null.

    The JAX package's refusals keep their words and their order, but the
    ones its ADAM loop would raise (zones with a field, malformed zones,
    zones on the dense tier) are raised before the twin-data solve, so a
    refused block launches nothing."""
    from ..solvers.banded_inverse import zone_index
    from ..solvers.newton import DENSE_DOF_LIMIT

    zones = analysis.get("zones")
    if zones is not None:
        zones = resolve_zones(problem, zones)
    synthetic = analysis.get("synthetic")
    measured_dofs, true_young = _twin_truth(problem, analysis, zones, family,
                                            probe_dofs)
    if synthetic is None and ("measured_dofs" not in analysis
                              or "measured_u" not in analysis):
        raise ValueError(f'{family} identification needs "measured_dofs" '
                         f'and "measured_u" (or "synthetic" twin data)')
    banded = True
    if identify_dense is not None:
        banded = analysis.get("banded")
        if banded is None:
            banded = problem.ndof > DENSE_DOF_LIMIT or zones is not None
    if zones is not None:
        if not banded:
            raise ValueError('"zones" rides the banded tier; drop '
                             '"banded": false')
        zone_index(zones, problem.nelm, bool(analysis.get("field", False)))
    if synthetic is not None:
        analysis = _twin_measurement(analysis, measured_dofs, true_young,
                                     true_solve)
    if banded:
        vals, hist, _ = identify_banded(analysis, zones)
    else:
        vals, hist, _ = identify_dense(analysis, zones)
    out = {
        "success": True,
        "analysis": "identification",
        "element_type": family,
        "parameter": "young",
        "method": "banded" if banded else "dense",
        "field": bool(analysis.get("field", False)),
        "young": vals.tolist(),
    }
    if centroids is not None:
        out["centroids"] = np.asarray(centroids).tolist()
    out["loss_history"] = hist[:: max(1, hist.size // 200)].tolist()
    out["final_loss"] = float(hist[-1]) if hist.size else None
    if zones is not None:
        out["zones"] = [np.asarray(z, dtype=int).tolist() for z in zones]
        out["zone_young"] = [float(np.mean(vals[np.asarray(z, dtype=int)]))
                             for z in zones]
    if report_truth and true_young is not None:
        out["synthetic"] = True
        rel = np.abs(vals - true_young) / np.abs(true_young)
        out["max_rel_error"] = float(rel.max())
        if zones is not None and "zone_young" in synthetic:
            out["true_zone_young"] = [float(v) for v in
                                      synthetic["zone_young"]]
            out["zone_rel_error"] = [
                abs(zy - ty) / abs(ty) for zy, ty in
                zip(out["zone_young"], out["true_zone_young"])]
    return _json_finite(out) if finite else out


def adam_options(analysis: Dict, banded: bool) -> Dict:
    """The ADAM and parameterization keys of a continuum identification
    block, with the JAX defaults of its tier."""
    opts = dict(
        n_iter=int(analysis.get("n_iter", 300 if banded else 800)),
        learning_rate=float(analysis.get("learning_rate", 0.05)),
        field=bool(analysis.get("field", False)),
        seed=int(analysis.get("seed", 0)),
        hidden_layers=int(analysis.get("hidden_layers", 2)),
        neurons_per_layer=int(analysis.get("neurons_per_layer", 16)))
    if banded:
        opts.update(tol=float(analysis.get("tolerance", 1e-7)),
                    max_iter=int(analysis.get("max_iter", 20000)))
    return opts


def centroid_zones(problem, zones, cent: np.ndarray, axes: str,
                   what: str = "elements"):
    """Zone specs -> element-id arrays: explicit id lists or centroid
    boxes {"x_min", "x_max", ...} over `axes` (any subset)."""
    keys = [f"{a}_{side}" for a in axes for side in ("min", "max")]
    out = []
    for z in zones:
        if isinstance(z, dict):
            unknown = set(z) - set(keys)
            if unknown:
                raise ValueError(f"unknown zone keys: {sorted(unknown)}")
            sel = np.ones(problem.nelm, dtype=bool)
            for ax, name in enumerate(axes):
                if f"{name}_min" in z:
                    sel &= cent[:, ax] >= float(z[f"{name}_min"])
                if f"{name}_max" in z:
                    sel &= cent[:, ax] <= float(z[f"{name}_max"])
            out.append(np.flatnonzero(sel))
        else:
            out.append(np.asarray(z, dtype=int).reshape(-1))
        if out[-1].size == 0:
            raise ValueError(f"zone {len(out) - 1} selects no {what}")
    return out
