"""Modal-domain identification: material parameters from extracted natural
frequencies and, optionally, mode-shape magnitudes (counterpart of
pinn_fem_tpu/solvers/modal_inverse.py).

The forward model is the differentiable generalized eigensolve on the free
block (solvers/modal._dense_eigensolve: the D^-1/2 scaling of the lumped
mass, then torch.linalg.eigh, whose backward carries the gradient through
K and M into the parameters).  The observables are omega^2 and, at sensor
DOFs, phi^2: sign-free (an eigenvector's sign is arbitrary) and density-
sensitive (M-orthonormal shapes scale as 1 / sqrt(rho)).

Frequencies are invariant under a uniform scaling of stiffness and mass
(omega^2 ~ EA / rho), so a spectrum alone fixes only their ratio: a
stiffness-like parameter together with density needs the phi^2 rows.
Rayleigh damping is invisible to undamped frequencies.  Dense, on the
caller's device; the ADAM loop fetches its losses once, at the end.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..models.fields import Material, MLPField, ScalarField
from ..models.problem import TrussProblem
from .modal import _dense_eigensolve, modal_eigenpairs
from .transient_inverse import (_PARAM_ORDER, _adam_layers_fit,
                                _adam_log_fit, _elem_operators,
                                _reject_ea_pair, _scalar_value)

_STIFF_PARAMS = ("young", "area")


def _sensor_index(sensor_dofs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sensor_dofs, dtype=np.int64),
                           device=device)


def modal_observables(problem: TrussProblem, material: Material,
                      n_modes: int, sensor_dofs=None, data=None,
                      lumped: bool = True, device=None):
    """Differentiable (omega^2 (n_modes,), phi^2 at the sensors
    (n_sensor, n_modes)); sensor_dofs=None skips the shapes.  device:
    where to solve when `data` is not given ("cuda" when None)."""
    data = data if data is not None else problem.to_device(device)
    lam, phi = modal_eigenpairs(problem, n_modes=n_modes, lumped=lumped,
                                data=data, material=material)
    if sensor_dofs is None:
        return lam, None
    return lam, phi[_sensor_index(sensor_dofs, data.device), :] ** 2


def modal_observables_elem(problem: TrussProblem, young_e, area_e, rho_e,
                           n_modes: int, sensor_dofs=None, data=None,
                           device=None):
    """Modal observables with per-element material values: the truth
    model of field-identification twin data (lumped mass)."""
    data = data if data is not None else problem.to_device(device)
    k, m = _elem_operators(problem, data, young_e, area_e, rho_e)
    free = torch.as_tensor(problem.free_fixed()[0], device=data.device)
    w, v = _dense_eigensolve(k[free][:, free], m[free], n_modes,
                             lumped=True)
    if sensor_dofs is None:
        return w, None
    phi = torch.zeros((problem.ndof, n_modes), dtype=v.dtype,
                      device=v.device).index_copy(0, free, v)
    return w, phi[_sensor_index(sensor_dofs, data.device), :] ** 2


def _lam_measured(measured_hz, dtype, device):
    f_meas = np.asarray(measured_hz, dtype=float).reshape(-1)
    return f_meas.size, torch.as_tensor((2.0 * np.pi * f_meas) ** 2,
                                        dtype=dtype, device=device)


def _shapes2(measured_shapes2, sensor_dofs, n_modes, dtype, device):
    """(phi^2 tensor, scale) of the measured sensor rows, checked for
    shape (n_sensor, n_modes)."""
    s2 = torch.as_tensor(np.asarray(measured_shapes2, dtype=float),
                         dtype=dtype, device=device)
    n_sensor = np.asarray(sensor_dofs).size
    if tuple(s2.shape) != (n_sensor, n_modes):
        raise ValueError(
            f"measured_shapes2 must be (n_sensor={n_sensor}, "
            f"n_modes={n_modes}), got {tuple(s2.shape)}")
    return s2, torch.clamp_min(torch.max(s2), 1e-30)


def identify_field_from_modal(
    problem: TrussProblem,
    measured_hz,
    sensor_dofs=None,
    measured_shapes2=None,
    field: str = "density",
    nn_field=None,
    n_iter: int = 800,
    learning_rate: float = 0.02,
    lumped: bool = True,
    data=None,
    device=None,
):
    """Recover a spatially varying material field (canonically rho(x)) from
    natural frequencies plus phi^2 sensor rows (required: frequencies
    alone underdetermine a profile).  nn_field: the MLPField to train
    (default getattr(problem.material, field)).  Returns (trained
    MLPField, loss history array)."""
    if field not in _PARAM_ORDER:
        raise ValueError(f"unknown parameter {field!r}")
    if measured_shapes2 is None or sensor_dofs is None:
        raise ValueError(
            "field identification from modal data needs sensor_dofs + "
            "measured_shapes2: a handful of frequencies alone "
            "underdetermines a spatial profile (and for density the "
            "spectrum only sees the stiffness/mass ratio)")
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    base = problem.material.to(dev)
    fld = nn_field if nn_field is not None else getattr(base, field)
    if not isinstance(fld, MLPField):
        raise ValueError(f"{field} must be an MLPField to identify a "
                         "spatial profile; pass nn_field=make_mlp_field(...)")
    n_modes, lam_meas = _lam_measured(measured_hz, dtype, dev)
    s2_meas, s2_scale = _shapes2(measured_shapes2, sensor_dofs, n_modes,
                                 dtype, dev)

    def loss_fn(trial):
        lam, s2 = modal_observables(problem, replace(base, **{field: trial}),
                                    n_modes, sensor_dofs, data,
                                    lumped=lumped)
        return (torch.mean(((lam - lam_meas) / lam_meas) ** 2)
                + torch.mean(((s2 - s2_meas) / s2_scale) ** 2))

    return _adam_layers_fit(loss_fn, fld.to(dev, dtype), n_iter,
                            learning_rate)


def identify_from_modal(
    problem: TrussProblem,
    measured_hz,
    sensor_dofs=None,
    measured_shapes2=None,
    params: Sequence[str] = ("young",),
    n_iter: int = 300,
    learning_rate: float = 0.05,
    initial: Dict[str, float] | None = None,
    lumped: bool = True,
    data=None,
    device=None,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Recover scalar material parameters from extracted modal data:
    measured_hz the k lowest natural frequencies in Hz; sensor_dofs and
    measured_shapes2 optional (n_sensor,) DOFs and (n_sensor, k) phi^2
    rows, required when `params` mixes a stiffness-like parameter with
    density.  Returns (identified dict, loss history array)."""
    for p in params:
        if p not in _PARAM_ORDER:
            raise ValueError(f"unknown parameter {p!r} (damping is "
                             "invisible to undamped frequencies)")
    _reject_ea_pair(params)
    has_stiff = any(p in _STIFF_PARAMS for p in params)
    if has_stiff and "density" in params and measured_shapes2 is None:
        raise ValueError(
            "frequencies alone determine only the stiffness/mass RATIO "
            "(omega^2 ~ EA/rho): identifying "
            f"{[p for p in params if p in _STIFF_PARAMS]} together with "
            "density needs measured_shapes2 (sign-invariant phi^2 at "
            "sensor DOFs; M-orthonormal shapes scale as 1/sqrt(rho))")
    if (measured_shapes2 is None) != (sensor_dofs is None):
        raise ValueError("sensor_dofs and measured_shapes2 go together")
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    n_modes, lam_meas = _lam_measured(measured_hz, dtype, dev)
    s2_meas = None
    if measured_shapes2 is not None:
        s2_meas, s2_scale = _shapes2(measured_shapes2, sensor_dofs, n_modes,
                                     dtype, dev)
    base = problem.material
    init = dict(initial or {})
    log_p0 = torch.as_tensor(
        [np.log(init[p] if p in init else _scalar_value(base, p))
         for p in params], dtype=dtype, device=dev)
    base = base.to(dev)

    def loss_fn(log_p):
        mat = replace(base, **{p: ScalarField(value=torch.exp(log_p[i]))
                               for i, p in enumerate(params)})
        lam, s2 = modal_observables(problem, mat, n_modes, sensor_dofs,
                                    data, lumped=lumped)
        loss = torch.mean(((lam - lam_meas) / lam_meas) ** 2)
        if s2_meas is not None:
            loss = loss + torch.mean(((s2 - s2_meas) / s2_scale) ** 2)
        return loss

    log_p, hist = _adam_log_fit(loss_fn, log_p0, n_iter, learning_rate)
    values = np.exp(log_p.double().cpu().numpy())
    return dict(zip(params, values.tolist())), hist
