"""Time-domain identification: material parameters from a measured
transient response (counterpart of pinn_fem_tpu/solvers/transient_inverse.py).

Statics cannot see density, and modal identification needs extracted
frequencies.  Here the measurement is the raw probe displacement history
under a known load history, and the model is the central-difference
integrator itself: the JAX package differentiates its `lax.scan` over the
time steps; the port runs the same step loop in torch under autograd, so
reverse mode through the integrator (the discrete adjoint) gives the
gradients of the trajectory mismatch with respect to (log E, log A,
log rho) and the Rayleigh coefficients (log alpha, log beta).

Dense K (identification meshes are small), on the caller's device.  No
repo kernel is on this path: the dense matvecs and the step loop are torch
ops (a few thousand small launches a loss evaluation on a card: launch
bound, ROADMAP item 9).  Like the JAX loop, the ADAM loop reads nothing
from the device until it ends: the losses are stacked and fetched once.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..models.fields import Material, MLPField, ScalarField
from ..models.problem import TrussProblem
from ..ops.assembly import _assemble_dense, assemble_system, scatter_add
from ..ops.elements import truss_linear_batch
from ..ops.mass import lumped_mass
from .banded_inverse import adam_fit

_PARAM_ORDER = ("young", "area", "density")
# Rayleigh damping coefficients, identifiable alongside the material.
_DAMP_PARAMS = ("alpha", "beta")


def _reject_ea_pair(params):
    """E and A enter the truss physics only as the product EA (and A pairs
    with rho in the mass the same way): identifying both is exactly
    degenerate, so every identification route refuses the pair."""
    if "young" in params and "area" in params:
        raise ValueError(
            "young and area are not separately identifiable (only the "
            "product EA enters the physics); identify one and fix the "
            "other")


def _probe_history(k, m, mask, loads, amp, dt, alpha, beta, probe,
                   n_steps: int, record_every: int) -> torch.Tensor:
    """(n_rec, n_probe) central-difference displacement history, the JAX
    package's recurrence step for step (its rounding order: the tests
    hold the loss rows to the JAX package's at 1e-4), differentiable in
    k, m and the damping coefficients."""
    inv_m = torch.where(m > 0, 1.0 / m, torch.zeros_like(m))
    dt2 = dt * dt
    forces = amp[:, None] * loads[None, :]      # amp[i] * loads, each step

    def residual(i, u, v_lag):
        return (forces[i] - k @ u - alpha * (m * v_lag)
                - beta * (k @ v_lag))

    u = torch.zeros_like(loads)
    a0 = inv_m * residual(0, u, u) * mask
    u_prev = u + 0.5 * dt2 * a0
    recs = []
    for i in range(n_steps):
        v_lag = (u - u_prev) / dt
        u, u_prev = ((2.0 * u - u_prev + dt2 * inv_m * residual(i, u, v_lag))
                     * mask), u
        if (i + 1) % record_every == 0:
            recs.append(u[probe])
    return torch.stack(recs)


def _amplitude(amplitude, n_steps: int, dtype, device) -> torch.Tensor:
    """(n_steps,) load scale a_i: the JAX index min(i, len - 1), padding
    a short history with its last value."""
    amp = np.ones(n_steps) if amplitude is None else np.asarray(
        amplitude, dtype=float).reshape(-1)
    amp = amp[np.minimum(np.arange(n_steps), amp.size - 1)]
    return torch.as_tensor(amp, dtype=dtype, device=device)


def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def transient_probe_response(problem: TrussProblem, material: Material,
                             dt, n_steps: int, amplitude, probe_dofs,
                             record_every: int = 1, damping=(0.0, 0.0),
                             data=None, device=None) -> torch.Tensor:
    """Differentiable (n_rec, n_probe) probe-displacement history.
    `material` may carry tensors that require grad.  device: where to
    integrate when `data` is not given ("cuda" when None)."""
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
    mask = data.free_mask
    m = lumped_mass(data, material) * mask + (1.0 - mask)
    return _probe_history(
        k, m, mask, data.loads, _amplitude(amplitude, n_steps, dtype, dev),
        _scalar(dt, dtype, dev), _scalar(damping[0], dtype, dev),
        _scalar(damping[1], dtype, dev),
        torch.as_tensor(np.asarray(probe_dofs, dtype=np.int64), device=dev),
        int(n_steps), int(record_every))


def _scalar_value(material: Material, name: str) -> float:
    f = getattr(material, name)
    if not isinstance(f, ScalarField):
        raise ValueError(f"{name} must be a scalar field to initialize "
                         "identification from it; pass initial={...}")
    return float(f.value)


def _adam_log_fit(loss_fn, log_p0: torch.Tensor, n_iter: int,
                  learning_rate: float):
    """n_iter ADAM steps on one parameter tensor; (log_p, losses) with the
    losses read once, at the end."""
    (log_p,), hist = adam_fit(lambda ps: loss_fn(ps[0]), [log_p0], n_iter,
                              learning_rate, read_each_iteration=False)
    return log_p, hist


def _adam_layers_fit(loss_fn, fld: MLPField, n_iter: int,
                     learning_rate: float):
    """ADAM on an MLPField's (W, b) layers (its scale stays fixed, as the
    JAX routes differentiate `layers` only); (trained field, losses read
    once)."""
    def with_layers(params):
        return fld.replace(layers=list(zip(params[0::2], params[1::2])))

    params, hist = adam_fit(lambda ps: loss_fn(with_layers(ps)),
                            fld.trainable_params(), n_iter, learning_rate,
                            read_each_iteration=False)
    return with_layers(params), hist


def _start_values(params, base: Material, damping, init: Dict):
    """Starting values of the identified parameters: `initial`, else the
    material's scalar, else the block's damping (a zero damping start is
    refused: the log parameterization has no gradient there)."""
    def start(p):
        if p in init:
            return init[p]
        if p in _DAMP_PARAMS:
            v = float(damping[_DAMP_PARAMS.index(p)])
            if v <= 0.0:
                raise ValueError(
                    f"identifying {p!r} from a zero starting value needs "
                    f"initial={{{p!r}: <positive guess>}} (log "
                    f"parameterization)")
            return v
        return _scalar_value(base, p)

    return [np.log(start(p)) for p in params]


def unpack_log_params(params, log_p, base: Material, damping, dtype, dev):
    """(material, (alpha, beta)) with the identified entries exp(log_p)."""
    fields, damp = {}, [_scalar(damping[0], dtype, dev),
                        _scalar(damping[1], dtype, dev)]
    for i, p in enumerate(params):
        if p in _PARAM_ORDER:
            fields[p] = ScalarField(value=torch.exp(log_p[i]))
        else:
            damp[_DAMP_PARAMS.index(p)] = torch.exp(log_p[i])
    return replace(base, **fields).to(dev), tuple(damp)


def identify_from_transient(
    problem: TrussProblem,
    measured: np.ndarray,
    dt: float,
    n_steps: int,
    probe_dofs,
    amplitude=None,
    params: Sequence[str] = ("young", "density"),
    record_every: int = 1,
    damping=(0.0, 0.0),
    n_iter: int = 300,
    learning_rate: float = 0.05,
    initial: Dict[str, float] | None = None,
    data=None,
    device=None,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Recover scalar material parameters (and the Rayleigh coefficients)
    from a measured (n_rec, n_probe) probe history, the contract of the
    JAX function: `params` among young / area / density / alpha / beta (E
    and A not together), the others fixed at the material's and
    `damping`'s values; `initial` starting guesses.  device: where to
    integrate when `data` is not given ("cuda" when None).

    Returns (identified dict, loss history array)."""
    for p in params:
        if p not in _PARAM_ORDER + _DAMP_PARAMS:
            raise ValueError(f"unknown parameter {p!r}")
    _reject_ea_pair(params)
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    meas = torch.as_tensor(np.asarray(measured, dtype=float), dtype=dtype,
                           device=dev)
    u_scale = torch.clamp_min(torch.max(torch.abs(meas)), 1e-30)
    base = problem.material
    log_p0 = torch.as_tensor(_start_values(params, base, damping,
                                           dict(initial or {})),
                             dtype=dtype, device=dev)

    def loss_fn(log_p):
        mat, damp = unpack_log_params(params, log_p, base, damping, dtype,
                                      dev)
        traj = transient_probe_response(
            problem, mat, dt, n_steps, amplitude, probe_dofs, record_every,
            damp, data)
        return torch.mean(((traj - meas) / u_scale) ** 2)

    log_p, hist = _adam_log_fit(loss_fn, log_p0, n_iter, learning_rate)
    values = np.exp(log_p.double().cpu().numpy())
    return dict(zip(params, values.tolist())), hist


def _elem_operators(problem: TrussProblem, data, young_e, area_e, rho_e):
    """(K dense, lumped m (ndof,)) from per-element material values."""
    from .sizing import _per_elem

    dtype = data.loads.dtype
    young_e, area_e, rho_e = (_per_elem(v, data.nelm, dtype, data.device)
                              for v in (young_e, area_e, rho_e))
    elem = truss_linear_batch(data.gvec, data.inv_len,
                              torch.zeros(data.dof_map.shape, dtype=dtype,
                                          device=data.device),
                              young_e, area_e)
    k = _assemble_dense(data, elem.ke)
    m_e = rho_e * area_e / data.inv_len
    m = scatter_add(data.ndof, data.dof_map,
                    (0.5 * m_e)[:, None].expand(data.dof_map.shape))
    if data.point_mass is not None:
        m = m + data.point_mass
    return k, m


def transient_probe_response_elem(problem: TrussProblem, young_e, area_e,
                                  rho_e, dt, n_steps: int, amplitude,
                                  probe_dofs, record_every: int = 1,
                                  damping=(0.0, 0.0), data=None,
                                  device=None) -> torch.Tensor:
    """Probe history with per-element material values: the truth model of
    field-identification twin data (a tabulated profile needs no Field
    object)."""
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    k, m = _elem_operators(problem, data, young_e, area_e, rho_e)
    mask = data.free_mask
    m = m * mask + (1.0 - mask)
    return _probe_history(
        k, m, mask, data.loads, _amplitude(amplitude, n_steps, dtype, dev),
        _scalar(dt, dtype, dev), _scalar(damping[0], dtype, dev),
        _scalar(damping[1], dtype, dev),
        torch.as_tensor(np.asarray(probe_dofs, dtype=np.int64), device=dev),
        int(n_steps), int(record_every))


def identify_field_from_transient(
    problem: TrussProblem,
    measured: np.ndarray,
    dt: float,
    n_steps: int,
    probe_dofs,
    field: str = "young",
    nn_field=None,
    amplitude=None,
    record_every: int = 1,
    damping=(0.0, 0.0),
    n_iter: int = 600,
    learning_rate: float = 0.05,
    data=None,
    device=None,
):
    """Recover a spatially varying material field (an MLPField: the
    reference's NN-property parameterization) from a probe history: ADAM
    on the net's (W, b) through the differentiated integrator, stiffness
    and mass at once.  field: "young", "area" or "density"; nn_field: the
    MLPField to train (default getattr(problem.material, field), which
    must then be one).  Returns (trained MLPField, loss history array)."""
    if field not in _PARAM_ORDER:
        raise ValueError(f"unknown parameter {field!r}")
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    base = problem.material
    fld = nn_field if nn_field is not None else getattr(base, field)
    if not isinstance(fld, MLPField):
        raise ValueError(f"{field} must be an MLPField to identify a "
                         "spatial profile; pass nn_field=make_mlp_field(...)")
    fld = fld.to(dev, dtype)
    base = base.to(dev)
    meas = torch.as_tensor(np.asarray(measured, dtype=float), dtype=dtype,
                           device=dev)
    u_scale = torch.clamp_min(torch.max(torch.abs(meas)), 1e-30)

    def loss_fn(trial):
        traj = transient_probe_response(
            problem, replace(base, **{field: trial}), dt, n_steps,
            amplitude, probe_dofs, record_every, damping, data)
        return torch.mean(((traj - meas) / u_scale) ** 2)

    return _adam_layers_fit(loss_fn, fld, n_iter, learning_rate)
