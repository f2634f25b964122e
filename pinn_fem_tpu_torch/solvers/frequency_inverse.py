"""Frequency-domain identification: material and Rayleigh damping from
measured FRF amplitudes (counterpart of
pinn_fem_tpu/solvers/frequency_inverse.py).

The model is the harmonic forward problem (K + i omega C - omega^2 M) X = F
in the real 2 x 2-block form of the JAX package,

    [[A, -B], [B, A]] [Re X; Im X] = [F; 0],  A = K - omega^2 M,
                                              B = omega (alpha M + beta K),

one batched real solve over the sweep.  The amplitudes |X| = hypot(Re X,
Im X) are differentiable in (log E, log A, log rho, log alpha, log beta)
through torch.linalg.solve's backward; the loss is the mean squared LOG-
amplitude mismatch (an FRF spans decades between anti-resonances and
peaks).  Because the solve is real, no complex number enters autograd, and
the gradient of the real loss is the JAX package's real gradient (torch's
conjugate-Wirtinger rule for complex tensors never applies;
tests/test_torch_identification.py holds a complex128 solve's gradient to
it as a check).  Dense, on the caller's device; each start's losses are
fetched once.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..models.fields import Material
from ..models.problem import TrussProblem
from ..ops.assembly import assemble_system
from ..ops.mass import lumped_mass
from .transient_inverse import (_DAMP_PARAMS, _PARAM_ORDER, _adam_log_fit,
                                _reject_ea_pair, _start_values,
                                unpack_log_params)


def _frf_amplitudes(k, m, mask, f, om, alpha, beta, probe) -> torch.Tensor:
    """(n_freq, n_probe) |X(omega)|, differentiable in k, m, alpha, beta:
    the real block systems of all frequencies in one batched solve
    (identity rows keep the fixed DOFs nonsingular)."""
    n = f.shape[0]
    w = om[:, None, None]
    a = k[None] - (w * w) * torch.diag(m)[None] + torch.diag(1.0 - mask)[None]
    b = w * (alpha * torch.diag(m) + beta * k)[None]
    z = torch.cat([torch.cat([a, -b], dim=2), torch.cat([b, a], dim=2)],
                  dim=1)
    rhs = torch.cat([f, torch.zeros_like(f)]).expand(om.shape[0], 2 * n)
    x = torch.linalg.solve(z, rhs)
    # Only the probe columns enter hypot: its gradient at a fixed DOF's
    # (0, 0) would be 0 / 0.
    return torch.hypot((x[:, :n] * mask)[:, probe],
                       (x[:, n:] * mask)[:, probe])


def frf_probe_amplitudes(problem: TrussProblem, material: Material, omegas,
                         damping, probe_dofs, data=None,
                         device=None) -> torch.Tensor:
    """Differentiable |X(omega)| at the probe DOFs, (n_freq, n_probe).
    `material` and `damping` may carry tensors that require grad.  device:
    where to solve when `data` is not given ("cuda" when None)."""
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    mask = data.free_mask
    k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
    k = mask[:, None] * k * mask[None, :]
    m = lumped_mass(data, material) * mask
    return _frf_amplitudes(
        k, m, mask, data.loads * mask,
        torch.as_tensor(np.asarray(omegas, dtype=float), dtype=dtype,
                        device=dev),
        torch.as_tensor(damping[0], dtype=dtype, device=dev),
        torch.as_tensor(damping[1], dtype=dtype, device=dev),
        torch.as_tensor(np.asarray(probe_dofs, dtype=np.int64), device=dev))


def identify_from_frf(
    problem: TrussProblem,
    measured_amp: np.ndarray,
    omegas,
    probe_dofs,
    params: Sequence[str] = ("young", "density"),
    damping=(0.0, 0.0),
    n_iter: int = 400,
    learning_rate: float = 0.08,
    initial: Dict[str, float] | None = None,
    restarts: int = 1,
    data=None,
    device=None,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Recover scalar parameters from a measured (n_freq, n_probe) FRF
    amplitude sweep: the contract of identify_from_transient (E and A
    only as a product; a zero damping start needs `initial`).  restarts >
    1 reruns the fit from geometrically spaced starts, 2^linspace(-1, 1,
    r) up on stiffness-like parameters and down on density, and keeps the
    lowest final loss (FRF fitting is multi-modal).

    Returns (identified dict, loss history of the best start)."""
    for p in params:
        if p not in _PARAM_ORDER + _DAMP_PARAMS:
            raise ValueError(f"unknown parameter {p!r}")
    _reject_ea_pair(params)
    data = data if data is not None else problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    om = np.asarray(omegas, dtype=float).reshape(-1)
    meas = torch.as_tensor(np.asarray(measured_amp, dtype=float),
                           dtype=dtype, device=dev)
    if meas.dim() != 2 or meas.shape[0] != om.size:
        raise ValueError(f"measured_amp must be (n_freq={om.size}, "
                         f"n_probe) amplitudes, got {tuple(meas.shape)}")
    # 1e-12 of the measured peak keeps exact-zero amplitudes finite.
    floor = 1e-12 * torch.clamp_min(torch.max(meas), 1e-30)
    log_meas = torch.log(meas + floor)
    base = problem.material
    log_p0 = torch.as_tensor(_start_values(params, base, damping,
                                           dict(initial or {})),
                             dtype=dtype, device=dev)

    def loss_fn(log_p):
        mat, damp = unpack_log_params(params, log_p, base, damping, dtype,
                                      dev)
        amp = frf_probe_amplitudes(problem, mat, om, damp, probe_dofs, data)
        return torch.mean((torch.log(amp + floor) - log_meas) ** 2)

    # The start offset that moves the resonances: +log f on stiffness-like
    # parameters, -log f on density (a uniform scale cancels out).
    shift_dir = torch.as_tensor(
        [0.0 if p in _DAMP_PARAMS else (-1.0 if p == "density" else 1.0)
         for p in params], dtype=dtype, device=dev)
    factors = (np.exp(np.log(2.0) * np.linspace(-1.0, 1.0, restarts))
               if restarts > 1 else np.ones(1))
    best = None
    for fac in factors:
        start = log_p0 + torch.as_tensor(np.log(fac), dtype=dtype,
                                         device=dev) * shift_dir
        log_p, hist = _adam_log_fit(loss_fn, start, n_iter, learning_rate)
        if best is None or hist[-1] < best[1][-1]:
            best = (log_p, hist)
    log_p, hist = best
    values = np.exp(log_p.double().cpu().numpy())
    return dict(zip(params, values.tolist())), hist
