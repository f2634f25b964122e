"""Stationary random-vibration response: PSD in, PSD + RMS out
(counterpart of pinn_fem_tpu/solvers/random_response.py).

For a stationary load f(t) = p(t) * loads with one-sided power spectral
density S_p(omega), linear theory gives per-DOF displacement PSDs

    S_u_j(omega) = |H_j(omega)|^2 S_p(omega)

with H_j the complex FRF of DOF j to the load pattern (harmonic_response
supplies it on whichever of its tiers the problem takes), and RMS values by
quadrature sigma_j^2 = integral S_u_j d omega.

Closed-form anchor: white noise S0 on an SDOF gives exactly
sigma^2 = pi S0 / (2 k c), the textbook result
integral_0^inf dw / ((k - m w^2)^2 + (c w)^2) = pi / (2 k c).

The omega grid is the accuracy knob: it must resolve each resonance peak
(half-power bandwidth 2 zeta omega_n); modal_analysis supplies the peak
locations when building one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np

from ..models.problem import TrussProblem
from .harmonic import harmonic_response


class RandomResponseResult(NamedTuple):
    omegas: np.ndarray       # (n_freq,)
    psd: np.ndarray          # (n_freq, n_probe) one-sided S_u(omega)
    rms: np.ndarray          # (n_probe,) sqrt(integral S_u d omega)
    frf_amplitude: np.ndarray  # (n_freq, n_probe) |H|
    # Member-force statistics at `probe_elements` (fatigue inputs:
    # S_N = |H_N|^2 S_p through the force FRF).
    force_psd: np.ndarray = None    # (n_freq, n_probe_elm)
    force_rms: np.ndarray = None    # (n_probe_elm,)


def random_response(
    problem: TrussProblem,
    load_psd: Union[Callable[[np.ndarray], np.ndarray], float],
    omegas,
    damping=(0.0, 0.0),
    method: str = "direct",
    n_modes: int = 12,
    probe_dofs: Optional[np.ndarray] = None,
    probe_elements: Optional[np.ndarray] = None,
    data=None,
    prestress_u=None,
    device=None,
) -> RandomResponseResult:
    """Displacement PSDs and RMS under a stationary random load.

    Args:
        load_psd: one-sided S_p(omega) of the load multiplier — a
            constant (white noise) or a callable over omega (rad/s).
        omegas: (n_freq,) integration/evaluation grid; must resolve the
            resonance peaks (bandwidth ~ 2 zeta omega_n each).
        prestress_u: initial-stress state forwarded to the FRF
            (harmonic_response) — buffeting of taut structures.
    The port's own: device, where harmonic_response solves when `data`
    is not given ("cuda" when None).
    """
    om = np.asarray(omegas, dtype=float).reshape(-1)
    if om.size < 2 or np.any(np.diff(om) <= 0):
        raise ValueError("omegas must be an increasing grid (>= 2 points)")
    if float(damping[0]) == 0.0 and float(damping[1]) == 0.0:
        # Undamped |H|^2 has non-integrable poles at every resonance: the
        # quadrature would return grid-dependent garbage (and the direct
        # solve is singular if the grid lands on an eigenfrequency).
        raise ValueError("random_response needs nonzero damping — the "
                         "undamped variance integral diverges")
    h = harmonic_response(problem, om, damping=damping, method=method,
                          n_modes=n_modes, probe_dofs=probe_dofs,
                          probe_elements=probe_elements,
                          data=data, prestress_u=prestress_u,
                          device=device)
    sp = (load_psd(om) if callable(load_psd)
          else float(load_psd) * np.ones_like(om))
    # A callable may return a scalar (white noise): broadcast it.
    sp = np.broadcast_to(np.asarray(sp, dtype=float), om.shape)
    if np.any(sp < 0):
        raise ValueError("a PSD cannot be negative")
    h2 = h.amplitude.astype(float) ** 2          # (n_freq, n_probe)
    s_u = h2 * sp[:, None]
    var = np.trapezoid(s_u, om, axis=0)
    s_n = n_rms = None
    if probe_elements is not None:
        s_n = h.force_amplitude.astype(float) ** 2 * sp[:, None]
        n_rms = np.sqrt(np.trapezoid(s_n, om, axis=0))
    return RandomResponseResult(
        omegas=om, psd=s_u, rms=np.sqrt(var),
        frf_amplitude=h.amplitude,
        force_psd=s_n, force_rms=n_rms,
    )
