"""Fatigue post-processing: damage estimates from stress PSDs and
stress histories (the port's own copy of pinn_fem_tpu/solvers/fatigue.py,
which imports no JAX; the port imports nothing of that package).

The random-vibration and transient solvers deliver the member-force
quantities (S_N(omega) PSDs, N_e(t) histories); this module turns them
into the numbers a fatigue engineer reports:

- **Spectral moments** m_k = integral omega^k S(omega) d omega of a
  one-sided PSD, and the Rice crossing rates they imply
  (nu_0 = sqrt(m2/m0)/2pi zero up-crossings, nu_p = sqrt(m4/m2)/2pi
  peaks, irregularity alpha_2 = m2/sqrt(m0 m4)).
- **Davenport peak factor** g(nu_0 T) — the expected extreme of a
  stationary Gaussian process over a duration, E[max] ~= g * sigma.
- **Frequency-domain damage rates** for a Basquin S-N curve
  N S^m = C (S = stress AMPLITUDE): the narrow-band (Rayleigh/Miner)
  closed form and the Dirlik rainflow-amplitude approximation — both
  evaluated in closed form via Gamma functions, no pdf quadrature.
- **Rainflow cycle counting** (ASTM E1049-85 three-point method with
  half-cycle residue) and the time-domain Miner damage it implies —
  the ground truth the spectral methods approximate, and the only
  correct method for non-Gaussian/non-stationary histories.
- **Gaussian history synthesis** from a PSD (random-phase cosine sum)
  — the bridge for cross-validating the two domains
  (tests/test_fatigue.py does: synthesize from the PSD, rainflow-count,
  compare to the Dirlik/narrow-band rates).

Everything here is host-side float64 numpy post-processing of already
small probe arrays (n_freq x n_probe, n_steps): the device work is over
by the time fatigue runs.  tests/test_torch_frequency.py holds every
function to the JAX package's at 1e-12, and the synthesized history
bit for bit.

Closed forms used as test anchors:
- SDOF + white noise: nu_0 is EXACTLY the undamped natural frequency
  (m2/m0 = (pi S0/2mc)/(pi S0/2kc) = k/m, independent of damping).
- A sinusoid of amplitude A at frequency f rainflow-counts to exactly
  f full cycles/second of range 2A: damage rate f A^m / C.
- Narrow-band Gaussian: Rayleigh amplitudes give
  E[D]/T = nu_0/C (sqrt(2 m0))^m Gamma(1 + m/2).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

__all__ = [
    "spectral_moments", "crossing_rates", "davenport_peak_factor",
    "narrowband_damage_rate", "dirlik_damage_rate",
    "rainflow_cycles", "rainflow_damage", "synthesize_gaussian_history",
    "SpectralFatigue", "spectral_fatigue", "first_passage_probability",
]

_EULER_GAMMA = 0.5772156649015329


def spectral_moments(omegas, psd, orders=(0, 1, 2, 4)) -> np.ndarray:
    """m_k = integral omega^k S(omega) d omega (trapezoid on the grid).

    Args:
        omegas: (n_freq,) increasing angular-frequency grid (rad/s).
        psd: (n_freq,) or (n_freq, n_q) one-sided PSD(s).
        orders: moment orders k.

    Returns:
        (n_orders,) or (n_orders, n_q) moments.  The integral is over
        the COMPUTED band only — standard practice (the m4 of an ideal
        SDOF response diverges; any physical/band-limited spectrum's
        does not, and the FRF grid defines the band).
    """
    om = np.asarray(omegas, dtype=float).reshape(-1)
    s = np.asarray(psd, dtype=float)
    if s.shape[0] != om.size:
        raise ValueError("psd leading axis must match omegas")
    return np.stack([np.trapezoid((om ** k)[(...,) + (None,) * (s.ndim - 1)]
                                  * s, om, axis=0)
                     for k in orders])


def crossing_rates(m0, m2, m4):
    """(nu_0, nu_p, alpha_2) from spectral moments (Rice formulas).

    nu_0 = sqrt(m2/m0)/2pi zero up-crossing rate [Hz], nu_p =
    sqrt(m4/m2)/2pi peak rate [Hz], alpha_2 = m2/sqrt(m0 m4) = nu_0/nu_p
    irregularity (1 = narrow band).
    """
    m0, m2, m4 = (np.asarray(m, dtype=float) for m in (m0, m2, m4))
    with np.errstate(divide="ignore", invalid="ignore"):
        nu0 = np.sqrt(m2 / m0) / (2.0 * np.pi)
        nup = np.sqrt(m4 / m2) / (2.0 * np.pi)
        alpha2 = m2 / np.sqrt(m0 * m4)
    return nu0, nup, alpha2


def davenport_peak_factor(nu0, duration):
    """Expected-extreme factor g: E[max |x|] ~= g sqrt(m0) over T seconds.

    Davenport (1964): g = sqrt(2 ln(nu_0 T)) + gamma_E/sqrt(2 ln(nu_0 T))
    for a stationary Gaussian process with nu_0 T >> 1.  Below
    nu_0 T = e (where the asymptotic turns over) the factor is clamped
    to its value there — the formula is meaningless for records shorter
    than a few cycles anyway.
    """
    nu0 = np.asarray(nu0, dtype=float)
    n = np.maximum(nu0 * float(duration), math.e)
    root = np.sqrt(2.0 * np.log(n))
    return root + _EULER_GAMMA / root


def narrowband_damage_rate(m0, nu0, sn_exponent, sn_coefficient):
    """Miner damage per second, narrow-band (Rayleigh amplitude) model.

    For Basquin N S^m = C and Rayleigh-distributed stress amplitudes
    (sigma^2 = m0 of the STRESS psd):
        E[D]/T = nu_0 / C * (sqrt(2 m0))^m * Gamma(1 + m/2).
    Conservative for broad-band processes (alpha_2 < 1) — Dirlik
    corrects that.
    """
    m = float(sn_exponent)
    m0 = np.asarray(m0, dtype=float)
    return (np.asarray(nu0, dtype=float) / float(sn_coefficient)
            * np.sqrt(2.0 * m0) ** m * math.gamma(1.0 + m / 2.0))


def dirlik_damage_rate(m0, m1, m2, m4, sn_exponent, sn_coefficient):
    """Miner damage per second, Dirlik's rainflow-amplitude pdf.

    Dirlik (1985) fits the rainflow amplitude distribution of a
    stationary Gaussian process as an exponential + two Rayleighs in
    the normalized amplitude Z = S / sqrt(m0); the Basquin damage
    integral then has the closed form

        E[D]/T = nu_p / C * sqrt(m0)^m *
                 [D1 Q^m Gamma(1+m) + sqrt(2)^m Gamma(1+m/2)
                                      (D2 |R|^m + D3)]

    with the standard parameters from (m0, m1, m2, m4).  Reduces to
    the narrow-band rate as alpha_2 -> 1 (tests pin this limit).
    """
    m0, m1, m2, m4 = (np.asarray(v, dtype=float) for v in (m0, m1, m2, m4))
    mexp = float(sn_exponent)
    with np.errstate(divide="ignore", invalid="ignore"):
        xm = m1 / m0 * np.sqrt(m2 / m4)
        alpha2 = m2 / np.sqrt(m0 * m4)
        d1 = 2.0 * (xm - alpha2 ** 2) / (1.0 + alpha2 ** 2)
        r = ((alpha2 - xm - d1 ** 2)
             / (1.0 - alpha2 - d1 + d1 ** 2))
        d2 = (1.0 - alpha2 - d1 + d1 ** 2) / (1.0 - r)
        d3 = 1.0 - d1 - d2
        q = 1.25 * (alpha2 - d3 - d2 * r) / d1
        nup = np.sqrt(m4 / m2) / (2.0 * np.pi)
        rate = (nup / float(sn_coefficient) * np.sqrt(m0) ** mexp
                * (d1 * q ** mexp * math.gamma(1.0 + mexp)
                   + np.sqrt(2.0) ** mexp * math.gamma(1.0 + mexp / 2.0)
                   * (d2 * np.abs(r) ** mexp + d3)))
    return rate


class SpectralFatigue(NamedTuple):
    """Frequency-domain fatigue summary of one or more stress PSDs."""
    m0: np.ndarray            # (n_q,) variance (sigma^2)
    rms: np.ndarray           # (n_q,) sqrt(m0)
    nu0: np.ndarray           # (n_q,) zero up-crossing rate [Hz]
    nu_peak: np.ndarray       # (n_q,) peak rate [Hz]
    alpha2: np.ndarray        # (n_q,) irregularity factor
    damage_rate: np.ndarray   # (n_q,) Miner damage per second
    life: np.ndarray          # (n_q,) 1/damage_rate [s] (inf if zero)
    method: str               # "dirlik" | "narrowband"
    peak_factor: Optional[np.ndarray] = None    # (n_q,) if duration given
    expected_peak: Optional[np.ndarray] = None  # (n_q,) g * rms


def spectral_fatigue(omegas, psd, sn_exponent=None, sn_coefficient=None,
                     method: str = "dirlik",
                     duration: Optional[float] = None) -> SpectralFatigue:
    """One-call frequency-domain fatigue summary of stress PSD(s).

    Args:
        omegas: (n_freq,) rad/s grid (must resolve the resonance peaks —
            the same grid-quality contract as random_response).
        psd: (n_freq,) or (n_freq, n_q) one-sided STRESS PSDs.  (Feed
            force PSDs divided by area^2; run_random does.)
        sn_exponent / sn_coefficient: Basquin N S^m = C, S = amplitude.
            Omit both for the STATISTICS-ONLY summary (moments, crossing
            rates, peak factor — no material curve needed; damage_rate
            and life come back None).
        method: "dirlik" (default — rainflow-calibrated) or
            "narrowband" (conservative Rayleigh/Miner bound).
        duration: optional record length [s] — adds the Davenport
            expected-extreme estimate (peak_factor, expected_peak).
    """
    if method not in ("dirlik", "narrowband"):
        raise ValueError('fatigue method must be "dirlik" or "narrowband"')
    if (sn_exponent is None) != (sn_coefficient is None):
        raise ValueError("give both sn_exponent and sn_coefficient, or "
                         "neither (statistics-only)")
    moms = spectral_moments(omegas, psd, orders=(0, 1, 2, 4))
    m0, m1, m2, m4 = moms
    one_d = np.ndim(m0) == 0
    m0, m1, m2, m4 = (np.atleast_1d(v) for v in (m0, m1, m2, m4))
    if np.any(m0 <= 0.0):
        raise ValueError("a stress PSD with zero variance has no fatigue "
                         "content — check the probe/grid")
    nu0, nup, alpha2 = crossing_rates(m0, m2, m4)
    if sn_exponent is None:
        rate = life = None
    else:
        if method == "dirlik":
            rate = dirlik_damage_rate(m0, m1, m2, m4,
                                      sn_exponent, sn_coefficient)
        else:
            rate = narrowband_damage_rate(m0, nu0,
                                          sn_exponent, sn_coefficient)
        with np.errstate(divide="ignore"):
            life = np.where(rate > 0.0, 1.0 / np.maximum(rate, 1e-300),
                            np.inf)
    g = peak = None
    if duration is not None:
        g = davenport_peak_factor(nu0, duration)
        peak = g * np.sqrt(m0)
    if one_d:
        (m0, nu0, nup, alpha2) = (v[0] for v in (m0, nu0, nup, alpha2))
        if rate is not None:
            rate, life = rate[0], life[0]
        if g is not None:
            g, peak = g[0], peak[0]
    return SpectralFatigue(m0=m0, rms=np.sqrt(m0), nu0=nu0, nu_peak=nup,
                           alpha2=alpha2, damage_rate=rate, life=life,
                           method=method, peak_factor=g,
                           expected_peak=peak)


def first_passage_probability(omegas, psd, barrier, duration,
                              two_sided: bool = True):
    """(crossing_rate_hz, pf) of a stationary Gaussian response
    exceeding a barrier within a duration — the serviceability/survival
    question the random-vibration block's PSDs answer.

    Rice's formula gives the up-crossing rate of level b as
    nu(b) = nu_0 exp(-b^2 / 2 m_0) (nu_0 = sqrt(m2/m0)/2pi from the
    response PSD); with |x| barriers (the usual case) the rate doubles.
    The Poisson approximation P = 1 - exp(-nu(b) T) assumes independent
    crossings — asymptotically exact for high barriers, conservative
    for narrow-band response at low ones (clumping), which is the
    standard engineering direction of error.  Cross-validated against
    first-passage counting on synthesized Gaussian sample paths
    (tests/test_fatigue.py).

    Args:
        omegas: (n_freq,) rad/s grid.
        psd: (n_freq,) or (n_freq, n_q) one-sided response PSD(s).
        barrier: level b > 0 (scalar or per-quantity).
        duration: exposure T [s].
        two_sided: count |x| >= b (default) or up-crossings of +b only.

    Returns:
        (nu_b, pf): crossing rate(s) [Hz] and first-passage
        probability(ies), shaped like the PSD's quantity axis.
    """
    b = np.asarray(barrier, dtype=float)
    if np.any(b <= 0.0):
        raise ValueError("barrier must be positive")
    if duration <= 0.0:
        raise ValueError("duration must be positive")
    m0, m2 = spectral_moments(omegas, psd, orders=(0, 2))
    if np.any(m0 <= 0.0):
        raise ValueError("a response PSD with zero variance has no "
                         "crossings — check the probe/grid")
    nu0 = np.sqrt(m2 / m0) / (2.0 * np.pi)
    nu_b = nu0 * np.exp(-b * b / (2.0 * m0))
    if two_sided:
        nu_b = 2.0 * nu_b
    return nu_b, -np.expm1(-nu_b * float(duration))


def _reversals(series: np.ndarray) -> np.ndarray:
    """Turning points of a series (first/last samples kept)."""
    x = np.asarray(series, dtype=float).reshape(-1)
    if x.size < 2:
        return x
    d = np.diff(x)
    # Collapse exact plateaus so sign changes are detectable.
    keep = np.concatenate([[True], d != 0.0])
    x = x[keep]
    if x.size < 3:
        return x
    s = np.sign(np.diff(x))
    interior = s[1:] * s[:-1] < 0.0
    mask = np.concatenate([[True], interior, [True]])
    return x[mask]


def rainflow_cycles(series) -> np.ndarray:
    """ASTM E1049-85 rainflow counting (three-point + residue).

    Returns (n_cycles, 3) rows [range, mean, count] with count 1.0 for
    closed cycles and 0.5 for the residue half-cycles.  Pinned against
    the standard's own worked example in tests/test_fatigue.py.
    """
    pts = list(_reversals(series))
    cycles = []
    stack: list = []
    for p in pts:
        stack.append(p)
        while len(stack) >= 3:
            x = abs(stack[-1] - stack[-2])
            y = abs(stack[-2] - stack[-3])
            if x < y:
                break
            if len(stack) == 3:
                # Y contains the starting point: count as half, drop it.
                cycles.append((y, 0.5 * (stack[0] + stack[1]), 0.5))
                stack.pop(0)
            else:
                cycles.append((y, 0.5 * (stack[-2] + stack[-3]), 1.0))
                del stack[-3:-1]
    for a, b in zip(stack[:-1], stack[1:]):
        cycles.append((abs(b - a), 0.5 * (a + b), 0.5))
    if not cycles:
        return np.zeros((0, 3))
    return np.asarray(cycles, dtype=float)


def rainflow_damage(series, duration, sn_exponent, sn_coefficient):
    """(damage_rate, n_cycles) — time-domain Miner sum over rainflow
    cycles of a stress history spanning `duration` seconds.

    Stress amplitude of a cycle is range/2 (means are returned by
    rainflow_cycles for mean-stress corrections, but the plain Basquin
    sum here ignores them — matching what the spectral methods model).
    """
    c = rainflow_cycles(series)
    if c.shape[0] == 0:
        return 0.0, 0.0
    amp = 0.5 * c[:, 0]
    dmg = float(np.sum(c[:, 2] * amp ** float(sn_exponent))
                / float(sn_coefficient))
    return dmg / float(duration), float(np.sum(c[:, 2]))


def synthesize_gaussian_history(omegas, psd, dt, n_steps, seed=0):
    """Stationary Gaussian sample path from a one-sided PSD.

    Random-phase cosine sum x(t) = sum_k sqrt(2 S(w_k) dw_k)
    cos(w_k t + phi_k) on the PSD's own grid — variance reproduces
    m0 by construction (the standard spectral-representation method).
    Used to cross-validate rainflow vs Dirlik/narrow-band rates.
    """
    om = np.asarray(omegas, dtype=float).reshape(-1)
    s = np.asarray(psd, dtype=float).reshape(-1)
    dw = np.gradient(om)
    amp = np.sqrt(2.0 * s * dw)
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.0, 2.0 * np.pi, om.size)
    t = np.arange(int(n_steps)) * float(dt)
    return np.sum(amp[None, :] * np.cos(t[:, None] * om[None, :]
                                        + phi[None, :]), axis=1)
