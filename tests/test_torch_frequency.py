"""The port's frequency-domain analyses (solvers/fatigue.py,
solvers/harmonic.py, solvers/random_response.py, solvers/spectrum.py),
their "harmonic", "random" and "spectrum" documents and a transient's
"probe_elements" / "fatigue" keys against the JAX package, on the CPU.

Each case gives the same inputs, made by numpy, to both packages.  The
float64 tiers (fatigue, the dense default of harmonic_response, random
vibration and response spectra below DENSE_DOF_LIMIT) are held to the JAX
host tier at 1e-10 or tighter; the float32 tiers at the gaps measured here
times a margin, never tighter than the JAX package's own floors.  Mode
shapes have arbitrary signs, so modal participations are compared by
magnitude.  Quantities of zero-force members (stress RMS at float64 noise,
~1e-14 of the largest) are noise in both packages and left out.
"""

import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu.solvers.newton as j_newton  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io import analysis as j_analysis  # noqa: E402
from pinn_fem_tpu.solvers import fatigue as j_fat  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
import pinn_fem_tpu_torch.solvers.modal as t_modal  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io import analysis as t_analysis  # noqa: E402
from pinn_fem_tpu_torch.solvers import fatigue as t_fat  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"

# Fatigue is the same float64 numpy in both packages: measured 0.
FATIGUE_RTOL = 1e-12
# The dense float64 tiers: torch eigh against LAPACK's, measured up to
# 2.3e-12 of the largest value (random's PSDs near the tower's lightly
# damped resonances; spectra 1.2e-13); bound 1e-10.
F64_RTOL = 1e-10
# Below this fraction of the largest member stress RMS a member carries
# no force: its crossing rates are a ratio of float64 noise in both.
ZERO_FORCE = 1e-10
# The direct float32 sweep against the JAX package's (_direct_sweep_jit):
# measured up to 2.6e-6 (damped) and 6.8e-5 (beta-only, the chain's and
# the grid's lightest modes) of max |X|; bound 1e-4.
DIRECT_RTOL = 1e-4
# The port's banded path (25 subspace iterations in float32) against the
# JAX package's float64 modal superposition and combination of the same
# modes: measured X 2.1e-5 of max |X|, spectrum 1.4e-6; held to
# tests/test_torch_modal.py's BANDED_RTOL.
BANDED_RTOL = 6e-3
BANDED_LIMIT = 16          # DENSE_DOF_LIMIT patched below the 40-bar chain
# Transient documents with probe_elements through both CLIs: histories
# within tests/test_torch_dynamics.py's CLI_RTOL of the largest JAX value
# (measured 9.6e-6), rainflow damage within 3 x that, member by member
# (the S-N exponent m = 3 triples a stress error; measured 1.3e-5).
CLI_RTOL = 2e-4
DAMAGE_RTOL = 3 * CLI_RTOL


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, real or complex."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@contextlib.contextmanager
def dense_limit(limit, jax_too=True):
    """DENSE_DOF_LIMIT of the port's (and the JAX package's) Newton
    module set to `limit`."""
    saved = (j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT)
    t_newton.DENSE_DOF_LIMIT = limit
    if jax_too:
        j_newton.DENSE_DOF_LIMIT = limit
    try:
        yield
    finally:
        j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT = saved


def chain(pkg, n_elm=6, fixed_end=False, load_at=None):
    """The 1D chain of tests/test_harmonic.py (tip load, fixed at 0); with
    fixed_end fixed at both ends and loaded at `load_at`."""
    n = n_elm + 1
    loads = np.zeros(n)
    loads[n - 1 if load_at is None else load_at] = 1.0
    fixed = np.array([0, n - 1] if fixed_end else [0])
    return pkg.TrussProblem(
        np.arange(n, dtype=float),
        np.stack([np.arange(n - 1), np.arange(1, n)], 1),
        pkg.Material(young=3.0, area=0.7, density=2.0), loads, fixed, 1)


def tower(pkg, stories=4, top_load=(0.3, -1.0)):
    """The cross-braced 2-chord tower of tests/test_torch_modal.py."""
    nodes, elements = [], []
    for s in range(stories + 1):
        nodes += [[0.0, float(s)], [1.0, float(s)]]
    for s in range(stories):
        a, b, c, d = 2 * s, 2 * s + 1, 2 * s + 2, 2 * s + 3
        elements += [[a, c], [b, d], [c, d], [a, d], [b, c]]
    loads = np.zeros(2 * len(nodes))
    for node in (2 * stories, 2 * stories + 1):
        loads[2 * node: 2 * node + 2] = top_load
    return pkg.TrussProblem(np.array(nodes), np.array(elements),
                            pkg.Material(young=1000.0, area=1.0, density=1.0),
                            loads, np.array([0, 1, 2, 3]), 2)


def tower_omegas(n=60):
    w = tp.modal_analysis(tower(tp), n_modes=4, device="cpu").omegas
    return np.linspace(0.5 * w[0], 1.2 * w[-1], n)


def complex_x(res):
    return res.real + 1j * res.imag


# ------------------------------------------------------------- fatigue

def psd_pair(seed=3):
    """A broad-band two-peak PSD of three quantities on a 300-point grid."""
    rng = np.random.default_rng(seed)
    om = np.linspace(0.2, 40.0, 300)
    peaks = rng.uniform(3.0, 30.0, (2, 3))
    widths = rng.uniform(0.5, 2.0, (2, 3))
    psd = sum(rng.uniform(0.5, 2.0, 3) / (1.0 + ((om[:, None] - peaks[i])
                                                / widths[i]) ** 2)
              for i in range(2))
    return om, psd


def history(seed=5, n=3000):
    om, psd = psd_pair(seed)
    return j_fat.synthesize_gaussian_history(om, psd[:, 0], 0.01, n,
                                             seed=seed)


FATIGUE_CASES = {
    "spectral_moments": lambda f: f.spectral_moments(*psd_pair()),
    "spectral_moments_1d": lambda f: f.spectral_moments(
        psd_pair()[0], psd_pair()[1][:, 1], orders=(0, 2, 3)),
    "crossing_rates": lambda f: f.crossing_rates(
        *f.spectral_moments(*psd_pair(), orders=(0, 2, 4))),
    "davenport_peak_factor": lambda f: f.davenport_peak_factor(
        np.array([0.01, 0.5, 3.0]), 600.0),
    "narrowband_damage_rate": lambda f: f.narrowband_damage_rate(
        np.array([1.5, 4.0]), np.array([0.8, 2.5]), 3.0, 1e8),
    "dirlik_damage_rate": lambda f: f.dirlik_damage_rate(
        *f.spectral_moments(*psd_pair()), 4.0, 1e9),
    "spectral_fatigue_dirlik": lambda f: f.spectral_fatigue(
        *psd_pair(), 3.0, 1e8, duration=3600.0),
    "spectral_fatigue_narrowband": lambda f: f.spectral_fatigue(
        psd_pair()[0], psd_pair()[1][:, 2], 5.0, 1e12,
        method="narrowband"),
    "spectral_fatigue_statistics": lambda f: f.spectral_fatigue(
        *psd_pair(), duration=60.0),
    "first_passage_two_sided": lambda f: f.first_passage_probability(
        *psd_pair(), np.array([1.0, 2.0, 3.0]), 100.0),
    "first_passage_one_sided": lambda f: f.first_passage_probability(
        psd_pair()[0], psd_pair()[1][:, 0], 2.5, 30.0, two_sided=False),
    "reversals": lambda f: f._reversals(history()),
    "rainflow_cycles": lambda f: f.rainflow_cycles(history()),
    "rainflow_astm": lambda f: f.rainflow_cycles(
        [-2.0, 1.0, -3.0, 5.0, -1.0, 3.0, -4.0, 4.0, -2.0]),
    "rainflow_damage": lambda f: f.rainflow_damage(history(), 30.0, 3.0,
                                                   1e8),
    "rainflow_plateaus": lambda f: f.rainflow_damage(
        [0.0, 1.0, 1.0, 1.0, -1.0, -1.0, 2.0], 1.0, 3.0, 1.0),
}


def flat(value) -> list:
    """Every array of a (possibly nested) result, in order."""
    if isinstance(value, tuple):
        return [a for v in value for a in flat(v)]
    if value is None or isinstance(value, str):
        return []
    return [np.asarray(value, dtype=float)]


@pytest.mark.parametrize("case", list(FATIGUE_CASES))
def test_fatigue_matches_jax(case):
    """Every public function of solvers/fatigue.py (and _reversals) on
    seeded PSDs and histories, float64."""
    want, got = (FATIGUE_CASES[case](f) for f in (j_fat, t_fat))
    assert type(got).__name__ == type(want).__name__
    want, got = flat(want), flat(got)
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=FATIGUE_RTOL, atol=0.0)


def test_synthesized_history_is_bit_equal():
    om, psd = psd_pair(11)
    for seed in (0, 7):
        want = j_fat.synthesize_gaussian_history(om, psd[:, 1], 0.02, 2000,
                                                 seed=seed)
        got = t_fat.synthesize_gaussian_history(om, psd[:, 1], 0.02, 2000,
                                                seed=seed)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("call, match", [
    (lambda f: f.spectral_fatigue(*psd_pair(), method="rainflow"),
     "dirlik"),
    (lambda f: f.spectral_fatigue(*psd_pair(), 3.0), "both"),
    (lambda f: f.spectral_fatigue(psd_pair()[0],
                                  np.zeros_like(psd_pair()[0])), "zero"),
    (lambda f: f.first_passage_probability(*psd_pair(), -1.0, 1.0),
     "barrier"),
    (lambda f: f.spectral_moments(np.arange(3.0), np.ones(4)), "leading"),
])
def test_fatigue_value_errors_kept(call, match):
    for f in (j_fat, t_fat):
        with pytest.raises(ValueError, match=match):
            call(f)


# ------------------------------------------------- harmonic: float64 tier

def prestress():
    from pinn_fem_tpu.ops.host import host_static_solve

    return 0.3 * host_static_solve(tower(jp))


@pytest.mark.parametrize("prestressed", [False, True])
@pytest.mark.parametrize("method", ["direct", "modal"])
def test_dense_harmonic_matches_jax_host_tier(prestressed, method):
    """The tower's dense default (full float64 basis; "modal": truncated
    to 4 modes), with member-force FRFs and a prestress state."""
    om = tower_omegas()
    kw = dict(damping=(0.05, 0.002), method=method, n_modes=4,
              probe_dofs=np.array([16, 17, 19]),
              probe_elements=np.array([0, 3, 7, 19]))
    u0 = prestress() if prestressed else None
    j = jp.harmonic_response(tower(jp), om, prestress_u=u0, **kw)
    t = tp.harmonic_response(tower(tp), om, prestress_u=u0, device="cpu",
                             **kw)
    assert t.real.dtype == np.float64 and t.real.shape == j.real.shape
    assert rel_err(complex_x(t), complex_x(j)) <= F64_RTOL
    assert rel_err(t.force_real + 1j * t.force_imag,
                   j.force_real + 1j * j.force_imag) <= F64_RTOL
    np.testing.assert_allclose(t.amplitude, j.amplitude,
                               atol=F64_RTOL * j.amplitude.max())
    np.testing.assert_allclose(t.residual, j.residual,
                               atol=F64_RTOL, rtol=F64_RTOL)
    assert np.array_equal(t.flagged, j.flagged)


def test_dense_harmonic_phase_convention_and_cache():
    """Undamped: exact zeros in Im X take the -0.0 sign, so a negative
    real FRF has phase -pi on both packages' tiers.  The basis is cached
    while the material and prestress_u are the same objects."""
    om = np.array([0.1, 0.9, 2.0, 3.5])
    j = jp.harmonic_response(chain(jp), om)
    p = chain(tp)
    t = tp.harmonic_response(p, om, device="cpu")
    np.testing.assert_array_equal(t.imag, j.imag)
    np.testing.assert_allclose(t.phase, j.phase, atol=1e-12)
    assert np.any(t.phase == -np.pi)
    cached = p._host_frf_cache
    tp.harmonic_response(p, om, device="cpu", host=True)
    assert p._host_frf_cache is cached
    p.material = tp.Material(young=6.0, area=0.7, density=2.0)
    t2 = tp.harmonic_response(p, om, device="cpu")
    assert p._host_frf_cache is not cached
    assert rel_err(t2.real, 0.5 * t.real) > 1e-3   # not the old basis


# ----------------------------------------- harmonic: the float32 sweeps

def small_grid(pkg):
    from pinn_fem_tpu_torch.examples_grid import grid_arrays

    nodes, elements, loads, fixed = grid_arrays(6, 8)
    return pkg.TrussProblem(nodes, elements,
                            pkg.Material(young=1.0, area=1.0, density=1.0),
                            loads, fixed, 2)


@pytest.mark.parametrize("mesh", ["chain", "grid"])
@pytest.mark.parametrize("damping", [(0.05, 0.002), (0.0, 1e-4)])
def test_direct_sweep_matches_jax(mesh, damping):
    """host=False: the real 2x2 block LU sweep in float32, 30 frequencies
    over the lowest four resonances (one chunk)."""
    make = {"chain": chain, "grid": small_grid}[mesh]
    w = tp.modal_analysis(make(tp), n_modes=4, device="cpu").omegas
    om = np.linspace(0.5 * w[0], 1.2 * w[-1], 30)
    j = jp.harmonic_response(make(jp), om, damping=damping, host=False)
    t = tp.harmonic_response(make(tp), om, damping=damping, host=False,
                             device="cpu")
    assert t.real.dtype == np.float32
    assert rel_err(complex_x(t), complex_x(j)) <= DIRECT_RTOL
    assert np.array_equal(t.flagged, j.flagged)
    assert np.all(np.isfinite(t.residual)) and t.residual.max() < 1e-3


def test_direct_sweep_flags_near_resonant_drift():
    """tests/test_harmonic.py:247: driven within 1e-7 of an undamped
    resonance, the float32 solution drifts and both packages flag the
    point; the far points agree and stay unflagged."""
    wj = float(tp.modal_analysis(chain(tp), n_modes=2,
                                 device="cpu").omegas[1])
    om = np.array([0.3 * wj, wj * (1.0 + 1e-7), 2.0 * wj])
    j = jp.harmonic_response(chain(jp), om, host=False)
    t = tp.harmonic_response(chain(tp), om, host=False, device="cpu")
    assert np.array_equal(t.flagged, j.flagged)
    assert list(t.flagged) == [False, True, False]
    keep = ~t.flagged
    assert rel_err(complex_x(t)[keep], complex_x(j)[keep]) <= DIRECT_RTOL
    h = tp.harmonic_response(chain(tp), om, host=True)
    assert not h.flagged.any()


def test_modal_sweep_on_the_banded_path_matches_jax(monkeypatch):
    """method="modal" with the port's DENSE_DOF_LIMIT below the 40-bar
    chain: the subspace iteration's block solves (ops.dia.dia_cg_solve:
    the plain PCG recurrence here, kernels 1-3 on a card), then the
    superposition and the truncation residual in float32; against the
    JAX package's float64 modal superposition of the same three modes."""
    from pinn_fem_tpu_torch.ops import dia as t_dia

    solves = []
    inner = t_dia.dia_cg_solve
    monkeypatch.setattr(t_dia, "dia_cg_solve",
                        lambda *a, **k: solves.append(a) or inner(*a, **k))
    w = tp.modal_analysis(chain(tp, 40, True, 13), n_modes=3,
                          device="cpu").omegas
    om = np.linspace(0.5 * w[0], 1.2 * w[-1], 60)
    kw = dict(damping=(0.01, 0.01), method="modal", n_modes=3,
              probe_elements=np.array([0, 5, 20]))
    j = jp.harmonic_response(chain(jp, 40, True, 13), om, **kw)
    with dense_limit(BANDED_LIMIT, jax_too=False):
        t = tp.harmonic_response(chain(tp, 40, True, 13), om, device="cpu",
                                 **kw)
    assert len(solves) == 25 * 10       # n_iter x k block solves
    assert t.real.dtype == np.float32
    assert rel_err(complex_x(t), complex_x(j)) <= BANDED_RTOL
    assert rel_err(t.force_amplitude, j.force_amplitude) <= BANDED_RTOL
    np.testing.assert_allclose(t.residual, j.residual, rtol=BANDED_RTOL)
    assert np.all(t.residual == t.residual[0]) and t.residual[0] > 0.5


# ------------------------------------------------------ random vibration

@pytest.mark.parametrize("psd", ["white", "callable"])
def test_random_response_matches_jax(psd):
    om = tower_omegas(120)
    load_psd = (0.02 if psd == "white"
                else (lambda w: 0.01 * (1.0 + np.cos(w))))
    kw = dict(damping=(0.05, 0.002), probe_dofs=np.array([16, 17]),
              probe_elements=np.array([1, 4, 8]))
    j = jp.random_response(tower(jp), load_psd, om, **kw)
    t = tp.random_response(tower(tp), load_psd, om, device="cpu", **kw)
    for key in ("psd", "rms", "frf_amplitude", "force_psd", "force_rms"):
        assert rel_err(getattr(t, key), getattr(j, key)) <= F64_RTOL, key


def test_random_response_needs_damping():
    for pkg in (jp, tp):
        with pytest.raises(ValueError, match="nonzero damping"):
            pkg.random_response(chain(pkg), 1.0, [0.5, 1.0])


# ---------------------------------------------------- response spectrum

SPECTRA = {
    "flat": 2.0,
    "tabulated": {"omegas": [0.0, 5.0, 20.0, 80.0],
                  "values": [1.0, 2.5, 1.5, 0.4]},
    "history": {"history": {"type": "sine", "frequency_hz": 1.3},
                "dt": 0.01, "n_steps": 800, "scale": 0.5},
}


@pytest.mark.parametrize("combination", ["srss", "cqc"])
@pytest.mark.parametrize("sa", list(SPECTRA))
def test_response_spectrum_matches_jax(sa, combination):
    analysis = {"sa": SPECTRA[sa], "damping_ratio": 0.05}
    spectra = [mod._sa_callable(analysis) for mod in (
        __import__("pinn_fem_tpu.io._common", fromlist=["x"]),
        __import__("pinn_fem_tpu_torch.io._common", fromlist=["x"]))]
    kw = dict(direction=[1.0, 0.3], n_modes=5, combination=combination)
    j = jp.response_spectrum(tower(jp), spectra[0], **kw)
    t = tp.response_spectrum(tower(tp), spectra[1], device="cpu", **kw)
    for key in ("displacements", "axial_forces", "omegas",
                "effective_mass"):
        assert rel_err(getattr(t, key), getattr(j, key)) <= F64_RTOL, key
    assert rel_err(np.abs(t.participation),
                   np.abs(j.participation)) <= F64_RTOL
    assert t.mass_fraction == pytest.approx(j.mass_fraction, rel=F64_RTOL)
    assert t.combination == j.combination and t.modal_ok == j.modal_ok


@pytest.mark.parametrize("rule", ["srss", "100-30"])
def test_directional_combination_matches_jax(rule):
    kw = dict(n_modes=4, combination="cqc", rule=rule)
    dirs = [[1.0, 0.0], [0.0, 1.0]]
    j = jp.directional_combination(tower(jp), 2.0, dirs, **kw)
    t = tp.directional_combination(tower(tp), 2.0, dirs, device="cpu", **kw)
    for key in ("displacements", "axial_forces"):
        assert rel_err(getattr(t, key), getattr(j, key)) <= F64_RTOL, key
    assert t.rule == j.rule and len(t.per_direction) == 2


def test_spectrum_from_history_matches_jax():
    rng = np.random.default_rng(2)
    accel = rng.normal(size=1500)
    om = np.linspace(0.5, 60.0, 40)
    j = jp.spectrum_from_history(accel, 0.01, om, 0.03)
    t = tp.spectrum_from_history(accel, 0.01, om, 0.03)
    for key in ("sd", "psv", "psa", "sa_abs"):
        np.testing.assert_allclose(getattr(t, key), getattr(j, key),
                                   rtol=FATIGUE_RTOL)


def test_banded_spectrum_matches_jax_float64(monkeypatch):
    """The 40-bar chain on the port's banded path (its limit patched; 25
    subspace iterations), against the JAX float64 modal combination."""
    runs = []
    inner = t_modal._subspace_iteration
    monkeypatch.setattr(t_modal, "_subspace_iteration",
                        lambda *a, **k: runs.append(a) or inner(*a, **k))
    kw = dict(n_modes=3, combination="cqc")
    j = jp.response_spectrum(chain(jp, 40, True, 13), 2.0, **kw)
    with dense_limit(BANDED_LIMIT, jax_too=False):
        t = tp.response_spectrum(chain(tp, 40, True, 13), 2.0, device="cpu",
                                 **kw)
    assert len(runs) == 1 and t.modal_ok
    for key in ("displacements", "axial_forces", "omegas"):
        assert rel_err(getattr(t, key), getattr(j, key)) <= BANDED_RTOL, key
    assert t.mass_fraction == pytest.approx(j.mass_fraction,
                                            rel=BANDED_RTOL)


def test_spectrum_mechanism_refused():
    """A lone diagonal bar's transverse DOF is a mechanism: both packages
    refuse its unbounded Sa / omega^2 peak."""
    def bar(pkg):
        return pkg.TrussProblem(np.array([[0.0, 0.0], [1.0, 1.0]]),
                                np.array([[0, 1]]),
                                pkg.Material(young=1.0, area=1.0,
                                             density=1.0),
                                np.zeros(4), np.array([0, 1]), 2)
    for pkg, kw in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match="mechanism"):
            pkg.response_spectrum(bar(pkg), 1.0, n_modes=2, **kw)


# ------------------------------------------------------- the documents

def cli_pair(tmp_path, doc, name):
    """(JAX result, port result) of one document through both CLIs, each
    exiting 0."""
    for pkg, cli in (("jax", jax_cli), ("port", torch_cli)):
        path = tmp_path / f"{name}-{pkg}.json"
        path.write_text(json.dumps(doc))
        assert cli.main([str(path)]) == 0, pkg
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    return [json.loads((tmp_path / f"{name}-{pkg}.res.json").read_text())
            for pkg in ("jax", "port")]


def assert_close_tree(t, j, rtol, path=""):
    """Equal keys and flags, numbers within rtol of each array's largest
    JAX value."""
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for key in j:
            assert_close_tree(t[key], j[key], rtol, f"{path}/{key}")
    elif isinstance(j, list) and j and not isinstance(j[0], str) \
            and None not in j:
        assert rel_err(t, j) <= rtol, path
    elif isinstance(j, float):
        assert t == pytest.approx(j, rel=rtol), path
    else:
        assert t == j, path


def spectrum_history_document() -> dict:
    doc = json.loads((CORPUS / "dyn-spectrum.json").read_text())
    doc["analysis"] = dict(doc["analysis"], sa=dict(
        SPECTRA["history"], curve_omegas={"start": 1.0, "stop": 30.0,
                                          "num": 12}))
    return doc


DOCS = ("dyn-harmonic", "dyn-random", "dyn-fatigue", "dyn-spectrum")


@pytest.mark.parametrize("name", DOCS + ("spectrum-history",))
def test_frequency_documents_through_both_clis(tmp_path, monkeypatch, name):
    """The four corpus documents (the dense float64 tiers) and dyn-spectrum
    with a history Sa and its curve: equal keys and flags, numbers within
    F64_RTOL.  Modal participations by magnitude; a zero-force member's
    fatigue statistics are left out."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    doc = (spectrum_history_document() if name == "spectrum-history"
           else json.loads((CORPUS / f"{name}.json").read_text()))
    j, t = cli_pair(tmp_path, doc, name)
    if "participation" in j:
        for out in (j, t):
            out["participation"] = np.abs(out["participation"]).tolist()
    if "fatigue" in j:
        rms = np.asarray(j["fatigue"]["stress_rms"])
        live = rms > ZERO_FORCE * rms.max()
        assert (~live).sum() == 3          # the corpus truss's three
        for out in (j, t):
            for key in ("nu0_hz", "nu_peak_hz", "alpha2", "damage_rate",
                        "life_s", "peak_factor", "expected_peak_stress"):
                out["fatigue"][key] = np.asarray(
                    out["fatigue"][key], dtype=float)[live].tolist()
    assert_close_tree(t, j, F64_RTOL)


def transient_fatigue_document(nonlinear: bool) -> dict:
    doc = json.loads((CORPUS / "dyn-transient.json").read_text())
    doc["analysis"] = dict(
        doc["analysis"], n_steps=600, record_every=1,
        amplitude={"type": "sine", "frequency_hz": 0.35},
        probe_elements=[0, 3, 5, 8],
        fatigue={"sn": {"exponent": 3.0, "coefficient": 1e6}},
        geometric_nonlinear=nonlinear)
    return doc


@pytest.mark.parametrize("nonlinear", [False, True])
def test_transient_probe_elements_and_fatigue(tmp_path, monkeypatch,
                                              nonlinear):
    """dyn-transient.json under a sine with four probed members and a
    rainflow fatigue block (linear, and Green-Lagrange with its quadratic
    force term): force histories at CLI_RTOL, damage at DAMAGE_RTOL, the
    user's probe sliced back out of the recorded union."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    j, t = cli_pair(tmp_path, transient_fatigue_document(nonlinear),
                    f"fatigue{int(nonlinear)}")
    assert list(t) == list(j)
    for key in ("probe_dofs", "probe_elements", "times"):
        assert t[key] == j[key], key
    for key in ("displacements", "velocities", "force_histories"):
        assert rel_err(t[key], j[key]) <= CLI_RTOL, key
    tf, jf = t["fatigue"], j["fatigue"]
    assert list(tf) == list(jf)
    assert tf["cycle_count"] == jf["cycle_count"]
    assert rel_err(tf["stress_rms"], jf["stress_rms"]) <= CLI_RTOL
    np.testing.assert_allclose(tf["damage_rate"], jf["damage_rate"],
                               rtol=DAMAGE_RTOL)


@pytest.mark.parametrize("extra, match", [
    ({"probe_elements": [0], "fatigue": {"sn": {"exponent": 3,
                                                "coefficient": 1e6},
                                         "method": "dirlik"}}, "rainflow"),
    ({"probe_elements": [0], "fatigue": {"method": "rainflow"}}, '"sn"'),
    ({"probe_elements": [99]}, "probe_elements must be valid"),
    ({"probe_elements": [0], "amplitudes": [[1.0] * 10]}, "single-run"),
])
def test_transient_fatigue_value_errors_kept(extra, match):
    from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse
    from pinn_fem_tpu_torch.io.schema import parse_problem_dict as t_parse

    doc = json.loads((CORPUS / "dyn-transient.json").read_text())
    analysis = dict(doc["analysis"], n_steps=10, record_every=1, **extra)
    for mod, parse, kw in ((j_analysis, j_parse, {}),
                           (t_analysis, t_parse, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            mod.run_analysis(parse(doc).problem, analysis, **kw)


def test_random_block_first_passage_and_fatigue_errors():
    """run_random's blocks: first_passage needs barrier and duration,
    fatigue needs probe_elements, in both packages."""
    base = {"omegas": [0.5, 1.0, 1.5], "damping": [0.1, 0.01]}
    for block, match in (({"first_passage": {"barrier": 1.0}}, "duration"),
                         ({"fatigue": {}}, "probe_elements")):
        for mod, pkg, kw in ((j_analysis, jp, {}),
                             (t_analysis, tp, {"device": "cpu"})):
            with pytest.raises(ValueError, match=match):
                mod.run_random(chain(pkg), dict(base, **block), **kw)


# ------------------------------------------------------------- the rest

def test_facade_exports_the_slice():
    """The names pinn_fem_tpu/__init__.py imports from solvers.harmonic,
    fatigue, random_response and spectrum."""
    names = ("HarmonicResult", "harmonic_response", "SpectralFatigue",
             "davenport_peak_factor", "dirlik_damage_rate",
             "first_passage_probability", "narrowband_damage_rate",
             "rainflow_cycles", "rainflow_damage", "spectral_fatigue",
             "spectral_moments", "synthesize_gaussian_history",
             "RandomResponseResult", "random_response",
             "DirectionalSpectrumResult", "SpectrumCurve", "SpectrumResult",
             "directional_combination", "response_spectrum",
             "spectrum_from_history")
    for name in names:
        assert hasattr(jp, name), name
        assert name in tp.__all__ and callable(getattr(tp, name)), name


def test_mesh_refused():
    """mesh= (the JAX package's frequency sharding) is ROADMAP item 15's
    multi-device row."""
    with pytest.raises(NotImplementedError, match="item 15"):
        tp.harmonic_response(chain(tp), [1.0], mesh=object(), device="cpu")


def test_harmonic_dtype_of_the_tiers():
    """The float64 tier on the CPU when asked (host=True), the working
    dtype off it; the direct tier refuses a mesh above the dense limit."""
    om = [0.4, 0.8]
    assert tp.harmonic_response(chain(tp), om, host=True,
                                damping=(0.1, 0.0)).real.dtype == np.float64
    data = chain(tp).to_device("cpu", torch.float64)
    t = tp.harmonic_response(chain(tp), om, host=False, data=data,
                             damping=(0.1, 0.0))
    assert t.real.dtype == np.float64
    with dense_limit(4, jax_too=False), \
            pytest.raises(ValueError, match="dense-only"):
        tp.harmonic_response(chain(tp), om, device="cpu")
