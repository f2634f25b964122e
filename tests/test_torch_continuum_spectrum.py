"""The port's response-spectrum, random-vibration and spectral-fatigue
analyses of the continuum and frame families (solvers/continuum_spectrum.py,
io/_common.run_continuum_spectrum / run_continuum_random, and "spectrum" /
"random" documents of every ported family through the CLI) against the JAX
package, on the CPU.

Both packages parse the same documents.  Every path is float64 on both
sides, so each result is held within F64_RTOL of the JAX package's (the
largest difference over the largest JAX value).  The participation factors
Gamma_j carry the sign of their mode and are compared by magnitude; the
peaks Gamma_j phi_j, the combined fields and the stresses are
sign-invariant.  The meshes avoid degenerate mode pairs (a pair's modal
peaks depend on the eigensolver's basis).  The JAX results are computed
once per module (fixtures).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu.solvers.continuum_spectrum as JCS  # noqa: E402
from pinn_fem_tpu.io import (frame3d_io as j_f3, frame_io as j_fr,  # noqa: E402,E501
                             plane_io as j_pl, plate_io as j_pt,
                             solid_io as j_so)
import torch  # noqa: E402

import pinn_fem_tpu_torch.solvers.continuum_spectrum as TCS  # noqa: E402
from pinn_fem_tpu_torch.io import (frame3d_io as t_f3,  # noqa: E402
                                   frame_io as t_fr, plane_io as t_pl,
                                   plate_io as t_pt, solid_io as t_so)
from test_torch_frame import both_clis  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# Every path is float64: measured up to 4e-13 (the random RMS).
F64_RTOL = 1e-10
CPU = "cpu"


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _frame_doc():
    # Two stories, two bays of unequal width, a section modulus (fiber
    # stresses) and a member load (the fixed-end correction of the FRF).
    nodes = [[0.0, 0.0], [0.0, 3.0], [0.0, 6.0], [4.0, 0.0], [4.0, 3.0],
             [4.0, 6.0], [9.0, 0.0], [9.0, 3.5], [9.0, 6.0]]
    elems = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8], [1, 4],
             [4, 7], [2, 5], [5, 8]]
    loads = np.zeros(27)
    loads[3], loads[6], loads[16] = 1.0, 2.0, -0.5
    return {"element_type": "frame", "nodes": nodes, "elements": elems,
            "material": {"young": 200.0, "area": [0.4, 0.4, 0.5, 0.5, 0.3,
                                                  0.3, 0.2, 0.2, 0.2, 0.2],
                         "inertia": 0.05, "density": 2.0,
                         "section_modulus": 0.2},
            "member_loads": [[8, 0.0, -0.3]],
            "loads": loads.tolist(), "fixed_nodes": [0, 3, 6]}


def _frame3d_doc():
    from pinn_fem_tpu_torch.examples_grid import space_frame_grid_document

    doc = space_frame_grid_document(2, 3, 2)
    doc["material"]["inertia_z"] = 1.5e-4
    doc.pop("analysis")
    return doc


DOCS = {
    "plane": {"element_type": "plane",
              "nodes": [[x, y + 0.03 * np.sin(7 * x + y)]
                        for y in np.linspace(0, 2, 4)
                        for x in np.linspace(0, 4, 7)],
              "elements": [[j * 7 + i, j * 7 + i + 1, (j + 1) * 7 + i + 1,
                            (j + 1) * 7 + i] for j in range(3)
                           for i in range(6)],
              "material": {"young": 200.0, "poisson": 0.3, "thickness": 0.5,
                           "density": 2.0},
              "fixed_nodes": "left",
              "edge_loads": [{"nodes": "right", "traction": [0.5, -1.0]}]},
    "plane_strain": None,
    "solid": {"element_type": "solid",
              "mesh": {"type": "box", "lx": 1.0, "ly": 1.4, "lz": 3.0,
                       "nx": 2, "ny": 2, "nz": 3},
              "material": {"young": 200.0, "poisson": 0.3, "density": 2.0},
              "fixed_nodes": "z_min",
              "surface_loads": [{"face": "z_max",
                                 "traction": [0.3, 0.1, -1.0]}]},
    "frame": _frame_doc(),
    "frame3d": _frame3d_doc(),
    "plate": {"element_type": "plate",
              "mesh": {"type": "rect", "width": 1.0, "height": 0.7,
                       "nx": 6, "ny": 4},
              "material": {"young": 2e11, "poisson": 0.3, "thickness": 0.05,
                           "density": 7850.0},
              "pressure": -1000.0,
              "supports": {"simply_supported": ["left", "right", "bottom",
                                                "top"]}},
}
DOCS["plane_strain"] = dict(DOCS["plane"], plane_strain=True)
FAMILY = {"plane": "plane", "plane_strain": "plane", "solid": "solid",
          "frame": "frame", "frame3d": "frame3d", "plate": "plate"}
RUNNERS = {"plane": (t_pl, j_pl), "solid": (t_so, j_so),
           "frame": (t_fr, j_fr), "frame3d": (t_f3, j_f3),
           "plate": (t_pt, j_pt)}
DIRECTION = {"plane": [1.0, 0.4], "solid": [0.2, 1.0, 0.1],
             "frame": [1.0, 0.0], "frame3d": [0.3, 1.0, 0.0],
             "plate": None}


def parse(name):
    """(port problem, JAX problem) of a family document."""
    t_io, j_io = RUNNERS[FAMILY[name]]
    fam = FAMILY[name]
    doc = json.loads(json.dumps(DOCS[name]))
    t_parse = getattr(t_io, f"parse_{fam}_document")
    j_parse = getattr(j_io, f"parse_{fam}_document")
    return t_parse(doc)[0], j_parse(json.loads(json.dumps(doc)))[0]


@pytest.fixture(scope="module")
def omegas():
    """A grid around each family's first modes (from the JAX modal)."""
    out = {}
    for name in DOCS:
        _, jp = parse(name)
        w, _ = JCS._family_of(jp).modal(jp, 3)
        out[name] = np.linspace(0.3 * w[0], 1.6 * w[2], 24)
    return out


def damping_of(w):
    return (0.05 * w[0], 0.02 / w[-1])


SPECTRA = [(name, comb) for name in DOCS for comb in ("srss", "cqc")]


@pytest.mark.parametrize("name, combination", SPECTRA,
                         ids=[f"{n}-{c}" for n, c in SPECTRA])
def test_response_spectrum_matches_jax(name, combination):
    tp, jp = parse(name)

    def sa(om):
        return 2.5 / (1.0 + 0.01 * om)

    kw = dict(direction=DIRECTION[FAMILY[name]], n_modes=5,
              combination=combination, damping_ratio=0.05)
    got = TCS.continuum_response_spectrum(tp, sa, device=CPU, **kw)
    want = JCS.continuum_response_spectrum(jp, sa, **kw)
    for key in ("displacements", "modal_peaks", "omegas", "effective_mass",
                "stresses", "von_mises", "modal_stresses"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL, \
            key
    assert rel_err(np.abs(got.participation),
                   np.abs(want.participation)) <= F64_RTOL
    assert abs(got.mass_fraction - want.mass_fraction) <= F64_RTOL
    assert got.combination == want.combination


@pytest.mark.parametrize("name", list(DOCS))
def test_random_response_matches_jax(name, omegas):
    tp, jp = parse(name)
    om = omegas[name]
    probe = np.arange(0, tp.ndof, 3)

    def psd(w):
        return 1.0 + 0.1 * np.sin(w)

    kw = dict(damping=damping_of(om), probe_dofs=probe)
    got = TCS.continuum_random_response(tp, psd, om, device=CPU, **kw)
    want = JCS.continuum_random_response(jp, psd, om, **kw)
    for key in ("omegas", "psd", "rms", "frf_amplitude"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL, \
            key


@pytest.mark.parametrize("name", ["plane", "plane_strain", "solid",
                                  "plate"])
def test_stress_frf_matches_jax(name, omegas):
    tp, jp = parse(name)
    om = omegas[name][::4]
    probe = [0, 2, 3] if name != "plate" else None
    got = TCS.continuum_stress_frf(tp, om, damping=damping_of(om),
                                   probe_elements=probe, device=CPU)
    want = JCS.continuum_stress_frf(jp, om, damping=damping_of(om),
                                    probe_elements=probe)
    assert got.shape == want.shape
    assert rel_err(got.real, want.real) <= F64_RTOL
    assert rel_err(got.imag, want.imag) <= F64_RTOL


def test_frame_fiber_stress_frf_matches_jax(omegas):
    tp, jp = parse("frame")
    om = omegas["frame"][::3]
    got = TCS.frame_fiber_stress_frf(tp, om, damping=damping_of(om),
                                     device=CPU)
    want = JCS.frame_fiber_stress_frf(jp, om, damping=damping_of(om))
    assert got.shape == want.shape == (om.size, tp.nelm, 4)
    assert rel_err(got.real, want.real) <= F64_RTOL
    assert rel_err(got.imag, want.imag) <= F64_RTOL


FATIGUE = [(name, method) for name in ("plane", "plane_strain", "solid",
                                       "frame", "plate")
           for method in ("dirlik", "narrowband")]


@pytest.mark.parametrize("name, method", FATIGUE,
                         ids=[f"{n}-{m}" for n, m in FATIGUE])
def test_spectral_fatigue_matches_jax(name, method, omegas):
    """Dirlik and narrowband damage on the Preumont equivalent von Mises
    PSDs (frames: the governing extreme fiber), with the S-N curve and
    the Davenport peak of a duration."""
    tp, jp = parse(name)
    om = omegas[name]
    kw = dict(damping=damping_of(om), sn_exponent=3.0, sn_coefficient=1e12,
              method=method, duration=600.0)
    got = TCS.continuum_spectral_fatigue(tp, 0.7, om, device=CPU, **kw)
    want = JCS.continuum_spectral_fatigue(jp, 0.7, om, **kw)
    assert np.array_equal(got.probe_elements, want.probe_elements)
    for key in ("omegas", "eq_psd", "eq_rms"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL, \
            key
    assert got.fatigue.method == want.fatigue.method
    for key in ("m0", "rms", "nu0", "nu_peak", "alpha2", "damage_rate",
                "life", "peak_factor", "expected_peak"):
        assert rel_err(getattr(got.fatigue, key),
                       getattr(want.fatigue, key)) <= F64_RTOL, key


def json_gap(got, want, path=""):
    """{path: relative gap} over the numeric leaves (participation by
    magnitude); the other leaves must be equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        out = {}
        for k in want:
            out.update(json_gap(got[k], want[k], f"{path}/{k}"))
        return out
    if isinstance(want, (bool, str)) or want is None:
        assert got == want, path
        return {}
    g, w = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    if path.endswith("participation"):
        g, w = np.abs(g), np.abs(w)
    return {path: rel_err(g, w) if w.size else 0.0}


def assert_clis_agree(outs):
    (rc_j, want, log_j), (rc_t, got, log_t) = outs
    assert rc_j == rc_t == 0, log_t
    gaps = json_gap(got, want)
    assert max(gaps.values()) <= F64_RTOL, gaps
    summary = [ln.split("] ", 1)[1] for ln in log_j.splitlines()
               if "SUMMARY" in ln or "Modal mass" in ln or "PSD grid" in ln]
    assert len(summary) == 2 and all(s in log_t for s in summary), summary


def test_plane_spectrum_corpus_document(tmp_path, monkeypatch):
    """dyn-plane-spectrum.json through both CLIs: the result JSON within
    F64_RTOL, the summary lines equal."""
    doc = json.loads((CORPUS / "dyn-plane-spectrum.json").read_text())
    assert_clis_agree(both_clis(tmp_path, monkeypatch, "dyn-plane-spectrum",
                                doc))


BUILT = [(name, kind) for name in ("solid", "frame", "frame3d", "plate")
         for kind in ("spectrum", "random")]


@pytest.mark.parametrize("name, kind", BUILT,
                         ids=[f"{n}-{k}" for n, k in BUILT])
def test_built_documents_through_both_clis(tmp_path, monkeypatch, name,
                                           kind, omegas):
    """A spectrum document (tabulated Sa, CQC) and a random document (a
    tabulated PSD, probe nodes, fatigue with an S-N curve) of each other
    family through both CLIs."""
    om = omegas[name]
    if kind == "spectrum":
        analysis = {"type": "spectrum", "n_modes": 4, "combination": "cqc",
                    "sa": {"omegas": [0.0, float(om[-1])],
                           "values": [3.0, 1.0]}}
        if DIRECTION[name] is not None:
            analysis["direction"] = DIRECTION[name]
    else:
        analysis = {"type": "random",
                    "omegas": {"start": float(om[0]),
                               "stop": float(om[-1]), "num": 16},
                    "psd": {"omegas": [0.0, float(om[-1])],
                            "values": [1.0, 0.5]},
                    "damping": list(damping_of(om)),
                    "probe_nodes": [5, 7]}
        if name != "frame3d":
            analysis["fatigue"] = {"sn": {"exponent": 4.0,
                                          "coefficient": 1e15},
                                   "method": "dirlik", "duration": 60.0}
            analysis["probe_elements"] = [0, 3]
    doc = dict(json.loads(json.dumps(DOCS[name])), analysis=analysis)
    assert_clis_agree(both_clis(tmp_path, monkeypatch, f"{name}-{kind}",
                                doc))


@pytest.mark.parametrize("name", ["plane", "solid", "frame", "plate"])
def test_fatigue_document_sweeps_once(monkeypatch, name, omegas):
    """A random document with a fatigue block solves each frequency's
    complex system once: the probes' PSDs and the stress FRFs read one
    full-field sweep (`harmonic_fields`); the results equal the public
    functions' own sweeps."""
    om = omegas[name][:8]
    damping = list(damping_of(om))
    analysis = {"type": "random", "omegas": om.tolist(), "psd": 0.7,
                "damping": damping, "probe_dofs": [3, 5],
                "probe_elements": [0, 3],
                "fatigue": {"sn": {"exponent": 3.0, "coefficient": 1e12},
                            "method": "dirlik"}}
    doc = dict(json.loads(json.dumps(DOCS[name])), analysis=analysis)
    solve = torch.linalg.solve
    calls = []

    def counted(a, b, *args, **kw):
        if a.is_complex():
            calls.append(a.shape)
        return solve(a, b, *args, **kw)

    monkeypatch.setattr(torch.linalg, "solve", counted)
    t_io = RUNNERS[FAMILY[name]][0]
    out = getattr(t_io, f"run_{FAMILY[name]}_document")(doc, CPU)
    assert len(calls) == om.size
    monkeypatch.setattr(torch.linalg, "solve", solve)
    tp, _ = parse(name)
    rr = TCS.continuum_random_response(tp, 0.7, om, damping=damping,
                                       probe_dofs=[3, 5], device=CPU)
    cf = TCS.continuum_spectral_fatigue(
        tp, 0.7, om, damping=damping, probe_elements=[0, 3],
        sn_exponent=3.0, sn_coefficient=1e12, device=CPU)
    assert rel_err(out["psd"], rr.psd) <= F64_RTOL
    assert rel_err(out["fatigue"]["damage_rate"],
                   cf.fatigue.damage_rate) <= F64_RTOL


def refusal(name, analysis, doc=None):
    """(port message, JAX message) of a document's refusal (ValueError)."""
    t_io, j_io = RUNNERS[FAMILY[name]]
    fam = FAMILY[name]
    doc = dict(json.loads(json.dumps(doc or DOCS[name])), analysis=analysis)
    msgs = []
    for run, extra in ((getattr(t_io, f"run_{fam}_document"), (CPU,)),
                       (getattr(j_io, f"run_{fam}_document"), ())):
        with pytest.raises(ValueError) as err:
            run(json.loads(json.dumps(doc)), *extra)
        msgs.append(str(err.value))
    return msgs


GUARDS = {
    "zero-damping": ("plane", {"type": "random", "omegas": [1.0, 2.0],
                               "probe_nodes": "right"}),
    "direction": ("solid", {"type": "spectrum", "direction": [1.0, 0.0]}),
    "plate-direction": ("plate", {"type": "spectrum", "direction": [0, 1]}),
    "zero-direction": ("frame", {"type": "spectrum", "direction": [0, 0]}),
    "combination": ("frame3d", {"type": "spectrum", "combination": "abs"}),
    "directions": ("plane", {"type": "spectrum", "directions": [[1, 0]]}),
    "payload": ("solid", {"type": "random", "damping": [0.1, 0.0],
                          "omegas": {"start": 1.0, "stop": 9.0,
                                     "num": 200}}),
    "grid": ("frame", {"type": "random", "omegas": [2.0, 1.0],
                       "damping": [0.1, 0.0]}),
    "negative-psd": ("plate", {"type": "random", "omegas": [1.0, 2.0],
                               "damping": [0.1, 0.0], "psd": -1.0}),
    "sn": ("plane", {"type": "random", "omegas": [1.0, 2.0],
                     "damping": [0.1, 0.0], "probe_nodes": "right",
                     "fatigue": {"sn": {"exponent": 3.0}}}),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_guards_match_jax(name):
    """Zero damping, a wrong or zero direction, an unknown combination,
    multi-direction, a payload over its bound, a decreasing grid, a
    negative PSD and an incomplete S-N curve: the JAX package's message."""
    got, want = refusal(*GUARDS[name])
    assert got == want


def test_mechanism_mode_refused():
    """A plane strip held only in y (a rigid x motion): both packages
    refuse the spectrum naming the mechanism (the ratio printed is
    eigensolver noise, so the message is compared up to it)."""
    doc = json.loads(json.dumps(DOCS["plane"]))
    doc.pop("fixed_nodes")
    doc["fixed_y_nodes"] = "bottom"
    got, want = refusal("plane", {"type": "spectrum"}, doc)
    assert "zero-frequency mechanism mode" in got
    assert got.split("(lambda")[0] == want.split("(lambda")[0]


def test_stress_frf_of_a_space_frame_refused():
    """continuum_stress_frf has no space-frame branch in either package:
    the same TypeError; spectral fatigue of a space frame takes it."""
    tp, jp = parse("frame3d")
    msgs = []
    for call in (lambda: TCS.continuum_spectral_fatigue(
            tp, 1.0, [1.0, 2.0], damping=(0.1, 0.0), device=CPU),
            lambda: JCS.continuum_spectral_fatigue(jp, 1.0, [1.0, 2.0],
                                                   damping=(0.1, 0.0))):
        with pytest.raises(TypeError) as err:
            call()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def shell_panel(pkg):
    """A 4 x 3 cylindrical panel cantilevered from its y = 0 edge, the
    global theta_z held at every node (which the JAX package's mechanism
    guard needs for a spectrum: ROADMAP fault 3.33), self-weight and a
    normal pressure, of either package."""
    nodes, el = pkg.cylinder_panel_mesh(25.0, 40.0, 40.0, 4, 3)
    base = np.flatnonzero(nodes[:, 1] == 0.0)
    fixed = np.union1d((6 * base[:, None] + np.arange(6)).ravel(),
                       6 * np.arange(len(nodes)) + 5)
    return pkg.ShellProblem(nodes=nodes, elements=el, young=4.32e8,
                            poisson=0.2, thickness=1.0, density=2.0,
                            loads=np.zeros(6 * len(nodes)), fixed_dofs=fixed,
                            body_force=[0.0, 0.0, -90.0], pressure=20.0)


SHELL_OMEGAS = np.linspace(25.0, 120.0, 8)


@pytest.mark.parametrize("call", [
    lambda cs, p, kw: cs.continuum_response_spectrum(
        p, 2.0, direction=[0.3, 1.0, -0.2], n_modes=3, combination="cqc",
        **kw).von_mises,
    lambda cs, p, kw: cs.continuum_random_response(
        p, 1.0, SHELL_OMEGAS, damping=(2.0, 1e-4), probe_dofs=[44, 50],
        **kw).psd,
    lambda cs, p, kw: cs.continuum_spectral_fatigue(
        p, 1.0, SHELL_OMEGAS, damping=(2.0, 1e-4), probe_elements=[0, 5],
        **kw).eq_psd,
    lambda cs, p, kw: np.abs(cs.shell_fiber_stress_frf(
        p, SHELL_OMEGAS, damping=(2.0, 1e-4), probe_elements=[0, 5], **kw)),
], ids=["spectrum", "random", "fatigue", "shell_fiber_stress_frf"])
def test_shell_is_item_22(call):
    """The shell branches of the spectrum module, refused until ROADMAP
    item 22 ported them: the combined spectrum stresses, the random PSDs,
    the governing-fiber equivalent stress PSDs and the fiber stress FRFs
    equal the JAX package's within F64_RTOL."""
    from pinn_fem_tpu import models as j_models
    from pinn_fem_tpu_torch import models as t_models

    got = call(TCS, shell_panel(t_models.shell), {"device": CPU})
    want = call(JCS, shell_panel(j_models.shell), {})
    assert rel_err(got, want) <= F64_RTOL


@pytest.mark.parametrize("call", [
    lambda p: TCS.continuum_response_spectrum(p, 1.0),
    lambda p: TCS.continuum_random_response(p, 1.0, [1.0, 2.0],
                                            damping=(0.1, 0.0)),
    lambda p: TCS.continuum_stress_frf(p, [1.0]),
    lambda p: TCS.continuum_spectral_fatigue(p, 1.0, [1.0, 2.0],
                                             damping=(0.1, 0.0)),
    lambda p: t_pl.run_plane_analysis(p, {"type": "spectrum"}),
], ids=["spectrum", "random", "stress_frf", "fatigue", "document"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """With no device= a spectrum entry point runs on "cuda": without a
    card it raises, and nothing falls back to the CPU."""
    tp, _ = parse("plane")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        call(tp)


def test_frame_fiber_frf_default_device(monkeypatch):
    tp, _ = parse("frame")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        TCS.frame_fiber_stress_frf(tp, [1.0])


def test_undamped_frf_at_a_natural_frequency_fault():
    """ROADMAP fault 3.2 (continuum_spectrum.py:719 of the JAX package),
    matched, not fixed: an undamped stress FRF at a natural frequency is a
    numerically singular solve that both packages return without a
    diagnostic, finite and ~1e12 times the static stress (the digits are
    rounding: the two packages' values differ)."""
    tp, jp = parse("plane")
    w, _ = JCS._family_of(jp).modal(jp, 1)
    static = np.abs(JCS.continuum_stress_frf(jp, [0.0])).max()
    for frf in (JCS.continuum_stress_frf(jp, w[:1]),
                TCS.continuum_stress_frf(tp, w[:1], device=CPU)):
        assert np.all(np.isfinite(frf))
        assert np.abs(frf).max() > 1e9 * static
