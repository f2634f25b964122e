"""The port's geometrically nonlinear shallow shells
(solvers/shell_nonlinear.py: the Marguerre / von Karman assembly, the
float64 Newton, Crisfield arc length and the banded tier) and
dyn-shell-snap.json through the CLI, against the JAX package on the CPU.

Both packages get the same numpy arrays.  Bounds, each the largest
difference over the largest JAX value (`rel_err`):

  * ELEM_RTOL: the projected geometry, the element blocks, the internal
    force and the strain energy;
  * F64_RTOL: the float64 Newton and arc-length paths, with the
    iteration counts equal (the JAX package's faults met, ROADMAP fault
    3.2: the damped Newton commits a step that raises the residual, a
    failed corrector is never committed);
  * the banded tier in float32: the Newton counts within +-1 of the JAX
    banded tier's, u within 5e-4 max|u| of the float64 Newton (the JAX
    test's bound, tests/test_shell_nonlinear.py).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu.models.shell as JS  # noqa: E402
import pinn_fem_tpu.solvers.shell_nonlinear as JN  # noqa: E402
from pinn_fem_tpu.io import shell_io as j_io  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu_torch.models.shell as TS  # noqa: E402
import pinn_fem_tpu_torch.solvers.shell_nonlinear as TN  # noqa: E402
from pinn_fem_tpu_torch.io import shell_io as t_io  # noqa: E402
from test_torch_frame import both_clis  # noqa: E402
from test_torch_plate import tree_gaps  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
ELEM_RTOL = 1e-12
F64_RTOL = 1e-10
BANDED_RTOL = 5e-4
CPU = "cpu"
E, T = 200e3, 0.1
L, W = 4.0, 1.0
D = E * T ** 3 / 12.0
K1 = np.pi / L
RISE = 0.15
Q_STRIP = 3.0 * 0.15 * 384.0 * D / (5.0 * L ** 4)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def both(**kw):
    return TS.ShellProblem(**kw), JS.ShellProblem(**kw)


def strip(nx, rise=0.0, pressure=None, loads=None):
    """The pinned-edge arch strip of tests/test_shell_nonlinear.py (theta_x
    suppressed, nu = 0): flat with rise 0 (the von Karman beam)."""
    nodes, el = JS.arch_strip_mesh(L, W, rise, nx)
    n = len(nodes)
    ends = np.flatnonzero((nodes[:, 0] < 1e-9)
                          | (np.abs(nodes[:, 0] - L) < 1e-9))
    fixed = np.union1d((6 * ends[:, None] + np.arange(3)).ravel(),
                       6 * np.arange(n) + 3)
    return both(nodes=nodes, elements=el, young=E, poisson=0.0, thickness=T,
                density=1.0, loads=np.zeros(6 * n) if loads is None
                else loads, fixed_dofs=fixed, pressure=pressure)


def sine_arch(nx):
    """The half-sine arch under the half-sine trapezoid load (amplitude 1
    per unit projected area at lambda = 1)."""
    loads = np.zeros(12 * (nx + 1))
    h = L / nx
    for i, x in enumerate(np.linspace(0.0, L, nx + 1)):
        wt = h if 0 < i < nx else h / 2.0
        for row in (0, nx + 1):
            loads[6 * (i + row) + 2] = -np.sin(K1 * x) * wt * (W / 2)
    return strip(nx, RISE, loads=loads)


def test_geometry_energy_and_blocks_match_jax():
    """The projected geometry, the Marguerre blocks at a random
    large-deflection state (the tangent, the internal force, the Gauss
    membrane forces, the energy) and marguerre_energy."""
    tp, jp = sine_arch(8)
    u = 0.02 * np.random.default_rng(1).standard_normal(jp.ndof)
    geo_j = JN._marguerre_geometry(jp)
    geo_t = TN._marguerre_geometry(tp)
    for name in ("c2", "bm", "gw", "g0", "det", "kb", "kd", "dm", "db"):
        assert rel_err(getattr(geo_t, name).numpy(),
                       getattr(geo_j, name)) <= ELEM_RTOL, name
    want = JN._marguerre_blocks(geo_j.bm, geo_j.gw, geo_j.g0, geo_j.det,
                                geo_j.kb, geo_j.kd, geo_j.dm,
                                u[geo_j.dof_map])
    got = TN._marguerre_blocks(*geo_t[1:8], torch.as_tensor(u)[
        geo_t.dof_map])
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= ELEM_RTOL
    assert abs(TN.marguerre_energy(tp, u, device=CPU)
               - JN.marguerre_energy(jp, u)) <= ELEM_RTOL * abs(want[3])
    f_t = TN._f_ext_marguerre(strip(4, pressure=-2.0)[0])
    assert rel_err(f_t.numpy(),
                   JN._f_ext_marguerre(strip(4, pressure=-2.0)[1])) \
        <= ELEM_RTOL


def test_newton_matches_jax():
    """The float64 Newton on the von Karman strip in four load steps:
    u, the centroid resultants and the residuals within F64_RTOL, the
    iteration counts equal."""
    tp, jp = strip(8, pressure=-Q_STRIP)
    kw = dict(load_factors=np.linspace(0.25, 1.0, 4), tol=1e-11)
    got = TN.solve_shell_nonlinear(tp, device=CPU, **kw)
    want = JN.solve_shell_nonlinear(jp, **kw)
    assert got.converged and want.converged
    for key in ("displacements", "membrane_forces", "moments"):
        assert rel_err(getattr(got, key), getattr(want, key)) <= F64_RTOL
    assert np.array_equal(got.iterations, want.iterations)


def test_damped_newton_commits_worse_steps_in_both_packages():
    """ROADMAP fault 3.2: past the arch's limit point (lambda 3 > 2.89) no
    halving satisfies Armijo and the host Newton commits its best trial
    even where that raises the residual: after 9, 10 and 11 iterations the
    residual rises in both packages, by the same steps."""
    tp, jp = sine_arch(8)
    got, want = [], []
    for k in (9, 10, 11):
        got.append(TN.solve_shell_nonlinear(tp, load_factors=[3.0],
                                            max_iter=k,
                                            device=CPU).residuals[0])
        want.append(JN.solve_shell_nonlinear(jp, load_factors=[3.0],
                                             max_iter=k).residuals[0])
    assert want[0] < want[1] < want[2]
    assert rel_err(got, want) <= F64_RTOL


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    doc = json.loads((CORPUS / "dyn-shell-snap.json").read_text())
    outs = both_clis(tmp_path_factory.mktemp("snap"), mp, "dyn-shell-snap",
                     doc)
    mp.undo()
    return outs


def test_snap_document_matches_jax(snap):
    """dyn-shell-snap.json (Riks through both folds of the half-sine arch)
    through both CLIs: exit codes 0, the path's load factors and probe
    displacements within F64_RTOL, the corrector iteration counts equal,
    the summary lines equal."""
    (rc_j, want, log_j), (rc_t, got, log_t) = snap
    assert rc_j == rc_t == 0 and got["success"] and want["success"]
    assert got["iterations"] == want["iterations"]
    assert max(got.pop("max_residual"), want.pop("max_residual")) <= 1e-9
    gaps = tree_gaps(got, want)
    assert max(gaps.values()) <= F64_RTOL, gaps
    lines = log_j.splitlines()
    at = next(i for i, ln in enumerate(lines) if "SUMMARY" in ln)
    for ln in lines[at:at + 2] + [ln for ln in lines
                                  if "Shell document" in ln]:
        assert ln.split("] ", 1)[1] in log_t
    a = np.asarray(got["displacements"])[:, 2]
    assert a.min() < -2.0 * RISE              # through both folds


def test_riks_failed_corrector_matches_jax():
    """Hostile settings (dl0 = 5, 3 corrector iterations, tol 1e-10): the
    shrunk steps fail in both packages alike and nothing is committed
    (the same path points, converged False)."""
    tp, jp = sine_arch(8)
    kw = dict(n_steps=10, dl0=5.0, tol=1e-10, max_arc_iter=3)
    got = TN.solve_shell_riks(tp, device=CPU, **kw)
    want = JN.solve_shell_riks(jp, **kw)
    assert not got.converged and not want.converged
    assert got.load_factors.size == want.load_factors.size
    if want.load_factors.size:
        assert rel_err(got.displacements, want.displacements) <= F64_RTOL


def test_banded_tier_matches_jax():
    """The banded tier (float32, the PCG on the twins) on the JAX test's
    16-element von Karman strip in four load steps: converged, the Newton
    counts within +-1 of the JAX banded tier's, u within BANDED_RTOL of
    the float64 Newton.  (The JAX test's 8 x 16 shallow panel costs 10 s of
    the twins' PCG here: `tools/measure_shell.py --panel --jax`.)"""
    tp, jp = strip(16, pressure=-Q_STRIP)
    lfs = np.linspace(0.25, 1.0, 4)
    host = TN.solve_shell_nonlinear(tp, load_factors=lfs, tol=1e-10,
                                    device=CPU)
    got = TN.solve_shell_nonlinear_banded(tp, load_factors=lfs, device=CPU)
    want = JN.solve_shell_nonlinear_banded(jp, load_factors=lfs)
    assert got.converged and want.converged
    assert np.abs(got.iterations - want.iterations).max() <= 1
    scale = np.abs(host.displacements[-1]).max()
    assert np.abs(got.displacements[-1] - host.displacements[-1]).max() \
        <= BANDED_RTOL * scale


def test_banded_document_opt_in():
    """The "banded": true opt-in of a nonlinear document: the banded tier
    with the size-guarded payload, the half-sine arch on the exact cubic
    within 5e-2 (tests/test_shell_nonlinear.py's bound)."""
    nx = 16
    tp, _ = sine_arch(nx)
    doc = {"element_type": "shell",
           "mesh": {"type": "arch_strip", "length": L, "width": W,
                    "rise": RISE, "nx": nx},
           "material": {"young": E, "poisson": 0.0, "thickness": T,
                        "density": 1.0},
           "loads": tp.loads.tolist(), "fixed_dofs": tp.fixed_dofs.tolist(),
           "analysis": {"type": "nonlinear", "banded": True,
                        "load_factors": [0.25, 0.5],
                        "probe_nodes": [nx // 2]}}
    out = t_io.run_shell_document(doc, CPU)
    assert out["success"] and out["tier"] == "banded"
    a = np.asarray(out["displacements"])[-1, 2]
    lam = -(D * K1 ** 4 * a + E * T * K1 ** 4 * (RISE * a / 2.0 + a * a
                                                 / 4.0) * (RISE + a))
    assert abs(lam - 0.5) <= 5e-2 * 0.5


def test_pcg_stall_message_matches_jax():
    """A banded PCG that does not reach 100 cg_tol raises the JAX
    package's ValueError, word for word: here the strip of
    test_banded_tier_matches_jax (the JAX package's compiled program) under
    a load whose PCG residual is not finite."""
    tp, jp = strip(16, pressure=np.nan)
    msgs = []
    for call in (lambda: TN.solve_shell_nonlinear_banded(
            tp, load_factors=[1.0], device=CPU),
            lambda: JN.solve_shell_nonlinear_banded(jp, load_factors=[1.0])):
        with pytest.raises(ValueError) as err:
            call()
        msgs.append(str(err.value))
    assert "banded PCG stalled (rel=nan)" in msgs[0] and msgs[0] == msgs[1]


@pytest.mark.parametrize("name", ["deep", "thermal", "degenerate"])
def test_refusals_match_jax(name):
    """The slope guard, the thermal load case and a facet that projects to
    no area: the JAX package's error type and message."""
    if name == "deep":
        nodes, el = JS.cylinder_panel_mesh(5.0, 4.0, 40.0, 4, 2)
        kw = dict(nodes=nodes, elements=el, fixed_dofs=[0, 1, 2])
    elif name == "thermal":
        nodes, el = JS.arch_strip_mesh(L, W, 0.0, 2)
        kw = dict(nodes=nodes, elements=el, fixed_dofs=[0, 1, 2],
                  alpha_cte=1e-5, temperature=2.0)
    else:
        nodes = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 1.0],
                          [0.0, 0.0, 1.0]])
        kw = dict(nodes=nodes, elements=[[0, 1, 2, 3]], fixed_dofs=[0])
    tp, jp = both(young=E, poisson=0.3, thickness=T, density=1.0,
                  loads=np.zeros(6 * len(kw["nodes"])), **kw)
    errs = []
    for call in (lambda: TN.solve_shell_nonlinear(tp, device=CPU),
                 lambda: JN.solve_shell_nonlinear(jp)):
        with pytest.raises(ValueError) as err:
            call()
        errs.append(str(err.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("call", [
    lambda p: TN.marguerre_energy(p, np.zeros(p.ndof)),
    lambda p: TN.solve_shell_nonlinear(p, n_steps=1),
    lambda p: TN.solve_shell_riks(p, n_steps=1),
    lambda p: TN.solve_shell_nonlinear_banded(p, n_steps=1),
    lambda p: t_io.run_shell_analysis(p, {"type": "continuation"}),
], ids=["energy", "newton", "riks", "banded", "document"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """With no device= a nonlinear shell entry point runs on "cuda":
    without a card it raises, and nothing falls back to the CPU."""
    tp, _ = sine_arch(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        call(tp)


def test_jax_corpus_parse_matches():
    """The arch_strip mesh and its server-built "sine_load" pattern parse
    to the same problem in both packages."""
    doc = json.loads((CORPUS / "dyn-shell-snap.json").read_text())
    tp, an_t = t_io.parse_shell_document(doc)
    jp, an_j = j_io.parse_shell_document(doc)
    assert an_t == an_j
    for name in ("nodes", "elements", "loads", "fixed_dofs"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name))
