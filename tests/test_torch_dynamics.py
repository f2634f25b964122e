"""The port's truss dynamics (solvers/dynamics.py, ops/mass.py,
ops/geometric.py, ops/host.py, io/transient_io.py) against the JAX
package, on the CPU.

Each case gives the same inputs, made by numpy, to both packages.  The
meshes are a 6 x 12 cross-braced grid (144 DOFs): dense as it is, banded
with DENSE_DOF_LIMIT patched below its size in both packages' Newton
modules (as tests/test_dynamics.py does), and without a banded layout
(the gather operator) once its nodes are shuffled.  On the banded path
the port runs the stencil kernel's twin for every K u and, for Newmark,
the plain PCG, as the JAX package off a TPU does.

Bounds: the gaps that `tests/measure_torch_agreement.py dynamics` prints,
times the margin written beside each, and never tighter than the JAX
package's own floors (its banded-vs-dense Newmark bound is 2e-3 max|u|
after 100 steps, tests/test_dynamics.py:192-197).  Two float32
integrators drift apart linearly in time, so every history is compared
against the largest value of its JAX counterpart.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu.solvers.newton as j_newton  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.ops import dia as j_dia  # noqa: E402
from pinn_fem_tpu.ops import geometric as j_geo  # noqa: E402
from pinn_fem_tpu.ops import mass as j_mass  # noqa: E402
from pinn_fem_tpu.solvers import dynamics as j_dyn  # noqa: E402
from pinn_fem_tpu.utils import checkpoint as j_ckpt  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io._common import _prestress_state  # noqa: E402
from pinn_fem_tpu_torch.io.analysis import run_analysis  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.ops import dia as t_dia  # noqa: E402
from pinn_fem_tpu_torch.ops import geometric as t_geo  # noqa: E402
from pinn_fem_tpu_torch.ops import host as t_host  # noqa: E402
from pinn_fem_tpu_torch.ops import mass as t_mass  # noqa: E402
from pinn_fem_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402

CPU = torch.device("cpu")
CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
GRID = (6, 12)
BANDED_LIMIT = 64         # DENSE_DOF_LIMIT patched below the grid's 144
# Load scale of the Green-Lagrange cases: strains of a few per cent.  At
# the full load the grid stretches to 7 units in 20 implicit steps, and
# both packages' fixed 8 Newton iterations a step part ways.
GL_LOAD = 0.05

# Mass and geometric ops (MLP density, point masses): float32 noise of
# another summation order (the port sums in float64, fault 3.4),
# measured up to 1.8e-7; bound 1e-5.
OPS_RTOL = 1e-5
# stable_dt: the dense bound is float64 on the host in both packages;
# the banded bound is float32 on the device (row sums, mass, sqrt).
# Measured equal in every case.
DT_DENSE_RTOL = 1e-12
DT_BANDED_RTOL = 1e-6
# Histories (u, v, kinetic and strain energy, u_final) of one case
# against the largest JAX value of each, 200 central steps: measured up
# to 7.7e-5 (base excitation's u_final; 3.4e-5 for the recorded u),
# bound 5e-4, margin 6.5.  Newmark, 200 steps: measured up to 1.5e-5,
# held to the JAX package's own banded-vs-dense floor, 2e-3.
CENTRAL_RTOL = 5e-4
NEWMARK_RTOL = 2e-3
# v_final, the central scheme's backward difference (u - u_prev) / dt,
# cancels two nearly equal states: measured up to 3.8e-4 (Newmark's v
# too); bound 2e-3, margin 5.
V_FINAL_RTOL = 2e-3
# A resumed or restarted run against the uninterrupted one: measured 0
# within a package and 3.8e-6 across them (files written by one package,
# resumed by the other); bound 1e-5.
RESUME_RTOL = 1e-5
# The corpus document and the 24 x 48 grid document through both CLIs:
# dt measured equal (the corpus document's float64 host bound, and the
# grid's float32 device bound, whose sums round alike here); histories
# measured up to 2.5e-5, bound 2e-4, margin 8.
CLI_DT_RTOL = 1e-12
CLI_RTOL = 2e-4
# The port's 24 x 48 grid history against float64: measured 3.9e-6,
# held to the grid's 1e-4 of tests/test_torch_slice.py.
GRID_F64_RTOL = 1e-4


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@contextlib.contextmanager
def dense_limit(limit):
    """DENSE_DOF_LIMIT of both packages' Newton modules set to `limit`
    (None: as it is)."""
    saved = (j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT)
    if limit is not None:
        j_newton.DENSE_DOF_LIMIT = t_newton.DENSE_DOF_LIMIT = limit
    try:
        yield
    finally:
        j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT = saved


def grid_arrays(shuffled=False):
    """(nodes, elements, loads, fixed) of the 6 x 12 grid, optionally with
    its nodes renumbered by a seeded permutation (no banded layout)."""
    doc = eg.grid_document(*GRID)
    if shuffled:
        doc, _ = eg.shuffled_document(doc, seed=3)
    return (np.asarray(doc["nodes"], float), np.asarray(doc["elements"]),
            np.asarray(doc["loads"], float), np.asarray(doc["fixed_dofs"]))


def point_masses(n_nodes):
    return np.random.default_rng(5).uniform(0.0, 2.0, n_nodes) * (
        np.arange(n_nodes) % 3 == 0)


def both_problems(shuffled=False, jmat=None, tmat=None, masses=True,
                  load_scale=1.0):
    nodes, elements, loads, fixed = grid_arrays(shuffled)
    loads = load_scale * loads
    pm = point_masses(len(nodes)) if masses else None
    jmat = jmat or jp.Material(young=1.0, area=1.0, density=1.0)
    tmat = tmat or tp.Material(young=1.0, area=1.0, density=1.0)
    return (jp.TrussProblem(nodes, elements, jmat, loads, fixed, 2,
                            point_masses=pm),
            tp.TrussProblem(nodes, elements, tmat, loads, fixed, 2,
                            point_masses=pm))


def mlp_materials():
    """E and rho as MLPs of seeded numpy weights (2 hidden layers of 8
    and 6, input (lf, x, y)), A a scalar: the JAX material and the
    port's."""
    rng = np.random.default_rng(11)

    def spec(width, scale):
        dims = [3, width, width, 1]
        return {"layers": [(rng.uniform(-0.5, 0.5, (a, b)).astype(np.float32),
                            rng.uniform(-0.5, 0.5, b).astype(np.float32))
                           for a, b in zip(dims[:-1], dims[1:])],
                "scale": np.float32(scale), "input_dim": 3,
                "enforce_positive": True}

    def jax_field(f):
        return jp.MLPField(layers=[(jax.numpy.asarray(w), jax.numpy.asarray(b))
                                   for w, b in f["layers"]],
                           scale=jax.numpy.asarray(f["scale"]), input_dim=3)

    young, rho = spec(8, 2.0), spec(6, 3.0)
    return (jp.Material(young=jax_field(young), area=0.7,
                        density=jax_field(rho)),
            tp.material_from_numpy(young, 0.7, rho, device="cpu"))


def prestress(t_problem):
    """The grid's static state under its own loads (float64 host solve)."""
    return _prestress_state(t_problem, True, "cpu")


# ------------------------------------------------------------ mass, K_g

def ops_gaps() -> dict:
    """Lumped, consistent (dense and banded) and total mass, axial forces
    and the geometric stiffness (dense and banded), port vs JAX, with an
    MLP density, an MLP Young's modulus and point masses; the host
    lumped mass and stiffness against the port's."""
    jmat, tmat = mlp_materials()
    jprob, tprob = both_problems(jmat=jmat, tmat=tmat)
    jd, td = jprob.to_device(use_native=False), tprob.to_device(CPU)
    u = np.random.default_rng(2).normal(size=tprob.ndof) * 1e-2
    j_ne = jax.jit(lambda d, x: j_geo.element_axial_forces(d, jmat, x))(
        jd, jax.numpy.asarray(u, jax.numpy.float32))
    t_ne = t_geo.element_axial_forces(td, tmat, torch.as_tensor(
        u, dtype=torch.float32))
    jl = j_dia.dia_layout(np.asarray(jd.dof_map), jprob.ndof)
    tl = t_dia.dia_layout(td.dof_map.numpy(), tprob.ndof)
    assert np.array_equal(jl.offsets, tl.offsets)

    @jax.jit
    def jax_ops(d, n_e):
        # One program: the JAX ops eagerly would compile one each.
        return {"lumped": j_mass.lumped_mass(d, jmat),
                "consistent": j_mass.consistent_mass(d, jmat),
                "consistent_dia": j_mass.consistent_mass_dia(jl, d, jmat),
                "total": j_mass.total_mass(d, jmat),
                "geometric": j_geo.assemble_geometric(d, n_e),
                "geometric_dia": j_geo.assemble_geometric_dia(jl, d, n_e),
                "stiffness": j_dyn.assemble_system(
                    d, jmat, jax.numpy.zeros(jprob.ndof))[0]}

    j = jax_ops(jd, j_ne)
    pairs = {
        "lumped": (j["lumped"], t_mass.lumped_mass(td, tmat)),
        "consistent": (j["consistent"], t_mass.consistent_mass(td, tmat)),
        "consistent_dia": (j["consistent_dia"],
                           t_mass.consistent_mass_dia(tl, td, tmat)),
        "total": (j["total"], t_mass.total_mass(td, tmat)),
        "axial": (j_ne, t_ne),
        "geometric": (j["geometric"], t_geo.assemble_geometric(td, t_ne)),
        "geometric_dia": (j["geometric_dia"],
                          t_geo.assemble_geometric_dia(tl, td, t_ne)),
        "host_lumped": (t_mass.lumped_mass(td, tmat),
                        t_host.host_lumped_mass(tprob)),
        "host_stiffness": (j["stiffness"], t_host.host_stiffness(tprob)),
    }
    assert np.array_equal(tprob.point_mass_dof(), jprob.point_mass_dof())
    return {name: rel_err(t, j) for name, (j, t) in pairs.items()}


def test_mass_and_geometric_ops():
    for name, gap in ops_gaps().items():
        assert gap <= OPS_RTOL, (name, gap)


# ------------------------------------------------------------- stable_dt

DT_CASES = {
    "dense": dict(limit=None, data=False, damping=(0.0, 0.0), pre=False),
    "dense-damped-prestressed": dict(limit=None, data=False,
                                     damping=(0.05, 1e-3), pre=True),
    "dense-on-device": dict(limit=None, data=True, damping=(0.05, 1e-3),
                            pre=True),
    "banded": dict(limit=BANDED_LIMIT, data=False, damping=(0.0, 0.0),
                   pre=False),
    "banded-damped-prestressed": dict(limit=BANDED_LIMIT, data=False,
                                      damping=(0.05, 1e-3), pre=True),
}


def stable_dt_pair(case):
    spec = DT_CASES[case]
    jprob, tprob = both_problems()
    pre = prestress(tprob) if spec["pre"] else None
    with dense_limit(spec["limit"]):
        kw = dict(damping=spec["damping"], prestress_u=pre)
        jd = jprob.to_device(use_native=False) if spec["data"] else None
        td = tprob.to_device(CPU) if spec["data"] else None
        return (j_dyn.stable_dt(jprob, data=jd, **kw),
                tp.stable_dt(tprob, data=td, device="cpu", **kw))


@pytest.mark.parametrize("case", list(DT_CASES))
def test_stable_dt_matches_jax(case):
    j, t = stable_dt_pair(case)
    host = DT_CASES[case]["limit"] is None and not DT_CASES[case]["data"]
    assert abs(t - j) / j <= (DT_DENSE_RTOL if host else DT_BANDED_RTOL)


# ------------------------------------------------------- solve_transient

def base_dt(prestressed=False):
    _, tprob = both_problems()
    return tp.stable_dt(tprob, prestress_u=prestress(tprob)
                        if prestressed else None)


CASES = {
    # name: (operator, solve_transient keywords)
    "central-dense": ("dense", dict(damping=(0.05, 0.0))),
    "central-dense-beta": ("dense", dict(damping=(0.05, 1e-3))),
    "central-dense-prestressed": ("dense", dict(prestress=True)),
    "central-dense-gl": ("dense", dict(geometric_nonlinear=True,
                                       damping=(0.05, 0.0),
                                       load_scale=GL_LOAD)),
    "central-banded": ("banded", dict(damping=(0.05, 0.0))),
    "central-banded-beta": ("banded", dict(damping=(0.05, 1e-3))),
    "central-banded-prestressed": ("banded", dict(prestress=True)),
    "central-banded-gl": ("banded", dict(geometric_nonlinear=True,
                                         load_scale=GL_LOAD)),
    "central-gather": ("gather", dict(damping=(0.05, 1e-3))),
    "newmark-dense": ("dense", dict(method="newmark",
                                    damping=(0.05, 1e-3))),
    "newmark-banded": ("banded", dict(method="newmark",
                                      damping=(0.05, 1e-3))),
    "newmark-banded-prestressed": ("banded", dict(method="newmark",
                                                  prestress=True)),
    "newmark-dense-gl": ("dense", dict(method="newmark",
                                       geometric_nonlinear=True,
                                       load_scale=GL_LOAD)),
    "moving-load": ("dense", dict(moving=True, damping=(0.05, 0.0))),
    "base-excitation": ("dense", dict(base=True, damping=(0.05, 0.0))),
}


def transient_pair(case, n_steps=200, record_every=20, port_only=False,
                   **extra):
    """(JAX result, port result) of one case at 0.5 x (newmark: 4 x) the
    float64 stable step, every DOF probed (port_only: (None, port))."""
    op, spec = CASES[case]
    spec = dict(spec)
    jprob, tprob = both_problems(shuffled=op == "gather",
                                 load_scale=spec.pop("load_scale", 1.0))
    pre = prestress(tprob) if spec.pop("prestress", False) else None
    dt = (4.0 if spec.get("method") == "newmark" else 0.5) * base_dt(
        pre is not None)
    kw = dict(n_steps=n_steps, record_every=record_every, prestress_u=pre,
              **spec, **extra)
    moving, base = kw.pop("moving", False), kw.pop("base", False)
    top = np.arange(GRID[0] * GRID[1] - GRID[1], GRID[0] * GRID[1])
    accel = np.sin(np.arange(n_steps) * 0.3)
    with dense_limit(None if op == "dense" else BANDED_LIMIT):
        runs = [None] if port_only else []
        for pkg, prob, extra_kw in ((j_dyn, jprob, {}),
                                    (tp, tprob, {"device": "cpu"}))[
                                        port_only:]:
            if moving:
                kw["force_fn"] = pkg.moving_load_force_fn(
                    prob, top, speed=4.0, magnitude=-1.0, dt=dt,
                    **extra_kw)
            if base:
                kw["force_fn"] = pkg.base_excitation_force_fn(
                    prob, accel, direction=[0.0, 1.0], **extra_kw)
            runs.append(pkg.solve_transient(prob, dt, **kw, **extra_kw))
    return runs


_PAIRS = {}


def cached_pair(case):
    if case not in _PAIRS:
        _PAIRS[case] = transient_pair(case)
    return _PAIRS[case]


def history_gaps(j, t) -> dict:
    return {k: rel_err(getattr(t, k), getattr(j, k))
            for k in ("displacements", "velocities", "kinetic_energy",
                      "strain_energy", "u_final", "v_final")}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_transient_matches_jax(case):
    j, t = cached_pair(case)
    assert np.array_equal(t.times, j.times)
    assert np.all(np.isfinite(t.displacements))
    assert np.abs(t.displacements).max() > 0
    bound = NEWMARK_RTOL if case.startswith("newmark") else CENTRAL_RTOL
    gaps = history_gaps(j, t)
    assert gaps.pop("v_final") <= V_FINAL_RTOL
    for name, gap in gaps.items():
        assert gap <= bound, (name, gap)


def test_operator_paths_taken():
    """The three operators: a dense K, the banded diagonals (kernel 1's
    twin) and the gather form (no matrix)."""
    from pinn_fem_tpu_torch.solvers.dynamics import _operator

    kinds = {}
    for op in ("dense", "banded", "gather"):
        _, tprob = both_problems(shuffled=op == "gather")
        with dense_limit(None if op == "dense" else BANDED_LIMIT):
            o = _operator(tprob, tprob.to_device(CPU), None)
        kinds[op] = (o.layout is not None, o.matrix is None)
    assert kinds == {"dense": (False, False), "banded": (True, False),
                     "gather": (False, True)}


def exact_restart_gaps() -> dict:
    """A second segment from (u_final, v_final) with exact_restart in
    both packages (history gaps), and the port's two segments against its
    own uninterrupted run ("whole")."""
    whole = cached_pair("central-dense-beta")[1]
    first = transient_pair("central-dense-beta", n_steps=100,
                           port_only=True)[1]
    j2, t2 = transient_pair(
        "central-dense-beta", n_steps=100, exact_restart=True,
        u0=first.u_final, v0=first.v_final)
    return {**history_gaps(j2, t2),
            "whole": rel_err(t2.displacements, whole.displacements[5:])}


def test_exact_restart_matches_jax_and_the_whole_run():
    gaps = exact_restart_gaps()
    assert gaps.pop("whole") <= RESUME_RTOL
    assert gaps.pop("v_final") <= V_FINAL_RTOL
    for name, gap in gaps.items():
        assert gap <= CENTRAL_RTOL, (name, gap)


# ----------------------------------------------------------- checkpoints

def checkpoint_run(pkg, prob, directory, n_steps, **kw):
    extra = {"device": "cpu"} if pkg is tp else {}
    return pkg.solve_transient_checkpointed(
        prob, 0.05, n_steps, directory, checkpoint_every=50,
        damping=(0.05, 1e-3), record_every=10, **extra, **kw)


def checkpoint_gaps(tmp_path) -> dict:
    """solve_transient_checkpointed in both packages ("records", the
    largest history gap; "plain", the port's against its own
    unsegmented run); and the transient.npz / transient_meta.json of each
    package, stopped after 100 of 200 steps, resumed by the other against
    the other's uninterrupted tail ("jax-to-port", "port-to-jax")."""
    jprob, tprob = both_problems()
    j_full = checkpoint_run(j_dyn, jprob, tmp_path / "jf", 200)
    t_full = checkpoint_run(tp, tprob, tmp_path / "tf", 200)
    t_plain = tp.solve_transient(tprob, 0.05, 200, damping=(0.05, 1e-3),
                                 record_every=10, device="cpu")
    gaps = {"records": max(history_gaps(j_full, t_full).values()),
            "plain": rel_err(t_full.displacements, t_plain.displacements)}
    for writer, w_prob, reader, r_prob, whole, tag in (
            (j_dyn, jprob, tp, tprob, t_full, "jax-to-port"),
            (tp, tprob, j_dyn, jprob, j_full, "port-to-jax")):
        d = tmp_path / tag
        checkpoint_run(writer, w_prob, d, 100)
        step, _, _, meta = t_ckpt.load_transient_state(d)
        assert (step, meta["n_steps"]) == (100, 100)
        assert j_ckpt.load_transient_state(d)[0] == 100
        resumed = checkpoint_run(reader, r_prob, d, 200)
        assert np.array_equal(resumed.times, whole.times[10:])
        gaps[tag] = rel_err(resumed.displacements, whole.displacements[10:])
    return gaps


def test_checkpointed_matches_jax_and_files_cross_resume(tmp_path):
    gaps = checkpoint_gaps(tmp_path)
    assert gaps.pop("records") <= CENTRAL_RTOL
    for name, gap in gaps.items():
        assert gap <= RESUME_RTOL, (name, gap)


def test_transient_state_files():
    """save / load round trip; the atomic rename leaves no temporary."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        u, v = np.arange(4, dtype=np.float32), -np.arange(4.0)
        t_ckpt.save_transient_state(d, 7, torch.from_numpy(u), v,
                                    meta={"dt": 0.1})
        step, u2, v2, meta = j_ckpt.load_transient_state(d)
        assert step == 7 and meta["dt"] == 0.1
        assert np.array_equal(u2, u) and np.array_equal(v2, v)
        assert not (Path(d) / ".transient.tmp").exists()
        assert t_ckpt.load_transient_state(Path(d) / "none") is None


# -------------------------------------------------------- the documents

def cli_pair(tmp_path, doc, name):
    for pkg, cli in (("jax", jax_cli), ("port", torch_cli)):
        path = tmp_path / f"{name}-{pkg}.json"
        path.write_text(json.dumps(doc))
        assert cli.main([str(path)]) == 0
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    return [json.loads((tmp_path / f"{name}-{pkg}.res.json").read_text())
            for pkg in ("jax", "port")]


def cli_gaps(j, t) -> dict:
    return {"dt": abs(t["dt"] - j["dt"]) / j["dt"],
            **{k: rel_err(t[k], j[k]) for k in (
                "displacements", "velocities", "kinetic_energy",
                "strain_energy")}}


CLI_DOCS = {
    "dyn-transient": lambda: json.loads(
        (CORPUS / "dyn-transient.json").read_text()),
    "grid24x48": lambda: eg.transient_grid_document(24, 48),
}


@pytest.mark.parametrize("name", list(CLI_DOCS))
def test_transient_documents_through_both_clis(tmp_path, monkeypatch, name):
    """The corpus document (12 DOFs, dense, dt "auto" on the float64
    host bound) and the 24 x 48 grid (2,304 DOFs: the banded operator)."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    j, t = cli_pair(tmp_path, CLI_DOCS[name](), name)
    assert list(t) == list(j)
    for key in ("analysis", "method", "n_steps", "record_every",
                "prestressed", "load_type", "moving_load", "checkpointed",
                "probe_dofs", "times"):
        assert t[key] == j[key], key
    gaps = cli_gaps(j, t)
    assert gaps.pop("dt") <= CLI_DT_RTOL
    for key, gap in gaps.items():
        assert gap <= CLI_RTOL, (key, gap)


def grid_float64_gap() -> float:
    """The port's 24 x 48 grid history (banded) against the float64
    transcription of the same recurrence at the same dt."""
    doc = eg.transient_grid_document(24, 48)
    parsed = parse_problem_dict(doc)
    out = run_analysis(parsed.problem, doc["analysis"], "cpu")
    ref = eg.float64_transient(doc, out["dt"])
    return rel_err(out["displacements"], ref["displacements"])


def test_grid_document_against_float64():
    assert grid_float64_gap() <= GRID_F64_RTOL


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kw, item", [
    pytest.param(dict(host=True), "17", id="kw1-17"),
])
def test_unported_solver_options_refused(kw, item):
    _, tprob = both_problems()
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        tp.solve_transient(tprob, 0.01, 10, device="cpu", **kw)


@pytest.mark.parametrize("extra, item", [
    ({"type": "identification"}, 23),
    ({"type": "sizing"}, 24),
])
def test_unported_transient_keys_refused(extra, item):
    """Every transient key runs, the "plasticity" key included; a
    transient block retyped to an analysis still to port is refused
    with that type's ROADMAP item, whatever transient keys it carries."""
    _, tprob = both_problems()
    analysis = {"type": "transient", "dt": 0.01, "n_steps": 10,
                "plasticity": {"sigma_y": 1.0}, **extra}
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        run_analysis(tprob, analysis, "cpu")


UNPORTED_ITEMS = {"identification": 23, "sizing": 24, "reliability": 24}


@pytest.mark.parametrize("kind", list(UNPORTED_ITEMS))
def test_other_analysis_types_refused(kind):
    """Each type not yet ported names its ROADMAP item: the truss
    identification, sizing and reliability solvers are items 23 and 24."""
    _, tprob = both_problems()
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP item {UNPORTED_ITEMS[kind]}$"):
        run_analysis(tprob, {"type": kind}, "cpu")


@pytest.mark.parametrize("call, match", [
    (lambda p: tp.solve_transient(p, 0.01, 10, record_every=3,
                                  device="cpu"), "multiple of"),
    (lambda p: run_analysis(p, {"type": "transient", "method": "newmark",
                                "n_steps": 10}, "cpu"), "auto"),
    (lambda p: tp.solve_transient(p, 0.01, 10, geometric_nonlinear=True,
                                  prestress_u=np.zeros(p.ndof),
                                  device="cpu"), "LINEARIZED"),
    (lambda p: tp.solve_transient(p, 0.01, 10, method="newmark",
                                  force_fn=lambda i: None, device="cpu"),
     "central"),
    (lambda p: run_analysis(p, {"type": "bogus"}, "cpu"), "analysis.type"),
])
def test_jax_value_errors_kept(call, match):
    """The ValueErrors of the JAX contract, raised by both packages."""
    _, tprob = both_problems()
    with pytest.raises(ValueError, match=match):
        call(tprob)
