"""The port's checkpoint / resume (utils/checkpoint.py, solvers/driver.py)
against the JAX package's, on the CPU.

Both packages write the same state.msgpack and meta.json bytes for the
same (increment, u, theta), each reads the other's files, and each resumes
a run from the other's checkpoint to its own uninterrupted answer.  The
port's cases of tests/test_aux.py:25-66 run here too.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
from pinn_fem_tpu.solvers.gd import get_theta as j_get_theta  # noqa: E402
from pinn_fem_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from pinn_fem_tpu_torch import examples_grid as eg  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.models.fields import assembly_inputs  # noqa: E402
from pinn_fem_tpu_torch.solvers.gd import get_theta, set_theta  # noqa: E402
from pinn_fem_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
# A resumed nr run against the same package's uninterrupted one: the
# contract's 1e-5 of max |u| (measured 7.2e-8 JAX to port, 1.4e-7 port to
# JAX: the warm start from the other package's increment 1 differs from
# its own by float32 rounding; tests/measure_torch_agreement.py
# checkpoint).
RESUME_RTOL = 1e-5
# The port's GD resume of example3 (1 MLP field, 2 increments) against an
# uninterrupted port run: increment 1 runs the same operations in both,
# so u and theta agree bit for bit on the CPU (measured 0, 454 rows in
# both); bound 1e-6.
GD_RESUME_RTOL = 1e-6


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def jax_material(n_fields: int, seed: int = 0):
    """A JAX Material whose first n_fields fields are MLPs."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    widths = (6, 5, 4)
    fields = [jp.make_mlp_field(keys[k], 2, widths[k], input_dim=3,
                                scale=1.0 + k)
              if k < n_fields else jp.to_field(1.0 + k) for k in range(3)]
    return jp.Material(young=fields[0], area=fields[1], density=fields[2])


def port_material(jmat):
    """The port's Material with the JAX material's weights."""
    def spec(f):
        if isinstance(f, jp.MLPField):
            return {"layers": [(np.asarray(w), np.asarray(b))
                               for w, b in f.layers],
                    "scale": np.asarray(f.scale), "input_dim": f.input_dim,
                    "enforce_positive": f.enforce_positive}
        return float(np.asarray(f.value))
    return tp.material_from_numpy(spec(jmat.young), spec(jmat.area),
                                  spec(jmat.density), device="cpu")


def leaves(theta):
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                       else x) for layers in theta for pair in layers
            for x in pair]


@pytest.mark.parametrize("n_fields", [0, 1, 2, 3])
def test_state_files_are_byte_equal_to_jax(tmp_path, n_fields):
    jmat = jax_material(n_fields)
    u = np.linspace(-1.0, 2.0, 14)
    meta = {"method": "gd", "load_factor": 0.7}
    j_ckpt.save_increment_state(tmp_path / "jax", 3, u, j_get_theta(jmat),
                                meta=meta)
    t_ckpt.save_increment_state(tmp_path / "port", 3, u,
                                get_theta(port_material(jmat)), meta=meta)
    for name in ("state.msgpack", "meta.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


@pytest.mark.parametrize("n_fields", [0, 1, 2, 3])
def test_each_package_loads_the_others_state(tmp_path, n_fields):
    jmat = jax_material(n_fields)
    tmat = port_material(jmat)
    u = np.arange(10.0) * 0.25
    j_ckpt.save_increment_state(tmp_path / "jax", 5, u, j_get_theta(jmat))
    t_ckpt.save_increment_state(tmp_path / "port", 5, u, get_theta(tmat))
    inc, u_t, theta_t = t_ckpt.load_increment_state(tmp_path / "jax",
                                                    get_theta(tmat))
    assert inc == 5 and u_t.dtype == np.float64
    np.testing.assert_array_equal(u_t, u)
    assert all(isinstance(p, tuple) for layers in theta_t for p in layers)
    for a, b in zip(leaves(theta_t), leaves(j_get_theta(jmat))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    inc, u_j, theta_j = j_ckpt.load_increment_state(tmp_path / "port",
                                                    j_get_theta(jmat))
    assert inc == 5
    np.testing.assert_array_equal(u_j, u)
    for a, b in zip(leaves(theta_j), leaves(get_theta(tmat))):
        np.testing.assert_array_equal(a, b)


def test_theta_from_a_jax_checkpoint_gives_the_jax_fields(tmp_path):
    """theta loaded from the JAX file into a port material of the same
    shapes (other weights) gives the fields that material_from_numpy gives
    from the JAX weights, bit for bit."""
    jmat = jax_material(3, seed=1)
    j_ckpt.save_increment_state(tmp_path, 1, np.zeros(4), j_get_theta(jmat))
    carried = port_material(jmat)
    other = port_material(jax_material(3, seed=2))
    _, _, theta = t_ckpt.load_increment_state(tmp_path, get_theta(other))
    restored = set_theta(other, theta)
    pts = torch.tensor(np.random.default_rng(1).uniform(0, 3, (7, 2)),
                       dtype=torch.float32)
    x = assembly_inputs(pts, 2, 0.5)
    for name in ("young", "area", "density"):
        assert torch.equal(getattr(restored, name).eval_batch(x),
                           getattr(carried, name).eval_batch(x))


# --- tests/test_aux.py:25-66 on the port ------------------------------------


def chain_problem(material=None):
    return tp.TrussProblem(
        nodes=np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]]),
        elements=np.array([[0, 1], [1, 2], [2, 3]]),
        material=material or tp.Material(young=1.0, area=1.0, density=1.0),
        loads=np.array([0, 0, 0, 0, 0, 0, 1.0, 0]),
        fixed_dofs=np.array([0, 1, 3, 5, 7]), dimension=2)


def test_checkpoint_roundtrip(tmp_path):
    mat = port_material(jax_material(1))
    theta = get_theta(mat)
    u = np.arange(8.0)
    t_ckpt.save_increment_state(tmp_path, 7, u, theta, meta={"method": "gd"})
    inc, u2, theta2 = t_ckpt.load_increment_state(tmp_path, get_theta(mat))
    assert inc == 7
    np.testing.assert_array_equal(u2, u)
    for a, b in zip(leaves(theta), leaves(theta2)):
        np.testing.assert_array_equal(a, b)


def test_load_missing_checkpoint_returns_none(tmp_path):
    assert t_ckpt.load_increment_state(tmp_path / "nope", []) is None


def test_solve_with_checkpoint_and_resume(tmp_path, caplog):
    ckpt = tmp_path / "run"
    full = tp.solve(chain_problem(), tp.SolverConfig(method="nr"),
                    verbose=False, checkpoint_dir=str(ckpt), device="cpu")
    assert (ckpt / "state.msgpack").exists()
    assert t_ckpt.load_increment_state(ckpt, [])[0] == 10
    # A preempted run: the checkpoint says increment 6 is done.
    t_ckpt.save_increment_state(
        ckpt, 6, np.asarray(full.displacements).flatten() * 0.6, [])
    with caplog.at_level(logging.INFO, logger="pinn_fem_tpu_torch"):
        resumed = tp.solve(chain_problem(), tp.SolverConfig(method="nr"),
                           verbose=True, checkpoint_dir=str(ckpt),
                           resume=True, device="cpu")
    assert "[resume] restored checkpoint after increment 6" in caplog.text
    np.testing.assert_allclose(resumed.displacements, full.displacements,
                               atol=1e-5)


# --- resumes across the packages ---------------------------------------------


def _grid(pkg):
    nodes, elements, loads, fixed = eg.grid_arrays(6, 10)
    return pkg.TrussProblem(nodes=nodes, elements=elements,
                            material=pkg.Material(young=1.0, area=1.0,
                                                  density=1.0),
                            loads=loads, fixed_dofs=fixed, dimension=2)


def _solve(pkg, **kw):
    extra = {"device": "cpu"} if pkg is tp else {}
    return pkg.solve(_grid(pkg), verbose=False, **kw, **extra)


@pytest.mark.parametrize("writer,reader", [(jp, tp), (tp, jp)],
                         ids=["jax-to-port", "port-to-jax"])
def test_resume_from_the_other_packages_checkpoint(tmp_path, writer, reader):
    """The writer's nr run of the first of two increments (lf 0.5) leaves
    its checkpoint; the reader resumes it and runs increment 2, to its own
    uninterrupted two-increment answer."""
    ckpt = str(tmp_path / "ckpt")
    _solve(writer, config=writer.SolverConfig(
        method="nr", n_increments=1, load_factor_final=0.5),
        checkpoint_dir=ckpt)
    meta = (tmp_path / "ckpt" / "meta.json").read_text()
    assert meta == '{"increment": 1, "method": "nr", "load_factor": 0.5}'
    cfg = reader.SolverConfig(method="nr", n_increments=2)
    resumed = _solve(reader, config=cfg, checkpoint_dir=ckpt, resume=True)
    whole = _solve(reader, config=reader.SolverConfig(method="nr",
                                                      n_increments=2))
    assert resumed.converged and whole.converged
    assert rel_err(resumed.displacements, whole.displacements) <= RESUME_RTOL
    inc, u, _ = j_ckpt.load_increment_state(tmp_path / "ckpt", [])
    assert inc == 2 and u.dtype == np.float64


def test_gd_resume_restores_theta_and_the_answer(tmp_path):
    """example3 (one MLP field, gd) in two increments: a run of the first
    increment alone leaves its checkpoint; the resumed run restores theta
    bit for bit, runs increment 2, and ends at the uninterrupted run's u
    and theta."""
    doc = json.loads((CORPUS / "example3.json").read_text())
    doc["solver_config"] = {"n_increments": 2}

    def run(**kw):
        parsed = parse_problem_dict(doc)
        cfg = parsed.config
        for key, value in kw.pop("config", {}).items():
            setattr(cfg, key, value)
        res = tp.solve(parsed.problem, cfg, parsed.measured_disp,
                       parsed.measured_dofs, verbose=False, device="cpu",
                       **kw)
        return parsed.problem, res

    ckpt = tmp_path / "ckpt"
    first, r1 = run(config={"n_increments": 1, "load_factor_final": 0.5},
                    checkpoint_dir=str(ckpt))
    assert r1.converged
    saved = get_theta(first.material)
    _, _, theta = t_ckpt.load_increment_state(ckpt, saved)
    for a, b in zip(leaves(theta), leaves(saved)):
        np.testing.assert_array_equal(a, b)
    resumed, r2 = run(checkpoint_dir=str(ckpt), resume=True)
    whole, r3 = run()
    assert r2.converged and r3.converged
    assert len(r2.history) == len(r3.history)
    assert rel_err(r2.displacements, r3.displacements) <= GD_RESUME_RTOL
    for a, b in zip(leaves(get_theta(resumed.material)),
                    leaves(get_theta(whole.material))):
        assert rel_err(a, b) <= GD_RESUME_RTOL
