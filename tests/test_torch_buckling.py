"""The port's linearized buckling (solvers/buckling.py) and "buckling"
documents against the JAX package, on the CPU.

The same inputs, made by numpy, go to both packages: a braced column
with a closed-form critical load, the cross-braced towers of
tests/test_buckling.py and the corpus document dyn-buckling.json.  The
dense float64 path is held to the JAX host tier at 1e-10; the float32
paths at the gaps measured here times a margin, never tighter than the
JAX package's floor eps32 kappa(K_ff) (kappa ~ 4e4 on the 12-story
tower: ~5e-3).  The banded path runs with DENSE_DOF_LIMIT patched below
the mesh in both packages' Newton modules.
"""

import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import pinn_fem_tpu as jp  # noqa: E402
import pinn_fem_tpu.solvers.newton as j_newton  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.solvers import buckling as j_buckling  # noqa: E402
import pinn_fem_tpu_torch as tp  # noqa: E402
import pinn_fem_tpu_torch.solvers.newton as t_newton  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.solvers.modal import mac  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"

# Dense float64 against the JAX host tier: load factors measured up to
# 9.3e-13 relative on the 12-story tower, u_base 1.6e-13 and N 2.3e-14 of
# their largest entries; bound 1e-10.
F64_RTOL = 1e-10
# The traced float32 path (host=False): load factors measured up to
# 1.1e-4 relative on the 12-story tower (1.8e-5 on 4 stories), u_base
# 1.3e-5; bound 1e-3, under the tower's eps32 kappa ~ 5e-3.
F32_RTOL = 1e-3
# Banded, port against JAX after BANDED_JAX_ITERS shifted subspace
# iterations from the same start vectors: the critical factor measured
# 1.9e-4 relative apart (float32 block solves), u_base 4.1e-5, N 5.7e-6;
# bound 5e-3, eps32 kappa of the tower.  Banded against dense after 25
# iterations: measured 2.9e-4, held to tests/test_buckling.py's 2e-3.
BANDED_JAX_ITERS = 4
BANDED_RTOL = 5e-3
BANDED_VS_DENSE_RTOL = 2e-3


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@contextlib.contextmanager
def dense_limit(limit):
    saved = (j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT)
    j_newton.DENSE_DOF_LIMIT = t_newton.DENSE_DOF_LIMIT = limit
    try:
        yield
    finally:
        j_newton.DENSE_DOF_LIMIT, t_newton.DENSE_DOF_LIMIT = saved


def braced_column(pkg, brace_length=4.0, p=1.0):
    """Vertical bar 0 -> 1 (length 1) under compression P at node 1,
    braced along x by a horizontal bar 1 -> 2 of length brace_length;
    E = A = 1.  The pencil on node 1 is diag(k_b - lam P, k_v - lam P)
    with k_b = 1 / brace_length, k_v = 1: lam = (k_b / P, k_v / P), the
    first a pure x sway (tests/test_buckling.py's column with the
    stiffness ratio set by lengths)."""
    nodes = np.array([[0.0, 0.0], [0.0, 1.0], [brace_length, 1.0]])
    loads = np.zeros(6)
    loads[3] = -p
    return pkg.TrussProblem(nodes, np.array([[0, 1], [1, 2]]),
                            pkg.Material(young=1.0, area=1.0, density=1.0),
                            loads, np.array([0, 1, 4, 5]), 2)


def tower(pkg, stories=12, young=1000.0):
    """The cross-braced 2-chord tower of tests/test_buckling.py under
    vertical tip compression."""
    nodes, elements = [], []
    for s in range(stories + 1):
        nodes += [[0.0, float(s)], [1.0, float(s)]]
    for s in range(stories):
        a, b, c, d = 2 * s, 2 * s + 1, 2 * s + 2, 2 * s + 3
        elements += [[a, c], [b, d], [c, d], [a, d], [b, c]]
    loads = np.zeros(2 * len(nodes))
    loads[2 * (2 * stories) + 1] = -1.0
    loads[2 * (2 * stories + 1) + 1] = -1.0
    return pkg.TrussProblem(np.array(nodes), np.array(elements),
                            pkg.Material(young=young, area=1.0, density=1.0),
                            loads, np.array([0, 1, 2, 3]), 2)


def test_braced_column_closed_form_and_jax():
    t = tp.buckling_analysis(braced_column(tp), n_modes=2, device="cpu")
    j = j_buckling.buckling_analysis(braced_column(jp), n_modes=2)
    np.testing.assert_allclose(t.load_factors, [0.25, 1.0], rtol=1e-12)
    np.testing.assert_allclose(t.load_factors, j.load_factors, rtol=F64_RTOL)
    np.testing.assert_allclose(t.axial_forces, [-1.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(t.u_base, j.u_base, atol=1e-12)
    assert abs(t.modes[2, 0]) > 100 * abs(t.modes[3, 0])    # x sway
    assert t.ok
    # Doubling the load halves every factor; host=True is the same
    # computation on the CPU.
    t2 = tp.buckling_analysis(braced_column(tp, p=2.0), n_modes=2, host=True)
    np.testing.assert_allclose(t.load_factors, 2.0 * t2.load_factors,
                               rtol=1e-12)


@pytest.mark.parametrize("stories", [12])
def test_dense_tower_matches_jax(stories):
    """The float64 default path against the JAX host tier, and the traced
    float32 path (host=False) against the JAX traced core (one jitted
    program)."""
    import jax

    j = j_buckling.buckling_analysis(tower(jp, stories), n_modes=3)
    t = tp.buckling_analysis(tower(tp, stories), n_modes=3, device="cpu")
    np.testing.assert_allclose(t.load_factors, j.load_factors, rtol=F64_RTOL)
    assert rel_err(t.u_base, j.u_base) <= F64_RTOL
    assert rel_err(t.axial_forces, j.axial_forces) <= F64_RTOL
    assert np.min(np.diag(mac(t.modes, j.modes))) >= 1.0 - 1e-8
    jprob = tower(jp, stories)
    lam, v, _, u_base = jax.device_get(jax.jit(
        lambda d: j_buckling._buckling_traced(jprob, 3, d, None, None))(
            jprob.to_device(use_native=False)))
    t32 = tp.buckling_analysis(tower(tp, stories), n_modes=3, host=False,
                               device="cpu")
    assert t32.load_factors.dtype == np.float32
    np.testing.assert_allclose(t32.load_factors, lam, rtol=F32_RTOL)
    assert rel_err(t32.u_base, u_base) <= F32_RTOL
    free = jprob.free_fixed()[0]
    assert np.min(np.diag(mac(t32.modes[free], v))) >= 0.999


def test_buckling_eigenvalues_differentiable():
    """d lam_c / dE = lam_c / E for a uniform material (K scales with E,
    N does not), as tests/test_buckling.py:101 asserts in JAX."""
    import torch

    e0 = torch.tensor(10.0, requires_grad=True)
    nodes = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    loads = np.zeros(6)
    loads[3] = -1.0
    prob = tp.TrussProblem(nodes, np.array([[0, 1], [1, 2]]),
                           tp.Material(young=tp.ScalarField(e0), area=1.0,
                                       density=1.0),
                           loads, np.array([0, 1, 4, 5]), 2)
    lam = tp.buckling_eigenvalues(prob, n_modes=1, device="cpu")[0]
    lam.backward()
    assert float(lam.detach()) == pytest.approx(10.0, rel=1e-5)
    assert float(e0.grad) == pytest.approx(float(lam.detach()) / 10.0,
                                           rel=1e-4)


def test_banded_buckling_matches_jax_and_dense():
    """The 12-story tower (52 DOFs) on the banded path: port against JAX
    after BANDED_JAX_ITERS iterations from the same start vectors, and
    the port's 25 iterations of one mode against the dense float64
    factor."""
    dense = tp.buckling_analysis(tower(tp), n_modes=1, device="cpu")
    with dense_limit(16):
        j = j_buckling.buckling_analysis(tower(jp), n_modes=2,
                                         n_iter=BANDED_JAX_ITERS)
        t = tp.buckling_analysis(tower(tp), n_modes=2,
                                 n_iter=BANDED_JAX_ITERS, device="cpu")
        full = tp.buckling_analysis(tower(tp), n_modes=1, n_iter=25,
                                    device="cpu")
        starved = tp.buckling_analysis(tower(tp), n_modes=1, n_iter=2,
                                       device="cpu")
        blind = tp.buckling_analysis(tower(tp), n_modes=1, n_iter=1,
                                     device="cpu")
    assert t.ok == j.ok
    assert rel_err(t.load_factors[0], j.load_factors[0]) <= BANDED_RTOL
    assert rel_err(t.u_base, j.u_base) <= BANDED_RTOL
    assert rel_err(t.axial_forces, j.axial_forces) <= BANDED_RTOL
    assert mac(t.modes[:, 0], j.modes[:, 0])[0, 0] >= 0.999
    np.testing.assert_allclose(full.load_factors, dense.load_factors,
                               rtol=BANDED_VS_DENSE_RTOL)
    assert mac(full.modes[:, 0], dense.modes[:, 0])[0, 0] >= 0.99
    # The trust flag (tests/test_buckling.py:336): converged runs set it;
    # starved and single-iteration runs do not.
    assert full.ok and not starved.ok and not blind.ok


def test_buckling_document_through_both_clis(tmp_path, monkeypatch):
    """dyn-buckling.json: equal keys, flags, exit codes and, to float64
    rounding, numbers (shapes by |phi|)."""
    monkeypatch.setenv("PINN_FEM_TORCH_DEVICE", "cpu")
    doc = json.loads((CORPUS / "dyn-buckling.json").read_text())
    out = []
    for pkg, cli in (("jax", jax_cli), ("port", torch_cli)):
        path = tmp_path / f"buckling-{pkg}.json"
        path.write_text(json.dumps(doc))
        assert cli.main([str(path)]) == 0, pkg
        out.append(json.loads((tmp_path / f"buckling-{pkg}.res.json")
                              .read_text()))
    logging.getLogger("pinn_fem_tpu").handlers.clear()
    j, t = out
    assert list(t) == list(j)
    for key in ("success", "analysis", "n_modes", "ok"):
        assert t[key] == j[key], key
    for key in ("load_factors", "axial_forces", "u_base"):
        assert rel_err(t[key], j[key]) <= F64_RTOL, key
    assert rel_err(np.abs(t["buckling_modes"]),
                   np.abs(j["buckling_modes"])) <= 1e-8


def test_buckling_refusals():
    """Both packages' ValueErrors: a custom ProblemData with host=True;
    the dense-only traced core above the dense limit."""
    jprob, tprob = braced_column(jp), braced_column(tp)
    with pytest.raises(ValueError, match="host buckling reads"):
        j_buckling.buckling_analysis(
            jprob, n_modes=1, data=jprob.to_device(use_native=False),
            host=True)
    with pytest.raises(ValueError, match="host buckling reads"):
        tp.buckling_analysis(tprob, n_modes=1, data=tprob.to_device("cpu"),
                             host=True)
    with dense_limit(4):
        with pytest.raises(ValueError, match="dense-only"):
            j_buckling.buckling_eigenvalues(jprob, n_modes=1)
        with pytest.raises(ValueError, match="dense-only"):
            tp.buckling_eigenvalues(tprob, n_modes=1, device="cpu")
