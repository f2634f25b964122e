"""The port's NN initialisation against the JAX package's, on the CPU.

pinn_fem_tpu_torch/utils/prng.py reproduces jax.random's PRNGKey, split and
float32 uniform in numpy, so that the port's CLI draws the initial weights
the JAX CLI draws.  Held here bit for bit: the three functions over many
seeds and every fan-in and width the corpus uses; `_build_material` leaf
for leaf on every NN document of examples/json; and both CLIs, with no
weights passed between them, on three NN documents (converged, history
length and displacements within U_ATOL of tests/test_torch_gd.py).
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
from pinn_fem_tpu.io.schema import parse_problem_dict as j_parse  # noqa: E402
from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.models.fields import MLPField, make_mlp_field  # noqa: E402
from pinn_fem_tpu_torch.utils import prng  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "examples" / "json"
NN_DOCUMENTS = sorted(
    p.name for p in CORPUS.glob("example*.json")
    if any(isinstance(c, dict) and c.get("enabled")
           for c in json.loads(p.read_text()).get("nn_config", {}).values()))
# Seeds: the CLI's seed * 1000 + k (k = 0, 1, 2 for E, A, rho) for seeds 0,
# 1, 2, 5 and 7, and others, large ones included.
SEEDS = sorted({1000 * s + k for s in (0, 1, 2, 5, 7) for k in (0, 1, 2)}
               | {3, 42, 999, 65_535, 123_456_789, 2**31 - 1})
FAN_INS = (3, 20, 15, 10)     # the corpus nets' input_dim and widths
WIDTHS = (20, 15, 10, 1)
U_ATOL = 2e-6                 # tests/test_torch_gd.py


def bits(a):
    return np.asarray(a).view(np.uint32)


def test_nn_corpus_is_what_the_seeds_cover():
    assert len(SEEDS) >= 20
    assert NN_DOCUMENTS == ["example10.json", "example3-P.json",
                            "example3.json", "example4-P.json",
                            "example4.json", "example6-P.json",
                            "example6.json", "example7-P.json",
                            "example7.json", "example9.json"]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_equals_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.PRNGKey(seed)
    assert mine.dtype == np.uint32
    np.testing.assert_array_equal(mine, np.asarray(key))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(mine, num),
                                      np.asarray(jax.random.split(key, num)))
    _, kw, kb = prng.split(mine, 3)
    _, jw, jb = jax.random.split(key, 3)
    for fan_in in FAN_INS:
        bound = 1.0 / np.sqrt(fan_in)
        for width in WIDTHS:
            want = jax.random.uniform(jw, (fan_in, width), jnp.float32,
                                      -bound, bound)
            got = prng.uniform(kw, (fan_in, width), -bound, bound)
            assert got.dtype == np.float32 and got.shape == (fan_in, width)
            np.testing.assert_array_equal(bits(got), bits(want))
        want = jax.random.uniform(jb, (fan_in,), jnp.float32, -bound, bound)
        np.testing.assert_array_equal(
            bits(prng.uniform(kb, (fan_in,), -bound, bound)), bits(want))
    np.testing.assert_array_equal(
        bits(prng.uniform(kw, (7,))),
        bits(jax.random.uniform(jw, (7,), jnp.float32)))


@pytest.mark.parametrize("hidden,width,input_dim",
                         [(2, 20, 3), (2, 15, 3), (2, 10, 3), (1, 20, 1),
                          (3, 12, 2)])
def test_make_mlp_field_equals_jax(hidden, width, input_dim):
    key = 7 * hidden + width
    want = J.make_mlp_field(jax.random.PRNGKey(key), hidden_layers=hidden,
                            neurons_per_layer=width, input_dim=input_dim,
                            scale=3.5)
    got = make_mlp_field(prng.PRNGKey(key), hidden_layers=hidden,
                         neurons_per_layer=width, input_dim=input_dim,
                         scale=3.5)
    assert len(got.layers) == len(want.layers) == hidden + 1
    for (w, b), (jw, jb) in zip(got.layers, want.layers):
        np.testing.assert_array_equal(bits(w.numpy()), bits(jw))
        np.testing.assert_array_equal(bits(b.numpy()), bits(jb))
    assert float(got.scale) == float(want.scale)


def field_leaves(field):
    if isinstance(field, (J.MLPField, MLPField)):
        return [np.asarray(t) for layer in field.layers for t in layer] + [
            np.asarray(field.scale), field.input_dim, field.enforce_positive]
    return [np.asarray(field.value, np.float32)]


@pytest.mark.parametrize("name", NN_DOCUMENTS)
@pytest.mark.parametrize("seed", [0, 3])
def test_build_material_equals_jax(name, seed):
    """The parsed material of each NN document: every leaf of every field,
    bit for bit, as the JAX CLI builds it."""
    doc = json.loads((CORPUS / name).read_text())
    jm = j_parse(doc, seed=seed).problem.material
    tm = parse_problem_dict(doc, seed=seed).problem.material
    for prop in ("young", "area", "density"):
        jf, tf = getattr(jm, prop), getattr(tm, prop)
        assert isinstance(tf, MLPField) == isinstance(jf, J.MLPField)
        jl, tl = field_leaves(jf), field_leaves(tf)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            if isinstance(a, np.ndarray) and a.dtype == np.float32:
                np.testing.assert_array_equal(bits(np.asarray(b, np.float32)),
                                              bits(a))
            else:
                assert a == b


# The pinned history lengths of tests/test_examples_e2e.py:54-60; example6
# (hybrid with an NN field, no preconditioning) fails in both packages
# (tests/test_examples_e2e.py:37).
CLI_CASES = {"example6.json": None, "example7-P.json": 96,
             "example3-P.json": 86}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_equals_jax_cli_without_passing_weights(tmp_path, name):
    outs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir()
        shutil.copy(CORPUS / name, d / name)
        outs.append(jax_cli.run(str(d / name)) if tag == "jax"
                    else torch_cli.run(str(d / name), device="cpu"))
    j, t = outs
    pinned = CLI_CASES[name]
    assert t["converged"] is j["converged"] is (pinned is not None)
    assert len(t["history"]) == len(j["history"])
    if pinned is not None:
        assert t["iterations"] == j["iterations"] == pinned
        assert len(t["history"]) == pinned
    np.testing.assert_allclose(t["displacements"], j["displacements"],
                               rtol=0, atol=U_ATOL)
