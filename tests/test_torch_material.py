"""Kernel 4's twin against the JAX package, on the CPU.

The port's material module (ops/kernels/material_kernel.py) on CPU tensors
runs its plain twin; here it is held against the JAX Pallas kernel in
interpret mode and the JAX XLA form (material_values /
stiffness_coefficients) on the same weights (drawn by JAX, handed over as
numpy through material_from_numpy) and the same inputs (made by numpy from
a seed), at the bounds of tests/test_pallas_material.py.  The twin's
autograd is held against jax.grad; the CUDA kernels against the twin run
on the card only (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pinn_fem_tpu as J  # noqa: E402
import pinn_fem_tpu_torch as T  # noqa: E402
from pinn_fem_tpu.models.fields import assembly_inputs as j_inputs  # noqa: E402
from pinn_fem_tpu.ops.assembly import material_values as j_material_values  # noqa: E402
from pinn_fem_tpu.ops.cg import stiffness_coefficients as j_coeffs  # noqa: E402
from pinn_fem_tpu.ops.pallas import material_kernel as jmk  # noqa: E402
from pinn_fem_tpu_torch.ops import assembly, kernels  # noqa: E402
from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients  # noqa: E402
from pinn_fem_tpu_torch.ops.kernels import material_kernel as tmk  # noqa: E402

CPU = torch.device("cpu")
RTOL, ATOL, RTOL_S = 2e-5, 1e-6, 3e-5   # tests/test_pallas_material.py:62-65


def leaves(field):
    if isinstance(field, J.ScalarField):
        return np.asarray(field.value)
    return {"layers": [(np.asarray(w), np.asarray(b)) for w, b in field.layers],
            "scale": np.asarray(field.scale), "input_dim": field.input_dim,
            "enforce_positive": field.enforce_positive}


def both_materials(widths=(20, 15, 10), hidden_layers=2,
                   scales=(2.0, 0.5, 7.0), input_dim=3):
    """The JAX test's nets (key 7), and the port's copy of the same weights."""
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    fields = [J.make_mlp_field(k, hidden_layers=hidden_layers,
                               neurons_per_layer=w, input_dim=input_dim,
                               scale=s)
              for k, w, s in zip(keys, widths, scales)]
    jmat = J.Material(young=fields[0], area=fields[1], density=fields[2])
    return jmat, T.material_from_numpy(*(leaves(f) for f in fields))


def chain_arrays(n_nodes, dim=2, seed=0):
    """A wavy chain (the JAX test's, y = 0.1 sin i), or its 3D version
    with seeded z offsets."""
    i = np.arange(n_nodes, dtype=float)
    cols = [i, 0.1 * np.sin(i)]
    if dim == 3:
        cols.append(np.random.default_rng(seed).uniform(-0.5, 0.5, n_nodes))
    nodes = np.stack(cols, axis=1)
    elements = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], 1)
    loads = np.zeros(dim * n_nodes)
    loads[-dim] = 1.0
    return nodes, elements, loads, np.arange(dim)


def both_data(jmat, tmat, n_nodes=778, dim=2):
    nodes, elements, loads, fixed = chain_arrays(n_nodes, dim)
    jp = J.TrussProblem(nodes, elements, jmat, loads, fixed, dim)
    tp = T.TrussProblem(nodes, elements, tmat, loads, fixed, dim)
    return jp.to_device(use_native=False), tp.to_device(CPU)


def test_supported_predicate():
    """tests/test_pallas_material.py:test_supported_predicate, plus the
    dimension rule (fault 3.6) and the depth and input_dim rules."""
    _, mat = both_materials()
    assert tmk.fused_coefficients_supported(mat, 2)
    assert tmk.fused_coefficients_supported(mat, 1)
    assert not tmk.fused_coefficients_supported(mat, 3)
    assert tmk.fused_coefficients_supported(both_materials(hidden_layers=1)[1], 2)
    assert not tmk.fused_coefficients_supported(both_materials(hidden_layers=3)[1], 2)
    assert not tmk.fused_coefficients_supported(T.Material(1.0, 1.0, 1.0), 2)
    assert not tmk.fused_coefficients_supported(
        both_materials(widths=(64, 15, 10))[1], 2)
    assert not tmk.fused_coefficients_supported(both_materials(input_dim=2)[1], 2)
    two_nn = T.Material(young=mat.young, area=mat.area, density=1.0)
    assert not tmk.fused_coefficients_supported(two_nn, 2)


@pytest.mark.parametrize("hidden_layers", [1, 2])
@pytest.mark.parametrize("lf", [0.3, 1.0])
def test_twin_matches_jax_kernel_and_xla(hidden_layers, lf):
    jmat, tmat = both_materials(hidden_layers=hidden_layers)
    jd, td = both_data(jmat, tmat)        # 777 elements: not a tile multiple
    assert td.nelm == 777

    je, ja, jrho, js = jmk.fused_material_coefficients(jd, jmat, lf,
                                                       interpret=True)
    x = j_inputs(jd.mid, 2, jnp.asarray(lf, jnp.float32))
    xla = (jmat.young.eval_batch(x), jmat.area.eval_batch(x),
           jmat.density.eval_batch(x), j_coeffs(jd, jmat, lf))

    before = kernels.launch_counts()
    got = tmk.fused_material_coefficients(td, tmat, lf)
    assert kernels.launch_counts() == before          # CPU: the twin
    for k, (g, pallas, ref) in enumerate(zip(got, (je, ja, jrho, js), xla)):
        rtol = RTOL_S if k == 3 else RTOL
        for want in (pallas, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=rtol,
                                       atol=ATOL)
    # The port's dispatch (material_values, stiffness_coefficients) takes
    # the same values as the JAX XLA form.
    jy, jar = j_material_values(jd, jmat, lf)
    ty, tar = assembly.material_values(td, tmat, lf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tar.numpy(), np.asarray(jar), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(stiffness_coefficients(td, tmat, lf).numpy(),
                               np.asarray(xla[3]), rtol=RTOL_S, atol=ATOL)
    np.testing.assert_array_equal(got[3].numpy(),
                                  stiffness_coefficients(td, tmat, lf).numpy())


@pytest.mark.parametrize("hidden_layers", [1, 2])
def test_twin_autograd_matches_jax_grad(hidden_layers):
    """d/dtheta of sum(c1 E + c2 A + c3 rho + c4 s) with seeded weights c:
    the twin's autograd (the backward kernel's twin) against jax.grad over
    the JAX layers, relative to the largest gradient entry."""
    from pinn_fem_tpu_torch.solvers.gd import get_theta, set_theta

    jmat, tmat = both_materials(hidden_layers=hidden_layers)
    jd, td = both_data(jmat, tmat)
    lf = 0.7
    c = np.random.default_rng(3).normal(size=(4, td.nelm)).astype(np.float32)

    def j_loss(layers):
        mat = J.Material(young=jmat.young.replace(layers=layers[0]),
                         area=jmat.area.replace(layers=layers[1]),
                         density=jmat.density.replace(layers=layers[2]))
        e, a = j_material_values(jd, mat, lf)
        rho = mat.density.eval_batch(j_inputs(jd.mid, 2, lf))
        s = j_coeffs(jd, mat, lf)
        return jnp.sum(c[0] * e + c[1] * a + c[2] * rho + c[3] * s)

    jlayers = [f.layers for f in (jmat.young, jmat.area, jmat.density)]
    jgrads = jax.grad(j_loss)(jlayers)

    theta = [[(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in layers] for layers in get_theta(tmat)]
    e, a, rho, s = tmk.fused_material_coefficients(td, set_theta(tmat, theta),
                                                   lf)
    ct = torch.from_numpy(c)
    torch.sum(ct[0] * e + ct[1] * a + ct[2] * rho + ct[3] * s).backward()

    pairs = [(t.grad.numpy(), np.asarray(j))
             for tl, jl in zip(theta, jgrads)
             for tp_, jp_ in zip(tl, jl) for t, j in zip(tp_, jp_)]
    scale = max(np.abs(j).max() for _, j in pairs)
    assert len(pairs) == 6 * (hidden_layers + 1)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_three_dimensional_truss_takes_the_torch_form(monkeypatch):
    """On a 3D truss the JAX kernel feeds (lf, x, y), the assembly (x, y, z)
    (fault 3.6): the port's dispatch equals JAX material_values and never
    reaches the kernel entry."""
    jmat, tmat = both_materials()
    jd, td = both_data(jmat, tmat, n_nodes=51, dim=3)
    calls = []
    monkeypatch.setattr(assembly, "fused_material_coefficients",
                        lambda *a: calls.append(a))
    lf = 0.6
    jy, jar = j_material_values(jd, jmat, lf)
    ty, tar = assembly.material_values(td, tmat, lf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tar.numpy(), np.asarray(jar), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(stiffness_coefficients(td, tmat, lf).numpy(),
                               np.asarray(j_coeffs(jd, jmat, lf)),
                               rtol=RTOL_S, atol=ATOL)
    assert calls == []
    # The JAX kernel on the same 3D data differs: it reads (lf, x, y).
    je, *_ = jmk.fused_material_coefficients(jd, jmat, lf, interpret=True)
    assert np.abs(np.asarray(je) - np.asarray(jy)).max() > 1e-3


def test_supported_material_goes_to_the_kernel_entry(monkeypatch):
    """In 2D, internal_force_and_strain and stiffness_coefficients take
    (E, A, s) from fused_material_coefficients."""
    jmat, tmat = both_materials()
    _, td = both_data(jmat, tmat, n_nodes=20)
    seen = []
    real = assembly.fused_material_coefficients

    def spy(data, material, lf):
        seen.append(data.nelm)
        return real(data, material, lf)

    monkeypatch.setattr(assembly, "fused_material_coefficients", spy)
    u = torch.from_numpy(np.random.default_rng(1).normal(
        size=td.ndof).astype(np.float32))
    assembly.internal_force_and_strain(td, tmat, u, 1.0)
    stiffness_coefficients(td, tmat, 1.0)
    assert seen == [19, 19]


def test_kernel_entry_has_no_twin_off_the_cpu():
    """Any device but the CPU goes to the kernels, never to the twin."""
    jmat, tmat = both_materials()
    _, td = both_data(jmat, tmat, n_nodes=20)
    meta = T.ProblemData(**{k: (v.to("meta") if torch.is_tensor(v) else v)
                            for k, v in vars(td).items()})
    with pytest.raises(ValueError, match="no kernel"):
        tmk.fused_material_coefficients(meta, tmat.to("meta"), 1.0)


def test_kernel_operand_checks():
    jmat, tmat = both_materials()
    _, td = both_data(jmat, tmat, n_nodes=20)
    with pytest.raises(TypeError, match="float32"):
        tmk._check(td.mid.double(), (td.inv_len,))
    with pytest.raises(ValueError, match="contiguous"):
        tmk._check(td.mid, (torch.zeros(2 * td.nelm)[::2],))
    with pytest.raises(ValueError, match="midpoints"):
        tmk._check(torch.zeros(td.nelm, 3), (td.inv_len,))
    with pytest.raises(ValueError, match="per-element"):
        tmk._check(td.mid, (td.inv_len, td.inv_len[1:]))
    assert list(tmk._widths(tmat)) == [20, 20, 15, 15, 10, 10]
    assert list(tmk._widths(both_materials(hidden_layers=1)[1])) == \
        [20, 0, 15, 0, 10, 0]
    # 3h + h + h*h + h + h + 1 flat parameters per net at h = 20, 15, 10.
    assert [f.n_params() for f in (tmat.young, tmat.area, tmat.density)] == \
        [521, 316, 161]


def test_forward_wrapper_refuses_bad_operands(monkeypatch):
    """The forward kernel's wrapper checks its operands before it reaches
    the library (a stand-in that fails if it is loaded)."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(tmk._build, "load_library", no_library)
    jmat, tmat = both_materials()
    _, td = both_data(jmat, tmat, n_nodes=20)
    fields = tmk._fields(tmat)
    params = torch.cat([t.reshape(-1) for f in fields
                        for t in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields])

    def forward(mid, inv_len, p=params):
        return tmk.material_coefficients(mid, inv_len, 1.0, p, scales,
                                         tmk._widths(tmat))

    with pytest.raises(TypeError, match="float32"):
        forward(td.mid.double(), td.inv_len)
    with pytest.raises(TypeError, match="float32"):
        forward(td.mid, td.inv_len, params.double())
    with pytest.raises(ValueError, match="contiguous"):
        forward(td.mid, torch.zeros(2 * td.nelm)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        forward(torch.zeros(2, td.nelm).T, td.inv_len)
    with pytest.raises(ValueError, match="midpoints"):
        forward(torch.zeros(td.nelm, 3), td.inv_len)
    with pytest.raises(ValueError, match="midpoints"):
        forward(td.mid[1:], td.inv_len)


def test_forward_plan_geometry():
    """The forward kernel's form (forward_elements, forward_form) and grid
    (forward_plan) at the main path's sizes on the H100's 132 SMs, from
    the blocks of a form one SM holds: up to one block an SM, a block per
    32 E elements a warp; beyond, a multiple of the SM count chosen by the
    passes of the longest warp."""
    plan = tmk.ForwardPlan
    # Two elements a thread for nets of widths <= 20, one beyond.
    assert tmk.forward_elements((20, 20, 15, 15, 10, 10)) == 2
    assert tmk.forward_elements((20, 0, 1, 3, 17, 5)) == 2
    assert tmk.forward_elements((20, 21, 15, 15, 10, 10)) == 1
    assert tmk.forward_elements((32, 0, 1, 0, 1, 0)) == 1
    # 128 threads while one pass of 4 blocks an SM covers n, then 256.
    assert tmk.forward_form(79_102, 2, 4, 132) == (2, 128)
    assert tmk.forward_form(135_168, 2, 4, 132) == (2, 128)
    assert tmk.forward_form(135_169, 2, 4, 132) == (2, 256)
    assert tmk.forward_form(1_000_000, 2, 4, 132) == (2, 256)
    assert tmk.forward_form(1_000_000, 1, 4, 132) == (1, 128)
    assert tmk.forward_plan(0, 4, 132, 2, 128) == plan(2, 128, 1)
    assert tmk.forward_plan(50, 4, 132, 2, 128) == plan(2, 128, 1)
    assert tmk.forward_plan(1001, 4, 132, 2, 128) == plan(2, 128, 4)
    # The PINN grid's 79,102 midpoints: 3 blocks an SM, one pass a warp
    # (50 elements: two for lanes 0-17, one for the rest).
    assert tmk.forward_plan(79_102, 4, 132, 2, 128) == plan(2, 128, 396)
    # A million elements: one block of 256 an SM, 15 passes of 64 a warp
    # (947 elements; two blocks an SM would take 8 passes of 474, 16
    # warps x 8 against 8 x 15).
    assert tmk.forward_plan(1_000_000, 2, 132, 2, 256) == plan(2, 256, 132)
    assert tmk.forward_plan(1_000_000, 1, 132, 2, 256) == plan(2, 256, 132)
    # One element a thread (the wide nets): 5 blocks an SM, one pass of 30
    # elements a warp; with room for 3 or 4, 3 blocks and two passes.
    assert tmk.forward_plan(79_102, 5, 132, 1, 128) == plan(1, 128, 660)
    assert tmk.forward_plan(79_102, 4, 132, 1, 128) == plan(1, 128, 396)
    assert tmk.forward_plan(300_007, 5, 132, 1, 128) == plan(1, 128, 396)
    # Another card: the grid follows its SM count (114 SMs: 5 blocks an
    # SM would still take two passes a warp, so 3 take them).
    assert tmk.forward_plan(79_102, 5, 114, 1, 128) == plan(1, 128, 342)
    for form in ((3, 128), (1, 96 + 1), (1, 256), (2, 512), (0, 128)):
        with pytest.raises(ValueError, match="no forward form"):
            tmk.forward_plan(1000, 5, 132, *form)


@pytest.mark.parametrize("n", [1, 50, 1001, 79_102, 300_007])
@pytest.mark.parametrize("form", [(1, 128), (2, 128), (2, 256), (1, 64)])
def test_forward_partition_covers_every_element(n, form):
    """The kernel's split, emulated: warp w of W takes [w n / W,
    (w + 1) n / W), 32 E elements a pass, lane l the elements base + l +
    32 e; every element is taken exactly once, and the warps' shares
    differ by at most one element."""
    plan = tmk.forward_plan(n, 5, 132, *form)
    warps = plan.blocks * plan.threads // 32
    ranges = np.array([(w * n // warps, (w + 1) * n // warps)
                       for w in range(warps)], np.int64)
    lengths = ranges[:, 1] - ranges[:, 0]
    assert lengths.max() - lengths.min() <= 1
    step = 32 * plan.per_thread
    passes = -(-int(lengths.max()) // step)
    offsets = (np.arange(passes)[:, None, None] * step
               + np.arange(32)[None, :, None]
               + 32 * np.arange(plan.per_thread)[None, None, :]).reshape(-1)
    taken = ranges[:, :1] + offsets[None, :]
    taken = taken[taken < ranges[:, 1:]]
    assert np.array_equal(np.sort(taken), np.arange(n))
