"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The banded kernels sum in the twins' order with separately rounded
multiplies and adds, and the twins reduce each block by the kernels' tree,
so those comparisons are exact.  The material kernels (kernel 4) are held
to their twin at the JAX kernel test's bounds (forward) and to 1e-4 of the
largest gradient entry (backward).
"""

import numpy as np
import pytest
import torch

import pinn_fem_tpu_torch as T

from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
from pinn_fem_tpu_torch.ops import kernels
from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_layout
from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel
from pinn_fem_tpu_torch.ops.kernels import material_kernel

pytestmark = pytest.mark.cuda

MESHES = {"chain3000": lambda: chain_problem(3000),
          "grid16x72": lambda: grid_problem(16, 72)}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def system(mesh, dev):
    p = MESHES[mesh]()
    data = p.to_device(dev)
    layout = dia_layout(data.dof_map.cpu().numpy(), p.ndof)
    diags = assemble_dia(layout, stiffness_coefficients(data, p.material, 1.0),
                         data.gvec)
    return data, layout, diags


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kernels_equal_twins_on_card(cuda_device, mesh):
    dev = cuda_device
    data, layout, d = system(mesh, dev)
    rng = np.random.default_rng(4)
    u, z, p, x, r = (torch.tensor(rng.normal(size=layout.ndof),
                                  dtype=torch.float32, device=dev)
                     for _ in range(5))
    before = kernels.launch_counts()
    assert torch.equal(kernels.dia_matvec(layout, d, u),
                       dia_kernel.dia_matvec_reference(layout, d, u))
    beta = torch.tensor(0.37, device=dev)
    got = kernels.dia_dir_matvec(beta, z, p, layout, d, data.free_mask)
    want = cg_kernel.dir_matvec_reference(beta, z, p, layout, d,
                                          data.free_mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    inv_diag = torch.rand(layout.ndof, device=dev) + 0.1
    x2, r2 = x.clone(), r.clone()
    zk, z2 = torch.empty_like(x), torch.empty_like(x)
    alpha = torch.tensor(0.21, device=dev)
    pk = kernels.cg_update(alpha, x, r, p, z, inv_diag, zk)
    pr = cg_kernel.cg_update_reference(alpha, x2, r2, p, z, inv_diag, z2)
    assert torch.equal(pk, pr) and torch.equal(x, x2) and torch.equal(zk, z2)
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1
               for k in ("dia_matvec", "dia_dir_matvec", "cg_update"))


def test_fused_cg_on_card_equals_twin_recurrence(cuda_device):
    data, layout, d = system("grid16x72", cuda_device)
    x, it, _ = kernels.fused_cg_solve(layout, d, data.loads, data.free_mask,
                                      tol=1e-5, max_iter=5000)
    x_ref, it_ref, _ = kernels.fused_cg_solve_reference(
        layout, d, data.loads, data.free_mask, tol=1e-5, max_iter=5000)
    assert int(it) == int(it_ref) > 0 and torch.equal(x, x_ref)
    assert float(torch.max(torch.abs(x * data.fixed_mask))) == 0.0


def test_wrappers_refuse_float64_on_card(cuda_device):
    data, layout, d = system("chain3000", cuda_device)
    with pytest.raises(TypeError, match="float32"):
        kernels.dia_matvec(layout, d.double(), data.loads.double())


def test_stop_flag_freezes_kernels(cuda_device):
    n = 1000
    x = torch.zeros(n, device=cuda_device)
    r, z = x + 1.0, x + 2.0
    kernels.cg_update(torch.tensor(0.5, device=cuda_device), x, r, r, r, r,
                      z, stop=torch.tensor(True, device=cuda_device))
    assert float(x.abs().max()) == 0.0 and float((r - 1).abs().max()) == 0.0
    assert float((z - 2).abs().max()) == 0.0


def mlp_material(hidden_layers, dev):
    g = torch.Generator().manual_seed(11)
    fields = [T.make_mlp_field(g, hidden_layers=hidden_layers,
                               neurons_per_layer=w, input_dim=3, scale=s)
              for w, s in ((20, 2.0), (15, 0.5), (10, 7.0))]
    return T.Material(*fields).to(dev)


@pytest.mark.parametrize("hidden_layers", [1, 2])
@pytest.mark.parametrize("lf", [0.3, 1.0])
def test_material_kernels_match_twin_on_card(cuda_device, hidden_layers, lf):
    from pinn_fem_tpu_torch.solvers.gd import get_theta, set_theta

    data = grid_problem(16, 72).to_device(cuda_device)
    mat = mlp_material(hidden_layers, cuda_device)
    theta = [[(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in layers] for layers in get_theta(mat)]
    mat = set_theta(mat, theta)
    params = [t for layers in theta for layer in layers for t in layer]
    c = torch.randn(4, data.nelm, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))

    def run(fn):
        out = fn()
        loss = sum(torch.sum(ci * o) for ci, o in zip(c, out))
        return out, torch.autograd.grad(loss, params)

    before = kernels.launch_counts()
    got, g_got = run(lambda: material_kernel.fused_material_coefficients(
        data, mat, lf))
    after = kernels.launch_counts()
    assert after["material_coefficients"] == before["material_coefficients"] + 1
    assert after["material_coefficients_backward"] == \
        before["material_coefficients_backward"] + 1
    want, g_want = run(lambda: material_kernel.material_coefficients_reference(
        data.mid, data.inv_len, lf, mat))
    for k, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=3e-5 if k == 3 else 2e-5,
                                   atol=1e-6)
    scale = max(float(g.abs().max()) for g in g_want)
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max()) <= 1e-4 * scale
    # The backward repeats bit for bit (no atomics).
    _, g_again = run(lambda: material_kernel.fused_material_coefficients(
        data, mat, lf))
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_again))
