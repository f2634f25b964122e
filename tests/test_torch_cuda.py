"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernels sum in the twins' order with separately rounded multiplies and
adds, and the twins reduce each block by the kernels' tree, so every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from pinn_fem_tpu_torch.examples_grid import chain_problem, grid_problem
from pinn_fem_tpu_torch.ops import kernels
from pinn_fem_tpu_torch.ops.cg import stiffness_coefficients
from pinn_fem_tpu_torch.ops.dia import assemble_dia, dia_layout
from pinn_fem_tpu_torch.ops.kernels import cg_kernel, dia_kernel

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
    assert all(after[k] == before[k] + 1 for k in after)


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
