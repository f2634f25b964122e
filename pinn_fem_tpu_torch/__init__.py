"""pinn_fem_tpu_torch: the PyTorch / CUDA port of pinn_fem_tpu.

The JAX package `pinn_fem_tpu` is the reference; this package computes the
same results with PyTorch, and runs the hot loops as hand-written CUDA
kernels on an NVIDIA Hopper card (ops/kernels/).  It never imports JAX.

Ported so far: truss documents through the JSON CLI (cli/generic.py) with
the Newton-Raphson method, on the dense path for small meshes and on the
banded (DIA) operator with the fused Jacobi-PCG kernels above 2048 DOFs;
PINN identification by gradient descent (methods gd and hybrid), whose
loss evaluates MLP material fields with the material kernels; and the
second-order methods full-nr with NN fields and gn, which differentiate
the torch form of the material twice and evaluate values with the
kernels.  Truss documents may carry thermal loads and prescribed support
displacements, and solve_nr takes Green-Lagrange kinematics on the dense
path.  ROADMAP.md lists what is still to port.

Float32 by default.  TF32 is switched off for every contraction, because
rounded inputs break the symmetry the Cholesky and PCG solves rely on.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import SolverConfig, SolverResult  # noqa: E402
from .models.fields import (  # noqa: E402
    Material,
    MLPField,
    ScalarField,
    make_mlp_field,
    material_from_numpy,
)
from .models.problem import ProblemData, TrussProblem  # noqa: E402
from .ops.thermal import thermal_free_strains, thermal_loads  # noqa: E402
from .solvers.driver import solve  # noqa: E402
from .solvers.full_newton import solve_full_nr  # noqa: E402
from .solvers.gauss_newton import solve_gauss_newton  # noqa: E402
from .solvers.gd import solve_gd  # noqa: E402
from .solvers.hybrid import solve_hybrid  # noqa: E402
from .solvers.newton import solve_nr  # noqa: E402

__all__ = [
    "Material", "MLPField", "ProblemData", "ScalarField", "SolverConfig",
    "SolverResult", "TrussProblem", "make_mlp_field", "material_from_numpy",
    "solve", "solve_full_nr", "solve_gauss_newton", "solve_gd",
    "solve_hybrid", "solve_nr", "thermal_free_strains", "thermal_loads",
]
