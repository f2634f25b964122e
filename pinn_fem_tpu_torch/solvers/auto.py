"""Execution-path selection for the CLI (counterpart of
pinn_fem_tpu/solvers/auto.py).

The JAX package sends every document to a one-dispatch fused driver on a
TPU (solvers/fused.py), which exists only because of that attachment and
runs the dense Newton phase at any size.  The port has no fused driver:
every document goes through driver.solve, so a large truss reaches the
banded path and its CUDA kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverConfig, SolverResult
from ..models.problem import TrussProblem
from .driver import solve


def solve_auto(problem: TrussProblem, config: Optional[SolverConfig] = None,
               measured_disp: Optional[np.ndarray] = None,
               measured_dofs: Optional[np.ndarray] = None,
               verbose: bool = False, device=None) -> SolverResult:
    return solve(problem, config, measured_disp, measured_dofs,
                 verbose=verbose, device=device)
