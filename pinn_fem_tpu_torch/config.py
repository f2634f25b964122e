"""Solver configuration and result types (pinn_fem_tpu/config.py as is).

Field-for-field capability parity with the source PINN-FEM's unified
SolverConfig (FEM/python/fem/solver.py:35-62) and SolverResult
(solver.py:65-75).  Defaults match the reference defaults, including the
documented-as-too-slow learning_rate_u=1e-7 (examples override it; see
examples/json/README.md:399-404).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np


@dataclass
class SolverConfig:
    # Common
    max_iterations: int = 1000
    tolerance: float = 1e-6
    print_every: int = 10

    # Universal incremental loading (all solvers)
    n_increments: int = 10
    load_factor_initial: float = 0.0
    load_factor_final: float = 1.0
    min_denominator: float = 1e-10

    # Gradient descent
    learning_rate_u: float = 1e-7
    learning_rate_theta: float = 1e-4

    # Loss weights
    alpha_physics: float = 1.0
    alpha_data: float = 100.0

    # Method: "auto" | "gd" | "nr" | "hybrid" | "full-nr" | "gn"
    method: str = "auto"

    # Two-phase GD preconditioning (solver.py:113-198)
    preconditioning: bool = False

    # Full-NR secondary convergence gate: when measurements are present, the
    # equilibrium-residual criterion ||R_free|| < tolerance additionally
    # requires sqrt(loss_data) (the RMS misfit of the measured DOFs) to be
    # below this value, so full-NR cannot declare victory on physics alone
    # while ignoring the data term.  See solvers/full_newton.py for the
    # float32 rationale behind having a secondary criterion at all.
    full_nr_data_tolerance: float = 1e-3

    # Extensions beyond the reference (documented divergences):
    # honor warm starts in NR (reference accepts but ignores u_initial,
    # solver.py:443; results identical, fewer iterations).
    nr_warm_start: bool = True
    # RNG seed for NN material initialization (reference is unseeded torch).
    seed: int = 0

    def with_(self, **kw) -> "SolverConfig":
        return replace(self, **kw)


@dataclass
class SolverResult:
    displacements: np.ndarray            # (nnode, dim)
    reactions: np.ndarray                # (nnode, dim)
    converged: bool
    history: List[Dict[str, float]] = field(default_factory=list)
    nn_parameters: Optional[Dict[str, np.ndarray]] = None
