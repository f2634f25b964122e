"""Classic FEM JSON API (counterpart of pinn_fem_tpu/cli/api_fem_solver.py).

    python -m pinn_fem_tpu_torch.cli.api_fem_solver input.json output.json

Output: {displacements, stresses, strains, converged, convergence_history}
from solve_incremental_newton (one history row per increment); on error
{error, type} and exit 1.  PINN_FEM_TORCH_DEVICE picks the device
(default "cuda").
"""

from __future__ import annotations

import sys

from ..solvers.legacy import LegacySolverConfig, solve_incremental_newton
from ._api_common import api_main, build_problem_2d, element_stresses_2d


def parse_and_solve(input_data, device=None):
    material = input_data.get("material", {})
    young = material.get("young", 210e9)
    area = material.get("area", 0.01)
    density = material.get("density", 7850)

    problem = build_problem_2d(input_data, young, area, density)

    sc = input_data.get("solver_config", {})
    config = LegacySolverConfig(
        tolerance=sc.get("tolerance", 1e-6),
        max_iterations=sc.get("max_iterations", 50),
        n_increments=sc.get("n_increments", 10),
    )

    print("Solving FEM problem:")
    print(f"  Nodes: {problem.nnode}")
    print(f"  Elements: {problem.nelm}")
    print(f"  DOFs: {problem.ndof}")
    print(f"  Fixed DOFs: {len(problem.fixed_dofs)}")
    print(f"  Increments: {config.n_increments}")

    result = solve_incremental_newton(problem, config, device=device)
    u_flat = result.displacements.reshape(-1)
    stresses, strains = element_stresses_2d(
        problem.node_coords_2d, problem.elements, u_flat, young)
    return {
        "displacements": u_flat.tolist(),
        "stresses": stresses,
        "strains": strains,
        "converged": result.converged,
        "convergence_history": result.history,
    }


def main(argv=None) -> int:
    return api_main(
        parse_and_solve, argv,
        usage="Usage: python -m pinn_fem_tpu_torch.cli.api_fem_solver "
              "input.json output.json")


if __name__ == "__main__":
    sys.exit(main())
