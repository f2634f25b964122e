"""PINN Newton-Raphson (Gauss-Newton / LM) JSON API: scalar (E, A)
identification (counterpart of pinn_fem_tpu/cli/api_pinn_nr.py).

    python -m pinn_fem_tpu_torch.cli.api_pinn_nr input.json output.json

Parses the measured data and lambda_lm, identifies scalar E and A
(solvers/scalar_inverse.identify_scalars_gn) and writes {displacements,
stresses, strains, identified_params, convergence_history,
final_residual}; on error {error, type} and exit 1.  PINN_FEM_TORCH_DEVICE
picks the device (default "cuda").
"""

from __future__ import annotations

import sys

from ..solvers.scalar_inverse import identify_scalars_gn
from ._api_common import (api_main, build_problem_2d, element_stresses_2d,
                          measurements)


def parse_and_solve(input_data, device=None):
    material = input_data.get("material", {})
    young_init = material.get("young", 210e9)
    area_init = material.get("area", 0.01)
    measured_disp, measured_dofs = measurements(input_data)

    sc = input_data.get("solver_config", {})
    problem = build_problem_2d(input_data, young_init, area_init)

    print("Starting PINN Newton-Raphson solver...")
    print(f"  Measured DOFs: {len(measured_dofs)}")
    print(f"  LM damping: {sc.get('lambda_lm', 1e-3):.3e}")

    result = identify_scalars_gn(
        problem,
        f_ext=problem.loads,
        u_measured=measured_disp,
        measured_dofs=measured_dofs,
        young_init=young_init,
        area_init=area_init,
        max_iterations=sc.get("max_iterations", 50),
        tolerance=sc.get("tolerance", 1e-6),
        lambda_lm=sc.get("lambda_lm", 1e-3),
        device=device,
    )
    history = result["history"]
    stresses, strains = element_stresses_2d(
        problem.node_coords_2d, problem.elements, result["u_final"],
        result["young_final"])
    return {
        "displacements": result["u_final"].tolist(),
        "stresses": stresses,
        "strains": strains,
        "identified_params": {"young": float(result["young_final"]),
                              "area": float(result["area_final"])},
        "convergence_history": history,
        "final_residual": (float(history[-1]["residual"]) if history
                           else None),
    }


def main(argv=None) -> int:
    return api_main(
        parse_and_solve, argv,
        usage="Usage: python -m pinn_fem_tpu_torch.cli.api_pinn_nr "
              "input.json output.json")


if __name__ == "__main__":
    sys.exit(main())
