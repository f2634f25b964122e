"""PINN gradient-descent JSON API: scalar (E, A) identification
(counterpart of pinn_fem_tpu/cli/api_pinn_gd.py).

    python -m pinn_fem_tpu_torch.cli.api_pinn_gd input.json output.json

Parses measured_disp / measured_dofs and the bounds and config, identifies
scalar E and A (solvers/scalar_inverse.identify_scalars_gd) and writes
{displacements, stresses, strains, identified_params, convergence_history
(every 10th row), final_loss}; on error {error, type} and exit 1.
PINN_FEM_TORCH_DEVICE picks the device (default "cuda").
"""

from __future__ import annotations

import sys

from ..solvers.scalar_inverse import identify_scalars_gd
from ._api_common import (api_main, build_problem_2d, element_stresses_2d,
                          measurements)

_ROW_KEYS = ("iteration", "loss_total", "loss_physics", "loss_data",
             "young", "area")


def parse_and_solve(input_data, device=None):
    material = input_data.get("material", {})
    young_init = material.get("young", 210e9)
    area_init = material.get("area", 0.01)
    measured_disp, measured_dofs = measurements(input_data)

    sc = input_data.get("solver_config", {})
    problem = build_problem_2d(input_data, young_init, area_init)

    print("Starting PINN Gradient Descent solver...")
    print(f"  Measured DOFs: {len(measured_dofs)}")
    print(f"  Initial Young's modulus: {young_init:.3e} Pa")
    print(f"  Initial Area: {area_init:.6f} m^2")

    result = identify_scalars_gd(
        problem,
        f_ext=problem.loads,
        u_measured=measured_disp,
        measured_dofs=measured_dofs,
        young_init=young_init,
        area_init=area_init,
        n_iterations=sc.get("max_iterations", 500),
        learning_rate=sc.get("learning_rate", 0.001),
        alpha=sc.get("alpha", 1.0),
        beta=sc.get("beta", 100.0),
        young_bounds=tuple(sc.get("young_bounds", [1e9, 500e9])),
        area_bounds=tuple(sc.get("area_bounds", [0.001, 0.1])),
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
        # every 10th iteration, like the reference
        "convergence_history": [{k: h[k] for k in _ROW_KEYS}
                                for h in history[::10]],
        "final_loss": float(history[-1]["loss_total"]) if history else None,
    }


def main(argv=None) -> int:
    return api_main(
        parse_and_solve, argv,
        usage="Usage: python -m pinn_fem_tpu_torch.cli.api_pinn_gd "
              "input.json output.json")


if __name__ == "__main__":
    sys.exit(main())
