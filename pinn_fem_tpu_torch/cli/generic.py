"""Generic JSON CLI for truss documents (counterpart of
pinn_fem_tpu/cli/generic.py).

    python -m pinn_fem_tpu_torch.cli.generic problem.json [output.json]

  * output defaults to <stem>.res.json next to the input;
  * a <stem>.log file captures the run (overwritten each run);
  * the result JSON carries {success, converged, iterations, displacements,
    reactions, history};
  * exit code 1, with "[ERROR]" and the traceback in the log, on failure.

The device comes from PINN_FEM_TORCH_DEVICE (default "cuda"); asking for
CUDA without a card is an error, not a CPU run.  PINN_FEM_TPU_SEED seeds
the NN initialisation, as in the JAX CLI.  Element-family documents
("element_type") and "analysis" documents are not yet ported and exit 1.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from datetime import datetime
from pathlib import Path

from ..io.results import result_to_output_dict
from ..io.schema import parse_problem_dict
from ..solvers.auto import solve_auto
from ..solvers.driver import resolve_method
from ..utils.progress import PACKAGE_LOGGER
from ..utils.runtime import resolve_device

logger = logging.getLogger(f"{PACKAGE_LOGGER}.cli")

# Element families of the JAX CLI, by the ROADMAP item that ports them.
_ELEMENT_FAMILIES = {"plane": 18, "solid": 19, "frame": 20, "frame3d": 20,
                     "plate": 21, "shell": 22}


def setup_logging(problem_file: str) -> Path:
    problem_name = Path(problem_file).stem
    log_file = Path(problem_file).parent / f"{problem_name}.log"
    pkg_logger = logging.getLogger(PACKAGE_LOGGER)
    pkg_logger.setLevel(logging.DEBUG)
    for h in list(pkg_logger.handlers):
        pkg_logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    for h in (
        logging.FileHandler(log_file, mode="w", encoding="utf-8"),
        logging.StreamHandler(sys.stdout),
    ):
        h.setFormatter(fmt)
        pkg_logger.addHandler(h)
    logger.info("=" * 60)
    logger.info("PINN-FEM-TPU (PyTorch port) Generic Solver Log")
    logger.info("Timestamp: %s", datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    logger.info("Problem file: %s", problem_file)
    logger.info("Log file: %s", log_file)
    logger.info("=" * 60)
    return log_file


def run(problem_file: str, output_file: str | None = None, seed: int = 0,
        device=None) -> dict:
    """Solve one truss document on `device` ("cuda" when None) and write
    its result JSON."""
    device = resolve_device(device)
    with open(problem_file) as fh:
        raw = json.load(fh)
    family = raw.get("element_type") if isinstance(raw, dict) else None
    if family in _ELEMENT_FAMILIES:
        raise NotImplementedError(
            f'"{family}" element documents are not yet ported, ROADMAP item '
            f"{_ELEMENT_FAMILIES[family]}")
    if isinstance(raw, dict) and raw.get("analysis"):
        raise NotImplementedError(
            '"analysis" documents are not yet ported, ROADMAP item 17')
    parsed = parse_problem_dict(raw, seed=seed)
    problem, config = parsed.problem, parsed.config

    logger.info("Device: %s", device)
    logger.info("Nodes: %d", problem.nnode)
    logger.info("Elements: %d", problem.nelm)
    logger.info("Fixed DOFs: %d", len(problem.fixed_dofs))
    logger.info("Has NN: %s", problem.material.has_trainable_params)
    has_meas = parsed.measured_dofs is not None and len(parsed.measured_dofs) > 0
    logger.info("Has measurements: %s", has_meas)
    logger.info(
        "Solver method: %s",
        resolve_method(problem, config, parsed.measured_disp, parsed.measured_dofs),
    )

    result = solve_auto(problem, config, measured_disp=parsed.measured_disp,
                        measured_dofs=parsed.measured_dofs, verbose=True,
                        device=device)
    output = result_to_output_dict(result)

    if output_file is None:
        p = Path(problem_file)
        output_file = str(p.parent / f"{p.stem}.res.json")
    with open(output_file, "w") as f:
        json.dump(output, f, indent=2)

    logger.info("%s", "=" * 60)
    logger.info("SOLUTION SUMMARY:")
    if output.get("success"):
        logger.info("  Status: SUCCESS")
        logger.info("  Iterations: %s", output.get("iterations"))
        disp = output.get("displacements", [])
        if disp:
            logger.info("  Max displacement: %.6e", max(abs(d) for d in disp))
    else:
        logger.info("  Status: FAILED")
    logger.info("Results written to %s", output_file)
    return output


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage: python -m pinn_fem_tpu_torch.cli.generic problem.json "
              "[output.json]")
        return 1
    problem_file = argv[0]
    output_file = argv[1] if len(argv) > 1 else None
    seed = int(os.environ.get("PINN_FEM_TPU_SEED", "0"))
    device = os.environ.get("PINN_FEM_TORCH_DEVICE", "cuda")
    setup_logging(problem_file)
    try:
        run(problem_file, output_file, seed=seed, device=device)
        logger.info("[SUCCESS] Solve completed successfully")
        return 0
    except Exception as e:  # contract: log the traceback, exit 1
        import traceback

        logger.error("[ERROR] %s", e)
        logger.error("%s", traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(main())
