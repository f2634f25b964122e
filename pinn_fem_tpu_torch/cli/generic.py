"""Generic JSON CLI for truss documents (counterpart of
pinn_fem_tpu/cli/generic.py).

    python -m pinn_fem_tpu_torch.cli.generic problem.json [output.json]

  * output defaults to <stem>.res.json next to the input;
  * a <stem>.log file captures the run (overwritten each run);
  * the result JSON carries {success, converged, iterations, displacements,
    reactions, history}, and for NN materials nn_parameters and
    identified_properties;
  * a solve that does not converge writes success: false and exits 0;
  * a "prescribed_displacements" document (support settlement) takes one
    Newton solve at the full load (method nr or auto), as in the JAX CLI;
  * exit code 1, with "[ERROR]" and the traceback in the log, on failure.

The device comes from PINN_FEM_TORCH_DEVICE (default "cuda"); asking for
CUDA without a card is an error, not a CPU run.  PINN_FEM_TPU_SEED seeds
the NN initialisation, as in the JAX CLI.  An "analysis" document
(routed, as in the JAX CLI, on the parsed document's meta["analysis"])
runs io/analysis.run_analysis and writes its result dict; of the analysis
types "transient" (with "plasticity"), "modal", "buckling", "harmonic",
"random", "spectrum", "continuation", "plastic" and "reduction" are
ported (the others exit 1, naming their ROADMAP item).
Plane documents ("element_type": "plane") are routed before the truss
parse to io/plane_io.run_plane_document and log the JAX CLI's PLANE
ANALYSIS SUMMARY lines; the other element families are not yet ported
and exit 1, naming their ROADMAP item.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from datetime import datetime
from pathlib import Path

import numpy as np

from ..io.results import result_to_output_dict
from ..io.schema import parse_problem_dict
from ..solvers.auto import solve_auto
from ..solvers.driver import resolve_method
from ..solvers.newton import solve_nr
from ..utils.progress import PACKAGE_LOGGER
from ..utils.runtime import resolve_device

logger = logging.getLogger(f"{PACKAGE_LOGGER}.cli")

# Element families of the JAX CLI, by the ROADMAP item that ports them.
_ELEMENT_FAMILIES = {"solid": 19, "frame": 20, "frame3d": 20, "plate": 21,
                     "shell": 22}


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
    """Solve one truss or plane document on `device` ("cuda" when None) and
    write its result JSON."""
    device = resolve_device(device)
    with open(problem_file) as fh:
        raw = json.load(fh)
    if output_file is None:
        p = Path(problem_file)
        output_file = str(p.parent / f"{p.stem}.res.json")
    family = raw.get("element_type") if isinstance(raw, dict) else None
    if family in _ELEMENT_FAMILIES:
        raise NotImplementedError(
            f'"{family}" element documents are not yet ported, ROADMAP item '
            f"{_ELEMENT_FAMILIES[family]}")
    from ..io.plane_io import is_plane_document

    if is_plane_document(raw):
        return _run_plane(raw, output_file, device)
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

    analysis = parsed.meta.get("analysis")
    if analysis and parsed.prescribed is not None:
        # The prescribed DOFs joined fixed_dofs, but their nonzero values
        # reach only the Newton settlement route: an analysis would clamp
        # them at zero.
        raise ValueError("prescribed_displacements cannot be combined "
                         "with an analysis block")
    if analysis:
        from ..io.analysis import run_analysis

        logger.info("Analysis block: %s", analysis.get("type"))
        output = run_analysis(problem, analysis, device)
        with open(output_file, "w") as f:
            json.dump(output, f, indent=2)
        logger.info("%s", "=" * 60)
        logger.info("ANALYSIS SUMMARY (%s):", output["analysis"])
        if output["analysis"] == "modal":
            logger.info("  Frequencies (Hz): %s",
                        ["%.6g" % f for f in output["frequencies_hz"]])
        elif output["analysis"] == "buckling":
            logger.info("  Critical load factors: %s",
                        output["load_factors"])
        elif output["analysis"] == "harmonic":
            logger.info("  Frequencies swept: %d (%s)",
                        len(output["omegas"]), output["method"])
        elif output["analysis"] == "spectrum":
            if "per_direction" in output:      # multi-direction response
                logger.info(
                    "  %d directions (%s rule), modal mass %s",
                    len(output["per_direction"]),
                    output["directional_rule"],
                    ", ".join("%.1f%%" % (100.0 * d["mass_fraction"])
                              for d in output["per_direction"]))
            else:
                logger.info("  Modal mass captured: %.1f%% (%s)",
                            100.0 * output["mass_fraction"],
                            output["combination"])
        elif output["analysis"] == "continuation":
            lf = output["load_factors"]
            logger.info("  Path points: %d (lambda in [%.4g, %.4g])",
                        output["n_points"], min(lf), max(lf))
        elif output["analysis"] == "reduction":
            logger.info("  %s: %d reduced DOFs, f1 = %.6g Hz",
                        output["method"], output["n_reduced_dofs"],
                        output["reduced_frequencies_hz"][0])
        elif output["analysis"] == "transient":
            # An ensemble result has no "method" (central only): the JAX
            # CLI raises KeyError on it after writing the result (ROADMAP
            # fault 3.16); here it logs the batch instead.
            logger.info("  Steps: %d (dt=%.3e, method=%s)",
                        output["n_steps"], output["dt"],
                        output.get("method", "central, ensemble of "
                                   f"{output.get('batch')}"))
        logger.info("Results written to %s", output_file)
        return output

    if parsed.prescribed is not None:
        # Support settlement: one Newton solve at the full load, with the
        # prescribed values of the fixed DOFs.
        method = resolve_method(problem, config, parsed.measured_disp,
                                parsed.measured_dofs)
        if method not in ("nr", "auto"):
            raise ValueError("prescribed_displacements require the "
                             f"Newton-Raphson path (got method={method!r})")
        logger.info("Prescribed displacements on %d DOFs",
                    int(np.count_nonzero(parsed.prescribed)))
        result = solve_nr(problem, config, 1.0,
                          prescribed_u=parsed.prescribed, device=device)
        output = result_to_output_dict(result, problem)
        with open(output_file, "w") as f:
            json.dump(output, f, indent=2)
        logger.info("Results written to %s", output_file)
        return output

    result = solve_auto(problem, config, measured_disp=parsed.measured_disp,
                        measured_dofs=parsed.measured_dofs, verbose=True,
                        device=device)
    output = result_to_output_dict(result, problem)
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


def _run_plane(raw: dict, output_file: str, device) -> dict:
    """A plane document through io/plane_io on `device`, with the JAX CLI's
    log lines."""
    from ..io.plane_io import run_plane_document

    logger.info("Plane document: %s",
                "generated mesh" if "mesh" in raw else
                f"{len(raw.get('nodes', ()))} nodes, "
                f"{len(raw.get('elements', ()))} elements")
    output = run_plane_document(raw, device)
    with open(output_file, "w") as f:
        json.dump(output, f, indent=2)
    logger.info("%s", "=" * 60)
    logger.info("PLANE ANALYSIS SUMMARY (%s):", output["analysis"])
    kind = output["analysis"]
    if kind == "modal":
        logger.info("  Frequencies (Hz): %s",
                    ["%.6g" % v for v in output["frequencies_hz"]])
    elif kind == "transient":
        logger.info("  Steps: %d (dt=%.3e)", output["n_steps"],
                    output["dt"])
    elif kind == "plastic":
        logger.info("  Steps: %d, yielded elements: %d, peak von "
                    "Mises: %.6g", output["n_steps"],
                    len(output["yielded_elements"]),
                    max(output["max_von_mises"]))
    elif kind == "harmonic":
        logger.info("  Sweep: %d frequencies, peak |X| %.6g",
                    len(output["omegas"]),
                    max(max(row) for row in output["amplitude"]))
    elif kind == "reduction":
        logger.info("  %s: %d reduced DOFs, f1 = %.6g Hz",
                    output["method"], output["n_reduced_dofs"],
                    output["reduced_frequencies_hz"][0])
    elif kind == "buckling":
        logger.info("  Load factors: %s",
                    ["%.6g" % v for v in output["load_factors"]])
    else:
        logger.info("  Max von Mises: %.6g (element %d)",
                    output["max_von_mises"],
                    output["max_von_mises_element"])
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
