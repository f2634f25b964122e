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
runs io/analysis.run_analysis and writes its result dict: every analysis
type of the JAX CLI ("transient" with "plasticity", "modal", "buckling",
"harmonic", "random", "spectrum", "continuation", "plastic", "reduction",
"identification", "sizing" and "reliability").
Solid, plane, frame, space-frame, plate and shell documents
("element_type": "solid", "plane", "frame", "frame3d", "plate", "shell")
are routed before the truss parse to io/solid_io, io/plane_io,
io/frame_io, io/frame3d_io, io/plate_io and io/shell_io and log the JAX
CLI's SOLID / PLANE / FRAME / SPACE-FRAME / PLATE / SHELL ANALYSIS SUMMARY
lines (a banded frame or shell statics logs its summaries, where the JAX
CLI raises KeyError after writing the result: ROADMAP fault 3.27).
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
    """Solve one truss, solid, plane, frame, space-frame, plate or shell
    document on `device` ("cuda" when None) and write its result JSON."""
    device = resolve_device(device)
    with open(problem_file) as fh:
        raw = json.load(fh)
    if output_file is None:
        p = Path(problem_file)
        output_file = str(p.parent / f"{p.stem}.res.json")
    from ..io.frame3d_io import is_frame3d_document
    from ..io.frame_io import is_frame_document
    from ..io.plane_io import is_plane_document
    from ..io.plate_io import is_plate_document
    from ..io.shell_io import is_shell_document
    from ..io.solid_io import is_solid_document

    for family, is_family in (("plate", is_plate_document),
                              ("shell", is_shell_document),
                              ("frame", is_frame_document),
                              ("frame3d", is_frame3d_document),
                              ("solid", is_solid_document),
                              ("plane", is_plane_document)):
        if is_family(raw):
            return _run_family(family, raw, output_file, device)
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
        elif output["analysis"] == "identification":
            _log_truss_identification(output)
        elif output["analysis"] == "sizing":
            _log_truss_sizing(output)
        elif output["analysis"] == "reliability":
            _log_truss_reliability(output)
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


def _log_modal(output: dict) -> None:
    logger.info("  Frequencies (Hz): %s",
                ["%.6g" % v for v in output["frequencies_hz"]])


def _log_sweep(output: dict) -> None:
    logger.info("  Sweep: %d frequencies, peak |X| %.6g",
                len(output["omegas"]),
                max(max(row) for row in output["amplitude"]))


def _log_transient(output: dict) -> None:
    if output.get("plastic"):
        logger.info("  Steps: %d (dt=%.3e), yielded elements: %d, plastic "
                    "work: %.6g", output["n_steps"], output["dt"],
                    len(output["yielded_elements"]),
                    output["plastic_work"][-1])
    else:
        logger.info("  Steps: %d (dt=%.3e)", output["n_steps"],
                    output["dt"])


def _log_spectrum(output: dict) -> None:
    logger.info("  Modal mass captured: %.1f%% (%s), peak |u| %.6g",
                100.0 * output["mass_fraction"], output["combination"],
                output["max_displacement"])


def _log_random(output: dict) -> None:
    logger.info("  PSD grid: %d frequencies, max RMS %.6g",
                len(output["omegas"]), max(output["rms"]))


def _log_reduction(output: dict) -> None:
    logger.info("  %s: %d reduced DOFs, f1 = %.6g Hz", output["method"],
                output["n_reduced_dofs"], output["reduced_frequencies_hz"][0])


def _log_factors(label: str):
    def log_factors(output: dict) -> None:
        logger.info("  %s: %s", label,
                    ["%.6g" % v for v in output["load_factors"]])
    return log_factors


def _log_plastic(output: dict) -> None:
    logger.info("  Steps: %d, yielded elements: %d, peak von Mises: %.6g",
                output["n_steps"], len(output["yielded_elements"]),
                max(output["max_von_mises"]))


def _log_banded(output: dict) -> None:
    """The summary of a banded frame statics (the JAX CLI raises KeyError
    here after writing the result: ROADMAP fault 3.27)."""
    logger.info("  Banded: %d PCG iterations (relative residual %.3e), max "
                "|u| %.6g (dof %d), max |end moment| %.6g",
                output["iterations"], output["relative_residual"],
                output["max_abs_displacement"],
                output["max_abs_displacement_dof"],
                output["max_abs_moment"])


def _log_shell_static(output: dict) -> None:
    if output.get("tier") == "banded":
        # The JAX CLI raises KeyError here after writing the result
        # (ROADMAP fault 3.27).
        logger.info("  Banded: %d PCG iterations (relative residual "
                    "%.3e), max |u| %.6g (dof %d), peak |N|: %.6g, peak "
                    "|M|: %.6g", output["iterations"],
                    output["relative_residual"], output["max_displacement"],
                    output["max_displacement_dof"],
                    output["max_abs_membrane_force"],
                    output["max_abs_moment"])
    else:
        logger.info("  Max |u|: %.6g (dof %d), peak |N|: %.6g, peak |M|: "
                    "%.6g", output["max_displacement"],
                    output["max_displacement_dof"],
                    max(max(abs(v) for v in row)
                        for row in output["membrane_forces"]),
                    max(max(abs(v) for v in row)
                        for row in output["moments"]))


def _log_shell_continuation(output: dict) -> None:
    lf = output["load_factors"]
    logger.info("  Path points: %d (lambda in [%.4g, %.4g])",
                output["n_points"], min(lf), max(lf))


def _log_frame_static(output: dict) -> None:
    if output.get("tier") == "banded":
        _log_banded(output)
    else:
        m = np.max(np.abs(np.asarray(output["end_moments"])))
        logger.info("  Max |end moment|: %.6g (member forces in the "
                    "result)", m)


def _log_frame_plastic(output: dict) -> None:
    if output["mechanism"]:
        logger.info("  Collapse at lambda = %.6g (%d hinges)",
                    output["collapse_factor"], len(output["hinges"]))
    else:
        logger.info("  No mechanism up to lambda = %.6g (%d hinges)",
                    output["load_factors"][-1], len(output["hinges"]))


def _log_frame3d_static(output: dict) -> None:
    if output.get("tier") == "banded":
        _log_banded(output)
    else:
        logger.info("  Max |u|: %.6g (dof %d), peak |torque|: %.6g",
                    output["max_displacement"],
                    output["max_displacement_dof"],
                    max(abs(v) for v in output["torques"]))


def _log_plate_plastic(output: dict) -> None:
    logger.info("  %d load steps (%d layers), %d elements yielded, peak "
                "fiber von Mises %.6g", output["n_steps"],
                output["n_layers"], len(output["yielded_elements"]),
                max(output["max_von_mises"]))


def _log_truss_identification(output: dict) -> None:
    if output.get("mode") == "field":
        vals = output["identified_field"]["at_elements"]["values"]
        logger.info("  Identified %s(x) field over %d elements in %d iters "
                    "(range %.6g..%.6g, final loss %.3e)", output["field"],
                    len(vals), output["n_iter"], min(vals), max(vals),
                    output["final_loss"])
    else:
        logger.info("  Identified %s in %d iters (final loss %.3e)",
                    ", ".join(f"{k}={v:.6g}" for k, v
                              in output["identified"].items()),
                    output["n_iter"], output["final_loss"])


def _log_young_range(output: dict) -> None:
    logger.info("  Identified E in [%.6g, %.6g], final loss %.3e",
                min(output["young"]), max(output["young"]),
                output["final_loss"])


def _log_identified_tier(output: dict) -> None:
    # final_loss is None when n_iter=0 left no history.
    logger.info("  Identified %s (%s tier), final loss %s",
                output["parameter"], output["method"], output["final_loss"])


def _log_frame_identification(output: dict) -> None:
    vals = output[output["parameter"]]
    logger.info("  Identified %s in [%.6g, %.6g], final loss %.3e",
                output["parameter"], min(vals), max(vals),
                output["final_loss"])


def _log_truss_sizing(output: dict) -> None:
    logger.info(
        "  %s sizing (%s): mass %.6g -> %.6g (%.1f%% lighter), "
        "max stress ratio %s",
        output["objective"], output["method"], output["mass_initial"],
        output["mass"], 100.0 * output["mass_reduction"],
        ("%.4f" % output["max_stress_ratio"])
        if "max_stress_ratio" in output else "n/a")
    if "min_reliability_beta" in output:
        logger.info("  RBDO: achieved min beta %.4f over the members "
                    "(target %.4f)", output["min_reliability_beta"],
                    output["target_beta"])
    if "min_fatigue_life_s" in output:
        logger.info("  Fatigue (%s): min life %.6g h over the members "
                    "(floor %.6g h, critical e%d)",
                    output["fatigue_method"],
                    output["min_fatigue_life_s"] / 3600.0,
                    output["fatigue_min_life_s"] / 3600.0,
                    output["fatigue_critical_element"])


def _log_truss_reliability(output: dict) -> None:
    worst = output["critical_limit_state"]
    logger.info("  FORM over %d limit states: min beta %.4f (pf %.3e, %s); "
                "system pf in [%.3e, %.3e]", len(output["labels"]),
                output["beta_min"], output["pf"][worst],
                output["labels"][worst], output["system_pf_bounds"][0],
                output["system_pf_bounds"][1])
    if "mc" in output:
        logger.info("  Monte-Carlo check: pf %.3e +/- %.1e (%d samples)",
                    output["mc"]["pf"], output["mc"]["std_error"],
                    output["mc"]["n_samples"])


def _log_plate_static(output: dict) -> None:
    logger.info("  Max deflection: %.6g (node %d), max extreme-fiber von "
                "Mises: %.6g (element %d)", output["max_deflection"],
                output["max_deflection_node"], output["max_von_mises"],
                output["max_von_mises_element"])


# The summary line of each analysis kind that every element family logs
# alike; _FAMILIES holds each family's own lines and its static summary.
_SUMMARIES = {"modal": _log_modal, "transient": _log_transient,
              "harmonic": _log_sweep, "spectrum": _log_spectrum,
              "random": _log_random, "reduction": _log_reduction,
              "sizing": lambda out: logger.info(
                  "  Weight %.6g after %d iterations", out["weight"],
                  len(out["history"])),
              "reliability": lambda out: logger.info(
                  "  beta_min = %s (pf bounds %s)", out["beta_min"],
                  out["system_pf_bounds"])}


def _counts_of(raw: dict) -> str:
    return (f"{len(raw.get('nodes', ()))} nodes, "
            f"{len(raw.get('elements', ()))} elements")


def _mesh_of(raw: dict) -> str:
    return "generated mesh" if "mesh" in raw else _counts_of(raw)


def _midsurface_of(raw: dict) -> str:
    return "generated midsurface" if "mesh" in raw else _counts_of(raw)


# family: (io module, document runner, log name, summary title,
#          description of the document, its own summaries, static summary)
_FAMILIES = {
    "plane": ("plane_io", "run_plane_document", "Plane", "PLANE", _mesh_of,
              {"plastic": _log_plastic,
               "buckling": _log_factors("Load factors"),
               "identification": _log_young_range},
              lambda out: logger.info(
                  "  Max von Mises: %.6g (element %d)",
                  out["max_von_mises"], out["max_von_mises_element"])),
    "solid": ("solid_io", "run_solid_document", "Solid", "SOLID", _mesh_of,
              {"plastic": lambda out: logger.info(
                  "  Steps: %d, yielded elements: %d, max von Mises: %.6g",
                  out["n_steps"], len(out["yielded_elements"]),
                  max(out["max_von_mises"])),
               "buckling": _log_factors("Load factors"),
               "identification": _log_identified_tier},
              lambda out: logger.info(
                  "  Max |u|: %.6g, max von Mises: %.6g (%s)",
                  out["max_displacement"], out["max_von_mises"],
                  out["method"])),
    "plate": ("plate_io", "run_plate_document", "Plate", "PLATE", _mesh_of,
              {"plastic": _log_plate_plastic,
               "buckling": _log_factors("Critical membrane-force factors"),
               "identification": _log_young_range},
              _log_plate_static),
    "shell": ("shell_io", "run_shell_document", "Shell", "SHELL",
              _midsurface_of,
              {"buckling": _log_factors("Load factors"),
               "plastic": lambda out: logger.info(
                   "  Steps: %d, yielded facets: %d, max von Mises: %.6g",
                   out["n_steps"], len(out["yielded_elements"]),
                   max(out["max_von_mises"])),
               "nonlinear": lambda out: logger.info(
                   "  Steps: %d (%s tier), max |u|: %.6g (von "
                   "Kármán/Marguerre)", out["n_steps"], out["tier"],
                   out["max_displacement"]),
               "continuation": _log_shell_continuation,
               "identification": _log_identified_tier},
              _log_shell_static),
    "frame": ("frame_io", "run_frame_document", "Frame", "FRAME",
              _counts_of,
              {"plastic": _log_frame_plastic,
               "identification": _log_frame_identification,
               "buckling": _log_factors("Critical load factors"),
               "harmonic": lambda out: logger.info(
                   "  Frequencies swept: %d", len(out["omegas"]))},
              _log_frame_static),
    "frame3d": ("frame3d_io", "run_frame3d_document", "Space-frame",
                "SPACE-FRAME", _counts_of,
                {"buckling": _log_factors("Critical load factors")},
                _log_frame3d_static),
}


def _run_family(family: str, raw: dict, output_file: str, device) -> dict:
    """A plane, solid, plate, shell, frame or space-frame document through
    its io module on `device`, with the JAX CLI's log lines."""
    import importlib

    module, runner, name, title, describe, own, static = _FAMILIES[family]
    run_document = getattr(importlib.import_module(
        f"..io.{module}", __package__), runner)
    logger.info("%s document: %s", name, describe(raw))
    output = run_document(raw, device)
    with open(output_file, "w") as f:
        json.dump(output, f, indent=2)
    logger.info("%s", "=" * 60)
    logger.info("%s ANALYSIS SUMMARY (%s):", title, output["analysis"])
    kind = output["analysis"]
    own.get(kind, _SUMMARIES.get(kind, static))(output)
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
