"""Legacy generic CLI variant (counterpart of
pinn_fem_tpu/cli/legacy_generic.py): entry-point parity with the
reference's older generic script, which its Node backend spawns.

    python -m pinn_fem_tpu_torch.cli.legacy_generic problem.json [output.json]

It differs from cli.generic in one observable way: the run log is
TIMESTAMPED, <stem>_<YYYYMMDD_HHMMSS>.log next to the problem file, where
cli.generic overwrites <stem>.log.  NN material fields default to
input_dim 1, as in every document the schema parses: such a net takes the
spatial columns (models/fields.py `_adapt_inputs`) and its torch form,
since kernel 4 takes nets of input_dim 3 only, as in the JAX package.
Everything else (schema, .res.json output, exit codes, PINN_FEM_TPU_SEED
and PINN_FEM_TORCH_DEVICE) is cli.generic's.
"""

from __future__ import annotations

import logging
import os
import sys
import traceback
from datetime import datetime
from pathlib import Path

from ..utils.progress import PACKAGE_LOGGER
from .generic import logger, run


def setup_logging_timestamped(problem_file: str) -> Path:
    problem_name = Path(problem_file).stem
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = Path(problem_file).parent / f"{problem_name}_{timestamp}.log"
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
    logger.info("Log file created: %s", log_file)
    return log_file


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage: python -m pinn_fem_tpu_torch.cli.legacy_generic "
              "problem.json [output.json]")
        return 1
    problem_file = argv[0]
    output_file = argv[1] if len(argv) > 1 else None
    seed = int(os.environ.get("PINN_FEM_TPU_SEED", "0"))
    device = os.environ.get("PINN_FEM_TORCH_DEVICE", "cuda")
    log_file = setup_logging_timestamped(problem_file)
    try:
        run(problem_file, output_file, seed=seed, device=device)
        logger.info("Log file saved: %s", log_file)
        return 0
    except Exception as e:  # contract: log the traceback, exit 1
        logger.error("[ERROR] %s", e)
        logger.error("%s", traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(main())
