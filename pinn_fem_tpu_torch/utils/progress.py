"""Console progress output (counterpart of pinn_fem_tpu/utils/progress.py).

Only `ensure_console_logging` is ported: the GD progress table
(`log_gd_progress`) prints gradient-descent history rows, which come with
the PINN solvers (ROADMAP item 6).
"""

from __future__ import annotations

import logging
import sys

PACKAGE_LOGGER = "pinn_fem_tpu_torch"


def ensure_console_logging() -> None:
    """Attach a bare stdout handler to the package logger if none exists.

    The CLI installs its own file and stdout handlers first, in which case
    this does nothing.
    """
    pkg = logging.getLogger(PACKAGE_LOGGER)
    if not pkg.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(message)s"))
        pkg.addHandler(h)
        pkg.setLevel(logging.INFO)
