"""Console progress output (counterpart of pinn_fem_tpu/utils/progress.py).

The GD and full-NR loops keep their history rows on the host, so the
reference's progress table (solver.py:245-249, 325-333) is printed from
the history after each increment, through the package logger; full-NR
rows get their own columns, Gauss-Newton rows no table, as in the JAX
package.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, List

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


def _log_full_nr_progress(log: logging.Logger, rows: List[Dict[str, float]],
                          print_every: int) -> None:
    """Full-NR rows: iterations 0 and 1, every print_every-th, the last."""
    log.info("%s", f"{'Iter':>6} | {'Loss Total':>12} | "
                   f"{'Loss Physics':>12} | {'||R||':>12} | "
                   f"{'|grad u|':>10} | {'|grad th|':>10}")
    log.info("%s", "-" * 78)
    for e in rows:
        it = int(e.get("iteration", 0))
        if not (it <= 1 or it % print_every == 0 or e is rows[-1]):
            continue
        rnorm = (2.0 * e.get("loss_physics", 0.0)) ** 0.5
        log.info("%s", f"{it:6d} | {e.get('loss_total', 0.0):12.3e} | "
                       f"{e.get('loss_physics', 0.0):12.3e} | {rnorm:12.3e} | "
                       f"{e.get('grad_norm_u', 0.0):10.3e} | "
                       f"{e.get('grad_norm_theta', 0.0):10.3e}")


def log_gd_progress(history: List[Dict[str, float]], print_every: int
                    ) -> None:
    """The reference's progress table from the history: full-NR rows
    (those with "grad_norm_u") in their own table, else GD rows (rows
    without "residual_norm", such as NR summaries, are skipped):
    iteration 1, every print_every-th iteration, and the last row."""
    log = logging.getLogger(f"{PACKAGE_LOGGER}.solvers")
    print_every = max(print_every, 1)
    fnr_rows = [e for e in history if "grad_norm_u" in e]
    if fnr_rows:
        _log_full_nr_progress(log, fnr_rows, print_every)
        return
    rows = [e for e in history if "residual_norm" in e]
    if not rows:
        return
    has_nn = "theta_norm" in rows[-1]
    header = (f"{'Iter':>6} | {'Loss Total':>12} | {'Loss Physics':>12} | "
              f"{'||R||':>12} | {'Loss Data':>12} | {'||u||':>10}")
    if has_nn:
        header += f" | {'NN Params':>10}"
    log.info("%s", header)
    log.info("%s", "-" * (82 + (12 if has_nn else 0)))
    for e in rows:
        it = int(e.get("iteration", 0))
        if not (it == 1 or it % print_every == 0 or e is rows[-1]):
            continue
        msg = (f"{it:6d} | {e.get('loss_total', 0.0):12.3e} | "
               f"{e.get('loss_physics', 0.0):12.3e} | "
               f"{e.get('residual_norm', 0.0):12.3e} | "
               f"{e.get('loss_data', 0.0):12.3e} | "
               f"{e.get('u_norm', 0.0):10.3e}")
        if has_nn:
            msg += f" | {e.get('theta_norm', 0.0):10.3e}"
        log.info("%s", msg)
