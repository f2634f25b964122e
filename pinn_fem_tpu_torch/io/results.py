"""Result serialization (counterpart of pinn_fem_tpu/io/results.py).

The output dict is {success, converged, iterations = len(history),
displacements, reactions, history}.  The NN-parameter export and the
identified-property evaluation at nodes and centroids come with the PINN
solvers (ROADMAP items 4 and 6); the ported methods produce no NN parameters.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import SolverResult


def result_to_output_dict(result: SolverResult) -> Dict:
    return {
        "success": result.converged,
        "converged": result.converged,
        "iterations": len(result.history),
        "displacements": np.asarray(result.displacements).flatten().tolist(),
        "reactions": (
            np.asarray(result.reactions).flatten().tolist()
            if result.reactions is not None
            else []
        ),
        "history": result.history,
    }
