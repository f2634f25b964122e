"""Structured test meshes: the cross-braced grid and the straight chain.

The same generators as benchmarks/scaling.py (grid_problem, chain_problem),
so the port's large-mesh runs use the JAX package's own benchmark meshes.
The 100 x 200 grid (40,000 DOFs, 79,102 elements) is the repository's
large-mesh Newton figure; the 1,000,001-node chain (2,000,002 DOFs, 7
diagonals) is its matvec and CG-iteration figure.
"""

from __future__ import annotations

import numpy as np

from .models.fields import Material
from .models.problem import TrussProblem


def grid_arrays(rows: int, cols: int):
    """(nodes, elements, loads, fixed_dofs) of a cross-braced grid strip in
    tension: the left edge is pinned and the right edge pulled along x.
    Node ids run row-major, so the stiffness is banded with ~2 * cols
    bandwidth."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    nodes = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(float)
    nid = np.arange(rows * cols).reshape(rows, cols)
    # Per node, the element order of benchmarks/scaling.py: right,
    # down, down-right diagonal, then the crossing diagonal.
    pairs = np.full((rows, cols, 4, 2), -1, dtype=np.int64)
    pairs[:, :-1, 0] = np.stack([nid[:, :-1], nid[:, 1:]], -1)
    pairs[:-1, :, 1] = np.stack([nid[:-1, :], nid[1:, :]], -1)
    pairs[:-1, :-1, 2] = np.stack([nid[:-1, :-1], nid[1:, 1:]], -1)
    pairs[:-1, :-1, 3] = np.stack([nid[:-1, 1:], nid[1:, :-1]], -1)
    pairs = pairs.reshape(-1, 2)
    elements = pairs[pairs[:, 0] >= 0]
    loads = np.zeros(2 * rows * cols)
    loads[2 * nid[:, -1]] = 1.0
    fixed = np.stack([2 * nid[:, 0], 2 * nid[:, 0] + 1], axis=1).reshape(-1)
    return nodes, elements, loads, fixed


def grid_problem(rows: int, cols: int) -> TrussProblem:
    nodes, elements, loads, fixed = grid_arrays(rows, cols)
    return TrussProblem(nodes=nodes, elements=elements,
                        material=Material(young=1.0, area=1.0, density=1.0),
                        loads=loads, fixed_dofs=fixed, dimension=2)


def grid_document(rows: int, cols: int, tolerance: float = 1e-5,
                  n_increments: int = 2, max_iterations: int = 20) -> dict:
    """The grid as a JSON problem document for the CLI (method "nr")."""
    nodes, elements, loads, fixed = grid_arrays(rows, cols)
    return {
        "description": f"cross-braced {rows}x{cols} grid strip in tension",
        "nodes": nodes.tolist(),
        "elements": elements.tolist(),
        "fixed_dofs": fixed.tolist(),
        "loads": loads.tolist(),
        "material": {"young": 1.0, "area": 1.0, "density": 1.0},
        "solver_type": "fem",
        "solver_config": {"method": "nr", "tolerance": tolerance,
                          "n_increments": n_increments,
                          "max_iterations": max_iterations},
    }


def chain_problem(n_nodes: int) -> TrussProblem:
    """Straight 2D chain, pinned at node 0, pulled at the free end."""
    nodes = np.stack([np.arange(n_nodes, dtype=float), np.zeros(n_nodes)], 1)
    elements = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], 1)
    loads = np.zeros(2 * n_nodes)
    loads[-2] = 1.0
    return TrussProblem(nodes=nodes, elements=elements,
                        material=Material(young=1.0, area=1.0, density=1.0),
                        loads=loads, fixed_dofs=np.array([0, 1]), dimension=2)
