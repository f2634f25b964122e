"""Structured test meshes: the cross-braced grid and the straight chain.

The same generators as benchmarks/scaling.py (grid_problem, chain_problem),
so the port's large-mesh runs use the JAX package's own benchmark meshes.
The 100 x 200 grid (40,000 DOFs, 79,102 elements) is the repository's
large-mesh Newton figure; the 1,000,001-node chain (2,000,002 DOFs, 7
diagonals) is its matvec and CG-iteration figure.  `pinn_grid_document`
makes the grid a PINN identification document (three MLP fields, measured
displacements), the large-mesh figure of the GD path.
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


def float64_stiffness(nodes, elements):
    """K of a 2D truss with E = A = 1, float64 scipy CSR."""
    import scipy.sparse as sp

    nodes = np.asarray(nodes, float)
    el = np.asarray(elements)
    ndof = 2 * nodes.shape[0]
    dx = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = np.linalg.norm(dx, axis=1)
    g = np.concatenate([-dx, dx], axis=1) / length[:, None]
    dof = np.concatenate([2 * el[:, :1], 2 * el[:, :1] + 1,
                          2 * el[:, 1:], 2 * el[:, 1:] + 1], axis=1)
    ke = g[:, :, None] * g[:, None, :] / length[:, None, None]
    return sp.coo_matrix((ke.ravel(), (np.repeat(dof, 4, 1).ravel(),
                                       np.tile(dof, (1, 4)).ravel())),
                         shape=(ndof, ndof)).tocsr()


def float64_solution(nodes, elements, loads, fixed_dofs) -> np.ndarray:
    """Displacements of a 2D truss with E = A = 1 by a float64 sparse
    direct solve (scipy)."""
    import scipy.sparse.linalg as spl

    k = float64_stiffness(nodes, elements)
    f = np.asarray(loads, float)
    free = np.setdiff1d(np.arange(f.size), fixed_dofs)
    u = np.zeros(f.size)
    u[free] = spl.spsolve(k[free][:, free].tocsc(), f[free])
    return u


def pinn_grid_document(rows: int, cols: int, max_iterations: int = 500,
                       tolerance: float = 1e-6) -> dict:
    """The grid as a PINN identification document (method "gd").

    Three MLP fields (E, A, rho) at the widths of corpus examples 4 and 7
    (20, 15, 10), two hidden layers, input_dim 3 (load-factor-aware
    (lf, x, y) inputs: the fields kernel 4 takes); every free DOF measured,
    from a float64 solve with E = A = 1; alpha_data 100 and example 7's
    learning rates; one increment of max_iterations GD steps.  The edge
    loads sum to 1, so the displacements are of order 1 and lr_u = 0.01
    moves them within a few hundred steps.
    """
    nodes, elements, loads, fixed = grid_arrays(rows, cols)
    loads = loads / rows
    u = float64_solution(nodes, elements, loads, fixed)
    free = np.setdiff1d(np.arange(loads.size), fixed)

    def nn(width):
        return {"enabled": True, "hidden_layers": 2,
                "neurons_per_layer": width, "input_dim": 3}

    return {
        "description": f"PINN identification of E, A, rho on the cross-braced "
                       f"{rows}x{cols} grid strip",
        "nodes": nodes.tolist(),
        "elements": elements.tolist(),
        "fixed_dofs": fixed.tolist(),
        "loads": loads.tolist(),
        "material": {"young": 1.0, "area": 1.0, "density": 1.0},
        "nn_config": {"young": nn(20), "area": nn(15), "density": nn(10)},
        "measured_displacements": {"global_dof": free.tolist(),
                                   "measured_u": u[free].tolist()},
        "solver_type": "pinn-gd",
        "solver_config": {"n_increments": 1},
        "pinn_config": {"max_iterations": max_iterations,
                        "tolerance": tolerance, "learning_rate_u": 0.01,
                        "learning_rate_theta": 0.0005, "alpha_physics": 1.0,
                        "alpha_data": 100.0, "print_every": 100,
                        "preconditioning": False},
    }
