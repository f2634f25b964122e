"""Bandwidth-reducing node reordering, reverse Cuthill-McKee (counterpart of
pinn_fem_tpu/ops/reorder.py).

The banded operator (ops/dia.py, kernels 1-3 on a card) needs a node
numbering whose stiffness is banded; a hand-numbered or exported mesh often
has none, and then the Newton solver takes the gather-based PCG
(ops/cg.py).  RCM renumbers such a mesh back onto the banded operator:
BFS from a minimum-degree seed, neighbours in ascending (degree, id)
order, each component in turn, the whole order reversed.  The orders are
the JAX package's bit for bit, disconnected components included; the
native library (utils/native.py) computes the same order when it is
present.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..models.problem import TrussProblem


def rcm_permutation_numpy(elements: np.ndarray, nnode: int) -> np.ndarray:
    """order[new] = old node id (int32), reverse Cuthill-McKee."""
    elements = np.asarray(elements, dtype=np.int64)
    degree = np.zeros(nnode, dtype=np.int64)
    np.add.at(degree, elements[:, 0], 1)
    np.add.at(degree, elements[:, 1], 1)
    offset = np.zeros(nnode + 1, dtype=np.int64)
    np.cumsum(degree, out=offset[1:])
    # Adjacency lists in element order, each then sorted by (degree, id).
    ends = np.concatenate([elements, elements[:, ::-1]], axis=1).reshape(-1, 2)
    slot = np.argsort(ends[:, 0], kind="stable")
    adj = ends[slot, 1]
    owner = ends[slot, 0]
    adj = adj[np.lexsort((adj, degree[adj], owner))]

    visited = np.zeros(nnode, dtype=bool)
    order = np.empty(nnode, dtype=np.int32)
    tail = 0
    while tail < nnode:
        unvisited = np.flatnonzero(~visited)
        seed = unvisited[np.argmin(degree[unvisited])]
        visited[seed] = True
        order[tail] = seed
        head = tail
        tail += 1
        while head < tail:
            n = order[head]
            head += 1
            for m in adj[offset[n]:offset[n + 1]]:
                if not visited[m]:
                    visited[m] = True
                    order[tail] = m
                    tail += 1
    return order[::-1].copy()


def rcm_permutation(elements: np.ndarray, nnode: int) -> np.ndarray:
    """order[new] = old node id: the native library when present, else
    the numpy path (the same order)."""
    from ..utils.native import rcm_order_native

    order = rcm_order_native(elements, nnode)
    if order is not None:
        return order
    return rcm_permutation_numpy(elements, nnode)


def reorder_problem(problem: TrussProblem, order: Optional[np.ndarray] = None
                    ) -> Tuple[TrussProblem, np.ndarray]:
    """RCM-renumbered copy of a problem and the node order used
    (order[new] = old).  DOF quantities map between the numberings with
    dof_permutation(); solution fields come back with restore_field()."""
    if order is None:
        order = rcm_permutation(np.asarray(problem.elements), problem.nnode)
    order = np.asarray(order, dtype=np.int64)
    new_of_old = np.empty_like(order)
    new_of_old[order] = np.arange(problem.nnode, dtype=np.int64)

    dim = problem.dimension
    nodes = np.asarray(problem.nodes).reshape(problem.nnode, -1)[order]
    if dim == 1:
        nodes = nodes.reshape(-1)
    elements = new_of_old[np.asarray(problem.elements, dtype=np.int64)]
    dof_perm = dof_permutation(order, dim)               # dof_new -> dof_old
    loads = np.asarray(problem.loads)[dof_perm]
    new_dof_of_old = np.empty_like(dof_perm)
    new_dof_of_old[dof_perm] = np.arange(dof_perm.size)
    fixed = np.sort(new_dof_of_old[np.asarray(problem.fixed_dofs,
                                              dtype=np.int64)])
    reordered = TrussProblem(nodes=nodes, elements=elements,
                             material=problem.material, loads=loads,
                             fixed_dofs=fixed, dimension=dim)
    return reordered, order


def dof_permutation(order: np.ndarray, dimension: int) -> np.ndarray:
    """perm[dof_new] = dof_old for a node permutation order[new] = old."""
    order = np.asarray(order, dtype=np.int64)
    return (dimension * order[:, None]
            + np.arange(dimension)[None, :]).reshape(-1)


def restore_field(field_new: np.ndarray, order: np.ndarray,
                  dimension: int) -> np.ndarray:
    """A per-DOF field in the original numbering:
    field_old[dof_old] = field_new[dof_new]."""
    perm = dof_permutation(order, dimension)
    out = np.empty_like(np.asarray(field_new).reshape(-1))
    out[perm] = np.asarray(field_new).reshape(-1)
    return out
