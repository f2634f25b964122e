"""Gather-based DOF accumulation (counterpart of pinn_fem_tpu/ops/scatter.py).

With a precomputed transposed incidence table the (nelm, 2d) -> (ndof,)
accumulation is a gather and a short sum per DOF:

    f[d] = sum_k fe_flat[gather_map[d, k]]        (gather_map: (ndof, V))

The map is the JAX package's, bit for bit: padding points one past the
end of fe_flat, where a zero is appended.  The sum follows the port's
accumulation rule (ops/assembly.scatter_add, ROADMAP fault 3.4): each
DOF's terms are summed in float64 and rounded once to the working type, so
the result does not depend on the order of the terms on any device.  The
JAX package sums them in float32 in the map's order
(tests/test_torch_gather.py states the measured gap).
"""

from __future__ import annotations

import numpy as np
import torch


def build_gather_map(dof_map: np.ndarray, ndof: int) -> np.ndarray:
    """Transpose the (nelm, 2d) DOF map into (ndof, V) int32 flat-slot
    indices, each DOF's slots in ascending order; padded entries point one
    past the end (nelm * 2d)."""
    flat = np.asarray(dof_map, dtype=np.int64).reshape(-1)
    n_slots = flat.size
    counts = np.bincount(flat, minlength=ndof)
    valence = int(counts.max()) if n_slots else 1

    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    starts = np.zeros(ndof + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    col = np.arange(n_slots, dtype=np.int64) - starts[sorted_dofs]

    gather = np.full((ndof, valence), n_slots, dtype=np.int64)
    gather[sorted_dofs, col] = order
    return gather.astype(np.int32)


def segment_sum_dofs(fe: torch.Tensor, gather_map: torch.Tensor,
                     dof_map: torch.Tensor = None) -> torch.Tensor:
    """(nelm, 2d) element contributions -> (ndof,) accumulated vector,
    summed in float64 and rounded once to fe.dtype.  dof_map is unused:
    kept for the JAX signature."""
    del dof_map
    flat = torch.cat([fe.reshape(-1).double(),
                      fe.new_zeros(1, dtype=torch.float64)])
    terms = torch.index_select(flat, 0, gather_map.reshape(-1))
    return terms.reshape(gather_map.shape).sum(dim=1).to(fe.dtype)
