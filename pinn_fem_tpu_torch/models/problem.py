"""Truss problem: host-side model and device-side structure of arrays.

Counterpart of pinn_fem_tpu/models/problem.py.  Per-element quantities
(DOF maps, lengths, direction vectors, midpoints) are computed once on the
host into dense arrays, so assembly is one batched gather/scatter.

For the linear truss the element stiffness factorizes as
ke = s_e g_e g_e^T with s_e = E_e A_e / L_e and g_e the signed direction
vector (1D: [-1, +1]; 2D: [-c, -s, +c, +s]).  Strain is (g_e . u_e) / L_e
and the internal force is s_e (g_e . u_e) g_e.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.runtime import default_dtype, resolve_device
from .fields import Material


@dataclass
class ProblemData:
    """Device-resident structure of arrays of a truss problem.

    gather_map (the transposed incidence used by the JAX package's
    scatter-free segment sum) is left None: the slice scatters with
    index_add_; the gather-based PCG that needs it waits for ROADMAP
    item 10.  The payload mass per DOF (point_mass) comes with the dynamics
    family, ROADMAP item 14.
    """

    dof_map: torch.Tensor     # (nelm, 2*dim) int64 global DOF per element
    gvec: torch.Tensor        # (nelm, 2*dim) signed direction vector g_e
    inv_len: torch.Tensor     # (nelm,) 1 / L0
    mid: torch.Tensor         # (nelm, dim) element midpoints
    loads: torch.Tensor       # (ndof,) external load vector
    free_mask: torch.Tensor   # (ndof,) 1.0 on free DOFs, 0.0 on fixed
    fixed_mask: torch.Tensor  # (ndof,) 1.0 on fixed DOFs
    dimension: int = 2
    gather_map: Optional[torch.Tensor] = None

    @property
    def ndof(self) -> int:
        return self.loads.shape[0]

    @property
    def nelm(self) -> int:
        return self.dof_map.shape[0]

    @property
    def device(self) -> torch.device:
        return self.loads.device


@dataclass
class TrussProblem:
    """Host-side problem container, with the JAX package's validation."""

    nodes: np.ndarray          # (nnode,) for 1D or (nnode, dim) for 2D/3D
    elements: np.ndarray       # (nelm, 2) int
    material: Material
    loads: np.ndarray          # (ndof,)
    fixed_dofs: np.ndarray     # (nfixed,) int
    dimension: int = 2
    # (nnode,) payload masses: validated here, used by the dynamics family.
    point_masses: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.nodes = np.asarray(self.nodes, dtype=float)
        self.elements = np.asarray(self.elements, dtype=int)
        self.loads = np.asarray(self.loads, dtype=float).reshape(-1)
        self.fixed_dofs = np.asarray(self.fixed_dofs, dtype=int).reshape(-1)
        if self.point_masses is not None:
            self.point_masses = np.asarray(self.point_masses,
                                           dtype=float).reshape(-1)
            if self.point_masses.size != self.nnode:
                raise ValueError(
                    f"point_masses must have one value per node "
                    f"({self.nnode}), got {self.point_masses.size}")
            if not np.all(np.isfinite(self.point_masses)) \
                    or np.any(self.point_masses < 0.0):
                raise ValueError("point_masses must be finite and "
                                 "nonnegative")
            if not np.any(self.point_masses):
                self.point_masses = None       # all-zero == absent

        if self.dimension not in (1, 2, 3):
            raise ValueError("dimension must be 1, 2 or 3")
        if self.dimension == 1 and self.nodes.ndim != 1:
            raise ValueError("For 1D, nodes must be 1D array of positions")
        if self.dimension >= 2 and (
            self.nodes.ndim != 2 or self.nodes.shape[1] != self.dimension
        ):
            raise ValueError(
                f"For {self.dimension}D, nodes must have shape "
                f"(nnode, {self.dimension})"
            )
        if self.elements.ndim != 2 or self.elements.shape[1] != 2:
            raise ValueError("elements must have shape (nelm, 2)")
        if self.loads.size != self.ndof:
            raise ValueError(f"loads size must be {self.ndof}, got {self.loads.size}")
        if self.fixed_dofs.size and (
            self.fixed_dofs.min() < 0 or self.fixed_dofs.max() >= self.ndof
        ):
            raise ValueError("fixed_dofs contain out-of-range indices")

    @property
    def nnode(self) -> int:
        return self.nodes.shape[0]

    @property
    def nelm(self) -> int:
        return self.elements.shape[0]

    @property
    def ndof(self) -> int:
        return self.nnode * self.dimension

    @property
    def node_coords_2d(self) -> np.ndarray:
        """(nnode, dim) view of node coordinates regardless of dimension."""
        return self.nodes.reshape(self.nnode, self.dimension)

    def element_midpoints(self) -> np.ndarray:
        coords = self.node_coords_2d
        i, j = self.elements[:, 0], self.elements[:, 1]
        return 0.5 * (coords[i] + coords[j])

    def to_device(self, device=None, dtype: torch.dtype = None) -> ProblemData:
        """Compute the geometry arrays on the host (numpy, float64) and move
        them to `device` ("cuda" when None) in `dtype`."""
        device = resolve_device(device)
        dtype = dtype or default_dtype()
        coords = self.node_coords_2d
        i, j = self.elements[:, 0], self.elements[:, 1]
        dx = coords[j] - coords[i]                      # (nelm, dim)
        lengths = np.linalg.norm(dx, axis=1)
        if np.any(lengths <= 0.0):
            raise ValueError("Element with zero initial length detected")
        cosines = dx / lengths[:, None]
        gvec = np.concatenate([-cosines, cosines], axis=1)
        mids = 0.5 * (coords[i] + coords[j])
        if self.dimension == 1:
            dof_map = np.stack([i, j], axis=1)
        else:
            d = self.dimension
            dof_map = np.concatenate(
                [np.stack([d * n + c for c in range(d)], axis=1)
                 for n in (i, j)],
                axis=1,
            )
        free_mask = np.ones(self.ndof)
        if self.fixed_dofs.size:
            free_mask[np.unique(self.fixed_dofs)] = 0.0

        def put(a, dt=dtype):
            host = torch.from_numpy(np.ascontiguousarray(a)).to(dt)
            return host.to(device)

        return ProblemData(
            dof_map=put(dof_map, torch.int64),
            gvec=put(gvec),
            inv_len=put(1.0 / lengths),
            mid=put(mids),
            loads=put(self.loads),
            free_mask=put(free_mask),
            fixed_mask=put(1.0 - free_mask),
            dimension=self.dimension,
        )
