"""Structured-grid gather and scatter (counterpart of
pinn_fem_tpu/ops/structured.py).

The generated rect and box meshes (models/plane.rect_mesh,
models/solid.box_mesh) have canonical connectivity: element (i, j[, k])
touches the nodes at grid offsets {0, 1}^d.  Both movements of an explicit
step then decompose into 2^d dense slices of the node grid:

    gather   u_e[.., corner] = u_grid[j + dj, i + di]
    scatter  f_grid[j + dj, i + di] += fe[.., corner]      (slice-add)

with no index vectors.  Detection looks at the connectivity only (the node
coordinates may be anything): the element table must equal the
generator's enumeration (x-fastest nodes, i-fastest elements).  Other
meshes take the general gather and the float64 scatter
(ops/assembly.scatter_add).

The closures work on tensors of any dtype on any device; the scatter adds
the corners in the order of `_Q4_OFF` / `_HEX_OFF` in the tensor's dtype,
the JAX package's order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rect_grid_of(elements: np.ndarray,
                 nnode: int) -> Optional[Tuple[int, int]]:
    """(nx, ny) if `elements` is exactly rect_mesh(nx, ny, "quad")
    connectivity for nnode = (nx+1)(ny+1), else None."""
    el = np.asarray(elements)
    if el.ndim != 2 or el.shape[1] != 4 or el.shape[0] == 0:
        return None
    nx1 = int(el[0, 3]) - int(el[0, 0])
    if nx1 < 2 or nnode % nx1:
        return None
    nx, ny = nx1 - 1, nnode // nx1 - 1
    if nx < 1 or ny < 1 or el.shape[0] != nx * ny:
        return None
    i = np.arange(nx)
    j = np.arange(ny)
    n00 = (j[:, None] * nx1 + i[None, :]).reshape(-1)
    expect = np.stack([n00, n00 + 1, n00 + 1 + nx1, n00 + nx1], 1)
    return (nx, ny) if np.array_equal(el, expect) else None


def box_grid_of(elements: np.ndarray,
                nnode: int) -> Optional[Tuple[int, int, int]]:
    """(nx, ny, nz) if `elements` is exactly box_mesh connectivity
    (x-fastest node ids, iz-major elements), else None."""
    el = np.asarray(elements)
    if el.ndim != 2 or el.shape[1] != 8 or el.shape[0] == 0:
        return None
    if int(el[0, 1]) - int(el[0, 0]) != 1:       # +x neighbour offset 1
        return None
    nx1 = int(el[0, 3]) - int(el[0, 0])          # +y offset nx + 1
    ny1xnx1 = int(el[0, 4]) - int(el[0, 0])      # +z offset (nx+1)(ny+1)
    if nx1 < 2 or ny1xnx1 < nx1 or ny1xnx1 % nx1:
        return None
    ny1 = ny1xnx1 // nx1
    if nnode % ny1xnx1:
        return None
    nx, ny, nz = nx1 - 1, ny1 - 1, nnode // ny1xnx1 - 1
    if min(nx, ny, nz) < 1 or el.shape[0] != nx * ny * nz:
        return None
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    n0 = (ix[None, None, :] + nx1 * (iy[None, :, None]
                                     + ny1 * iz[:, None, None])).reshape(-1)
    off = np.array([0, 1, 1 + nx1, nx1,
                    ny1xnx1, ny1xnx1 + 1, ny1xnx1 + 1 + nx1,
                    ny1xnx1 + nx1])
    expect = n0[:, None] + off[None, :]
    return (nx, ny, nz) if np.array_equal(el, expect) else None


_Q4_OFF = ((0, 0), (0, 1), (1, 1), (1, 0))        # (dj, di) per corner
_HEX_OFF = ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
            (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))  # (dk, dj, di)


def make_plane_grid_ops(nx: int, ny: int):
    """(gather, scatter) for a (nx, ny) Q4 grid with 2 DOFs a node in the
    [u1 v1 u2 v2 ..] element order:

        gather(u (ndof,)) -> u_e (m, 8)
        scatter(fe (m, 8)) -> f (ndof,)
    """

    def gather(u):
        g = u.reshape(ny + 1, nx + 1, 2)
        parts = [g[dj:dj + ny, di:di + nx] for dj, di in _Q4_OFF]
        return torch.stack(parts, dim=2).reshape(nx * ny, 8)

    def scatter(fe):
        fg = fe.reshape(ny, nx, 4, 2)
        f = torch.zeros((ny + 1, nx + 1, 2), dtype=fe.dtype,
                        device=fe.device)
        for c, (dj, di) in enumerate(_Q4_OFF):
            f[dj:dj + ny, di:di + nx] += fg[:, :, c]
        return f.reshape(-1)

    return gather, scatter


def make_solid_grid_ops(nx: int, ny: int, nz: int):
    """(gather, scatter) for a (nx, ny, nz) hex8 grid, 3 DOFs a node:

        gather(u (ndof,)) -> u_e (m, 24)
        scatter(fe (m, 24)) -> f (ndof,)
    """

    def gather(u):
        g = u.reshape(nz + 1, ny + 1, nx + 1, 3)
        parts = [g[dk:dk + nz, dj:dj + ny, di:di + nx]
                 for dk, dj, di in _HEX_OFF]
        return torch.stack(parts, dim=3).reshape(nx * ny * nz, 24)

    def scatter(fe):
        fg = fe.reshape(nz, ny, nx, 8, 3)
        f = torch.zeros((nz + 1, ny + 1, nx + 1, 3), dtype=fe.dtype,
                        device=fe.device)
        for c, (dk, dj, di) in enumerate(_HEX_OFF):
            f[dk:dk + nz, dj:dj + ny, di:di + nx] += fg[:, :, :, c]
        return f.reshape(-1)

    return gather, scatter
