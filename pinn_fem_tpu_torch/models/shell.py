"""Flat-facet shell elements (counterpart of pinn_fem_tpu/models/shell.py):
curved thin-walled structures (roofs, cylinders, vessels) carrying load by
membrane action and bending at once.

Element: the flat-facet quadrilateral, the Q4 plane-stress membrane
(models/plane._k_blocks, 2 x 2 Gauss) superposed with the MITC4 Mindlin
bending element (models/plate._k_blocks_plate) in a per-element local
frame, plus a rank-correcting drilling stiffness

    K_drill = alpha G t A_e (I_4 - 1/4 11^T + eps I_4)

on the four local theta_z DOFs (alpha = 1e-3; eps = 1e-6 in the dense
tier, 1e-3 in the banded tier, whose float32 PCG works on K alone).

Local frame (per element): the normal z from the cross product of the
diagonals, e_1 the 1 -> 2 edge projected onto the plane, e_2 = z x e_1;
corners projected onto the plane through the centroid.  Six DOFs a node
(u, v, w, theta_x, theta_y, theta_z, global axes); in the local frame the
membrane block takes (u, v), the bending block (w, beta_x, beta_y) with
beta_x = -theta_y, beta_y = +theta_x.

The facet frames, the local corner coordinates and the mesh generators are
numpy (geometry, computed once on the host, as in the JAX package).  The
element blocks, the load vectors and the resultant recovery are torch
functions in the dtype and on the device of their inputs.  The dense
analyses (statics, modal with an optional membrane prestress, buckling,
Newmark, harmonic) assemble K and M by one float64 scatter on the caller's
device, the card by default, and solve there with the plane and frame
families' helpers; their results are numpy float64, as in the JAX package.
The modal, Newmark and harmonic pencils carry the JAX package's uniform
mass ridge 1e-10 max(diag M) I (the drilling rotation has no mass).

`solve_shell_static_banded` is the large-mesh statics: the float64 facet
blocks (banded drilling eps) scattered once into DIA storage and rounded
once, the Jacobi-PCG of ops/dia.dia_cg_solve with components=6 (on a card
the fused kernels 1-3), the reactions by one matvec (kernel 1), and the
resultants on the host from one fetch.  A structured cylinder panel has 69
diagonals, bandwidth 6 (nx + 2) + 5.

`identify_shell_young` (the dense traced solve) and
`identify_shell_young_banded` (the banded adjoint: kernels 1-3 twice an
ADAM iteration on a card) recover Young's modulus from measured
displacements through solvers/banded_inverse.py, at known thickness.  The
differentiable `shell_static_response` (u, resultants, governing
extreme-fiber von Mises) carries the thickness sizing and the reliability
analyses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..utils.runtime import default_dtype, resolve_device
from .plane import (_GP, _free_index, _general_eigh, _material, _numpy,
                    _q4_point, _t, harmonic_solves)
from .plane import _dmat as _plane_dmat
from .plane import _k_blocks as _membrane_k
from .plane import _m_blocks as _membrane_m
from .plate import (_bend_b, _dmats, _k_blocks_plate, _m_blocks_plate,
                    _shape_grads)

__all__ = [
    "ShellProblem", "ShellStaticResult", "ShellModalResult",
    "ShellBucklingResult", "ShellTransientResult", "ShellHarmonicResult",
    "shell_matrices", "solve_shell_static", "shell_modal",
    "shell_geometric_stiffness", "shell_buckling", "solve_shell_transient",
    "shell_harmonic", "solve_shell_static_banded", "shell_dia_layout",
    "shell_fiber_vm", "cylinder_panel_mesh", "hemisphere_mesh",
    "arch_strip_mesh", "shell_static_response",
]

_DRILL_ALPHA = 1e-3
_DRILL_EPS = 1e-6
# The banded tier's drilling eps: its float32 PCG works on K alone, whose
# near-null drilling subspace sits at alpha G t A eps (the JAX package's
# rationale, models/shell.py:869-877).
_DRILL_EPS_BANDED = 1e-3
# The uniform mass ridge of the dynamic pencils, times max(diag M).
_MASS_RIDGE = 1e-10
_F64 = torch.float64


@dataclass
class ShellProblem:
    """Flat-facet shell: nodes (n, 3) midsurface coordinates, elements (m,
    4) quads (CCW seen from the +normal side), scalars broadcast per
    element; loads (6n,) as [Fx, Fy, Fz, Mx, My, Mz]*n; optional uniform
    normal pressure per element (+ along the facet normal), a global body
    force per unit area, per-node translational point masses, and the
    static thermoelastic load case (alpha_cte with a midsurface
    temperature and / or a top-minus-bottom gradient).  Numpy arrays, as
    the JAX package's problem holds them."""
    nodes: np.ndarray
    elements: np.ndarray
    young: np.ndarray
    poisson: np.ndarray
    thickness: np.ndarray
    density: np.ndarray
    loads: np.ndarray              # (6n,)
    fixed_dofs: np.ndarray
    pressure: Optional[np.ndarray] = None      # (m,) normal q
    body_force: Optional[np.ndarray] = None    # (3,) force / area
    point_masses: Optional[np.ndarray] = None  # (n,) translational
    alpha_cte: Optional[np.ndarray] = None            # (m,) or scalar
    temperature: Optional[np.ndarray] = None          # (m,) mid dT
    temperature_gradient: Optional[np.ndarray] = None  # (m,) dT_g

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=float)
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 3:
            raise ValueError("shell nodes must be (n, 3)")
        self.elements = np.asarray(self.elements, dtype=int)
        if self.elements.ndim != 2 or self.elements.shape[1] != 4:
            raise ValueError("shell elements must be (m, 4) quads")
        m = self.elements.shape[0]
        for name in ("young", "poisson", "thickness", "density"):
            setattr(self, name, np.broadcast_to(
                np.asarray(getattr(self, name), dtype=float), (m,)).copy())
        if np.any(self.thickness <= 0.0) or np.any(self.young <= 0.0):
            raise ValueError("young and thickness must be positive")
        self.loads = np.asarray(self.loads, dtype=float).reshape(-1)
        if self.loads.size != self.ndof:
            raise ValueError(f"loads must have {self.ndof} entries "
                             f"(6 per node), got {self.loads.size}")
        self.fixed_dofs = np.asarray(self.fixed_dofs, dtype=int).reshape(-1)
        if self.pressure is not None:
            self.pressure = np.broadcast_to(
                np.asarray(self.pressure, dtype=float), (m,)).copy()
        if self.body_force is not None:
            self.body_force = np.asarray(self.body_force,
                                         dtype=float).reshape(3)
        if self.point_masses is not None:
            self.point_masses = np.broadcast_to(
                np.asarray(self.point_masses, dtype=float),
                (self.nnode,)).copy()
        if (self.temperature is not None
                or self.temperature_gradient is not None):
            if self.alpha_cte is None:
                raise ValueError("a shell temperature load needs "
                                 "alpha_cte (the expansion "
                                 "coefficient)")
        for name in ("alpha_cte", "temperature", "temperature_gradient"):
            val = getattr(self, name)
            if val is not None:
                setattr(self, name, np.broadcast_to(
                    np.asarray(val, dtype=float), (m,)).copy())

    @property
    def nnode(self) -> int:
        return self.nodes.shape[0]

    @property
    def nelm(self) -> int:
        return self.elements.shape[0]

    @property
    def ndof(self) -> int:
        return 6 * self.nnode

    def free_mask(self) -> np.ndarray:
        m = np.ones(self.ndof)
        m[self.fixed_dofs] = 0.0
        return m

    def free_dofs(self) -> np.ndarray:
        return np.setdiff1d(np.arange(self.ndof), self.fixed_dofs)

    def dof_map(self) -> np.ndarray:
        """(m, 24) global DOF indices per element."""
        return (6 * self.elements[:, :, None]
                + np.arange(6)).reshape(self.nelm, 24)


# --------------------------------------------------------------------
# Facet geometry (numpy, on the host)


def _facet_frames(problem: ShellProblem):
    """(r (m, 3, 3) local triads (rows e_1, e_2, z), coords2d (m, 4, 2)
    in-plane corner coordinates, warp (m,) the largest out-of-plane corner
    offset over the diagonal length)."""
    x = problem.nodes[problem.elements]            # (m, 4, 3)
    d1 = x[:, 2] - x[:, 0]
    d2 = x[:, 3] - x[:, 1]
    zh = np.cross(d1, d2)
    nz = np.linalg.norm(zh, axis=1)
    if np.any(nz <= 0.0):
        raise ValueError("degenerate shell facet (zero normal)")
    zh = zh / nz[:, None]
    e12 = x[:, 1] - x[:, 0]
    e1 = e12 - (np.einsum("mi,mi->m", e12, zh))[:, None] * zh
    n1 = np.linalg.norm(e1, axis=1)
    if np.any(n1 <= 0.0):
        raise ValueError("degenerate shell facet (zero edge)")
    e1 = e1 / n1[:, None]
    e2 = np.cross(zh, e1)
    r = np.stack([e1, e2, zh], axis=1)
    rel = x - x.mean(axis=1)[:, None, :]
    coords2d = np.stack([np.einsum("mai,mi->ma", rel, e1),
                         np.einsum("mai,mi->ma", rel, e2)], axis=-1)
    off = np.abs(np.einsum("mai,mi->ma", rel, zh)).max(axis=1)
    warp = off / np.maximum(np.linalg.norm(d1, axis=1), 1e-300)
    return r, coords2d, warp


def _facet_area(c2: np.ndarray) -> np.ndarray:
    """(m,) quad areas by the shoelace formula on the local coordinates."""
    x, y = c2[..., 0], c2[..., 1]
    return 0.5 * np.abs(np.sum(x * np.roll(y, -1, axis=1)
                               - np.roll(x, -1, axis=1) * y, axis=1))


# Per-node map from local (w, theta_x, theta_y) to the plate module's
# (w, beta_x, beta_y): beta_x = -theta_y, beta_y = +theta_x.
_BETA_OF_THETA = np.array([[1.0, 0.0, 0.0],
                           [0.0, 0.0, -1.0],
                           [0.0, 1.0, 0.0]])
_MEM_IDX = np.array([6 * a + d for a in range(4) for d in (0, 1)])
_BND_IDX = np.array([6 * a + d for a in range(4) for d in (2, 3, 4)])
_DRL_IDX = np.array([6 * a + 5 for a in range(4)])
_Q_BETA = np.kron(np.eye(4), _BETA_OF_THETA)


def _facets(problem: ShellProblem, device):
    """(r, c2, area) of the facets as float64 tensors on `device`."""
    r, c2, _ = _facet_frames(problem)
    return _t(r, device), _t(c2, device), _t(_facet_area(c2), device)


def _transformation(r: torch.Tensor) -> torch.Tensor:
    """(m, 24, 24) local <- global: block-diag(R, ..., R), eight 3 x 3
    blocks a facet."""
    t = torch.zeros((r.shape[0], 24, 24), dtype=r.dtype, device=r.device)
    for off in range(0, 24, 3):
        t[:, off:off + 3, off:off + 3] = r
    return t


def _to_global(t: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mji,mjk,mkl->mil", t, loc, t)


def _embed(m: int, like: torch.Tensor, parts) -> torch.Tensor:
    """(m, 24, 24) zeros of like's dtype and device with each (rows,
    block) of `parts` added on rows x rows."""
    k = torch.zeros((m, 24, 24), dtype=like.dtype, device=like.device)
    for rows, block in parts:
        idx = torch.as_tensor(rows, device=like.device)
        k[:, idx[:, None], idx[None, :]] += block
    return k


def _q_beta(like: torch.Tensor) -> torch.Tensor:
    return _t(_Q_BETA, like.device, like.dtype)


def _shell_blocks(c2, r, young, poisson, thickness, area,
                  drill_eps: float = _DRILL_EPS_BANDED) -> torch.Tensor:
    """(m, 24, 24) GLOBAL stiffness blocks T^T K_loc T from the facets'
    local coordinates, triads, properties and areas (tensors of one dtype
    on one device): the membrane and the conjugated MITC4 blocks, the
    drilling stabilization with `drill_eps`."""
    km = _membrane_k(c2, _plane_dmat(young, poisson, False), thickness, 4)
    q = _q_beta(c2)
    kp = q.T @ _k_blocks_plate(c2, young, poisson, thickness) @ q
    g = young / (2.0 * (1.0 + poisson))
    kd = _DRILL_ALPHA * g * thickness * area
    pen = _t((np.eye(4) - 0.25) + drill_eps * np.eye(4), c2.device,
             c2.dtype)
    k = _embed(c2.shape[0], c2, ((_MEM_IDX, km), (_BND_IDX, kp),
                                 (_DRL_IDX, kd[:, None, None] * pen)))
    return _to_global(_transformation(r), k)


def _stiffness_blocks(problem: ShellProblem, device,
                      drill_eps: float = _DRILL_EPS) -> torch.Tensor:
    """(m, 24, 24) float64 global stiffness blocks on `device`."""
    r, c2, area = _facets(problem, device)
    return _shell_blocks(c2, r, *_material(problem, device, "young",
                                           "poisson", "thickness"),
                         area, drill_eps)


def _mass_blocks(problem: ShellProblem, device) -> torch.Tensor:
    """(m, 24, 24) float64 global consistent mass blocks on `device` (the
    membrane mass and the conjugated plate mass with rotary inertia; none
    on the drilling DOFs)."""
    r, c2, _ = _facets(problem, device)
    rho, thick = _material(problem, device, "density", "thickness")
    q = _q_beta(c2)
    mm = _membrane_m(c2, rho, thick, 4)
    mp = q.T @ _m_blocks_plate(c2, rho, thick) @ q
    return _to_global(_transformation(r),
                      _embed(problem.nelm, c2, ((_MEM_IDX, mm),
                                                (_BND_IDX, mp))))


def _dof_map(problem: ShellProblem, device) -> torch.Tensor:
    return torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                           device=device)


def _corner_weights(c2: torch.Tensor) -> torch.Tensor:
    """(m, 4) int N_a dA over each facet (2 x 2 Gauss)."""
    fe = torch.zeros((c2.shape[0], 4), dtype=c2.dtype, device=c2.device)
    for xi, eta in _GP:
        n, _, _, det = _shape_grads(c2, xi, eta)
        fe += det[:, None] * _t(n, c2.device, c2.dtype)[None, :]
    return fe


def _load_vectors(problem: ShellProblem, device=None) -> torch.Tensor:
    """(6n,) consistent nodal loads of the normal pressure and the global
    body force per unit area (bilinear tributary, 2 x 2 Gauss), float64 on
    `device` (CPU when None)."""
    f = torch.zeros(problem.ndof, dtype=_F64, device=device)
    if problem.pressure is None and problem.body_force is None:
        return f
    r, c2, _ = _facets(problem, device)
    fe = _corner_weights(c2)
    enodes = torch.as_tensor(problem.elements, dtype=torch.int64,
                             device=device)
    if problem.pressure is not None:
        fz = _t(problem.pressure, device)[:, None] * fe
        for d in range(3):
            f = f + scatter_add(problem.ndof, 6 * enodes + d,
                                fz * r[:, 2, d][:, None])
    if problem.body_force is not None:
        for d in range(3):
            f = f + scatter_add(problem.ndof, 6 * enodes + d,
                                float(problem.body_force[d]) * fe)
    return f


def _thermal_fields(problem: ShellProblem, device=None):
    """(eps_th (m, 3) or None, kappa_th (m, 3) or None): a uniform
    midsurface dT stretches the membrane (eps_th = alpha dT [1, 1, 0]), a
    top-minus-bottom dT_g bends it (kappa_th = alpha dT_g / t [1, 1, 0])."""
    eps_th = kap_th = None
    if problem.temperature is not None:
        a = _t(problem.alpha_cte * problem.temperature, device)
        eps_th = torch.stack([a, a, torch.zeros_like(a)], dim=-1)
    if problem.temperature_gradient is not None:
        k = _t(problem.alpha_cte * problem.temperature_gradient
               / problem.thickness, device)
        kap_th = torch.stack([k, k, torch.zeros_like(k)], dim=-1)
    return eps_th, kap_th


def _thermal_load_vectors(problem: ShellProblem,
                          device=None) -> torch.Tensor:
    """(6n,) consistent thermal nodal loads, assembled per facet in the
    local frame (membrane int B^T D eps_th t dA on (u, v), bending int
    B_b^T D_b kappa_th dA conjugated to (w, theta_x, theta_y)) and rotated
    T^T to global, float64 on `device` (CPU when None)."""
    eps_th, kap_th = _thermal_fields(problem, device)
    if eps_th is None and kap_th is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    r, c2, _ = _facets(problem, device)
    young, nu, thick = _material(problem, device, "young", "poisson",
                                 "thickness")
    fe_loc = torch.zeros((problem.nelm, 24), dtype=_F64, device=device)
    if eps_th is not None:
        s_th = torch.einsum("mij,mj->mi", _plane_dmat(young, nu, False),
                            eps_th)
        fe_mem = torch.zeros((problem.nelm, 8), dtype=_F64, device=device)
        for xi, eta in _GP:
            b, det = _q4_point(c2, xi, eta)
            fe_mem += (thick * det)[:, None] * torch.einsum(
                "mia,mi->ma", b, s_th)
        fe_loc[:, _MEM_IDX] += fe_mem
    if kap_th is not None:
        db, _ = _dmats(young, nu, thick)
        m_th = torch.einsum("mij,mj->mi", db, kap_th)
        fe_bnd = torch.zeros((problem.nelm, 12), dtype=_F64, device=device)
        for xi, eta in _GP:
            _, dx, dy, det = _shape_grads(c2, xi, eta)
            fe_bnd += det[:, None] * torch.einsum("mia,mi->ma",
                                                  _bend_b(dx, dy), m_th)
        fe_loc[:, _BND_IDX] += fe_bnd @ _q_beta(c2)
    fg = torch.einsum("mji,mj->mi", _transformation(r), fe_loc)
    return scatter_add(problem.ndof, _dof_map(problem, device), fg)


def _require_no_thermal(problem: ShellProblem, kind: str):
    """The dynamic paths refuse a temperature load: it is a static case."""
    if problem.temperature is not None \
            or problem.temperature_gradient is not None:
        raise ValueError(
            f"shell {kind} does not take a temperature load case — "
            "thermoelastic loads are static; use analysis type "
            '"static" (or "buckling", which inherits ΔT membrane '
            "forces through the static state)")


def _static_loads(problem: ShellProblem, device) -> torch.Tensor:
    """(6n,) nodal + pressure / body-force + thermal loads, float64."""
    return (_t(problem.loads, device) + _load_vectors(problem, device)
            + _thermal_load_vectors(problem, device))


def _assemble(problem: ShellProblem, blocks: torch.Tensor) -> torch.Tensor:
    """(m, 24, 24) blocks -> dense (ndof, ndof), one float64 scatter on
    the blocks' device."""
    n = problem.ndof
    dm = _dof_map(problem, blocks.device)
    return scatter_add(n * n, dm[:, :, None] * n + dm[:, None, :],
                       blocks).reshape(n, n)


def _matrices(problem: ShellProblem, with_mass: bool, device):
    k = _assemble(problem, _stiffness_blocks(problem, device))
    mmat = None
    if with_mass:
        mmat = _assemble(problem, _mass_blocks(problem, device))
        if problem.point_masses is not None:
            pm = torch.zeros(problem.ndof, dtype=_F64, device=device)
            pmn = _t(problem.point_masses, device)
            for d in range(3):
                pm[d::6] += pmn
            mmat = mmat + torch.diag(pm)
    return k, mmat


def shell_matrices(problem: ShellProblem, with_mass: bool = True,
                   device=None):
    """(K, M) dense global float64 tensors on `device` ("cuda" when None);
    M is None unless with_mass.  The one assembly every dense shell
    analysis shares."""
    return _matrices(problem, with_mass, resolve_device(device))


def _ridged(m: torch.Tensor) -> torch.Tensor:
    """M + 1e-10 max(diag M) I: the drilling direction carries no mass, and
    on a curved midsurface it mixes into every global rotation."""
    return m + _MASS_RIDGE * torch.diagonal(m).max() * torch.eye(
        m.shape[0], dtype=m.dtype, device=m.device)


# --------------------------------------------------------------------
# Statics and resultant recovery


@dataclass
class ShellStaticResult:
    displacements: np.ndarray      # (6n,)
    # (m, 3) centroid membrane forces [Nxx, Nyy, Nxy] (force / length,
    # local facet axes) and (m, 3) bending moments [Mxx, Myy, Mxy].
    membrane_forces: np.ndarray
    moments: np.ndarray
    reactions: np.ndarray          # (6n,)


def shell_fiber_vm(nf, mom, thickness):
    """Governing extreme-fiber von Mises of membrane-force + moment
    resultants (numpy): sigma+- = N/t +- 6M/t^2 (Voigt [xx, yy, xy], local
    facet axes), plane-stress von Mises at both fibers, elementwise max."""
    t = thickness[:, None]
    sm = nf / t
    sb = 6.0 * mom / t ** 2

    def _vm(s):
        return np.sqrt(s[:, 0] ** 2 - s[:, 0] * s[:, 1] + s[:, 1] ** 2
                       + 3.0 * s[:, 2] ** 2)

    return np.maximum(_vm(sm + sb), _vm(sm - sb))


def _resultants(problem: ShellProblem, u: torch.Tensor):
    """Centroid membrane forces and bending moments (local axes, tensors)
    of a float64 u, on u's device, less the thermal case's free strain and
    curvature."""
    device = u.device
    r, c2, _ = _facets(problem, device)
    young, nu, thick = _material(problem, device, "young", "poisson",
                                 "thickness")
    u_loc = torch.einsum("mij,mj->mi", _transformation(r),
                         u[_dof_map(problem, device)])
    bmem, _ = _q4_point(c2, 0.0, 0.0)
    eps = torch.einsum("mia,ma->mi", bmem, u_loc[:, _MEM_IDX])
    eps_th, kap_th = _thermal_fields(problem, device)
    if eps_th is not None:
        eps = eps - eps_th
    nf = thick[:, None] * torch.einsum("mij,mj->mi",
                                       _plane_dmat(young, nu, False), eps)
    u_plate = u_loc[:, _BND_IDX] @ _q_beta(c2).T
    _, dx, dy, _ = _shape_grads(c2, 0.0, 0.0)
    kap = torch.einsum("mia,ma->mi", _bend_b(dx, dy), u_plate)
    if kap_th is not None:
        kap = kap - kap_th
    d0 = young * thick ** 3 / (12.0 * (1.0 - nu * nu))
    mom = torch.stack([d0 * (kap[:, 0] + nu * kap[:, 1]),
                       d0 * (kap[:, 1] + nu * kap[:, 0]),
                       d0 * (1.0 - nu) / 2.0 * kap[:, 2]], dim=-1)
    return nf, mom


def _recover_shell(problem: ShellProblem, u):
    """(membrane forces (m, 3), moments (m, 3)) numpy at the centroids, the
    thermal case's free strain and curvature subtracted.  A tensor u is
    worked on its device, an array on the CPU."""
    u = _t(u, u.device if isinstance(u, torch.Tensor) else None)
    return tuple(_numpy(x) for x in _resultants(problem, u))


def _static_result(problem: ShellProblem, u: torch.Tensor,
                   reactions: torch.Tensor) -> ShellStaticResult:
    nf, mom = _resultants(problem, u)
    return ShellStaticResult(displacements=_numpy(u),
                             membrane_forces=_numpy(nf),
                             moments=_numpy(mom),
                             reactions=_numpy(reactions))


def solve_shell_static(problem: ShellProblem,
                       device=None) -> ShellStaticResult:
    """Dense masked static solve and centroid membrane-force / moment
    recovery in the local facet axes, float64 on `device` ("cuda" when
    None)."""
    dev = resolve_device(device)
    k, _ = _matrices(problem, False, dev)
    mask = _t(problem.free_mask(), dev)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    f = _static_loads(problem, dev)
    u = torch.linalg.solve(km, f * mask) * mask
    return _static_result(problem, u, (k @ u - f) * (1.0 - mask))


# --------------------------------------------------------------------
# Modal, geometric stiffness, buckling


@dataclass
class ShellModalResult:
    frequencies_hz: np.ndarray
    omegas: np.ndarray
    eigenvalues: np.ndarray
    mode_shapes: np.ndarray        # (n_modes, 6n)


def _low_modes(k: torch.Tensor, m: torch.Tensor):
    """All eigenpairs of K phi = lambda M phi, ascending lambda, phi
    M-orthonormal.  The ridged shell mass has a condition number near
    1e10, so the congruence through M's Cholesky factor (LAPACK's sygv,
    the JAX package's scipy.linalg.eigh(k, m)) leaves the low eigenvalues
    about 1e-7 to 1e-6 off; an SPD K takes the reciprocal pencil M phi = mu
    K phi through K's Cholesky factor instead, where the low modes are the
    largest mu and come out to rounding.  An indefinite K (a compressive
    prestress past buckling) takes the congruence through M."""
    lo, info = torch.linalg.cholesky_ex(k)
    if int(info) != 0:
        return _general_eigh(k, m)
    c = torch.linalg.solve_triangular(lo, m, upper=False)
    c = torch.linalg.solve_triangular(lo, c.T, upper=False).T
    mu, y = torch.linalg.eigh(0.5 * (c + c.T))
    mu, y = mu.flip(0), y.flip(1)
    phi = torch.linalg.solve_triangular(lo.T, y, upper=True)
    phi = phi / torch.sqrt(torch.einsum("ij,ij->j", phi, m @ phi))
    return 1.0 / mu, phi


def shell_modal(problem: ShellProblem, n_modes: int = 6,
                membrane_force=None, device=None) -> ShellModalResult:
    """Generalized K phi = lambda M phi on the free block (consistent mass,
    rotary inertia from the plate block, the uniform mass ridge), dense
    float64 on `device` ("cuda" when None), by `_low_modes`.  A membrane
    force state [N11, N22, N12] (local axes, per element or broadcast)
    adds its geometric stiffness K_g(N)."""
    dev = resolve_device(device)
    k, m = _matrices(problem, True, dev)
    if membrane_force is not None:
        k = k + _geometric(problem, membrane_force, dev)
    m = _ridged(m)
    free = _free_index(problem, dev)
    lam, vec = _low_modes(k[free][:, free], m[free][:, free])
    n_modes = min(n_modes, lam.numel())
    lam = torch.clamp_min(lam[:n_modes], 0.0)
    shapes = torch.zeros((n_modes, problem.ndof), dtype=_F64, device=dev)
    shapes[:, free] = vec[:, :n_modes].T
    lam = _numpy(lam)
    om = np.sqrt(lam)
    return ShellModalResult(frequencies_hz=om / (2.0 * np.pi), omegas=om,
                            eigenvalues=lam, mode_shapes=_numpy(shapes))


def _membrane_force_array(problem: ShellProblem, membrane_force):
    nf = np.asarray(membrane_force, dtype=float)
    if nf.ndim <= 1:
        nf = np.broadcast_to(nf.reshape(-1), (3,))
        nf = np.broadcast_to(nf, (problem.nelm, 3))
    if nf.shape != (problem.nelm, 3):
        raise ValueError("membrane_force must be [N11, N22, N12] or "
                         f"(nelm, 3); got shape {nf.shape}")
    return nf


def _geometric(problem: ShellProblem, membrane_force,
               device) -> torch.Tensor:
    """Dense float64 K_g = sum int sum_k (grad u_k)^T N (grad u_k) dA over
    the three local displacement components, 2 x 2 Gauss, T^T K_g T."""
    nf = _t(_membrane_force_array(problem, membrane_force), device)
    nmat = torch.stack([torch.stack([nf[:, 0], nf[:, 2]], dim=-1),
                        torch.stack([nf[:, 2], nf[:, 1]], dim=-1)], dim=-2)
    r, c2, _ = _facets(problem, device)
    blk = None
    for xi, eta in _GP:
        _, dx, dy, det = _shape_grads(c2, xi, eta)
        g = torch.stack([dx, dy], dim=1)                    # (m, 2, 4)
        b = det[:, None, None] * torch.einsum("mia,mij,mjb->mab", g, nmat,
                                              g)
        blk = b if blk is None else blk + b
    kg_loc = _embed(problem.nelm, c2, [(6 * np.arange(4) + k, blk)
                                       for k in range(3)])
    return _assemble(problem, _to_global(_transformation(r), kg_loc))


def shell_geometric_stiffness(problem: ShellProblem, membrane_force,
                              device=None) -> torch.Tensor:
    """Dense geometric stiffness of a membrane force state on the faceted
    midsurface (all three local displacement components, so the form is
    objective on curved meshes), float64 on `device` ("cuda" when None)."""
    return _geometric(problem, membrane_force, resolve_device(device))


@dataclass
class ShellBucklingResult:
    load_factors: np.ndarray       # (n_modes,) ascending positive lambda
    modes: np.ndarray              # (n_modes, 6n)
    membrane_forces: np.ndarray    # (m, 3) the N state that was scaled


def shell_buckling(problem: ShellProblem, membrane_force=None,
                   n_modes: int = 4, device=None) -> ShellBucklingResult:
    """Linearized shell buckling (K + lambda K_g(N)) phi = 0 on the free
    block, float64 on `device` ("cuda" when None).  N is the problem's own
    static membrane state when membrane_force is None (lambda scales the
    applied loads), else the given [N11, N22, N12] / (nelm, 3).  The
    symmetric pencil -K_g phi = mu K phi through K_ff's Cholesky factor,
    lambda = 1/mu for the positive mu above 1e-12 of the largest |mu|,
    largest mu first."""
    dev = resolve_device(device)
    if membrane_force is None:
        membrane_force = solve_shell_static(problem,
                                            device=dev).membrane_forces
    nf = np.asarray(membrane_force, dtype=float)
    kg = _geometric(problem, nf, dev)
    k, _ = _matrices(problem, False, dev)
    free = _free_index(problem, dev)
    mu, vec = _general_eigh(-kg[free][:, free], k[free][:, free])
    mu_h = _numpy(mu)
    pos = np.flatnonzero(mu_h > 1e-12 * np.abs(mu_h).max())
    if pos.size == 0:
        raise ValueError("the membrane force state destabilizes no "
                         "mode (all-tension N?) — shell buckling "
                         "needs a compressive component")
    order = pos[np.argsort(mu_h[pos])[::-1]][:n_modes]
    modes = torch.zeros((order.size, problem.ndof), dtype=_F64, device=dev)
    modes[:, free] = vec[:, torch.as_tensor(order, device=dev)].T
    if nf.ndim <= 1:
        nf = np.broadcast_to(np.reshape(nf, -1), (3,))
        nf = np.broadcast_to(nf, (problem.nelm, 3))
    return ShellBucklingResult(load_factors=1.0 / mu_h[order],
                               modes=_numpy(modes),
                               membrane_forces=np.array(nf))


# --------------------------------------------------------------------
# Curved-geometry mesh generators (numpy, the JAX package's numbering)


def cylinder_panel_mesh(radius: float, length: float,
                        half_angle_deg: float, nx: int, ny: int):
    """(nodes (n, 3), elements (m, 4)) faceted cylindrical panel: axis
    along y, arc +-half_angle about the crown (x = 0, z = R), y in [0,
    length].  Arc-fastest numbering."""
    phi = np.deg2rad(half_angle_deg)
    arcs = np.linspace(-phi, phi, nx + 1)
    ys = np.linspace(0.0, length, ny + 1)
    nodes = np.array([[radius * np.sin(a), y, radius * np.cos(a)]
                      for y in ys for a in arcs])
    na = nx + 1
    elems = [[j * na + i, j * na + i + 1, j * na + i + 1 + na, j * na + i + na]
             for j in range(ny) for i in range(nx)]
    return nodes, np.asarray(elems, dtype=int).reshape(-1, 4)


def arch_strip_mesh(length: float, width: float, rise: float, nx: int):
    """(nodes (n, 3), elements (m, 4)) half-sine shallow arch strip:
    elevation z = rise sin(pi x / length) over x in [0, length], two node
    rows at y = 0 and y = width (nx quads), x-fastest numbering."""
    xs = np.linspace(0.0, length, nx + 1)
    nodes = np.array([[x, y, rise * np.sin(np.pi * x / length)]
                      for y in (0.0, width) for x in xs])
    elems = np.array([[i, i + 1, i + 1 + (nx + 1), i + (nx + 1)]
                      for i in range(nx)], dtype=int)
    return nodes, elems


def hemisphere_mesh(radius: float, hole_deg: float, n: int):
    """(nodes, elements) one quarter of a hemisphere with a polar hole:
    longitude 0..90 deg, colatitude hole_deg..90 deg, n x n quads,
    longitude-fastest numbering."""
    lons = np.deg2rad(np.linspace(0.0, 90.0, n + 1))
    lats = np.deg2rad(np.linspace(hole_deg, 90.0, n + 1))
    nodes = np.array([[radius * np.sin(t) * np.cos(p),
                       radius * np.sin(t) * np.sin(p),
                       radius * np.cos(t)]
                      for t in lats for p in lons])
    npl = n + 1
    elems = [[j * npl + i, j * npl + i + 1, j * npl + i + 1 + npl,
              j * npl + i + npl] for j in range(n) for i in range(n)]
    return nodes, np.asarray(elems, dtype=int).reshape(-1, 4)


# --------------------------------------------------------------------
# Newmark and harmonic


@dataclass
class ShellTransientResult:
    times: np.ndarray
    displacements: np.ndarray      # (n_rec, n_probe)
    dt: float
    n_steps: int


def _free_block(problem: ShellProblem, damping, device):
    """(K_ff, M_ff, C_ff, f_ff, free) of the dynamic analyses, float64 on
    `device`: M ridged, Rayleigh C = alpha M + beta K, f the nodal +
    pressure / body-force loads."""
    from .frame import _free_block as free_block

    k, m = _matrices(problem, True, device)
    f0 = _t(problem.loads, device) + _load_vectors(problem, device)
    return free_block(k, _ridged(m), f0, problem, damping)


def solve_shell_transient(problem: ShellProblem, dt: float, n_steps: int,
                          damping=(0.0, 0.0), amplitude=None,
                          probe_dofs=None, record_every: int = 1,
                          device=None) -> ShellTransientResult:
    """Newmark (average acceleration) on the dense shell K / ridged M,
    float64 on `device` ("cuda" when None), one LU for every step
    (models/frame.newmark_frame: records after steps 0, r, 2r, ...)."""
    from .frame import newmark_frame

    _require_no_thermal(problem, "transient")
    if dt <= 0.0 or n_steps <= 0:
        raise ValueError("transient needs positive dt and n_steps")
    dev = resolve_device(device)
    times, rec_u = newmark_frame(*_free_block(problem, damping, dev),
                                 problem.ndof, dt, n_steps, amplitude,
                                 probe_dofs, record_every)
    return ShellTransientResult(times=times, displacements=rec_u,
                                dt=float(dt), n_steps=int(n_steps))


@dataclass
class ShellHarmonicResult:
    omegas: np.ndarray
    amplitude: np.ndarray          # (n_freq, n_probe) |X|
    real: np.ndarray
    imag: np.ndarray


def shell_harmonic(problem: ShellProblem, omegas, damping=(0.0, 0.0),
                   probe_dofs=None, device=None) -> ShellHarmonicResult:
    """Steady-state X(omega): (K - omega^2 M + i omega C) X = f on the free
    block, Rayleigh C = alpha M + beta K on the ridged M, complex128 on
    `device` ("cuda" when None) (models/plane.harmonic_solves)."""
    _require_no_thermal(problem, "harmonic")
    om = np.asarray(omegas, dtype=float).reshape(-1)
    dev = resolve_device(device)
    xs = harmonic_solves(*_free_block(problem, damping, dev), problem.ndof,
                         om, probe_dofs)
    return ShellHarmonicResult(omegas=om, amplitude=np.abs(xs),
                               real=xs.real, imag=xs.imag)


# --------------------------------------------------------------------
# Banded large-mesh statics


def shell_dia_layout(problem: ShellProblem):
    """The problem's DIA layout (ops/dia.dia_layout of its DOF map, up to
    224 diagonals: a structured quad midsurface has up to 9 node-neighbour
    classes x 11 block diagonals), built on the host once and kept on the
    instance."""
    from ..ops.dia import dia_layout

    layout = getattr(problem, "_dia_layout_cache", None)
    if layout is None:
        layout = dia_layout(problem.dof_map(), problem.ndof, max_diags=224)
        problem._dia_layout_cache = layout
    return layout


def _banded_operator(problem: ShellProblem, dtype, dev):
    """(layout, diagonals in dtype, mask) on `dev`: the float64 facet
    blocks with the banded drilling eps, one float64 scatter into DIA
    storage, rounded once."""
    from ..ops.dia import assemble_dia_blocks

    layout = shell_dia_layout(problem)
    diags = assemble_dia_blocks(layout, _stiffness_blocks(
        problem, dev, _DRILL_EPS_BANDED)).to(dtype).contiguous()
    return layout, diags, _t(problem.free_mask(), dev, dtype)


def solve_shell_static_banded(problem: ShellProblem, tol: float = 1e-7,
                              max_iter: int = 40000,
                              use_pallas: bool = False,
                              precond: str = "auto", dtype=None,
                              mesh=None, device=None):
    """Large-mesh shell statics on `device` ("cuda" when None) in `dtype`
    (the working dtype when None): the float64 facet blocks (drilling eps
    1e-3) scattered once into DIA storage, the Jacobi-PCG of
    ops/dia.dia_cg_solve with components=6 ("auto" is Jacobi: on a card
    the fused kernels 1-3), the reactions by one matvec.  use_pallas is the
    JAX package's switch for its TPU kernels and has no effect: a CUDA
    tensor always runs the repo's kernels.  mesh= (a device mesh) is
    ROADMAP item 15's multi-device row and raises.

    Returns (ShellStaticResult, iterations, relative recurrence residual);
    the resultants are recovered on the host from one fetch of u and the
    reactions."""
    from ..parallel import refuse_mesh
    from .frame import banded_static

    del use_pallas
    refuse_mesh(mesh, "the banded shell solve")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    f = _static_loads(problem, dev).to(dtype)
    u, reac, iters, rel = banded_static(layout, diags, mask, f, tol,
                                        max_iter, precond, 6)
    return _static_result(problem, u, reac), iters, rel


# --------------------------------------------------------------------
# Identification (solvers/banded_inverse.py carries the ADAM loops)


def _young_blocks_of(problem: ShellProblem, device):
    """young_e (m,) -> (m, 24, 24) float64 global facet blocks T'KT on
    `device` (the banded drilling eps, as both JAX identification tiers
    take it), differentiable in young_e."""
    r, c2, area = _facets(problem, device)
    nu, thick = _material(problem, device, "poisson", "thickness")
    return lambda young_e: _shell_blocks(c2, r, young_e.to(_F64), nu, thick,
                                         area, _DRILL_EPS_BANDED)


def _identification_inputs(problem: ShellProblem):
    """(centroids (m, 3), loads (6n,)) of the identification tiers: nodal
    plus pressure / body-force loads, no thermal case (the JAX package's
    shell_static_response)."""
    return (problem.nodes[problem.elements].mean(axis=1),
            problem.loads + _load_vectors(problem).numpy())


def identify_shell_young(problem: ShellProblem, measured_dofs,
                         measured_disp, n_iter: int = 800,
                         learning_rate: float = 0.05, field: bool = False,
                         seed: int = 0, hidden_layers: int = 2,
                         neurons_per_layer: int = 16, device=None):
    """Recover Young's modulus from measured shell displacements on the
    dense traced solve: per-facet log-E ADAM, or field=True a smooth
    E(x, y, z) MLP (input_dim 3) at the facet centroids.  Shell data sees
    E t and E t^3, so E is identified at known thickness.  device: where
    to solve ("cuda" when None).  Returns (young (m,), loss_history,
    field|None)."""
    from ..solvers.banded_inverse import identify_young_dense

    dev = resolve_device(device)
    centroids, f = _identification_inputs(problem)
    return identify_young_dense(
        _young_blocks_of(problem, dev), problem.dof_map(), problem.young,
        centroids, f, problem.free_mask(), measured_dofs, measured_disp,
        n_iter=n_iter, learning_rate=learning_rate, field=field, seed=seed,
        hidden_layers=hidden_layers, neurons_per_layer=neurons_per_layer,
        input_dim=3, device=dev)


def identify_shell_young_banded(problem: ShellProblem, measured_dofs,
                                measured_disp, n_iter: int = 300,
                                learning_rate: float = 0.05,
                                tol: float = 1e-7, max_iter: int = 20000,
                                zones=None, field: bool = False,
                                seed: int = 0, hidden_layers: int = 2,
                                neurons_per_layer: int = 16, device=None):
    """identify_shell_young past DENSE_DOF_LIMIT: the Jacobi-scaled banded
    PCG forward and one adjoint PCG a step
    (solvers/banded_inverse.identify_young_banded; only the (m, 24, 24)
    facet blocks are shell-specific).  zones=[[ids..], ..] gives one log-E
    per zone.  A thermal load case is refused, as in the JAX package.
    device: where to solve ("cuda" when None)."""
    from ..solvers.banded_inverse import identify_young_banded

    _require_no_thermal(problem, "banded identification")
    dev = resolve_device(device)
    centroids, f = _identification_inputs(problem)
    return identify_young_banded(
        shell_dia_layout(problem), _young_blocks_of(problem, dev),
        problem.young, centroids, f, problem.free_mask(), measured_dofs,
        measured_disp, n_iter=n_iter, learning_rate=learning_rate, tol=tol,
        max_iter=max_iter, zones=zones, field=field, seed=seed,
        hidden_layers=hidden_layers, neurons_per_layer=neurons_per_layer,
        input_dim=3, device=dev)


def _fiber_vm(nf: torch.Tensor, mom: torch.Tensor,
              thickness: torch.Tensor) -> torch.Tensor:
    """`shell_fiber_vm` on tensors, differentiable."""
    t = thickness[:, None]
    sm = nf / t
    sb = 6.0 * mom / t ** 2

    def _vm(s):
        return torch.sqrt(s[:, 0] ** 2 - s[:, 0] * s[:, 1] + s[:, 1] ** 2
                          + 3.0 * s[:, 2] ** 2)

    return torch.maximum(_vm(sm + sb), _vm(sm - sb))


def shell_static_response(problem: ShellProblem, young_e=None,
                          thickness_e=None, load_scale=None, dtype=None,
                          drill_eps: float = _DRILL_EPS_BANDED,
                          device=None):
    """Differentiable shell statics with per-element properties (the JAX
    package's traced twin): (u, resultants (m, 6) [Nxx, Nyy, Nxy, Mxx,
    Myy, Mxy] in local facet axes, governing extreme-fiber von Mises (m,)
    of N / t +- 6M / t^2) from the masked dense solve K(E, t) u = f
    (float64 facet blocks with the banded drilling eps, one float64
    scatter rounded once to `dtype`) and the centroid recovery in `dtype`.
    Thermoelastic documents are refused, as in the JAX package.  device:
    "cuda" when None."""
    from ..solvers.banded_inverse import dense_masked_solve

    if problem.temperature is not None \
            or problem.temperature_gradient is not None:
        raise ValueError("the traced shell twin does not carry the "
                         "thermoelastic load case — drop temperature/"
                         "temperature_gradient for reliability or "
                         "sizing blocks")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    m = problem.nelm

    def prop(v, name):
        return torch.broadcast_to(_t(getattr(problem, name) if v is None
                                     else v, dev), (m,))

    young, nu, thick = (prop(young_e, "young"), prop(None, "poisson"),
                        prop(thickness_e, "thickness"))
    r, c2, area = _facets(problem, dev)
    blocks = _shell_blocks(c2, r, young, nu, thick, area, drill_eps)
    dm = _dof_map(problem, dev)
    f = (_t(problem.loads, dev) + _load_vectors(problem, dev)).to(dtype)
    if load_scale is not None:
        f = f * _t(load_scale, dev, dtype)
    mask = _t(problem.free_mask(), dev, dtype)
    u = dense_masked_solve(blocks, dm, problem.ndof, f, mask)
    r, c2 = r.to(dtype), c2.to(dtype)
    young, nu, thick = young.to(dtype), nu.to(dtype), thick.to(dtype)
    u_loc = torch.einsum("mij,mj->mi", _transformation(r), u[dm])
    bmem, _ = _q4_point(c2, 0.0, 0.0)
    eps = torch.einsum("mia,ma->mi", bmem, u_loc[:, _MEM_IDX])
    nf = thick[:, None] * torch.einsum("mij,mj->mi",
                                       _plane_dmat(young, nu, False), eps)
    u_plate = u_loc[:, _BND_IDX] @ _q_beta(c2).T
    _, dx, dy, _ = _shape_grads(c2, 0.0, 0.0)
    kap = torch.einsum("mia,ma->mi", _bend_b(dx, dy), u_plate)
    d0 = young * thick ** 3 / (12.0 * (1.0 - nu ** 2))
    mom = torch.stack([d0 * (kap[:, 0] + nu * kap[:, 1]),
                       d0 * (kap[:, 1] + nu * kap[:, 0]),
                       d0 * (1.0 - nu) / 2.0 * kap[:, 2]], dim=-1)
    return u, torch.cat([nf, mom], dim=-1), _fiber_vm(nf, mom, thick)
