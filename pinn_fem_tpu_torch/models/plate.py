"""Reissner-Mindlin plate bending (counterpart of
pinn_fem_tpu/models/plate.py).

Element: the 4-node MITC4 (Bathe-Dvorkin) Mindlin quadrilateral, three
DOFs a node (w, beta_x, beta_y; u = -z beta_x, v = -z beta_y):

    curvature  kappa = [bx,x; by,y; bx,y + by,x]     2 x 2 Gauss
    shear      gamma = [w,x - bx; w,y - by]          2 x 2 Gauss on the
               ASSUMED covariant field sampled at the edge midpoints
               (gamma_xi at (0, +-1), gamma_eta at (+-1, 0)), rotated
               with J^-1: locking-free with no soft zigzag w-modes
    D_b = E t^3 / 12(1 - nu^2) [[1, nu, 0], [nu, 1, 0], [0, 0, (1-nu)/2]]
    D_s = kappa_s G t I,  kappa_s = 5/6
    mass       rho t on w, rho t^3 / 12 rotary inertia on the rotations
               (consistent, 2 x 2 Gauss)

The element library (`_shape_grads`, `_bend_b`, `_shear_b`,
`_cov_shear_row`, `_mitc_rows`, `_shear_b_mitc`, `_dmats`,
`_k_blocks_plate`, `_m_blocks_plate`) is plain functions on tensors,
batched over elements, in the dtype and on the device of their inputs.
The dense analyses (statics up to DENSE_DOF_LIMIT DOFs, modal with a
membrane prestress, buckling, Newmark, harmonic) assemble K and M by one
float64 scatter on the caller's device, the card by default, and solve
there with the plane family's helpers (models/plane.py: the Cholesky
congruence eigh, one LU for Newmark, the complex128 sweep); their results
are numpy float64, as in the JAX package.

`solve_plate_static_banded` is the large-mesh statics: the float64 MITC4
blocks scattered once into DIA storage and rounded once, the Jacobi-PCG of
ops/dia.dia_cg_solve with components=3 (on a card the fused kernels 1-3;
Jacobi is load-bearing, the w and rotation DOFs differ in scale by
(a/t)^2), the reactions by one matvec (kernel 1), and the moments on the
host from one fetch.  A structured n x n grid under row-major numbering
has 33 diagonals, bandwidth 3 nx + 8.

The closed forms `mindlin_navier_w` and `mindlin_ss_buckling_nx`, the
supports helper and the mesh generator (models/plane.rect_mesh) are numpy.
`identify_plate_young` (the dense traced solve) and
`identify_plate_young_banded` (the banded adjoint: kernels 1-3 twice an
ADAM iteration on a card) recover Young's modulus from measured
deflections through solvers/banded_inverse.py.  The differentiable
`plate_static_response` (u, moments, extreme-fiber von Mises) carries the
thickness sizing and the reliability analyses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..utils.runtime import default_dtype, resolve_device
from .plane import (_GP, _free_index, _general_eigh, _numpy, _q4_detj,
                    _q4_dn, _q4_n, _t, harmonic_solves, newmark_records)
from .plane import rect_mesh  # noqa: F401  (the plate io's mesh generator)

_SHEAR_K = 5.0 / 6.0
_F64 = torch.float64


@dataclass
class PlateProblem:
    """Mindlin plate: nodes (n, 2) midsurface coordinates; elements (m, 4)
    Q4 (counterclockwise); per-element material (scalars broadcast); nodal
    loads (3n,) as [Fz, Mx, My]*n on the numbering w_i = 3i, bx_i = 3i+1,
    by_i = 3i+2; optional uniform transverse pressure (force / area,
    consistent nodal loads), per-node point masses, and a through-thickness
    thermal gradient (temperature = the top-minus-bottom difference dT,
    kappa_th = alpha dT / t).  Numpy arrays, as the JAX package's problem
    holds them."""
    nodes: np.ndarray
    elements: np.ndarray
    young: np.ndarray            # (m,) or scalar
    poisson: np.ndarray
    thickness: np.ndarray
    density: np.ndarray
    loads: np.ndarray            # (3n,)
    fixed_dofs: np.ndarray
    pressure: Optional[np.ndarray] = None       # (m,) or scalar q
    point_masses: Optional[np.ndarray] = None   # (n,)
    alpha_cte: Optional[np.ndarray] = None      # (m,) or scalar alpha
    temperature: Optional[np.ndarray] = None    # (m,) or scalar dT

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=float)
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 2:
            raise ValueError("plate nodes must be (n, 2)")
        self.elements = np.asarray(self.elements, dtype=int)
        if self.elements.ndim != 2 or self.elements.shape[1] != 4:
            raise ValueError("plate elements must be (m, 4) Q4 — the "
                             "MITC4 Mindlin element is quadrilateral")
        n, m = self.nodes.shape[0], self.elements.shape[0]
        if self.elements.min(initial=0) < 0 \
                or self.elements.max(initial=-1) >= n:
            raise ValueError("element connectivity out of node range")
        for name in ("young", "poisson", "thickness", "density"):
            v = np.broadcast_to(
                np.asarray(getattr(self, name), dtype=float), (m,))
            setattr(self, name, np.array(v))
        if np.any(self.young <= 0) or np.any(self.thickness <= 0):
            raise ValueError("young and thickness must be positive")
        if np.any(self.poisson < 0) or np.any(self.poisson >= 0.5):
            raise ValueError("poisson must lie in [0, 0.5)")
        self.loads = np.asarray(self.loads, dtype=float).reshape(-1)
        if self.loads.size != 3 * n:
            raise ValueError(f"loads must have 3*nnode = {3 * n} "
                             f"entries, got {self.loads.size}")
        self.fixed_dofs = np.unique(np.asarray(self.fixed_dofs,
                                               dtype=int).reshape(-1))
        if self.fixed_dofs.size and (self.fixed_dofs.min() < 0
                                     or self.fixed_dofs.max() >= 3 * n):
            raise ValueError("fixed_dofs out of range")
        if self.pressure is not None:
            self.pressure = np.broadcast_to(
                np.asarray(self.pressure, dtype=float), (m,)).copy()
        if self.point_masses is not None:
            self.point_masses = np.broadcast_to(
                np.asarray(self.point_masses, dtype=float), (n,)).copy()
        if self.temperature is not None:
            if self.alpha_cte is None:
                raise ValueError("a plate temperature gradient needs "
                                 "the thermal expansion coefficient "
                                 "alpha_cte (κ_th = α ΔT / t)")
            self.temperature = np.broadcast_to(
                np.asarray(self.temperature, dtype=float), (m,)).copy()
        if self.alpha_cte is not None:
            self.alpha_cte = np.broadcast_to(
                np.asarray(self.alpha_cte, dtype=float), (m,)).copy()
        if bool(torch.any(_q4_detj(_t(self.coords())) <= 0.0)):
            raise ValueError("plate quadrilaterals must be CCW and "
                             "convex enough for positive Jacobians")

    @property
    def nnode(self) -> int:
        return self.nodes.shape[0]

    @property
    def nelm(self) -> int:
        return self.elements.shape[0]

    @property
    def ndof(self) -> int:
        return 3 * self.nnode

    def coords(self) -> np.ndarray:
        return self.nodes[self.elements]          # (m, 4, 2)

    def dof_map(self) -> np.ndarray:
        return (3 * self.elements[:, :, None]
                + np.arange(3)).reshape(self.nelm, 12)

    def free_mask(self) -> np.ndarray:
        mask = np.ones(self.ndof)
        mask[self.fixed_dofs] = 0.0
        return mask

    def free_dofs(self) -> np.ndarray:
        return np.setdiff1d(np.arange(self.ndof), self.fixed_dofs)


# --------------------------------------------------------------------
# Element closed forms, batched over elements, on tensors


def _jacobian(coords: torch.Tensor, xi, eta):
    """(J^-1 (m, 2, 2), detJ (m,), dN/dxi (2, 4) tensor) at one point."""
    dn = _t(_q4_dn(xi, eta), coords.device, coords.dtype)   # (2, 4)
    jac = torch.einsum("an,mnc->mac", dn, coords)
    det = jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0]
    inv = torch.stack([
        torch.stack([jac[:, 1, 1], -jac[:, 0, 1]], dim=-1),
        torch.stack([-jac[:, 1, 0], jac[:, 0, 0]], dim=-1)],
        dim=-2) / det[:, None, None]
    return inv, det, dn


def _shape_grads(coords: torch.Tensor, xi, eta):
    """(N (4,) numpy, dN/dx (m, 4), dN/dy (m, 4), detJ (m,)) at one natural
    point of the bilinear map."""
    inv, det, dn = _jacobian(coords, xi, eta)
    dxy = torch.einsum("mab,bn->man", inv, dn)              # (m, 2, 4)
    return _q4_n(xi, eta), dxy[:, 0], dxy[:, 1], det


def _bend_b(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(m, 3, 12) curvature-displacement matrix at one point, DOF order
    (w, bx, by) per node: kappa = [bx,x; by,y; bx,y + by,x]."""
    z = torch.zeros_like(dx)
    cols = []
    for i in range(4):
        cols.append(torch.stack([z[:, i], z[:, i], z[:, i]], dim=-1))
        cols.append(torch.stack([dx[:, i], z[:, i], dy[:, i]], dim=-1))
        cols.append(torch.stack([z[:, i], dy[:, i], dx[:, i]], dim=-1))
    return torch.stack(cols, dim=-1)


def _shear_b(n, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(m, 2, 12) displacement-based shear matrix at one point, gamma =
    [w,x - bx; w,y - by]: a diagnostic; the stiffness takes the MITC4
    field (it locks in the thin limit)."""
    z = torch.zeros_like(dx)
    nn = _t(n, dx.device, dx.dtype).expand_as(dx)
    cols = []
    for i in range(4):
        cols.append(torch.stack([dx[:, i], dy[:, i]], dim=-1))
        cols.append(torch.stack([-nn[:, i], z[:, i]], dim=-1))
        cols.append(torch.stack([z[:, i], -nn[:, i]], dim=-1))
    return torch.stack(cols, dim=-1)


# MITC4 covariant shear sample points: gamma_xi at (0, +-1), gamma_eta at
# (+-1, 0).
_MITC_XI = ((0.0, 1.0), (0.0, -1.0))
_MITC_ETA = ((1.0, 0.0), (-1.0, 0.0))


def _cov_shear_row(coords: torch.Tensor, xi, eta, comp: int):
    """(m, 12) covariant transverse shear row at one natural point:
    gamma~ = w,c - N_i (x,c bx + y,c by), c = xi (comp 0) or eta (1)."""
    n = _q4_n(xi, eta)
    dn = _q4_dn(xi, eta)[comp]                              # (4,)
    tang = torch.einsum("n,mnc->mc", _t(dn, coords.device, coords.dtype),
                        coords)                             # (m, 2)
    ones = torch.ones_like(tang[:, 0])
    cols = []
    for i in range(4):
        cols.append(float(dn[i]) * ones)
        cols.append(-float(n[i]) * tang[:, 0])
        cols.append(-float(n[i]) * tang[:, 1])
    return torch.stack(cols, dim=-1)


def _mitc_rows(coords: torch.Tensor):
    """The four covariant sample rows (each (m, 12)): gamma_xi at (0, +1),
    (0, -1), gamma_eta at (+1, 0), (-1, 0)."""
    return (_cov_shear_row(coords, *_MITC_XI[0], 0),
            _cov_shear_row(coords, *_MITC_XI[1], 0),
            _cov_shear_row(coords, *_MITC_ETA[0], 1),
            _cov_shear_row(coords, *_MITC_ETA[1], 1))


def _shear_b_mitc(coords: torch.Tensor, rows, xi, eta):
    """((m, 2, 12) cartesian MITC4 shear matrix, (m,) detJ) at one natural
    point: the covariant samples interpolated, rotated with J^-1."""
    a1, a2, b1, b2 = rows
    bxi = 0.5 * (1.0 + eta) * a1 + 0.5 * (1.0 - eta) * a2
    bet = 0.5 * (1.0 + xi) * b1 + 0.5 * (1.0 - xi) * b2
    btil = torch.stack([bxi, bet], dim=-2)                  # (m, 2, 12)
    inv, det, _ = _jacobian(coords, xi, eta)
    return torch.einsum("mab,mbk->mak", inv, btil), det


def _dmats(young, poisson, thickness):
    """(D_b (m, 3, 3), D_s (m,)): the bending rigidity matrix and the
    isotropic shear stiffness kappa_s G t (D_s I)."""
    e, nu, t = young, poisson, thickness
    d = e * t ** 3 / (12.0 * (1.0 - nu * nu))
    z = torch.zeros_like(d)
    db = torch.stack([
        torch.stack([d, d * nu, z], dim=-1),
        torch.stack([d * nu, d, z], dim=-1),
        torch.stack([z, z, d * (1.0 - nu) / 2.0], dim=-1)], dim=-2)
    g = e / (2.0 * (1.0 + nu))
    return db, _SHEAR_K * g * t


def _k_blocks_plate(coords, young, poisson, thickness) -> torch.Tensor:
    """(m, 12, 12) MITC4 stiffness blocks: bending 2 x 2 Gauss on the
    displacement curvatures, shear 2 x 2 Gauss on the assumed field."""
    db, ds = _dmats(young, poisson, thickness)
    rows = _mitc_rows(coords)
    k = None
    for xi, eta in _GP:
        _, dx, dy, det = _shape_grads(coords, xi, eta)
        bb = _bend_b(dx, dy)
        kg = det[:, None, None] * torch.einsum("mia,mij,mjb->mab", bb, db,
                                               bb)
        bs, dets = _shear_b_mitc(coords, rows, xi, eta)
        kg = kg + (ds * dets)[:, None, None] \
            * torch.einsum("mia,mib->mab", bs, bs)
        k = kg if k is None else k + kg
    return k


def _m_blocks_plate(coords, density, thickness) -> torch.Tensor:
    """(m, 12, 12) consistent mass blocks: rho t on w, rho t^3 / 12 rotary
    inertia on the rotations, 2 x 2 Gauss."""
    m = torch.zeros((coords.shape[0], 12, 12), dtype=coords.dtype,
                    device=coords.device)
    for xi, eta in _GP:
        n, _, _, det = _shape_grads(coords, xi, eta)
        nn = _t(np.outer(n, n), coords.device, coords.dtype)
        mw = (density * thickness * det)[:, None, None] * nn
        mr = (density * thickness ** 3 / 12.0 * det)[:, None, None] * nn
        m[:, 0::3, 0::3] += mw
        m[:, 1::3, 1::3] += mr
        m[:, 2::3, 2::3] += mr
    return m


# --------------------------------------------------------------------
# Problem-level operators, float64 on a device


def _elements(problem: PlateProblem, device):
    """(coords, dof map) of the problem on `device`, float64 / int64."""
    return (_t(problem.coords(), device),
            torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                            device=device))


def _material(problem: PlateProblem, device, *names):
    return [_t(getattr(problem, name), device) for name in names]


def _pressure_vectors(problem: PlateProblem, device=None) -> torch.Tensor:
    """(3n,) consistent nodal loads of the uniform transverse pressure q on
    the w DOFs, int N q dA (2 x 2 Gauss); float64 on `device` (CPU when
    None)."""
    if problem.pressure is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    coords, dm = _elements(problem, device)
    q = _t(problem.pressure, device)
    fe = torch.zeros((problem.nelm, 12), dtype=_F64, device=device)
    for xi, eta in _GP:
        n, _, _, det = _shape_grads(coords, xi, eta)
        fe[:, 0::3] += (q * det)[:, None] * _t(n, device)[None, :]
    return scatter_add(problem.ndof, dm, fe)


def _thermal_curvature(problem: PlateProblem, device=None):
    """(m, 3) Voigt thermal curvature kappa_th = alpha dT / t [1, 1, 0] of
    the through-thickness gradient, or None."""
    if problem.temperature is None:
        return None
    k = _t(problem.alpha_cte * problem.temperature / problem.thickness,
           device)
    return torch.stack([k, k, torch.zeros_like(k)], dim=-1)


def _thermal_load_vectors(problem: PlateProblem,
                          device=None) -> torch.Tensor:
    """(3n,) consistent thermal nodal loads int B_b^T D_b kappa_th dA (2 x 2
    Gauss), float64 on `device` (CPU when None)."""
    if problem.temperature is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    (young,) = _material(problem, device, "young")
    return _thermal_loads_of(problem, young, device)


def _thermal_loads_of(problem: PlateProblem, young: torch.Tensor,
                      device=None) -> torch.Tensor:
    """The thermal nodal loads of `_thermal_load_vectors` with the moduli
    `young` (m,) float64, differentiable in them."""
    kap_th = _thermal_curvature(problem, device)
    coords, dm = _elements(problem, device)
    nu, thick = _material(problem, device, "poisson", "thickness")
    db, _ = _dmats(young, nu, thick)
    m_th = torch.einsum("mij,mj->mi", db, kap_th)
    fe = torch.zeros((problem.nelm, 12), dtype=_F64, device=device)
    for xi, eta in _GP:
        _, dx, dy, det = _shape_grads(coords, xi, eta)
        fe += det[:, None] * torch.einsum("mia,mi->ma", _bend_b(dx, dy),
                                          m_th)
    return scatter_add(problem.ndof, dm, fe)


def _require_no_thermal(problem: PlateProblem, kind: str):
    """The dynamic analyses refuse a dT gradient: its load is static."""
    if problem.temperature is not None:
        raise ValueError(
            f"plate {kind} does not take a temperature-gradient load "
            "case — thermoelastic bending is static; use analysis type "
            '"static"')


def _assemble(problem: PlateProblem, blocks: torch.Tensor) -> torch.Tensor:
    """(m, 12, 12) blocks -> dense (ndof, ndof), one float64 scatter on the
    blocks' device."""
    n = problem.ndof
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                         device=blocks.device)
    flat = dm[:, :, None] * n + dm[:, None, :]
    return scatter_add(n * n, flat, blocks).reshape(n, n)


def _stiffness_blocks(problem: PlateProblem, device) -> torch.Tensor:
    coords, _ = _elements(problem, device)
    return _k_blocks_plate(coords, *_material(problem, device, "young",
                                              "poisson", "thickness"))


def _matrices(problem: PlateProblem, with_mass: bool, device):
    k = _assemble(problem, _stiffness_blocks(problem, device))
    mmat = None
    if with_mass:
        coords, _ = _elements(problem, device)
        rho, thick = _material(problem, device, "density", "thickness")
        mmat = _assemble(problem, _m_blocks_plate(coords, rho, thick))
        if problem.point_masses is not None:
            pm = torch.zeros(problem.ndof, dtype=_F64, device=device)
            pm[0::3] += _t(problem.point_masses, device)
            mmat = mmat + torch.diag(pm)
    return k, mmat


def plate_matrices(problem: PlateProblem, with_mass: bool = True,
                   device=None):
    """(K, M) dense global float64 tensors on `device` ("cuda" when None);
    M is None unless with_mass.  The one assembly every dense plate
    analysis shares."""
    return _matrices(problem, with_mass, resolve_device(device))


def _recover(problem: PlateProblem, u: torch.Tensor):
    """(moments, shear forces, extreme-fiber von Mises) tensors at the
    centroids from a float64 u, on u's device."""
    device = u.device
    coords, dm = _elements(problem, device)
    young, nu, thick = _material(problem, device, "young", "poisson",
                                 "thickness")
    db, ds = _dmats(young, nu, thick)
    _, dx, dy, _ = _shape_grads(coords, 0.0, 0.0)
    u_e = u[dm]
    kap = torch.einsum("mia,ma->mi", _bend_b(dx, dy), u_e)
    kap_th = _thermal_curvature(problem, device)
    if kap_th is not None:
        # M = D_b (kappa - kappa_th): the free thermal cap is moment-free.
        kap = kap - kap_th
    mom = torch.einsum("mij,mj->mi", db, kap)
    bs, _ = _shear_b_mitc(coords, _mitc_rows(coords), 0.0, 0.0)
    q = ds[:, None] * torch.einsum("mia,ma->mi", bs, u_e)
    s = 6.0 * mom / thick[:, None] ** 2
    sxx, syy, sxy = s[:, 0], s[:, 1], s[:, 2]
    vm = torch.sqrt(sxx ** 2 - sxx * syy + syy ** 2 + 3.0 * sxy ** 2)
    return mom, q, vm


def recover_moments(problem: PlateProblem, u):
    """Centroid bending moments (m, 3) Voigt [Mxx, Myy, Mxy], shear forces
    (m, 2) [Qx, Qy] and the extreme-fiber von Mises stress (m,) of 6M/t^2
    (the transverse shear vanishes at the surface), numpy.  A tensor u is
    worked on its device, an array on the CPU."""
    u = _t(u, u.device if isinstance(u, torch.Tensor) else None)
    return tuple(_numpy(x) for x in _recover(problem, u))


@dataclass
class PlateStaticResult:
    displacements: np.ndarray    # (3n,) [w, bx, by]*n
    moments: np.ndarray          # (m, 3) centroid [Mxx, Myy, Mxy]
    shear_forces: np.ndarray     # (m, 2) centroid [Qx, Qy]
    von_mises: np.ndarray        # (m,) extreme-fiber
    reactions: np.ndarray        # (3n,) K u - f on fixed DOFs


def _static_result(problem: PlateProblem, u: torch.Tensor,
                   reactions: torch.Tensor) -> PlateStaticResult:
    mom, q, vm = _recover(problem, u)
    return PlateStaticResult(displacements=_numpy(u), moments=_numpy(mom),
                             shear_forces=_numpy(q), von_mises=_numpy(vm),
                             reactions=_numpy(reactions))


def _static_loads(problem: PlateProblem, device) -> torch.Tensor:
    """(3n,) nodal + pressure + thermal loads, float64 on `device`."""
    return (_t(problem.loads, device) + _pressure_vectors(problem, device)
            + _thermal_load_vectors(problem, device))


def solve_plate_static(problem: PlateProblem,
                       device=None) -> PlateStaticResult:
    """Dense masked static solve and centroid moment recovery, float64 on
    `device` ("cuda" when None)."""
    dev = resolve_device(device)
    k, _ = _matrices(problem, False, dev)
    mask = _t(problem.free_mask(), dev)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    f = _static_loads(problem, dev)
    u = torch.linalg.solve(km, f * mask) * mask
    return _static_result(problem, u, (k @ u - f) * (1.0 - mask))


@dataclass
class PlateModalResult:
    frequencies_hz: np.ndarray
    omegas: np.ndarray
    eigenvalues: np.ndarray
    mode_shapes: np.ndarray      # (n_modes, 3n)


def plate_modal(problem: PlateProblem, n_modes: int = 6,
                membrane_force=None, device=None) -> PlateModalResult:
    """Generalized K phi = lambda M phi on the free block (consistent mass
    with rotary inertia), dense float64 on `device` ("cuda" when None),
    through M_ff's Cholesky factor.  membrane_force: an optional in-plane
    force state [Nxx, Nyy, Nxy] (force / length, per element or broadcast)
    whose geometric stiffness K_g(N) is added: tension raises the
    frequencies, compression lowers them, omega_1 -> 0 at the state's own
    buckling factor."""
    dev = resolve_device(device)
    k, m = _matrices(problem, True, dev)
    if membrane_force is not None:
        k = k + _geometric(problem, membrane_force, dev)
    free = _free_index(problem, dev)
    lam, vec = _general_eigh(k[free][:, free], m[free][:, free])
    n_modes = min(n_modes, lam.numel())
    lam = torch.clamp_min(lam[:n_modes], 0.0)
    shapes = torch.zeros((n_modes, problem.ndof), dtype=_F64, device=dev)
    shapes[:, free] = vec[:, :n_modes].T
    lam = _numpy(lam)
    om = np.sqrt(lam)
    return PlateModalResult(frequencies_hz=om / (2.0 * np.pi), omegas=om,
                            eigenvalues=lam, mode_shapes=_numpy(shapes))


# --------------------------------------------------------------------
# Geometric stiffness of a membrane force state, linearized buckling


def _membrane_force_array(problem: PlateProblem,
                          membrane_force) -> np.ndarray:
    n = np.asarray(membrane_force, dtype=float)
    if n.ndim <= 1:
        n = np.broadcast_to(n.reshape(-1), (3,))
        n = np.broadcast_to(n, (problem.nelm, 3))
    if n.shape != (problem.nelm, 3):
        raise ValueError("membrane_force must be [Nxx, Nyy, Nxy] or "
                         f"(nelm, 3); got shape {n.shape}")
    return np.array(n, dtype=float)


def _gw_blocks(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(m, 2, 12) deflection-gradient matrix at one point, grad w = [w,x;
    w,y]: only the w columns (0::3) carry entries."""
    z = torch.zeros_like(dx)
    cols = []
    for i in range(4):
        cols.append(torch.stack([dx[:, i], dy[:, i]], dim=-1))
        cols.append(torch.stack([z[:, i], z[:, i]], dim=-1))
        cols.append(torch.stack([z[:, i], z[:, i]], dim=-1))
    return torch.stack(cols, dim=-1)


def _geometric_blocks(problem: PlateProblem, membrane_force,
                      device) -> torch.Tensor:
    """(m, 12, 12) float64 K_g blocks of a membrane force state."""
    nf = _t(_membrane_force_array(problem, membrane_force), device)
    nmat = torch.stack([torch.stack([nf[:, 0], nf[:, 2]], dim=-1),
                        torch.stack([nf[:, 2], nf[:, 1]], dim=-1)], dim=-2)
    coords, _ = _elements(problem, device)
    kg = None
    for xi, eta in _GP:
        _, dx, dy, det = _shape_grads(coords, xi, eta)
        gw = _gw_blocks(dx, dy)
        blk = det[:, None, None] * torch.einsum("mia,mij,mjb->mab", gw, nmat,
                                                gw)
        kg = blk if kg is None else kg + blk
    return kg


def _geometric(problem: PlateProblem, membrane_force,
               device) -> torch.Tensor:
    return _assemble(problem, _geometric_blocks(problem, membrane_force,
                                                device))


def plate_geometric_stiffness(problem: PlateProblem, membrane_force,
                              device=None) -> torch.Tensor:
    """Dense geometric stiffness of a membrane force state, K_g = int grad
    w^T N grad w dA (2 x 2 Gauss), N = [[Nxx, Nxy], [Nxy, Nyy]]; float64
    on `device` ("cuda" when None)."""
    return _geometric(problem, membrane_force, resolve_device(device))


@dataclass
class PlateBucklingResult:
    load_factors: np.ndarray     # (n_modes,) ascending positive lambda
    modes: np.ndarray            # (n_modes, 3n)


def plate_buckling(problem: PlateProblem, membrane_force,
                   n_modes: int = 4, device=None) -> PlateBucklingResult:
    """Linearized plate buckling (K + lambda K_g(N)) phi = 0 on the free
    block, float64 on `device` ("cuda" when None): lambda scales the given
    membrane force state (compression negative).  The symmetric pencil
    -K_g phi = mu K phi through K_ff's Cholesky factor, lambda = 1/mu for
    the positive mu above 1e-12 of the largest |mu|, largest mu first;
    the modes K-orthonormal (scipy.linalg.eigh's)."""
    dev = resolve_device(device)
    kg = _geometric(problem, membrane_force, dev)
    k, _ = _matrices(problem, False, dev)
    free = _free_index(problem, dev)
    mu, vec = _general_eigh(-kg[free][:, free], k[free][:, free])
    mu_h = _numpy(mu)
    pos = np.flatnonzero(mu_h > 1e-12 * np.abs(mu_h).max())
    if pos.size == 0:
        raise ValueError("the membrane force state destabilizes no "
                         "mode (all-tension N?) — plate buckling "
                         "needs a compressive component")
    order = pos[np.argsort(mu_h[pos])[::-1]][:n_modes]  # largest mu first
    modes = torch.zeros((order.size, problem.ndof), dtype=_F64, device=dev)
    modes[:, free] = vec[:, torch.as_tensor(order, device=dev)].T
    return PlateBucklingResult(load_factors=1.0 / mu_h[order],
                               modes=_numpy(modes))


def mindlin_ss_buckling_nx(a: float, b: float, young: float,
                           poisson: float, thickness: float,
                           m_max: int = 8, n_max: int = 8) -> float:
    """Exact critical uniaxial compression |Nx| of the hard simply
    supported Mindlin rectangle (any thickness): the minimum over (m, n)
    of D k^4 / [(1 + D k^2 / kappa G t)(m pi / a)^2], k^2 = (m pi / a)^2 +
    (n pi / b)^2."""
    d = young * thickness ** 3 / (12.0 * (1.0 - poisson ** 2))
    c = _SHEAR_K * young / (2.0 * (1.0 + poisson)) * thickness
    best = np.inf
    for mm in range(1, m_max + 1):
        for nn in range(1, n_max + 1):
            k2 = (mm * np.pi / a) ** 2 + (nn * np.pi / b) ** 2
            ncr = d * k2 ** 2 / ((1.0 + d * k2 / c)
                                 * (mm * np.pi / a) ** 2)
            best = min(best, ncr)
    return float(best)


# --------------------------------------------------------------------
# Supports, the Navier series


def plate_supports(nodes: np.ndarray, edges, kind: str,
                   tol: float = 1e-9):
    """Fixed-DOF list of a classic support on the named rectangle edges
    ("left" / "right" / "bottom" / "top"): "clamped" w = bx = by = 0;
    "simply_supported" hard: w = 0 and the rotation along the edge (by on
    x-normal edges, bx on y-normal ones); "free" adds nothing."""
    if isinstance(edges, str):
        edges = [edges]
    span_x = max(float(nodes[:, 0].max() - nodes[:, 0].min()), 1.0)
    span_y = max(float(nodes[:, 1].max() - nodes[:, 1].min()), 1.0)
    sel = {
        "left": np.abs(nodes[:, 0] - nodes[:, 0].min()) <= tol * span_x,
        "right": np.abs(nodes[:, 0] - nodes[:, 0].max()) <= tol * span_x,
        "bottom": np.abs(nodes[:, 1] - nodes[:, 1].min()) <= tol * span_y,
        "top": np.abs(nodes[:, 1] - nodes[:, 1].max()) <= tol * span_y,
    }
    fixed = []
    for e in edges:
        if e not in sel:
            raise ValueError(f'plate edge must be one of {sorted(sel)},'
                             f' got {e!r}')
        ids = np.flatnonzero(sel[e])
        if kind == "clamped":
            fixed += [3 * ids, 3 * ids + 1, 3 * ids + 2]
        elif kind == "simply_supported":
            tangent_rot = 2 if e in ("left", "right") else 1
            fixed += [3 * ids, 3 * ids + tangent_rot]
        elif kind == "free":
            pass
        else:
            raise ValueError('plate support kind must be "clamped", '
                             '"simply_supported" or "free"')
    return (np.unique(np.concatenate(fixed)) if fixed
            else np.zeros(0, dtype=int))


def mindlin_navier_w(a: float, b: float, x: float, y: float, q: float,
                     young: float, poisson: float, thickness: float,
                     n_terms: int = 60) -> float:
    """Exact hard simply supported Mindlin deflection under uniform q: the
    Navier series sum q_mn sin sin [1/(D k^4) + 1/(kappa G t k^2)]."""
    d = young * thickness ** 3 / (12.0 * (1.0 - poisson ** 2))
    c = _SHEAR_K * young / (2.0 * (1.0 + poisson)) * thickness
    w = 0.0
    for mm in range(1, n_terms, 2):
        for nn in range(1, n_terms, 2):
            k2 = (mm * np.pi / a) ** 2 + (nn * np.pi / b) ** 2
            qmn = 16.0 * q / (np.pi ** 2 * mm * nn)
            w += qmn * (1.0 / (d * k2 ** 2) + 1.0 / (c * k2)) \
                * np.sin(mm * np.pi * x / a) * np.sin(nn * np.pi * y / b)
    return w


# --------------------------------------------------------------------
# Newmark and harmonic


@dataclass
class PlateTransientResult:
    times: np.ndarray
    displacements: np.ndarray    # (n_rec, n_probe)
    velocities: np.ndarray
    dt: float
    n_steps: int


def _free_block(problem: PlateProblem, damping, device):
    """(K_ff, M_ff, C_ff, f_ff, free) of the dynamic analyses, float64 on
    `device`, Rayleigh C = alpha M + beta K; f the nodal + pressure
    loads."""
    k, m = _matrices(problem, True, device)
    alpha, beta = (float(damping[0]), float(damping[1]))
    c = alpha * m + beta * k
    f0 = _t(problem.loads, device) + _pressure_vectors(problem, device)
    free = _free_index(problem, device)
    return (k[free][:, free], m[free][:, free], c[free][:, free], f0[free],
            free)


def solve_plate_transient(problem: PlateProblem, dt: float, n_steps: int,
                          damping=(0.0, 0.0), amplitude=None,
                          probe_dofs=None, record_every: int = 1,
                          device=None) -> PlateTransientResult:
    """Newmark (average acceleration) on the dense plate K / M, float64 on
    `device` ("cuda" when None), one LU for every step
    (models/plane.newmark_records).  amplitude: (n_steps,) load scale of
    the nodal + pressure loads (None = unit step)."""
    _require_no_thermal(problem, "transient")
    if dt <= 0.0 or n_steps <= 0:
        raise ValueError("transient needs positive dt and n_steps")
    dev = resolve_device(device)
    kf, mf, cf, ff, free = _free_block(problem, damping, dev)
    times, rec_u, rec_v = newmark_records(
        kf, mf, cf, ff, free, problem.ndof, dt, n_steps, amplitude,
        probe_dofs, record_every)
    return PlateTransientResult(times=times, displacements=rec_u,
                                velocities=rec_v, dt=float(dt),
                                n_steps=int(n_steps))


@dataclass
class PlateHarmonicResult:
    omegas: np.ndarray
    amplitude: np.ndarray        # (n_omega, n_probe) |X|
    real: np.ndarray
    imag: np.ndarray


def plate_harmonic(problem: PlateProblem, omegas, damping=(0.0, 0.0),
                   probe_dofs=None, device=None) -> PlateHarmonicResult:
    """Steady-state X(omega) to the plate load pattern: (K - omega^2 M + i
    omega C) X = f on the free block, Rayleigh C = alpha M + beta K, in
    complex128 on `device` ("cuda" when None)
    (models/plane.harmonic_solves)."""
    _require_no_thermal(problem, "harmonic")
    om = np.asarray(omegas, dtype=float).reshape(-1)
    dev = resolve_device(device)
    kf, mf, cf, ff, free = _free_block(problem, damping, dev)
    xs = harmonic_solves(kf, mf, cf, ff, free, problem.ndof, om, probe_dofs)
    return PlateHarmonicResult(omegas=om, amplitude=np.abs(xs),
                               real=xs.real, imag=xs.imag)


# --------------------------------------------------------------------
# Banded large-mesh statics


def plate_dia_layout(problem: PlateProblem):
    """The problem's DIA layout (ops/dia.dia_layout of its DOF map), built
    on the host once and kept on the instance: it depends only on the
    connectivity, fixed at construction."""
    from ..ops.dia import dia_layout

    layout = getattr(problem, "_dia_layout_cache", None)
    if layout is None:
        layout = dia_layout(problem.dof_map(), problem.ndof)
        problem._dia_layout_cache = layout
    return layout


def _banded_operator(problem: PlateProblem, dtype, dev):
    """(layout, diagonals in dtype, mask) on `dev`: float64 MITC4 blocks,
    one float64 scatter into DIA storage, rounded once."""
    from ..ops.dia import assemble_dia_blocks

    layout = plate_dia_layout(problem)
    diags = assemble_dia_blocks(layout, _stiffness_blocks(problem, dev)
                                ).to(dtype).contiguous()
    return layout, diags, _t(problem.free_mask(), dev, dtype)


def solve_plate_static_banded(problem: PlateProblem, tol: float = 1e-7,
                              max_iter: int = 50000,
                              use_pallas: bool = False,
                              precond: str = "auto", dtype=None,
                              mesh=None, device=None):
    """Large-mesh plate statics on `device` ("cuda" when None) in `dtype`
    (the working dtype when None): the float64 MITC4 blocks scattered once
    into DIA storage, the PCG of ops/dia.dia_cg_solve with components=3
    ("auto" is Jacobi: on a card the fused kernels 1-3; "mg" the banded
    multigrid), the reactions by one matvec.  use_pallas is the JAX
    package's switch for its TPU kernels and has no effect: a CUDA tensor
    always runs the repo's kernels.  mesh= (a device mesh) is ROADMAP item
    15's multi-device row and raises.

    Returns (PlateStaticResult, iterations, relative recurrence residual);
    the moments are recovered on the host from one fetch of u and the
    reactions."""
    from ..parallel import refuse_mesh
    from .frame import banded_static

    del use_pallas
    refuse_mesh(mesh, "the banded plate solve")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    f = _static_loads(problem, dev).to(dtype)
    u, reac, iters, rel = banded_static(layout, diags, mask, f, tol,
                                        max_iter, precond, 3)
    return _static_result(problem, u, reac), iters, rel


# --------------------------------------------------------------------
# Identification (solvers/banded_inverse.py carries the ADAM loops)


def _young_blocks_of(problem: PlateProblem, device):
    """young_e (m,) -> (m, 12, 12) float64 MITC4 blocks on `device`,
    differentiable in young_e."""
    coords, _ = _elements(problem, device)
    nu, thick = _material(problem, device, "poisson", "thickness")
    return lambda young_e: _k_blocks_plate(coords, young_e.to(_F64), nu,
                                           thick)


def identify_plate_young(problem: PlateProblem, measured_dofs,
                         measured_disp, n_iter: int = 800,
                         learning_rate: float = 0.05, field: bool = False,
                         seed: int = 0, hidden_layers: int = 2,
                         neurons_per_layer: int = 16, device=None):
    """Recover Young's modulus from measured plate deflections on the
    dense traced solve (the JAX package's plate_static_response, its
    thermal gradient load included, which moves with E): per-element
    log-E ADAM, or field=True a smooth E(x, y) MLP at the centroids.
    device: where to solve ("cuda" when None).  Returns (young (m,),
    loss_history, field|None)."""
    from ..solvers.banded_inverse import identify_young_dense

    dev = resolve_device(device)
    loads_of = None
    if problem.temperature is not None:
        def loads_of(young_e):
            return _thermal_loads_of(problem, young_e.to(_F64), dev)
    return identify_young_dense(
        _young_blocks_of(problem, dev), problem.dof_map(), problem.young,
        problem.coords().mean(axis=1),
        problem.loads + _pressure_vectors(problem).numpy(),
        problem.free_mask(), measured_dofs, measured_disp, n_iter=n_iter,
        learning_rate=learning_rate, field=field, seed=seed,
        hidden_layers=hidden_layers, neurons_per_layer=neurons_per_layer,
        input_dim=2, loads_of=loads_of, device=dev)


def identify_plate_young_banded(problem: PlateProblem, measured_dofs,
                                measured_disp, n_iter: int = 300,
                                learning_rate: float = 0.05,
                                tol: float = 1e-7, max_iter: int = 20000,
                                zones=None, field: bool = False,
                                seed: int = 0, hidden_layers: int = 2,
                                neurons_per_layer: int = 16, device=None):
    """identify_plate_young past DENSE_DOF_LIMIT: the banded PCG forward
    (Jacobi-scaled for the plate's mixed (a/t)^2 DOF scales) and one
    adjoint PCG a step (solvers/banded_inverse.identify_young_banded).
    zones=[[ids..], ..] gives one log-E per zone.  A thermal load case is
    refused, as in the JAX package.  device: where to solve ("cuda" when
    None).  Returns (young, hist, field|None)."""
    from ..solvers.banded_inverse import identify_young_banded

    _require_no_thermal(problem, "banded identification")
    dev = resolve_device(device)
    return identify_young_banded(
        plate_dia_layout(problem), _young_blocks_of(problem, dev),
        problem.young, problem.coords().mean(axis=1),
        problem.loads + _pressure_vectors(problem).numpy(),
        problem.free_mask(), measured_dofs, measured_disp, n_iter=n_iter,
        learning_rate=learning_rate, tol=tol, max_iter=max_iter,
        zones=zones, field=field, seed=seed, hidden_layers=hidden_layers,
        neurons_per_layer=neurons_per_layer, input_dim=2,
        device=dev)


def plate_static_response(problem: PlateProblem, young_e=None,
                          thickness_e=None, loads=None, load_scale=None,
                          dtype=None, device=None):
    """Differentiable plate statics with per-element properties (the JAX
    package's traced twin): (u, centroid moments (m, 3), extreme-fiber
    von Mises (m,) of 6M / t^2) from the masked dense solve K(E, t) u = f
    (float64 MITC4 blocks, one float64 scatter rounded once to `dtype`)
    and the recovery in `dtype`.  The thermal case's curvature alpha dT / t
    and its loads are rebuilt from the given E and t, so their gradients
    stay exact.  device: "cuda" when None."""
    from ..solvers.banded_inverse import dense_masked_solve

    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    m = problem.nelm

    def prop(v, name):
        return torch.broadcast_to(_t(getattr(problem, name) if v is None
                                     else v, dev), (m,))

    young, nu, thick = (prop(young_e, "young"), prop(None, "poisson"),
                        prop(thickness_e, "thickness"))
    coords, dm = _elements(problem, dev)
    blocks = _k_blocks_plate(coords, young, nu, thick)
    db, _ = _dmats(young, nu, thick)
    kap_th = None
    if problem.temperature is not None:
        kt = _t(problem.alpha_cte * problem.temperature, dev) / thick
        kap_th = torch.stack([kt, kt, torch.zeros_like(kt)], dim=-1)
    if loads is None:
        f = _t(problem.loads, dev) + _pressure_vectors(problem, dev)
        if kap_th is not None:
            m_th = torch.einsum("mij,mj->mi", db, kap_th)
            fe = torch.zeros((m, 12), dtype=_F64, device=dev)
            for xi, eta in _GP:
                _, dx, dy, det = _shape_grads(coords, xi, eta)
                fe = fe + det[:, None] * torch.einsum(
                    "mia,mi->ma", _bend_b(dx, dy), m_th)
            f = f + scatter_add(problem.ndof, dm, fe)
        f = f.to(dtype)
    else:
        f = _t(loads, dev, dtype)
    if load_scale is not None:
        f = f * _t(load_scale, dev, dtype)
    mask = _t(problem.free_mask(), dev, dtype)
    u = dense_masked_solve(blocks, dm, problem.ndof, f, mask)
    _, dx, dy, _ = _shape_grads(coords.to(dtype), 0.0, 0.0)
    kap = torch.einsum("mia,ma->mi", _bend_b(dx, dy), u[dm])
    if kap_th is not None:
        kap = kap - kap_th.to(dtype)
    mom = torch.einsum("mij,mj->mi", db.to(dtype), kap)
    s = 6.0 * mom / thick.to(dtype)[:, None] ** 2
    vm = torch.sqrt(s[:, 0] ** 2 - s[:, 0] * s[:, 1] + s[:, 1] ** 2
                    + 3.0 * s[:, 2] ** 2)
    return u, mom, vm
