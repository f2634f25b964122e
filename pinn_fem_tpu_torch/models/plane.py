"""2D plane-stress / plane-strain continuum elements (counterpart of
pinn_fem_tpu/models/plane.py).

    CST  3-node constant-strain triangle: K_e = t A B^T D B (6 x 6).
    Q4   4-node bilinear quadrilateral, 2 x 2 Gauss quadrature:
         K_e = sum_g t B^T(xi_g) D B(xi_g) |J(xi_g)| (8 x 8).

Constitutive matrices (sigma = D eps, Voigt [xx, yy, xy]):

    plane stress  D = E/(1-nu^2) [[1, nu, 0], [nu, 1, 0], [0, 0, (1-nu)/2]]
    plane strain  D = E/((1+nu)(1-2nu)) [[1-nu, nu, 0], [nu, 1-nu, 0],
                                         [0, 0, (1-2nu)/2]]

The element library (`_dmat`, `_cst_b`, `_q4_point`, `_k_blocks`,
`_m_blocks`) is plain functions on tensors, batched over elements, in the
dtype and on the device of their inputs.  The dense analyses (statics up
to DENSE_DOF_LIMIT DOFs, modal, buckling, Newmark, harmonic) assemble the
dense K and M in float64 on the caller's device, the card by default, and
solve there: `torch.linalg.solve`, the generalized eigenproblems through
the Cholesky factor of M (buckling: of K_ff), one `lu_factor` for every
Newmark step, batched complex128 solves for the harmonic sweep.  Their
results are numpy float64, as in the JAX package.

`solve_plane_static_banded` is the large-mesh statics: the (m, 2nen,
2nen) blocks built in float64 on the device, scattered once into DIA
storage (ops/dia.assemble_dia_blocks: float64 sums rounded once), the
Jacobi-PCG of ops/dia.dia_cg_solve (on a card the fused kernels 1-3 of
ops/kernels/cg_kernel.fused_cg_solve) and the reaction matvec on kernel 1;
the stresses are recovered on the host from one fetch of u.

The mesh generators (`rect_mesh`, `annulus_mesh`) and the edge loads
(`edge_load`, `pressure_load`) are numpy, node numbering and all, as in
the JAX package.  The identification functions of the JAX module are
ROADMAP item 23.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..utils.runtime import default_dtype, resolve_device

# 2 x 2 Gauss points (weights 1) on [-1, 1]^2; corner order is CCW
# (-1,-1), (1,-1), (1,1), (-1,1): node ordering must match.
_GP = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]
               ) / np.sqrt(3.0)
_CORNERS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0],
                     [-1.0, 1.0]])
_F64 = torch.float64


def _t(a, device=None, dtype=_F64) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor of `dtype` on `device` (CPU
    when None)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=dtype)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                           device=device)


@dataclass
class PlaneProblem:
    """2D membrane: nodes (n, 2); elements (m, 3) CST triangles or (m, 4)
    Q4 quadrilaterals (counterclockwise); per-element material (scalars
    broadcast); nodal loads (2n,) as [Fx, Fy]*n; fixed DOFs on the 2-DOF
    numbering u_i = 2i, v_i = 2i+1.  Optional: prescribed values at the
    fixed DOFs, a body-force density [bx, by], per-node point masses, a
    thermal load case (alpha_cte with temperature).  Numpy arrays, as the
    JAX package's problem holds them."""
    nodes: np.ndarray
    elements: np.ndarray
    young: np.ndarray            # (m,) or scalar
    poisson: np.ndarray
    thickness: np.ndarray
    density: np.ndarray
    loads: np.ndarray            # (2n,)
    fixed_dofs: np.ndarray
    plane_strain: bool = False
    prescribed: Optional[np.ndarray] = None     # (len(fixed_dofs),)
    body_force: Optional[np.ndarray] = None     # (2,)
    point_masses: Optional[np.ndarray] = None   # (n,)
    alpha_cte: Optional[np.ndarray] = None      # (m,) or scalar CTE
    temperature: Optional[np.ndarray] = None    # (m,) or scalar dT

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=float)
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 2:
            raise ValueError("plane nodes must be (n, 2)")
        self.elements = np.asarray(self.elements, dtype=int)
        if self.elements.ndim != 2 or self.elements.shape[1] not in (3, 4):
            raise ValueError("plane elements must be (m, 3) triangles "
                             "or (m, 4) quadrilaterals")
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
        nu_max = 0.5 if self.plane_strain else 1.0
        if np.any(self.poisson < 0) or np.any(self.poisson >= nu_max):
            raise ValueError(f"poisson must lie in [0, {nu_max})")
        self.loads = np.asarray(self.loads, dtype=float).reshape(-1)
        if self.loads.size != 2 * n:
            raise ValueError(f"loads must have 2*nnode = {2 * n} "
                             f"entries, got {self.loads.size}")
        self.fixed_dofs = np.asarray(self.fixed_dofs,
                                     dtype=int).reshape(-1)
        if self.fixed_dofs.size and (self.fixed_dofs.min() < 0
                                     or self.fixed_dofs.max() >= 2 * n):
            raise ValueError("fixed_dofs out of range")
        if self.prescribed is not None:
            self.prescribed = np.asarray(self.prescribed,
                                         dtype=float).reshape(-1)
            if self.prescribed.size != self.fixed_dofs.size:
                raise ValueError("prescribed must pair one value per "
                                 "fixed DOF")
        if self.body_force is not None:
            self.body_force = np.asarray(self.body_force,
                                         dtype=float).reshape(2)
        if self.point_masses is not None:
            self.point_masses = np.broadcast_to(
                np.asarray(self.point_masses, dtype=float), (n,)).copy()
        if self.temperature is not None and self.alpha_cte is None:
            raise ValueError('a "temperature" load case needs the '
                             'thermal expansion coefficient (material '
                             '"alpha")')
        for name in ("alpha_cte", "temperature"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, np.broadcast_to(
                    np.asarray(v, dtype=float), (m,)).copy())
        # detJ <= 0 would flip stiffness signs silently.
        coords = _t(self.coords())
        if self.nen == 3:
            if bool(torch.any(_tri_area(coords) <= 0.0)):
                raise ValueError("triangles must be counterclockwise "
                                 "with positive area")
        elif bool(torch.any(_q4_detj(coords) <= 0.0)):
            raise ValueError("quadrilaterals must be "
                             "counterclockwise and convex enough "
                             "for positive Jacobians at all Gauss "
                             "points")

    @property
    def nnode(self) -> int:
        return self.nodes.shape[0]

    @property
    def nelm(self) -> int:
        return self.elements.shape[0]

    @property
    def nen(self) -> int:
        return self.elements.shape[1]

    @property
    def ndof(self) -> int:
        return 2 * self.nnode

    def coords(self) -> np.ndarray:
        """(m, nen, 2) element corner coordinates."""
        return self.nodes[self.elements]

    def dof_map(self) -> np.ndarray:
        """(m, 2*nen) global DOFs, [u1 v1 u2 v2 ...] per element."""
        e = self.elements
        dm = np.empty((self.nelm, 2 * self.nen), dtype=int)
        dm[:, 0::2] = 2 * e
        dm[:, 1::2] = 2 * e + 1
        return dm

    def free_mask(self) -> np.ndarray:
        mask = np.ones(self.ndof)
        mask[self.fixed_dofs] = 0.0
        return mask

    def free_dofs(self) -> np.ndarray:
        return np.setdiff1d(np.arange(self.ndof), self.fixed_dofs)


# --------------------------------------------------------------------
# Element closed forms, batched over elements, on tensors


def _dmat(young, poisson, plane_strain: bool) -> torch.Tensor:
    """(m, 3, 3) constitutive matrices, Voigt [xx, yy, xy]."""
    e, nu = young, poisson
    z = torch.zeros_like(e)
    if plane_strain:
        c = e / ((1.0 + nu) * (1.0 - 2.0 * nu))
        rows = [[c * (1.0 - nu), c * nu, z],
                [c * nu, c * (1.0 - nu), z],
                [z, z, c * (1.0 - 2.0 * nu) / 2.0]]
    else:
        c = e / (1.0 - nu * nu)
        rows = [[c, c * nu, z],
                [c * nu, c, z],
                [z, z, c * (1.0 - nu) / 2.0]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _tri_area(coords: torch.Tensor) -> torch.Tensor:
    """(m,) signed triangle areas (positive = counterclockwise)."""
    d1 = coords[:, 1] - coords[:, 0]
    d2 = coords[:, 2] - coords[:, 0]
    return 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])


def _cst_b(coords: torch.Tensor):
    """CST strain-displacement matrices (m, 3, 6), with constant entries
    b_i = (y_j - y_k)/2A, c_i = (x_k - x_j)/2A, and the (m,) areas."""
    x, y = coords[..., 0], coords[..., 1]
    area = _tri_area(coords)
    j, k = [1, 2, 0], [2, 0, 1]
    b = (y[:, j] - y[:, k]) / (2.0 * area)[:, None]   # (m, 3) dN/dx
    c = (x[:, k] - x[:, j]) / (2.0 * area)[:, None]   # (m, 3) dN/dy
    z = torch.zeros_like(b[:, 0])
    row1 = torch.stack([b[:, 0], z, b[:, 1], z, b[:, 2], z], dim=-1)
    row2 = torch.stack([z, c[:, 0], z, c[:, 1], z, c[:, 2]], dim=-1)
    row3 = torch.stack([c[:, 0], b[:, 0], c[:, 1], b[:, 1],
                        c[:, 2], b[:, 2]], dim=-1)
    return torch.stack([row1, row2, row3], dim=-2), area


def _q4_dn(xi, eta) -> np.ndarray:
    """(2, 4) bilinear shape derivatives in natural coordinates."""
    xa, ea = _CORNERS[:, 0], _CORNERS[:, 1]
    return np.stack([0.25 * xa * (1.0 + ea * eta),
                     0.25 * ea * (1.0 + xa * xi)])


def _q4_point(coords: torch.Tensor, xi, eta):
    """B (m, 3, 8) and detJ (m,) at one natural point."""
    dn = _t(_q4_dn(xi, eta), coords.device, coords.dtype)   # (2, 4)
    jac = torch.einsum("an,mnc->mac", dn, coords)           # (m, 2, 2)
    det = jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0]
    inv = torch.stack([
        torch.stack([jac[:, 1, 1], -jac[:, 0, 1]], dim=-1),
        torch.stack([-jac[:, 1, 0], jac[:, 0, 0]], dim=-1)],
        dim=-2) / det[:, None, None]
    dxy = torch.einsum("mab,bn->man", inv, dn)              # (m, 2, 4)
    dx, dy = dxy[:, 0], dxy[:, 1]
    z = torch.zeros_like(dx[:, 0])
    row1 = torch.stack([dx[:, 0], z, dx[:, 1], z,
                        dx[:, 2], z, dx[:, 3], z], dim=-1)
    row2 = torch.stack([z, dy[:, 0], z, dy[:, 1],
                        z, dy[:, 2], z, dy[:, 3]], dim=-1)
    row3 = torch.stack([dy[:, 0], dx[:, 0], dy[:, 1], dx[:, 1],
                        dy[:, 2], dx[:, 2], dy[:, 3], dx[:, 3]], dim=-1)
    return torch.stack([row1, row2, row3], dim=-2), det


def _q4_detj(coords: torch.Tensor) -> torch.Tensor:
    """(m, 4) Jacobian determinants at the Gauss points (validation)."""
    return torch.stack([_q4_point(coords, xi, eta)[1]
                        for xi, eta in _GP], dim=-1)


def _k_blocks(coords, dmat, thickness, nen: int) -> torch.Tensor:
    """(m, 2nen, 2nen) stiffness blocks (CST closed form or Q4 2 x 2
    Gauss)."""
    if nen == 3:
        b, area = _cst_b(coords)
        scale = (thickness * area)[:, None, None]
        return scale * torch.einsum("mia,mij,mjb->mab", b, dmat, b)
    k = None
    for xi, eta in _GP:
        b, det = _q4_point(coords, xi, eta)
        kg = (thickness * det)[:, None, None] \
            * torch.einsum("mia,mij,mjb->mab", b, dmat, b)
        k = kg if k is None else k + kg
    return k


def _q4_n(xi, eta) -> np.ndarray:
    xa, ea = _CORNERS[:, 0], _CORNERS[:, 1]
    return 0.25 * (1.0 + xa * xi) * (1.0 + ea * eta)        # (4,)


def _m_blocks(coords, density, thickness, nen: int) -> torch.Tensor:
    """(m, 2nen, 2nen) consistent mass blocks."""
    m = torch.zeros((coords.shape[0], 2 * nen, 2 * nen),
                    dtype=coords.dtype, device=coords.device)
    if nen == 3:
        scal = density * thickness * _tri_area(coords) / 12.0
        base = _t([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]],
                  coords.device, coords.dtype)
        m[:, 0::2, 0::2] = scal[:, None, None] * base
        m[:, 1::2, 1::2] = scal[:, None, None] * base
        return m
    for xi, eta in _GP:
        n = _q4_n(xi, eta)
        _, det = _q4_point(coords, xi, eta)
        nn = _t(np.outer(n, n), coords.device, coords.dtype)
        scal = (density * thickness * det)[:, None, None]
        m[:, 0::2, 0::2] += scal * nn
        m[:, 1::2, 1::2] += scal * nn
    return m


# --------------------------------------------------------------------
# Problem-level operators, float64 on a device


def _elements(problem: PlaneProblem, device):
    """(coords, dof map) of the problem on `device`, float64 / int64."""
    return (_t(problem.coords(), device),
            torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                            device=device))


def _material(problem: PlaneProblem, device, *names):
    return [_t(getattr(problem, name), device) for name in names]


def _body_force_vectors(problem: PlaneProblem, device=None) -> torch.Tensor:
    """(2n,) consistent nodal loads of the uniform body-force density
    [bx, by]: CST t A b / 3 per node, Q4 the 2 x 2 Gauss sum.  Float64 on
    `device` (CPU when None)."""
    if problem.body_force is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    bx, by = (float(v) for v in problem.body_force)
    coords, dm = _elements(problem, device)
    (thick,) = _material(problem, device, "thickness")
    fe = torch.zeros((problem.nelm, 2 * problem.nen), dtype=_F64,
                     device=device)
    if problem.nen == 3:
        share = thick * _tri_area(coords) / 3.0
        fe[:, 0::2] = share[:, None] * bx
        fe[:, 1::2] = share[:, None] * by
    else:
        for xi, eta in _GP:
            n = _t(_q4_n(xi, eta), device)
            _, det = _q4_point(coords, xi, eta)
            w = thick * det
            fe[:, 0::2] += w[:, None] * n[None, :] * bx
            fe[:, 1::2] += w[:, None] * n[None, :] * by
    return scatter_add(problem.ndof, dm, fe)


def _thermal_strain(problem: PlaneProblem, device=None):
    """(m, 3) Voigt thermal strain of the dT load case, or None.  Plane
    stress: alpha dT [1, 1, 0]; plane strain carries the (1 + nu) factor of
    the suppressed eps_zz."""
    if problem.temperature is None:
        return None
    a = _t(problem.alpha_cte * problem.temperature, device)
    if problem.plane_strain:
        a = (1.0 + _t(problem.poisson, device)) * a
    return torch.stack([a, a, torch.zeros_like(a)], dim=-1)


def _thermal_load_vectors(problem: PlaneProblem,
                          device=None) -> torch.Tensor:
    """(2n,) consistent thermal nodal loads f_th = int B^T D eps_th t dA,
    float64 on `device` (CPU when None)."""
    eps_th = _thermal_strain(problem, device)
    if eps_th is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    coords, dm = _elements(problem, device)
    young, nu, thick = _material(problem, device, "young", "poisson",
                                 "thickness")
    s_th = torch.einsum("mij,mj->mi", _dmat(young, nu, problem.plane_strain),
                        eps_th)
    if problem.nen == 3:
        b, area = _cst_b(coords)
        fe = (thick * area)[:, None] * torch.einsum("mia,mi->ma", b, s_th)
    else:
        fe = torch.zeros((problem.nelm, 8), dtype=_F64, device=device)
        for xi, eta in _GP:
            b, det = _q4_point(coords, xi, eta)
            fe += (thick * det)[:, None] * torch.einsum("mia,mi->ma", b,
                                                        s_th)
    return scatter_add(problem.ndof, dm, fe)


def _require_no_thermal(problem: PlaneProblem, kind: str):
    """The dynamic analyses refuse a dT field: its load is static."""
    if problem.temperature is not None:
        raise ValueError(
            f"plane {kind} does not take a temperature load case — "
            "thermoelastic loads are static; use analysis type "
            '"static" (or "modal"/"buckling" with prestress, which '
            "inherit ΔT through the static state)")


def _assemble(problem: PlaneProblem, blocks: torch.Tensor,
              dm: torch.Tensor) -> torch.Tensor:
    """(m, 2nen, 2nen) blocks -> dense (ndof, ndof), one float64
    scatter."""
    n = problem.ndof
    flat = dm[:, :, None] * n + dm[:, None, :]
    return scatter_add(n * n, flat, blocks).reshape(n, n)


def _stiffness_blocks(problem: PlaneProblem, device) -> torch.Tensor:
    coords, _ = _elements(problem, device)
    young, nu, thick = _material(problem, device, "young", "poisson",
                                 "thickness")
    return _k_blocks(coords, _dmat(young, nu, problem.plane_strain), thick,
                     problem.nen)


def _matrices(problem: PlaneProblem, with_mass: bool, device):
    coords, dm = _elements(problem, device)
    k = _assemble(problem, _stiffness_blocks(problem, device), dm)
    mmat = None
    if with_mass:
        rho, thick = _material(problem, device, "density", "thickness")
        mmat = _assemble(problem, _m_blocks(coords, rho, thick, problem.nen),
                         dm)
        if problem.point_masses is not None:
            pm = torch.zeros(problem.ndof, dtype=_F64, device=device)
            pmn = _t(problem.point_masses, device)
            pm[0::2] += pmn
            pm[1::2] += pmn
            mmat = mmat + torch.diag(pm)
    return k, mmat


def plane_matrices(problem: PlaneProblem, with_mass: bool = True,
                   device=None):
    """(K, M) dense global float64 tensors on `device` ("cuda" when None);
    M is None unless with_mass.  The one assembly every dense plane
    analysis shares."""
    return _matrices(problem, with_mass, resolve_device(device))


def _centroid_b(problem: PlaneProblem, device=None) -> torch.Tensor:
    """(m, 3, 2nen) strain-displacement at the element centroids (CST: its
    constant B; Q4: xi = eta = 0)."""
    coords, _ = _elements(problem, device)
    if problem.nen == 3:
        return _cst_b(coords)[0]
    return _q4_point(coords, 0.0, 0.0)[0]


def _recover(problem: PlaneProblem, u: torch.Tensor, thermal: bool):
    """(sig, vm, principal, strains) tensors at the centroids from a
    float64 u, on u's device."""
    device = u.device
    b = _centroid_b(problem, device)
    young, nu = _material(problem, device, "young", "poisson")
    dmat = _dmat(young, nu, problem.plane_strain)
    _, dm = _elements(problem, device)
    eps = torch.einsum("mia,ma->mi", b, u[dm])
    eps_th = _thermal_strain(problem, device) if thermal else None
    eps_mech = eps if eps_th is None else eps - eps_th
    sig = torch.einsum("mij,mj->mi", dmat, eps_mech)
    sxx, syy, sxy = sig[:, 0], sig[:, 1], sig[:, 2]
    if problem.plane_strain:
        szz = nu * (sxx + syy)
        if eps_th is not None:
            # eps_zz = 0 with dT != 0 adds -E alpha dT out of plane.
            szz = szz - young * _t(problem.alpha_cte * problem.temperature,
                                   device)
        vm = torch.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                               + (szz - sxx) ** 2) + 3.0 * sxy ** 2)
    else:
        vm = torch.sqrt(sxx ** 2 - sxx * syy + syy ** 2 + 3.0 * sxy ** 2)
    mean = 0.5 * (sxx + syy)
    rad = torch.sqrt((0.5 * (sxx - syy)) ** 2 + sxy ** 2)
    principal = torch.stack([mean + rad, mean - rad], dim=-1)
    return sig, vm, principal, eps


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(float)


def recover_stresses(problem: PlaneProblem, u, thermal: bool = False):
    """Centroid stresses from a displacement field: (m, 3) Voigt [xx, yy,
    xy], von Mises (m,), principal (m, 2) [s1 >= s2], numpy.  Plane strain
    includes s_zz = nu (sxx + syy) in the von Mises.  thermal=True
    subtracts the dT case's thermal strain (for fields solved with that
    load).  A tensor u is worked on its device, an array on the CPU."""
    u = _t(u, u.device if isinstance(u, torch.Tensor) else None)
    sig, vm, principal, _ = _recover(problem, u, thermal)
    return _numpy(sig), _numpy(vm), _numpy(principal)


@dataclass
class PlaneStaticResult:
    displacements: np.ndarray    # (2n,)
    stresses: np.ndarray         # (m, 3) centroid Voigt [xx, yy, xy]
    von_mises: np.ndarray        # (m,)
    principal: np.ndarray        # (m, 2) [s1, s2]
    strains: np.ndarray          # (m, 3) centroid Voigt
    reactions: np.ndarray        # (2n,) K u - f on fixed DOFs


def _static_result(problem: PlaneProblem, u: torch.Tensor,
                   reactions: torch.Tensor) -> PlaneStaticResult:
    sig, vm, principal, eps = _recover(problem, u, thermal=True)
    return PlaneStaticResult(
        displacements=_numpy(u), stresses=_numpy(sig), von_mises=_numpy(vm),
        principal=_numpy(principal), strains=_numpy(eps),
        reactions=_numpy(reactions))


def _dense_static(problem: PlaneProblem, device):
    """(u, K, f, mask) of the dense masked solve, float64 on `device`:
    prescribed values enter as the inhomogeneous-Dirichlet lift."""
    k, _ = _matrices(problem, False, device)
    mask = _t(problem.free_mask(), device)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    f = (_t(problem.loads, device) + _body_force_vectors(problem, device)
         + _thermal_load_vectors(problem, device))
    u_p = torch.zeros(problem.ndof, dtype=_F64, device=device)
    if problem.prescribed is not None:
        u_p[torch.as_tensor(problem.fixed_dofs, device=device)] = _t(
            problem.prescribed, device)
        rhs = (f - k @ u_p) * mask
    else:
        rhs = f * mask
    u = torch.linalg.solve(km, rhs) * mask + u_p
    return u, k, f, mask


def solve_plane_static(problem: PlaneProblem,
                       device=None) -> PlaneStaticResult:
    """Dense masked static solve and centroid stress recovery, float64 on
    `device` ("cuda" when None)."""
    u, k, f, mask = _dense_static(problem, resolve_device(device))
    return _static_result(problem, u, (k @ u - f) * (1.0 - mask))


def _free_index(problem: PlaneProblem, device) -> torch.Tensor:
    return torch.as_tensor(problem.free_dofs(), dtype=torch.int64,
                           device=device)


def _general_eigh(a: torch.Tensor, b: torch.Tensor):
    """All eigenpairs of the symmetric-definite pencil a v = w b v, through
    b = L L^T: ascending w, v b-orthonormal (scipy.linalg.eigh(a, b)'s
    normalization; the signs are the eigensolver's)."""
    lo = torch.linalg.cholesky(b)
    c = torch.linalg.solve_triangular(lo, a, upper=False)
    c = torch.linalg.solve_triangular(lo, c.T, upper=False).T
    w, y = torch.linalg.eigh(0.5 * (c + c.T))
    return w, torch.linalg.solve_triangular(lo.T, y, upper=True)


@dataclass
class PlaneModalResult:
    frequencies_hz: np.ndarray
    omegas: np.ndarray
    eigenvalues: np.ndarray
    mode_shapes: np.ndarray      # (n_modes, 2n)


def plane_modal(problem: PlaneProblem, n_modes: int = 6, prestress_u=None,
                device=None) -> PlaneModalResult:
    """Generalized K phi = lambda M phi on the free block (consistent mass),
    dense float64 on `device` ("cuda" when None), through M_ff's Cholesky
    factor.  prestress_u adds the geometric stiffness K_g(sigma(u0))
    (plane_geometric_stiffness): tension stiffens, compression softens."""
    dev = resolve_device(device)
    k, m = _matrices(problem, True, dev)
    if prestress_u is not None:
        k = k + _geometric(problem, _t(prestress_u, dev), dev)
    free = _free_index(problem, dev)
    lam, vec = _general_eigh(k[free][:, free], m[free][:, free])
    n_modes = min(n_modes, lam.numel())
    lam = torch.clamp_min(lam[:n_modes], 0.0)
    shapes = torch.zeros((n_modes, problem.ndof), dtype=_F64, device=dev)
    shapes[:, free] = vec[:, :n_modes].T
    lam = _numpy(lam)
    om = np.sqrt(lam)
    return PlaneModalResult(frequencies_hz=om / (2.0 * np.pi), omegas=om,
                            eigenvalues=lam, mode_shapes=_numpy(shapes))


def plane_stable_dt(problem: PlaneProblem, safety: float = 0.9,
                    damping=(0.0, 0.0), device=None) -> float:
    """Gershgorin bound on the explicit critical step: omega_max^2 <=
    max_i sum_j |K_ij| / m_i over free rows, m the row-sum lumped mass;
    Rayleigh damping shrinks it, dt = (2/w)(sqrt(1 + zeta^2) - zeta) with
    zeta = alpha/2w + beta w/2.  Float64 on `device` ("cuda" when None)."""
    k, m = plane_matrices(problem, device=device)
    md = m.sum(dim=1)
    row = _numpy(torch.abs(k).sum(dim=1) / torch.clamp_min(md, 1e-300))
    free = problem.free_mask() > 0
    w2 = float(row[free].max()) if free.any() and row[free].max() > 0 \
        else float(row.max())
    w = np.sqrt(max(w2, 1e-30))
    alpha, beta = float(damping[0]), float(damping[1])
    zeta = 0.5 * alpha / w + 0.5 * beta * w
    return safety * (2.0 / w) * (np.sqrt(1.0 + zeta * zeta) - zeta)


def _geometric_blocks(problem: PlaneProblem, u: torch.Tensor, device):
    """((m, 2nen, 2nen) geometric stiffness blocks of the stress state of
    u, the DOF map), float64 on `device`."""
    from ..ops.plane_plastic import gp_geometry

    b, wdet = gp_geometry(problem, device)      # (m, ngp, 3, 2nen), (m, ngp)
    young, nu, thick = _material(problem, device, "young", "poisson",
                                 "thickness")
    dmat = _dmat(young, nu, problem.plane_strain)
    _, dm = _elements(problem, device)
    eps = torch.einsum("mgia,ma->mgi", b, u[dm])
    sig = torch.einsum("mij,mgj->mgi", dmat, eps)           # [xx, yy, xy]
    # Shape gradients sit inside B: row 0 holds dN/dx at even columns,
    # row 1 dN/dy at odd columns.
    g = torch.stack([b[:, :, 0, 0::2], b[:, :, 1, 1::2]], dim=2)
    sigm = torch.stack([torch.stack([sig[..., 0], sig[..., 2]], dim=-1),
                        torch.stack([sig[..., 2], sig[..., 1]], dim=-1)],
                       dim=-2)
    w = wdet * thick[:, None]
    s_ab = torch.einsum("mgia,mgij,mgjb,mg->mab", g, sigm, g, w)
    nen = problem.nen
    kg = torch.zeros((problem.nelm, 2 * nen, 2 * nen), dtype=_F64,
                     device=device)
    kg[:, 0::2, 0::2] = s_ab
    kg[:, 1::2, 1::2] = s_ab
    return kg, dm


def _geometric(problem: PlaneProblem, u: torch.Tensor,
               device) -> torch.Tensor:
    return _assemble(problem, *_geometric_blocks(problem, u, device))


def plane_geometric_stiffness(problem: PlaneProblem, u,
                              device=None) -> torch.Tensor:
    """Dense geometric (initial-stress) stiffness K_g(sigma(u)), the
    continuum form int t grad N_a . sigma . grad N_b dA on each
    displacement component, from the Gauss-point in-plane stress; float64
    on `device` ("cuda" when None)."""
    dev = resolve_device(device)
    return _geometric(problem, _t(u, dev), dev)


@dataclass
class PlaneBucklingResult:
    load_factors: np.ndarray     # (n_modes,) ascending positive lambda
    modes: np.ndarray            # (n_modes, 2n)
    von_mises: np.ndarray        # (m,) base-state centroid vM


def plane_buckling(problem: PlaneProblem, n_modes: int = 4,
                   device=None) -> PlaneBucklingResult:
    """Linearized continuum buckling, float64 on `device` ("cuda" when
    None): the static base state, K_g(sigma), and the symmetric pencil
    -K_g phi = mu K phi on the free block through K_ff's Cholesky factor;
    lambda = 1/mu for the largest positive mu (those above 1e-12 of the
    largest |mu|), scaling the applied load pattern."""
    dev = resolve_device(device)
    u, k, f, mask = _dense_static(problem, dev)
    stat = _static_result(problem, u, (k @ u - f) * (1.0 - mask))
    kg = _geometric(problem, u, dev)
    free = _free_index(problem, dev)
    mu, vec = _general_eigh(-kg[free][:, free], k[free][:, free])
    mu_h = _numpy(mu)
    pos = np.flatnonzero(mu_h > 1e-12 * np.abs(mu_h).max())
    order = pos[np.argsort(mu_h[pos])[::-1]][:n_modes]  # largest mu first
    modes = torch.zeros((order.size, problem.ndof), dtype=_F64, device=dev)
    modes[:, free] = vec[:, torch.as_tensor(order, device=dev)].T
    return PlaneBucklingResult(load_factors=1.0 / mu_h[order],
                               modes=_numpy(modes),
                               von_mises=stat.von_mises)


@dataclass
class PlaneTransientResult:
    times: np.ndarray
    displacements: np.ndarray    # (n_rec, n_probe)
    velocities: np.ndarray       # (n_rec, n_probe)
    dt: float
    n_steps: int


def _free_block(problem: PlaneProblem, damping, device):
    """(K_ff, M_ff, C_ff, f_ff, free) of the dynamic analyses, float64 on
    `device`, with Rayleigh C = alpha M + beta K."""
    k, m = _matrices(problem, True, device)
    alpha, beta = (float(damping[0]), float(damping[1]))
    c = alpha * m + beta * k
    f0 = _t(problem.loads, device) + _body_force_vectors(problem, device)
    free = _free_index(problem, device)
    return (k[free][:, free], m[free][:, free], c[free][:, free], f0[free],
            free)


def solve_plane_transient(problem: PlaneProblem, dt: float, n_steps: int,
                          damping=(0.0, 0.0), amplitude=None,
                          probe_dofs=None, record_every: int = 1,
                          device=None) -> PlaneTransientResult:
    """Newmark (average acceleration) on the dense plane K / M, float64 on
    `device` ("cuda" when None): one LU factorization of the effective
    stiffness serves every step (`lu_solve` a step), with no host read in
    the loop; the records stay on the device and are fetched once.
    amplitude: (n_steps,) load scale of the nodal + body-force loads (None
    = unit step); the forcing of the step that reaches t_{i+1} is
    a_{i+1}, the last step holding the last value."""
    if dt <= 0.0 or n_steps <= 0:
        raise ValueError("transient needs positive dt and n_steps")
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("transient supports homogeneous supports only")
    _require_no_thermal(problem, "transient")
    dev = resolve_device(device)
    kf, mf, cf, ff, free = _free_block(problem, damping, dev)
    amp = (np.ones(n_steps) if amplitude is None
           else np.broadcast_to(np.asarray(amplitude, dtype=float),
                                (n_steps,)))
    a0 = 4.0 / dt ** 2
    a1 = 2.0 / dt
    lu, piv = torch.linalg.lu_factor(kf + a0 * mf + a1 * cf)
    probe = torch.as_tensor(
        np.arange(problem.ndof) if probe_dofs is None
        else np.asarray(probe_dofs, dtype=int).reshape(-1),
        dtype=torch.int64, device=dev)
    n = free.numel()
    u = torch.zeros(n, dtype=_F64, device=dev)
    v = torch.zeros_like(u)
    a_acc = (torch.linalg.solve(mf, ff * float(amp[0])) if n
             else torch.zeros_like(u))
    n_rec = n_steps // record_every
    rec_u = torch.empty((n_rec, probe.numel()), dtype=_F64, device=dev)
    rec_v = torch.empty_like(rec_u)
    full_u = torch.zeros(problem.ndof, dtype=_F64, device=dev)
    full_v = torch.zeros_like(full_u)
    r = 0
    for step in range(n_steps):
        f_t = ff * float(amp[min(step + 1, n_steps - 1)])
        rhs = f_t + mf @ (a0 * u + 2.0 * a1 * v + a_acc) \
            + cf @ (a1 * u + v)
        u_new = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
        v_new = a1 * (u_new - u) - v
        a_new = a0 * (u_new - u) - 2.0 * a1 * v - a_acc
        u, v, a_acc = u_new, v_new, a_new
        if (step + 1) % record_every == 0:
            full_u[free] = u
            full_v[free] = v
            rec_u[r] = full_u[probe]
            rec_v[r] = full_v[probe]
            r += 1
    times = dt * record_every * (np.arange(n_rec) + 1.0)
    return PlaneTransientResult(
        times=times, displacements=_numpy(rec_u), velocities=_numpy(rec_v),
        dt=float(dt), n_steps=int(n_steps))


# --------------------------------------------------------------------
# Structured meshes and edge loads (numpy, the JAX package's numbering)


def rect_mesh(width: float, height: float, nx: int, ny: int,
              element: str = "quad"):
    """Structured (nx x ny)-element rectangle on [0, W] x [0, H]: (nodes
    (n, 2), elements (m, 3|4)).  Node (i, j) sits at index j*(nx+1)+i (x
    fastest); "quad" gives CCW Q4s, "tri" splits each cell along its SW-NE
    diagonal into two CCW CSTs."""
    if nx < 1 or ny < 1:
        raise ValueError("rect_mesh needs nx, ny >= 1")
    if element not in ("quad", "tri"):
        raise ValueError('element must be "quad" or "tri"')
    xs = np.linspace(0.0, float(width), nx + 1)
    ys = np.linspace(0.0, float(height), ny + 1)
    gx, gy = np.meshgrid(xs, ys)                # (ny+1, nx+1)
    nodes = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n00 = (jj * (nx + 1) + ii).ravel()
    n10, n01 = n00 + 1, n00 + nx + 1
    n11 = n01 + 1
    if element == "quad":
        elems = np.stack([n00, n10, n11, n01], axis=-1)
    else:
        elems = np.stack([np.stack([n00, n10, n11], axis=-1),
                          np.stack([n00, n11, n01], axis=-1)],
                         axis=1).reshape(-1, 3)
    return nodes, elems.astype(int)


def annulus_mesh(r_inner: float, r_outer: float, nr: int, nt: int,
                 sweep: float = 0.5 * np.pi):
    """Structured quarter-annulus (or `sweep`-radian sector) Q4 mesh: node
    (i, j) = (radial, angular) at index j*(nr+1)+i, so the inner arc is
    i = 0, the theta = 0 edge j = 0 and the theta = sweep edge j = nt."""
    if nr < 1 or nt < 1:
        raise ValueError("annulus_mesh needs nr, nt >= 1")
    if not 0.0 < r_inner < r_outer:
        raise ValueError("annulus_mesh needs 0 < r_inner < r_outer")
    rs = np.linspace(float(r_inner), float(r_outer), nr + 1)
    ts = np.linspace(0.0, float(sweep), nt + 1)
    rg, tg = np.meshgrid(rs, ts)                  # (nt+1, nr+1)
    nodes = np.stack([(rg * np.cos(tg)).ravel(),
                      (rg * np.sin(tg)).ravel()], axis=-1)
    jj, ii = np.meshgrid(np.arange(nt), np.arange(nr), indexing="ij")
    n00 = (jj * (nr + 1) + ii).ravel()
    elems = np.stack([n00, n00 + 1, n00 + nr + 2, n00 + nr + 1], axis=-1)
    return nodes, elems.astype(int)


def pressure_load(nodes: np.ndarray, node_ids: np.ndarray,
                  pressure: float, thickness: float,
                  ndof: Optional[int] = None) -> np.ndarray:
    """(2n,) consistent nodal loads of a normal pressure along the polyline
    through `node_ids`: each straight segment P1 -> P2 adds p t (dy, -dx)/2
    to both ends (material on the path's left; positive pushes into it)."""
    nodes = np.asarray(nodes, dtype=float)
    ids = np.asarray(node_ids, dtype=int).reshape(-1)
    f = np.zeros(2 * nodes.shape[0] if ndof is None else ndof)
    p = float(pressure) * float(thickness)
    for i, j in zip(ids[:-1], ids[1:]):
        d = nodes[j] - nodes[i]
        fx, fy = p * d[1], -p * d[0]
        f[2 * i] += 0.5 * fx
        f[2 * i + 1] += 0.5 * fy
        f[2 * j] += 0.5 * fx
        f[2 * j + 1] += 0.5 * fy
    return f


def edge_load(nodes: np.ndarray, node_ids: np.ndarray, traction,
              thickness: float, ndof: Optional[int] = None) -> np.ndarray:
    """(2n,) consistent nodal loads of a uniform traction [tx, ty]
    (force/area) along the polyline through `node_ids` (path order): each
    segment adds t L t_vec / 2 to both ends."""
    nodes = np.asarray(nodes, dtype=float)
    ids = np.asarray(node_ids, dtype=int).reshape(-1)
    tx, ty = np.asarray(traction, dtype=float).reshape(2)
    f = np.zeros(2 * nodes.shape[0] if ndof is None else ndof)
    seg = np.linalg.norm(np.diff(nodes[ids], axis=0), axis=1)
    for a, (i, j) in enumerate(zip(ids[:-1], ids[1:])):
        w = 0.5 * thickness * seg[a]
        f[2 * i] += w * tx
        f[2 * i + 1] += w * ty
        f[2 * j] += w * tx
        f[2 * j + 1] += w * ty
    return f


# --------------------------------------------------------------------
# Banded large-mesh statics


def plane_dia_layout(problem: PlaneProblem):
    """The problem's DIA layout (ops/dia.dia_layout of its DOF map), built
    on the host once and kept on the instance: it depends only on the
    connectivity, fixed at construction."""
    from ..ops.dia import dia_layout

    layout = getattr(problem, "_dia_layout_cache", None)
    if layout is None:
        layout = dia_layout(problem.dof_map(), problem.ndof)
        problem._dia_layout_cache = layout
    return layout


def solve_plane_static_banded(problem: PlaneProblem, tol: float = 1e-7,
                              max_iter: int = 20000,
                              use_pallas: bool = False,
                              precond: str = "auto", dtype=None,
                              mesh=None, device=None):
    """Large-mesh plane statics on `device` ("cuda" when None) in `dtype`
    (the working dtype when None): the blocks built in float64 on the
    device and scattered once into DIA storage, PCG on the banded operator
    (ops/dia.dia_cg_solve with components=2), the reactions by one
    matvec.  A Q4 grid has 27 diagonals.

    precond: "auto" / "jacobi" (on a card the fused kernels 1-3) or "mg"
    (the banded multigrid, u / v aggregated apart).  use_pallas is the JAX
    package's switch for its TPU kernels and has no effect: a CUDA tensor
    always runs the repo's kernels.  mesh= (a device mesh) is ROADMAP item
    15's multi-device row and raises.

    Returns (PlaneStaticResult, iterations, relative recurrence residual);
    the stresses and strains are recovered on the host from one fetch of
    u."""
    from ..ops.dia import assemble_dia_blocks, dia_cg_solve, dia_matvec
    from ..parallel import refuse_mesh

    del use_pallas
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("the banded path supports homogeneous "
                         "supports only (lift the prescribed field "
                         "into loads, or use the dense tier)")
    refuse_mesh(mesh, "the banded plane solve")
    if precond == "auto":
        precond = "jacobi"
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    layout = plane_dia_layout(problem)
    diags = assemble_dia_blocks(
        layout, _stiffness_blocks(problem, dev)).to(dtype)
    f = (_t(problem.loads, dev) + _body_force_vectors(problem, dev)
         + _thermal_load_vectors(problem, dev)).to(dtype)
    mask = _t(problem.free_mask(), dev, dtype)
    x, iters, rel = dia_cg_solve(layout, diags, f, mask, tol=float(tol),
                                 max_iter=int(max_iter), precond=precond,
                                 components=2)
    reac = (dia_matvec(layout, diags, x) - f) * (1.0 - mask)
    u = x.double().cpu()
    res = _static_result(problem, u, reac.double().cpu())
    return res, int(iters), float(rel)


@dataclass
class PlaneHarmonicResult:
    omegas: np.ndarray
    amplitude: np.ndarray          # (n_freq, n_probe) |X|
    real: np.ndarray
    imag: np.ndarray


# Bytes of complex128 system matrices one batched harmonic solve may hold.
_HARMONIC_CHUNK_BYTES = 4 << 30


def plane_harmonic(problem: PlaneProblem, omegas, damping=(0.0, 0.0),
                   probe_dofs=None, device=None) -> PlaneHarmonicResult:
    """Steady-state X(omega) to the plane load pattern: the complex systems
    (K - omega^2 M + i omega C) X = f on the free block, Rayleigh C =
    alpha M + beta K, solved in complex128 on `device` ("cuda" when None),
    as many frequencies at once as fit _HARMONIC_CHUNK_BYTES (each
    system built in place from the real K, M and C)."""
    om = np.asarray(omegas, dtype=float).reshape(-1)
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("harmonic supports homogeneous supports only")
    _require_no_thermal(problem, "harmonic")
    dev = resolve_device(device)
    kf, mf, cf, ff, free = _free_block(problem, damping, dev)
    probe = torch.as_tensor(
        np.arange(problem.ndof) if probe_dofs is None
        else np.asarray(probe_dofs, dtype=int).reshape(-1),
        dtype=torch.int64, device=dev)
    n = free.numel()
    chunk = max(1, _HARMONIC_CHUNK_BYTES // max(16 * n * n, 1))
    c128 = torch.complex128
    xs = torch.zeros((om.size, probe.numel()), dtype=c128, device=dev)
    full = torch.zeros((min(chunk, max(om.size, 1)), problem.ndof),
                       dtype=c128, device=dev)
    rhs = ff.to(c128)[:, None]
    for i in range(0, om.size, chunk):
        ws = om[i:i + chunk]
        z = torch.empty((ws.size, n, n), dtype=c128, device=dev)
        for j, w in enumerate(ws):
            z[j].real.copy_(kf).add_(mf, alpha=-w * w)
            z[j].imag.copy_(cf).mul_(w)
        x = torch.linalg.solve(z, rhs.expand(ws.size, n, 1))[..., 0]
        part = full[:ws.size]
        part.zero_()
        part[:, free] = x
        xs[i:i + chunk] = part[:, probe]
        del z
    xs = xs.cpu().numpy()
    return PlaneHarmonicResult(omegas=om, amplitude=np.abs(xs),
                               real=xs.real, imag=xs.imag)
