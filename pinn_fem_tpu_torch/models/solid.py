"""3D solid continuum: trilinear hex8 bricks, small strain, isotropic
(counterpart of pinn_fem_tpu/models/solid.py).

Voigt order [xx, yy, zz, yz, xz, xy] with engineering shear strains; node
order of a brick: the bottom quad counterclockwise seen from +z, then the
top quad above it.

The element library (`_dmat3`, `_hex_point`, `_inv3`, `_k_blocks3`,
`_m_blocks3`) is plain functions on tensors, batched over elements, in the
dtype and on the device of their inputs.  The dense analyses (statics up
to DENSE_DOF_LIMIT DOFs, modal, buckling, Newmark, harmonic) assemble the
dense K and M in float64 on the caller's device, the card by default, and
solve there with the plane family's forms (models/plane.py): the
generalized eigenproblems through a Cholesky factor, one `lu_factor` for
every Newmark step, complex128 solves built in place in chunks for the
harmonic sweep.  Their results are numpy float64, as in the JAX package.

The banded tier runs large meshes on the DIA operator.  A box grid's
stiffness has 99 distinct diagonals under the interleaved [u, v, w]
numbering (the JAX docstring's 135 is a bound), bandwidth
3((nx+1)(ny+1) + nx + 2) + 2; the layout (`solid_dia_layout`, at most 160
diagonals) is built once on the host and kept on the problem.

  * `solve_solid_static_banded`: float64 blocks on the device, one float64
    scatter into DIA storage, the Jacobi-PCG of ops/dia.dia_cg_solve with
    components=3 (on a card the fused kernels 2-3, kernel 1 for the
    reactions); the stresses are recovered on the host from one fetch.
  * `solid_modal_banded`: inverse subspace iteration
    (solvers/modal._subspace_iteration) with row-sum lumped mass, whose
    block solves are the fused PCG.
  * `solve_solid_transient_banded`: central difference
    (solvers/dynamics._central_run) with K u on kernel 1; no host read in
    the step loop, the records fetched once.

`solid_stable_dt`'s Gershgorin row sums of |K| come from the element
blocks (models/plane.abs_row_sums), never a dense K.  The mesh tools
(`box_mesh`, `boundary_quads`, `surface_load`, `extrude_mesh`) are numpy,
node numbering and all, as in the JAX package.
`identify_solid_young_banded` recovers Young's modulus from measured
displacements on the banded adjoint (solvers/banded_inverse.py: kernels
1-3 twice an ADAM iteration on a card).  The differentiable
`solid_static_response` (u, stresses, von Mises) carries the reliability
analyses; mesh= is item 15's multi-device row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..utils.runtime import default_dtype, require_float32, resolve_device
from .plane import (_F64, _general_eigh, _numpy, _t, abs_row_sums,
                    gershgorin_dt, harmonic_solves, newmark_records)

# 2 x 2 x 2 Gauss abscissa and the hex8 corner signs (node order: bottom
# quad CCW, then the top quad, as box_mesh numbers them).
_G3 = 1.0 / np.sqrt(3.0)
_CORNERS3 = np.array([[-1.0, -1.0, -1.0], [1.0, -1.0, -1.0],
                      [1.0, 1.0, -1.0], [-1.0, 1.0, -1.0],
                      [-1.0, -1.0, 1.0], [1.0, -1.0, 1.0],
                      [1.0, 1.0, 1.0], [-1.0, 1.0, 1.0]])
_GP3 = [(sx * _G3, sy * _G3, sz * _G3)
        for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)]
# Local node ids of the six hex faces, outward-CCW, keyed by the natural
# axis and side they sit on (boundary_quads).
_FACES3 = {
    (0, -1): [0, 4, 7, 3], (0, +1): [1, 2, 6, 5],
    (1, -1): [0, 1, 5, 4], (1, +1): [3, 7, 6, 2],
    (2, -1): [0, 3, 2, 1], (2, +1): [4, 5, 6, 7],
}
# Diagonals a solid's DIA layout may hold (27 node neighbours x 5 DOF
# offsets bound it; the 2D default is 64).
_SOLID_MAX_DIAGS = 160


@dataclass
class SolidProblem:
    """3D solid: nodes (n, 3); elements (m, 8) hex8 connectivity (bottom
    quad CCW viewed from +z, then the top quad above it); per-element
    material (scalars broadcast); nodal loads (3n,) as [Fx, Fy, Fz]*n;
    fixed DOFs on the 3-DOF numbering u_i = 3i, v_i = 3i+1, w_i = 3i+2.
    Optional: prescribed nonzero values at fixed DOFs, a global body-force
    density [bx, by, bz], per-node point masses, a thermal load case
    (alpha_cte with temperature).  Numpy arrays, as the JAX package's
    problem holds them."""
    nodes: np.ndarray
    elements: np.ndarray
    young: np.ndarray            # (m,) or scalar
    poisson: np.ndarray
    density: np.ndarray
    loads: np.ndarray            # (3n,)
    fixed_dofs: np.ndarray
    prescribed: Optional[np.ndarray] = None     # (len(fixed_dofs),)
    body_force: Optional[np.ndarray] = None     # (3,)
    point_masses: Optional[np.ndarray] = None   # (n,)
    alpha_cte: Optional[np.ndarray] = None      # (m,) or scalar CTE
    temperature: Optional[np.ndarray] = None    # (m,) or scalar dT

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=float)
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 3:
            raise ValueError("solid nodes must be (n, 3)")
        self.elements = np.asarray(self.elements, dtype=int)
        if self.elements.ndim != 2 or self.elements.shape[1] != 8:
            raise ValueError("solid elements must be (m, 8) hex8")
        n, m = self.nodes.shape[0], self.elements.shape[0]
        if self.elements.min() < 0 or self.elements.max() >= n:
            raise ValueError("element connectivity out of range")
        for name in ("young", "poisson", "density"):
            v = np.broadcast_to(
                np.asarray(getattr(self, name), dtype=float), (m,)).copy()
            setattr(self, name, v)
        if np.any(self.young <= 0) or np.any(self.density <= 0):
            raise ValueError("young and density must be positive")
        if np.any(self.poisson >= 0.5) or np.any(self.poisson < 0):
            raise ValueError("poisson must be in [0, 0.5) — 3D "
                             "elasticity is singular at 0.5")
        self.loads = np.asarray(self.loads, dtype=float).reshape(-1)
        if self.loads.size != 3 * n:
            raise ValueError(f"loads must have 3n = {3 * n} entries")
        self.fixed_dofs = np.unique(np.asarray(self.fixed_dofs, dtype=int))
        if self.fixed_dofs.size and (self.fixed_dofs.min() < 0
                                     or self.fixed_dofs.max() >= 3 * n):
            raise ValueError("fixed_dofs out of range")
        if self.prescribed is not None:
            self.prescribed = np.asarray(self.prescribed, dtype=float)
            if self.prescribed.shape != self.fixed_dofs.shape:
                raise ValueError("prescribed must match fixed_dofs")
        if self.body_force is not None:
            self.body_force = np.asarray(self.body_force,
                                         dtype=float).reshape(3)
        if self.point_masses is not None:
            self.point_masses = np.asarray(self.point_masses,
                                           dtype=float).reshape(n)
        if self.temperature is not None and self.alpha_cte is None:
            raise ValueError('a "temperature" load case needs the '
                             'thermal expansion coefficient (material '
                             '"alpha")')
        for name in ("alpha_cte", "temperature"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, np.broadcast_to(
                    np.asarray(v, dtype=float), (m,)).copy())
        det = _hex_point(_t(self.coords()), *_GP3[0])[1]
        if bool(torch.any(det <= 0)):
            raise ValueError("hex8 elements must be positively "
                             "oriented (bottom quad CCW from +z, top "
                             "quad above)")

    @property
    def nelm(self) -> int:
        return self.elements.shape[0]

    @property
    def ndof(self) -> int:
        return 3 * self.nodes.shape[0]

    def coords(self) -> np.ndarray:
        return self.nodes[self.elements]         # (m, 8, 3)

    def dof_map(self) -> np.ndarray:
        return (3 * self.elements[:, :, None]
                + np.arange(3)).reshape(self.nelm, 24)

    def free_mask(self) -> np.ndarray:
        mask = np.ones(self.ndof)
        mask[self.fixed_dofs] = 0.0
        return mask

    def free_dofs(self) -> np.ndarray:
        return np.setdiff1d(np.arange(self.ndof), self.fixed_dofs)


# --------------------------------------------------------------------
# Element closed forms, batched over elements, on tensors


def _dmat3(young, poisson) -> torch.Tensor:
    """(m, 6, 6) isotropic constitutive matrices, Voigt [xx, yy, zz, yz,
    xz, xy] (engineering shear: G on the diagonal)."""
    e, nu = young, poisson
    lam = e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = e / (2.0 * (1.0 + nu))
    d = lam + 2.0 * mu
    z = torch.zeros_like(e)
    rows = [[d, lam, lam, z, z, z],
            [lam, d, lam, z, z, z],
            [lam, lam, d, z, z, z],
            [z, z, z, mu, z, z],
            [z, z, z, z, mu, z],
            [z, z, z, z, z, mu]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _hex_dn(xi, eta, zeta) -> np.ndarray:
    """(3, 8) trilinear shape derivatives in natural coordinates."""
    xa, ea, za = _CORNERS3[:, 0], _CORNERS3[:, 1], _CORNERS3[:, 2]
    return np.stack([
        0.125 * xa * (1.0 + ea * eta) * (1.0 + za * zeta),
        0.125 * ea * (1.0 + xa * xi) * (1.0 + za * zeta),
        0.125 * za * (1.0 + xa * xi) * (1.0 + ea * eta)])


def _hex_n(xi, eta, zeta) -> np.ndarray:
    """(8,) trilinear shape functions."""
    xa, ea, za = _CORNERS3[:, 0], _CORNERS3[:, 1], _CORNERS3[:, 2]
    return 0.125 * (1.0 + xa * xi) * (1.0 + ea * eta) * (1.0 + za * zeta)


def _inv3(jac: torch.Tensor):
    """Batched closed-form 3 x 3 inverse and determinant (adjugate over
    det)."""
    a, b, c = jac[:, 0, 0], jac[:, 0, 1], jac[:, 0, 2]
    d, e, f = jac[:, 1, 0], jac[:, 1, 1], jac[:, 1, 2]
    g, h, i = jac[:, 2, 0], jac[:, 2, 1], jac[:, 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    inv = torch.stack([
        torch.stack([co00, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([co01, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([co02, b * g - a * h, a * e - b * d], dim=-1)],
        dim=-2) / det[:, None, None]
    return inv, det


def _hex_point(coords: torch.Tensor, xi, eta, zeta):
    """B (m, 6, 24) and detJ (m,) at one natural point."""
    dn = _t(_hex_dn(xi, eta, zeta), coords.device, coords.dtype)  # (3, 8)
    jac = torch.einsum("an,mnc->mac", dn, coords)                 # (m, 3, 3)
    inv, det = _inv3(jac)
    dxyz = torch.einsum("mab,bn->man", inv, dn)                   # (m, 3, 8)
    dx, dy, dz = dxyz[:, 0], dxyz[:, 1], dxyz[:, 2]
    z = torch.zeros_like(dx)
    m = dx.shape[0]

    def row(cu, cv, cw):
        return torch.stack([cu, cv, cw], dim=-1).reshape(m, 24)

    b = torch.stack([
        row(dx, z, z),            # eps_xx
        row(z, dy, z),            # eps_yy
        row(z, z, dz),            # eps_zz
        row(z, dz, dy),           # gamma_yz
        row(dz, z, dx),           # gamma_xz
        row(dy, dx, z),           # gamma_xy
    ], dim=-2)
    return b, det


def _k_blocks3(coords: torch.Tensor, dmat: torch.Tensor) -> torch.Tensor:
    """(m, 24, 24) hex8 stiffness blocks, 2 x 2 x 2 Gauss (weights 1)."""
    k = None
    for xi, eta, zeta in _GP3:
        b, det = _hex_point(coords, xi, eta, zeta)
        kg = det[:, None, None] * torch.einsum("mia,mij,mjb->mab",
                                               b, dmat, b)
        k = kg if k is None else k + kg
    return k


def _m_blocks3(coords: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """(m, 24, 24) consistent mass blocks."""
    m = torch.zeros((coords.shape[0], 24, 24), dtype=coords.dtype,
                    device=coords.device)
    for xi, eta, zeta in _GP3:
        n = _hex_n(xi, eta, zeta)
        nn = _t(np.outer(n, n), coords.device, coords.dtype)
        _, det = _hex_point(coords, xi, eta, zeta)
        scal = (density * det)[:, None, None]
        for c in range(3):
            m[:, c::3, c::3] += scal * nn
    return m


# --------------------------------------------------------------------
# Problem-level operators, float64 on a device


def _elements(problem: SolidProblem, device):
    """(coords, dof map) of the problem on `device`, float64 / int64."""
    return (_t(problem.coords(), device),
            torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                            device=device))


def _material(problem: SolidProblem, device, *names):
    return [_t(getattr(problem, name), device) for name in names]


def _body_force_vectors3(problem: SolidProblem, device=None) -> torch.Tensor:
    """(3n,) consistent nodal loads of a uniform body-force density, float64
    on `device` (CPU when None)."""
    if problem.body_force is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    coords, dm = _elements(problem, device)
    fe = torch.zeros((problem.nelm, 24), dtype=_F64, device=device)
    for xi, eta, zeta in _GP3:
        n = _t(_hex_n(xi, eta, zeta), device)
        _, det = _hex_point(coords, xi, eta, zeta)
        for c in range(3):
            fe[:, c::3] += det[:, None] * n[None, :] \
                * float(problem.body_force[c])
    return scatter_add(problem.ndof, dm, fe)


def _thermal_strain3(problem: SolidProblem, device=None):
    """(m, 6) Voigt thermal strain alpha dT [1, 1, 1, 0, 0, 0] of the dT
    load case, or None.  The load is static: the dynamic analyses refuse
    it."""
    if problem.temperature is None:
        return None
    a = _t(problem.alpha_cte * problem.temperature, device)
    z = torch.zeros_like(a)
    return torch.stack([a, a, a, z, z, z], dim=-1)


def _thermal_load_vectors3(problem: SolidProblem,
                           device=None) -> torch.Tensor:
    """(3n,) consistent thermal nodal loads f_th = int B^T D eps_th dV
    (2 x 2 x 2 Gauss with the element-constant eps_th), float64 on
    `device` (CPU when None)."""
    eps_th = _thermal_strain3(problem, device)
    if eps_th is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device)
    coords, dm = _elements(problem, device)
    young, nu = _material(problem, device, "young", "poisson")
    s_th = torch.einsum("mij,mj->mi", _dmat3(young, nu), eps_th)
    fe = torch.zeros((problem.nelm, 24), dtype=_F64, device=device)
    for xi, eta, zeta in _GP3:
        b, det = _hex_point(coords, xi, eta, zeta)
        fe += det[:, None] * torch.einsum("mia,mi->ma", b, s_th)
    return scatter_add(problem.ndof, dm, fe)


def _require_no_thermal3(problem: SolidProblem, kind: str):
    """The dynamic analyses refuse a dT field: its load is static."""
    if problem.temperature is not None:
        raise ValueError(
            f"solid {kind} does not take a temperature load case — "
            "thermoelastic loads are static; use analysis type "
            '"static" (or "modal"/"buckling" with prestress, which '
            "inherit ΔT through the static state)")


def _assemble3(problem: SolidProblem, blocks: torch.Tensor,
               dm: torch.Tensor) -> torch.Tensor:
    """(m, 24, 24) blocks -> dense (ndof, ndof), one float64 scatter."""
    n = problem.ndof
    flat = dm[:, :, None] * n + dm[:, None, :]
    return scatter_add(n * n, flat, blocks).reshape(n, n)


def _stiffness_blocks3(problem: SolidProblem, device) -> torch.Tensor:
    coords, _ = _elements(problem, device)
    young, nu = _material(problem, device, "young", "poisson")
    return _k_blocks3(coords, _dmat3(young, nu))


def _mass_blocks3(problem: SolidProblem, device) -> torch.Tensor:
    coords, _ = _elements(problem, device)
    (rho,) = _material(problem, device, "density")
    return _m_blocks3(coords, rho)


def _point_mass_diag(problem: SolidProblem, device) -> torch.Tensor:
    return torch.repeat_interleave(_t(problem.point_masses, device), 3)


def _matrices(problem: SolidProblem, with_mass: bool, device):
    _, dm = _elements(problem, device)
    k = _assemble3(problem, _stiffness_blocks3(problem, device), dm)
    mmat = None
    if with_mass:
        mmat = _assemble3(problem, _mass_blocks3(problem, device), dm)
        if problem.point_masses is not None:
            mmat = mmat + torch.diag(_point_mass_diag(problem, device))
    return k, mmat


def solid_matrices(problem: SolidProblem, with_mass: bool = True,
                   device=None):
    """(K, M) dense global float64 tensors on `device` ("cuda" when None);
    M is None unless with_mass.  The one assembly every dense solid
    analysis shares."""
    return _matrices(problem, with_mass, resolve_device(device))


def mass_row_sums3(problem: SolidProblem, device) -> torch.Tensor:
    """(3n,) row sums of the consistent M with point masses (the dense
    M's sum over columns), float64 on `device`, from the element blocks'
    row sums in one float64 scatter."""
    _, dm = _elements(problem, device)
    md = scatter_add(problem.ndof, dm,
                     _mass_blocks3(problem, device).sum(dim=-1))
    if problem.point_masses is not None:
        md = md + _point_mass_diag(problem, device)
    return md


def _centroid_b3(problem: SolidProblem, device=None) -> torch.Tensor:
    """(m, 6, 24) strain-displacement at the element centroids."""
    return _hex_point(_t(problem.coords(), device), 0.0, 0.0, 0.0)[0]


def _recover3(problem: SolidProblem, u: torch.Tensor, thermal: bool):
    """(sig, vm, principal, strains) tensors at the centroids from a
    float64 u, on u's device."""
    device = u.device
    b = _centroid_b3(problem, device)
    young, nu = _material(problem, device, "young", "poisson")
    _, dm = _elements(problem, device)
    eps = torch.einsum("mia,ma->mi", b, u[dm])
    eps_th = _thermal_strain3(problem, device) if thermal else None
    eps_mech = eps if eps_th is None else eps - eps_th
    sig = torch.einsum("mij,mj->mi", _dmat3(young, nu), eps_mech)
    sxx, syy, szz = sig[:, 0], sig[:, 1], sig[:, 2]
    syz, sxz, sxy = sig[:, 3], sig[:, 4], sig[:, 5]
    vm = torch.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                           + (szz - sxx) ** 2)
                    + 3.0 * (sxy ** 2 + syz ** 2 + sxz ** 2))
    tens = torch.stack([torch.stack([sxx, sxy, sxz], dim=-1),
                        torch.stack([sxy, syy, syz], dim=-1),
                        torch.stack([sxz, syz, szz], dim=-1)], dim=-2)
    principal = torch.flip(torch.linalg.eigvalsh(tens), dims=(-1,))
    return sig, vm, principal, eps


def recover_stresses3(problem: SolidProblem, u, thermal: bool = False):
    """Centroid stresses: (m, 6) Voigt [xx, yy, zz, yz, xz, xy], von Mises
    (m,), principal (m, 3) [s1 >= s2 >= s3] and the strains (m, 6), numpy.
    thermal=True subtracts the dT case's thermal strain (for fields solved
    with that load).  A tensor u is worked on its device, an array on the
    CPU."""
    u = _t(u, u.device if isinstance(u, torch.Tensor) else None)
    return tuple(_numpy(x) for x in _recover3(problem, u, thermal))


@dataclass
class SolidStaticResult:
    displacements: np.ndarray    # (3n,)
    stresses: np.ndarray         # (m, 6) centroid Voigt
    von_mises: np.ndarray        # (m,)
    principal: np.ndarray        # (m, 3)
    strains: np.ndarray          # (m, 6)
    reactions: np.ndarray        # (3n,) K u - f on fixed DOFs


def _static_result(problem: SolidProblem, u: torch.Tensor,
                   reactions: torch.Tensor) -> SolidStaticResult:
    sig, vm, principal, eps = _recover3(problem, u, thermal=True)
    return SolidStaticResult(
        displacements=_numpy(u), stresses=_numpy(sig), von_mises=_numpy(vm),
        principal=_numpy(principal), strains=_numpy(eps),
        reactions=_numpy(reactions))


def _loads(problem: SolidProblem, device) -> torch.Tensor:
    """f = nodal + body-force + thermal loads, float64 on `device`."""
    return (_t(problem.loads, device) + _body_force_vectors3(problem, device)
            + _thermal_load_vectors3(problem, device))


def _dense_static(problem: SolidProblem, device):
    """(u, K, f, mask) of the dense masked solve, float64 on `device`:
    prescribed values enter as the inhomogeneous-Dirichlet lift."""
    k, _ = _matrices(problem, False, device)
    mask = _t(problem.free_mask(), device)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    f = _loads(problem, device)
    u_p = torch.zeros(problem.ndof, dtype=_F64, device=device)
    if problem.prescribed is not None:
        u_p[torch.as_tensor(problem.fixed_dofs, device=device)] = _t(
            problem.prescribed, device)
        rhs = (f - k @ u_p) * mask
    else:
        rhs = f * mask
    u = torch.linalg.solve(km, rhs) * mask + u_p
    return u, k, f, mask


def solve_solid_static(problem: SolidProblem,
                       device=None) -> SolidStaticResult:
    """Dense masked static solve and centroid stress recovery, float64 on
    `device` ("cuda" when None); inhomogeneous Dirichlet by the lift."""
    u, k, f, mask = _dense_static(problem, resolve_device(device))
    return _static_result(problem, u, (k @ u - f) * (1.0 - mask))


def _free_index(problem: SolidProblem, device) -> torch.Tensor:
    return torch.as_tensor(problem.free_dofs(), dtype=torch.int64,
                           device=device)


@dataclass
class SolidModalResult:
    frequencies_hz: np.ndarray
    omegas: np.ndarray
    eigenvalues: np.ndarray
    mode_shapes: np.ndarray      # (n_modes, 3n)


def _modal_result(lam: np.ndarray, shapes: np.ndarray) -> SolidModalResult:
    om = np.sqrt(lam)
    return SolidModalResult(frequencies_hz=om / (2.0 * np.pi), omegas=om,
                            eigenvalues=lam, mode_shapes=shapes)


def solid_modal(problem: SolidProblem, n_modes: int = 6, prestress_u=None,
                device=None) -> SolidModalResult:
    """Generalized K phi = lambda M phi on the free block (consistent
    mass), dense float64 on `device` ("cuda" when None), through M_ff's
    Cholesky factor.  prestress_u adds the geometric stiffness
    K_g(sigma(u0)) (solid_geometric_stiffness)."""
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
    return _modal_result(_numpy(lam), _numpy(shapes))


@dataclass
class SolidTransientResult:
    times: np.ndarray
    displacements: np.ndarray    # (n_rec, n_probe)
    velocities: np.ndarray
    dt: float
    n_steps: int


def _free_block(problem: SolidProblem, damping, device):
    """(K_ff, M_ff, C_ff, f_ff, free) of the dynamic analyses, float64 on
    `device`, with Rayleigh C = alpha M + beta K."""
    k, m = _matrices(problem, True, device)
    alpha, beta = (float(damping[0]), float(damping[1]))
    c = alpha * m + beta * k
    f0 = _t(problem.loads, device) + _body_force_vectors3(problem, device)
    free = _free_index(problem, device)
    return (k[free][:, free], m[free][:, free], c[free][:, free], f0[free],
            free)


def solve_solid_transient(problem: SolidProblem, dt: float, n_steps: int,
                          damping=(0.0, 0.0), amplitude=None,
                          probe_dofs=None, record_every: int = 1,
                          device=None) -> SolidTransientResult:
    """Newmark (average acceleration) on the dense solid K / M, float64 on
    `device` ("cuda" when None): one LU factorization serves every step
    (models/plane.newmark_records), the records fetched once; the forcing
    of the step that reaches t_{i+1} is amplitude[i+1]."""
    if dt <= 0.0 or n_steps <= 0:
        raise ValueError("transient needs positive dt and n_steps")
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("transient supports homogeneous supports only")
    _require_no_thermal3(problem, "transient")
    dev = resolve_device(device)
    kf, mf, cf, ff, free = _free_block(problem, damping, dev)
    times, rec_u, rec_v = newmark_records(
        kf, mf, cf, ff, free, problem.ndof, dt, n_steps, amplitude,
        probe_dofs, record_every)
    return SolidTransientResult(times=times, displacements=rec_u,
                                velocities=rec_v, dt=float(dt),
                                n_steps=int(n_steps))


@dataclass
class SolidHarmonicResult:
    omegas: np.ndarray
    amplitude: np.ndarray          # (n_freq, n_probe) |X|
    real: np.ndarray
    imag: np.ndarray


def solid_harmonic(problem: SolidProblem, omegas, damping=(0.0, 0.0),
                   probe_dofs=None, device=None) -> SolidHarmonicResult:
    """Steady-state X(omega) to the solid load pattern: (K - omega^2 M +
    i omega C) X = f on the free block, Rayleigh C = alpha M + beta K, in
    complex128 on `device` ("cuda" when None)
    (models/plane.harmonic_solves)."""
    om = np.asarray(omegas, dtype=float).reshape(-1)
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("harmonic supports homogeneous supports only")
    _require_no_thermal3(problem, "harmonic")
    dev = resolve_device(device)
    kf, mf, cf, ff, free = _free_block(problem, damping, dev)
    xs = harmonic_solves(kf, mf, cf, ff, free, problem.ndof, om, probe_dofs)
    return SolidHarmonicResult(omegas=om, amplitude=np.abs(xs),
                               real=xs.real, imag=xs.imag)


def _geometric_blocks(problem: SolidProblem, u: torch.Tensor, device):
    """((m, 24, 24) geometric stiffness blocks of the stress state of u,
    the DOF map), float64 on `device`: int grad N_a . sigma . grad N_b dV
    on each displacement component, the full 3 x 3 stress at the Gauss
    points."""
    from ..ops.solid_plastic import gp_geometry3

    b, wdet = gp_geometry3(problem, device)     # (m, 8, 6, 24), (m, 8)
    young, nu = _material(problem, device, "young", "poisson")
    _, dm = _elements(problem, device)
    eps = torch.einsum("mgia,ma->mgi", b, u[dm])
    sig = torch.einsum("mij,mgj->mgi", _dmat3(young, nu), eps)
    # Shape gradients sit inside B: row 0 holds dN/dx at columns 3a, row 1
    # dN/dy at 3a+1, row 2 dN/dz at 3a+2.
    g = torch.stack([b[:, :, 0, 0::3], b[:, :, 1, 1::3],
                     b[:, :, 2, 2::3]], dim=2)            # (m, 8, 3, 8)
    sxx, syy, szz = sig[..., 0], sig[..., 1], sig[..., 2]
    syz, sxz, sxy = sig[..., 3], sig[..., 4], sig[..., 5]
    sigm = torch.stack([torch.stack([sxx, sxy, sxz], dim=-1),
                        torch.stack([sxy, syy, syz], dim=-1),
                        torch.stack([sxz, syz, szz], dim=-1)], dim=-2)
    s_ab = torch.einsum("mgia,mgij,mgjb,mg->mab", g, sigm, g, wdet)
    kg = torch.zeros((problem.nelm, 24, 24), dtype=_F64, device=device)
    for c in range(3):
        kg[:, c::3, c::3] = s_ab
    return kg, dm


def _geometric(problem: SolidProblem, u: torch.Tensor,
               device) -> torch.Tensor:
    return _assemble3(problem, *_geometric_blocks(problem, u, device))


def solid_geometric_stiffness(problem: SolidProblem, u,
                              device=None) -> torch.Tensor:
    """Dense geometric (initial-stress) stiffness K_g(sigma(u)), float64
    on `device` ("cuda" when None)."""
    dev = resolve_device(device)
    return _geometric(problem, _t(u, dev), dev)


@dataclass
class SolidBucklingResult:
    load_factors: np.ndarray     # (n_modes,) ascending positive lambda
    modes: np.ndarray            # (n_modes, 3n)
    von_mises: np.ndarray        # (m,) base-state centroid vM


def solid_buckling(problem: SolidProblem, n_modes: int = 4,
                   device=None) -> SolidBucklingResult:
    """Linearized continuum buckling, float64 on `device` ("cuda" when
    None): the static base state, K_g(sigma), and the symmetric pencil
    -K_g phi = mu K phi on the free block through K_ff's Cholesky factor;
    lambda = 1/mu for the largest positive mu (those above 1e-12 of the
    largest |mu|)."""
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
    return SolidBucklingResult(load_factors=1.0 / mu_h[order],
                               modes=_numpy(modes),
                               von_mises=stat.von_mises)


# --------------------------------------------------------------------
# Mesh generation and surface loads (numpy, the JAX package's numbering)


def box_mesh(lx: float, ly: float, lz: float, nx: int, ny: int, nz: int):
    """Structured hex8 box: nodes ((nx+1)(ny+1)(nz+1), 3) with x-fastest
    numbering (id = ix + (nx+1)(iy + (ny+1) iz), the banded order),
    elements (nx ny nz, 8)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([gx, gy, gz], axis=-1).transpose(2, 1, 0, 3
                                                      ).reshape(-1, 3)
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    n0 = (ix + (nx + 1) * (iy + (ny + 1) * iz)).transpose(2, 1, 0
                                                          ).reshape(-1)
    nx1, nxy = nx + 1, (nx + 1) * (ny + 1)
    off = np.array([0, 1, 1 + nx1, nx1, nxy, nxy + 1, nxy + 1 + nx1,
                    nxy + nx1])
    return nodes, (n0[:, None] + off[None, :]).astype(int)


def boundary_quads(problem: SolidProblem, axis: int, side: int,
                   tol: float = 1e-9) -> np.ndarray:
    """(q, 4) node-id quads of the element faces lying on the domain
    boundary plane axis = min/max (side = -1/+1): every node of the face
    template must sit on the plane."""
    coord = problem.nodes[:, axis]
    target = coord.min() if side < 0 else coord.max()
    span = max(float(coord.max() - coord.min()), 1.0)
    on_plane = np.abs(coord - target) <= tol * span
    local = _FACES3[(axis, -1 if side < 0 else +1)]
    face_nodes = problem.elements[:, local]      # (m, 4)
    sel = np.all(on_plane[face_nodes], axis=1)
    return face_nodes[sel]


def surface_load(nodes: np.ndarray, quads: np.ndarray, traction,
                 ndof: Optional[int] = None) -> np.ndarray:
    """(3n,) consistent nodal loads of a uniform traction [tx, ty, tz]
    (force/area) over bilinear quad facets: 2 x 2 Gauss on each face with
    |dA| = |x_xi x x_eta| (exact for planar faces)."""
    quads = np.asarray(quads, dtype=int)
    t = np.asarray(traction, dtype=float).reshape(3)
    f = np.zeros(3 * nodes.shape[0] if ndof is None else ndof)
    xq = nodes[quads]                            # (q, 4, 3)
    xa, ea = _CORNERS3[:4, 0], _CORNERS3[:4, 1]  # quad corner signs
    g = 1.0 / np.sqrt(3.0)
    for xi, eta in [(-g, -g), (g, -g), (g, g), (-g, g)]:
        n = 0.25 * (1.0 + xa * xi) * (1.0 + ea * eta)        # (4,)
        dnx = 0.25 * xa * (1.0 + ea * eta)
        dne = 0.25 * ea * (1.0 + xa * xi)
        tx = np.einsum("n,qnc->qc", dnx, xq)     # (q, 3) x_xi
        te = np.einsum("n,qnc->qc", dne, xq)     # (q, 3) x_eta
        da = np.linalg.norm(np.cross(tx, te), axis=1)        # (q,)
        fe = da[:, None, None] * n[None, :, None] * t[None, None, :]
        np.add.at(f, (3 * quads[:, :, None] + np.arange(3)).reshape(-1),
                  fe.reshape(-1))
    return f


def extrude_mesh(nodes2d: np.ndarray, quads: np.ndarray, thickness: float,
                 nz: int = 1):
    """Extrude a 2D quad mesh (CCW quads) into `nz` hex8 layers of total
    `thickness` along +z: node l * n2d + i is 2D node i at layer l."""
    nodes2d = np.asarray(nodes2d, dtype=float)
    quads = np.asarray(quads, dtype=int)
    if quads.ndim != 2 or quads.shape[1] != 4:
        raise ValueError("extrude_mesh needs (m, 4) quads")
    n2d = nodes2d.shape[0]
    zs = np.linspace(0.0, float(thickness), nz + 1)
    nodes = np.concatenate([
        np.concatenate([nodes2d, np.full((n2d, 1), z)], axis=1)
        for z in zs])
    elems = [np.concatenate([quads + l * n2d, quads + (l + 1) * n2d],
                            axis=1) for l in range(nz)]
    return nodes, np.concatenate(elems, axis=0)


# --------------------------------------------------------------------
# The banded tier (large meshes): the DIA pipeline with hex8 blocks


def solid_dia_layout(problem: SolidProblem):
    """The problem's DIA layout (ops/dia.dia_layout of its DOF map, at most
    160 diagonals), built on the host once and kept on the instance: it
    depends only on the connectivity, fixed at construction."""
    from ..ops.dia import dia_layout

    layout = getattr(problem, "_dia_layout_cache", None)
    if layout is None:
        layout = dia_layout(problem.dof_map(), problem.ndof,
                            max_diags=_SOLID_MAX_DIAGS)
        problem._dia_layout_cache = layout
    return layout


def _banded_operator(problem: SolidProblem, dtype, dev):
    """(layout, diagonals in dtype, mask) on `dev`: float64 blocks, one
    float64 scatter into DIA storage, rounded once."""
    from ..ops.dia import assemble_dia_blocks

    layout = solid_dia_layout(problem)
    diags = assemble_dia_blocks(layout, _stiffness_blocks3(problem, dev)
                                ).to(dtype).contiguous()
    return layout, diags, _t(problem.free_mask(), dev, dtype)


def solve_solid_static_banded(problem: SolidProblem, tol: float = 1e-7,
                              max_iter: int = 50000,
                              precond: str = "jacobi", dtype=None,
                              mesh=None, device=None):
    """Large-mesh solid statics on `device` ("cuda" when None) in `dtype`
    (the working dtype when None): float64 blocks scattered once into DIA
    storage, the Jacobi-PCG of ops/dia.dia_cg_solve with components=3 (on
    a card the fused kernels 2-3), the reactions by one matvec (kernel 1).
    precond "mg" takes the banded multigrid.  mesh= (a device mesh) is
    ROADMAP item 15's multi-device row and raises.

    Returns (SolidStaticResult, iterations, relative recurrence residual);
    the stresses are recovered on the host from one fetch of u."""
    from ..ops.dia import dia_cg_solve, dia_matvec
    from ..parallel import refuse_mesh

    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("the banded path supports homogeneous "
                         "supports only")
    refuse_mesh(mesh, "the banded solid solve")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    f = _loads(problem, dev).to(dtype)
    x, iters, rel = dia_cg_solve(layout, diags, f, mask, tol=float(tol),
                                 max_iter=int(max_iter), precond=precond,
                                 components=3)
    reac = (dia_matvec(layout, diags, x) - f) * (1.0 - mask)
    u = x.double().cpu()
    res = _static_result(problem, u, reac.double().cpu())
    return res, int(iters), float(rel)


def _lumped_mass(problem: SolidProblem, device) -> torch.Tensor:
    """(3n,) row-sum lumped mass, float64 on `device`: for trilinear
    shapes sum_b N_a N_b = N_a, so each node takes int density N_a dV;
    point masses add per node."""
    coords, _ = _elements(problem, device)
    (rho,) = _material(problem, device, "density")
    elements = torch.as_tensor(problem.elements, dtype=torch.int64,
                               device=device)
    share = torch.zeros((problem.nelm, 8), dtype=_F64, device=device)
    for xi, eta, zeta in _GP3:
        n = _t(_hex_n(xi, eta, zeta), device)
        _, det = _hex_point(coords, xi, eta, zeta)
        share += (rho * det)[:, None] * n[None, :]
    m_node = scatter_add(problem.nodes.shape[0], elements, share)
    if problem.point_masses is not None:
        m_node = m_node + _t(problem.point_masses, device)
    return torch.repeat_interleave(m_node, 3)


def solid_lumped_mass_diag(problem: SolidProblem,
                           device=None) -> np.ndarray:
    """(3n,) row-sum (partition-of-unity) lumped mass: the exact integral
    of density N_a at each node (positive for every hex8, total mass
    preserved), point masses added; float64 on `device` ("cuda" when
    None), returned as numpy."""
    return _numpy(_lumped_mass(problem, resolve_device(device)))


def solid_modal_banded(problem: SolidProblem, n_modes: int = 4,
                       n_iter: int = 30, cg_tol: float = 1e-7,
                       seed: int = 0, dtype=None, mesh=None,
                       device=None) -> SolidModalResult:
    """Large-mesh 3D modal analysis on `device` ("cuda" when None) in the
    working dtype: inverse subspace iteration
    (solvers/modal._subspace_iteration) on the banded hex8 operator with
    row-sum lumped mass, each block solve a fused PCG on a card (kernels
    1-3).  Lumped-mass frequencies converge from below under refinement,
    the consistent dense tier's from above.  mesh= raises (item 15)."""
    from ..parallel import refuse_mesh
    from ..solvers.modal import _subspace_iteration

    refuse_mesh(mesh, "the banded solid modal analysis")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    if dev.type == "cuda":
        require_float32(dtype, "banded solid modal analysis (kernels 1-3)")
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    m_diag = _lumped_mass(problem, dev).to(dtype) * mask + (1.0 - mask)
    w, y, _change = _subspace_iteration(
        layout, diags, m_diag, mask, int(n_modes), int(n_iter), cg_tol,
        int(seed), int(problem.free_dofs().size))
    lam = np.maximum(w.cpu().numpy().astype(float), 0.0)
    return _modal_result(lam, _numpy((y * mask[:, None]).T))


def solid_stable_dt(problem: SolidProblem, safety: float = 0.9,
                    damping=(0.0, 0.0), device=None) -> float:
    """Gershgorin bound on the explicit critical step for the hex8 mesh:
    omega_max^2 <= max_i sum_j |K_ij| / m_i over free rows, m the row-sum
    lumped mass (solid_lumped_mass_diag), with the all-rows fallback;
    Rayleigh damping shrinks it, dt = (2/w)(sqrt(1 + zeta^2) - zeta),
    zeta = alpha/2w + beta w/2.  Float64 on `device` ("cuda" when None),
    the row sums of |K| from the element blocks (no dense K)."""
    dev = resolve_device(device)
    _, dm = _elements(problem, dev)
    row = abs_row_sums(problem.ndof, dm, _stiffness_blocks3(problem, dev)) \
        / _lumped_mass(problem, dev)
    return gershgorin_dt(_numpy(row), problem.free_mask(), safety, damping)


def solve_solid_transient_banded(problem: SolidProblem, dt: float,
                                 n_steps: int, amplitude=None,
                                 damping=(0.0, 0.0), probe_dofs=None,
                                 record_every: int = 1, dtype=None,
                                 device=None) -> SolidTransientResult:
    """Large-mesh 3D explicit dynamics on `device` ("cuda" when None) in
    the working dtype: central difference (solvers/dynamics._central_run)
    on the banded hex8 operator, K u = kernel 1 on a card, with row-sum
    lumped mass.  The step loop reads nothing on the host; the probes are
    fetched once.  Kernel 1 launches 1 + n + 2 n / record_every times with
    beta = 0 (the start, a step each, and each record's centred-velocity
    peek and strain energy), 2 + 2n + 3 n / record_every with beta != 0."""
    from ..ops.kernels.dia_kernel import dia_matvec
    from ..solvers.dynamics import _central_run, _np_float, _Records

    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    if problem.prescribed is not None and np.any(problem.prescribed):
        raise ValueError("transient supports homogeneous supports only")
    _require_no_thermal3(problem, "transient")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    if dev.type == "cuda":
        require_float32(dtype, "banded solid transient (kernel 1: "
                        "dia_matvec)")
    npf = _np_float(dtype)
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    m_diag = _lumped_mass(problem, dev).to(dtype) * mask + (1.0 - mask)
    loads = (_t(problem.loads, dev)
             + _body_force_vectors3(problem, dev)).to(dtype)
    amp = (np.ones(n_steps) if amplitude is None
           else np.broadcast_to(np.asarray(amplitude, dtype=float),
                                (n_steps,))).astype(npf)
    probe = torch.as_tensor(
        np.arange(problem.ndof) if probe_dofs is None
        else np.asarray(probe_dofs, dtype=int).reshape(-1),
        dtype=torch.int64, device=dev)
    n_rec = n_steps // record_every
    alpha, beta = float(npf(damping[0])), float(npf(damping[1]))

    def k_apply(u):
        return dia_matvec(layout, diags, u * mask) * mask

    def force(i):
        return float(amp[min(i, n_steps - 1)]) * loads

    records = _Records(n_rec, probe, mask)
    zeros = torch.zeros_like(mask)
    _central_run(k_apply, m_diag, mask, force, float(npf(dt)), alpha, beta,
                 zeros, zeros, records, n_rec, record_every)
    times = dt * record_every * np.arange(1, n_rec + 1)
    return SolidTransientResult(
        times=times, displacements=records.us.cpu().numpy().astype(float),
        velocities=records.vs.cpu().numpy().astype(float), dt=float(dt),
        n_steps=int(n_steps))


def identify_solid_young_banded(problem: SolidProblem, measured_dofs,
                                measured_disp, n_iter: int = 300,
                                learning_rate: float = 0.05,
                                tol: float = 1e-7, max_iter: int = 20000,
                                zones=None, field: bool = False,
                                seed: int = 0, hidden_layers: int = 2,
                                neurons_per_layer: int = 16, device=None):
    """Young-modulus identification on the hex8 family through the banded
    adjoint (solvers/banded_inverse.identify_young_banded; only the hex8
    block builder is solid-specific): zones (one log-E per zone),
    field=True (E(x, y, z) MLP at the centroids, input_dim 3), the default
    per-element log-E.  device: where to solve ("cuda" when None).
    Returns (young (m,), loss_history, mlp_field_or_None)."""
    from ..solvers.banded_inverse import identify_young_banded

    dev = resolve_device(device)
    coords, _ = _elements(problem, dev)
    (nu,) = _material(problem, dev, "poisson")

    def blocks_of(young_e):
        return _k_blocks3(coords, _dmat3(young_e.to(torch.float64), nu))

    return identify_young_banded(
        solid_dia_layout(problem), blocks_of, problem.young,
        problem.coords().mean(axis=1),
        problem.loads + _body_force_vectors3(problem).numpy(),
        problem.free_mask(), measured_dofs, measured_disp, n_iter=n_iter,
        learning_rate=learning_rate, tol=tol, max_iter=max_iter,
        zones=zones, field=field, seed=seed, hidden_layers=hidden_layers,
        neurons_per_layer=neurons_per_layer, input_dim=3,
        device=dev)


def solid_static_response(problem: SolidProblem, young_e=None,
                          poisson_e=None, loads=None, load_scale=None,
                          dtype=None, device=None):
    """Differentiable solid statics with per-element properties (the JAX
    package's traced twin): (u, centroid stresses (m, 6), von Mises (m,))
    from the masked dense solve K(E, nu) u = f (float64 blocks, one
    float64 scatter rounded once to `dtype`) and the centroid recovery in
    `dtype`.  A temperature load case is refused, as in the JAX package.
    device: "cuda" when None."""
    from ..solvers.banded_inverse import dense_masked_solve

    if problem.temperature is not None:
        raise ValueError("solid_static_response does not take a "
                         "temperature load case (traced f_th not "
                         "implemented — run the host static instead)")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    m = problem.nelm

    def prop(v, name):
        return torch.broadcast_to(_t(getattr(problem, name) if v is None
                                     else v, dev), (m,))

    young, nu = prop(young_e, "young"), prop(poisson_e, "poisson")
    coords, dm = _elements(problem, dev)
    dmat = _dmat3(young, nu)
    blocks = _k_blocks3(coords, dmat)
    if loads is None:
        f = (_t(problem.loads, dev) + _body_force_vectors3(problem, dev)
             ).to(dtype)
    else:
        f = _t(loads, dev, dtype)
    if load_scale is not None:
        f = f * _t(load_scale, dev, dtype)
    mask = _t(problem.free_mask(), dev, dtype)
    u_p = None
    if problem.prescribed is not None:
        u_p_np = np.zeros(problem.ndof)
        u_p_np[problem.fixed_dofs] = problem.prescribed
        u_p = _t(u_p_np, dev, dtype)
    u = dense_masked_solve(blocks, dm, problem.ndof, f, mask, u_p)
    b = _centroid_b3(problem, dev).to(dtype)
    eps = torch.einsum("mia,ma->mi", b, u[dm])
    sig = torch.einsum("mij,mj->mi", dmat.to(dtype), eps)
    sxx, syy, szz = sig[:, 0], sig[:, 1], sig[:, 2]
    syz, sxz, sxy = sig[:, 3], sig[:, 4], sig[:, 5]
    vm = torch.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                           + (szz - sxx) ** 2)
                    + 3.0 * (sxy ** 2 + syz ** 2 + sxz ** 2))
    return u, sig, vm
