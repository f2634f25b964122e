"""2D Euler-Bernoulli frame elements (counterpart of
pinn_fem_tpu/models/frame.py).

Three DOFs a node (u, v, theta), linear axial and cubic Hermite bending
interpolation, exact within Euler-Bernoulli theory for nodal loads (one
element reproduces the PL^3/3EI cantilever tip to machine precision).

Element matrices (local axes, DOFs [u1 v1 t1 u2 v2 t2], closed forms):

    axial     EA/L  [[1, -1], [-1, 1]]                     on (u1, u2)
    bending   EI/L^3 [[ 12,  6L,  -12,  6L],
                      [ 6L, 4L^2, -6L, 2L^2],
                      [-12, -6L,   12, -6L],
                      [ 6L, 2L^2, -6L, 4L^2]]    on (v1, t1, v2, t2)
    mass      rho A L / 420 consistent (156 / 22L / 54 / -13L ...), axial
              rho A L / 6 [[2, 1], [1, 2]]
    geometric N / (30 L) (36 / 3L / -36 / 3L ...)   (P-Delta, buckling)

The element library (`_geometry`, `_rotation`, `_k_local`, `_m_local`,
`_kg_local`, the member and thermal load vectors) is plain functions on
float64 tensors, batched over members.  The dense analyses (statics,
modal with prestress, buckling, Newmark, harmonic) assemble K and M by one
float64 scatter on the caller's device, the card by default, and solve
there (the JAX package's host tier is numpy float64); their results are
numpy float64, as in the JAX package.

`solve_frame_static_banded` is the large-mesh statics: the float64 T'KT
blocks scattered once into DIA storage and rounded once, the Jacobi-PCG of
ops/dia.dia_cg_solve with components=3 (on a card the fused kernels 1-3),
the reactions by one matvec (kernel 1), and the member end forces on the
host from one fetch.  `frame_modal_banded` is inverse subspace iteration
on that operator with the HRZ-lumped mass.

`identify_frame_properties` recovers a per-member I (or E) profile from
measured static displacements: ADAM on log-values through the dense
masked solve of the T'KT blocks (solvers/banded_inverse.py), the JAX
module's traced `frame_static_response` forward.  `frame_static_response`
is that forward as a function (u, end moments, axial forces, each
differentiable in per-member E, A, I and a load scale); on it run the
design functions: `optimize_frame_inertia` (the minimum-weight inertia
profile under a deflection limit, `_al_minimize`'s augmented Lagrangian),
`optimize_frame_inertia_rbdo` (its RBDO form) and `frame_reliability`
(FORM through solvers/reliability.form_core).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..utils.runtime import default_dtype, require_float32, resolve_device
from .plane import (_free_index, _general_eigh, _material, _numpy, _t,
                    harmonic_solves)

_F64 = torch.float64


@dataclass
class FrameProblem:
    """2D frame: nodes (n, 2), elements (m, 2), per-element E / A / I / rho
    (scalars broadcast), nodal loads (3n,) as [Fx, Fy, M]*n, fixed DOFs on
    the numbering u_i = 3i, v_i = 3i+1, theta_i = 3i+2; optional per-node
    translational point masses, uniform member loads [wx, wy] in global
    axes (m, 2), an elastic section modulus (m,) for the extreme-fiber
    stress, and a static thermal load case: alpha_cte with a uniform member
    dT (temperature) and / or a through-depth gradient dT/dy
    (temperature_gradient).  Numpy arrays, as the JAX package's problem
    holds them."""
    nodes: np.ndarray
    elements: np.ndarray
    young: np.ndarray          # (m,) or scalar
    area: np.ndarray
    inertia: np.ndarray        # second moment I
    density: np.ndarray
    loads: np.ndarray          # (3n,)
    fixed_dofs: np.ndarray
    point_masses: Optional[np.ndarray] = None   # (n,) translational
    member_loads: Optional[np.ndarray] = None   # (m, 2) global [wx, wy]
    section_modulus: Optional[np.ndarray] = None
    alpha_cte: Optional[np.ndarray] = None
    temperature: Optional[np.ndarray] = None
    temperature_gradient: Optional[np.ndarray] = None

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=float)
        self.elements = np.asarray(self.elements, dtype=int)
        m = self.elements.shape[0]
        for name in ("young", "area", "inertia", "density"):
            v = np.broadcast_to(
                np.asarray(getattr(self, name), dtype=float), (m,))
            setattr(self, name, np.array(v))
        self.loads = np.asarray(self.loads, dtype=float)
        self.fixed_dofs = np.asarray(self.fixed_dofs,
                                     dtype=int).reshape(-1)
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 2:
            raise ValueError("frame nodes must be (n, 2)")
        if self.loads.shape != (3 * self.nnode,):
            raise ValueError(f"frame loads must be (3*{self.nnode},)")
        if self.fixed_dofs.size and (self.fixed_dofs.min() < 0
                                     or self.fixed_dofs.max()
                                     >= self.ndof):
            raise ValueError("fixed_dofs out of range")
        if self.point_masses is not None:
            self.point_masses = np.broadcast_to(
                np.asarray(self.point_masses, dtype=float),
                (self.nnode,)).copy()
        if self.member_loads is not None:
            self.member_loads = np.broadcast_to(
                np.asarray(self.member_loads, dtype=float),
                (self.nelm, 2)).copy()
        if self.section_modulus is not None:
            self.section_modulus = np.broadcast_to(
                np.asarray(self.section_modulus, dtype=float),
                (self.nelm,)).copy()
            if np.any(self.section_modulus <= 0.0):
                raise ValueError("section_modulus must be positive")
        if (self.temperature is not None
                or self.temperature_gradient is not None) \
                and self.alpha_cte is None:
            raise ValueError('a thermal load case needs the thermal '
                             'expansion coefficient (material '
                             '"alpha")')
        for name in ("alpha_cte", "temperature",
                     "temperature_gradient"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, np.broadcast_to(
                    np.asarray(v, dtype=float), (self.nelm,)).copy())
        if bool(torch.any(_geometry(self)[0] <= 0.0)):
            raise ValueError("zero-length frame element")

    @property
    def nnode(self) -> int:
        return self.nodes.shape[0]

    @property
    def nelm(self) -> int:
        return self.elements.shape[0]

    @property
    def ndof(self) -> int:
        return 3 * self.nnode

    def free_mask(self) -> np.ndarray:
        m = np.ones(self.ndof)
        m[self.fixed_dofs] = 0.0
        return m

    def free_dofs(self) -> np.ndarray:
        return np.setdiff1d(np.arange(self.ndof), self.fixed_dofs)

    def dof_map(self) -> np.ndarray:
        """(m, 6) global DOF indices per element."""
        i, j = self.elements[:, 0], self.elements[:, 1]
        return np.stack([3 * i, 3 * i + 1, 3 * i + 2,
                         3 * j, 3 * j + 1, 3 * j + 2], axis=1)


# --------------------------------------------------------------------
# The element library, batched over members, float64 tensors


def _geometry(problem: FrameProblem, device=None):
    """(length, c, s) (m,) float64 on `device` (CPU when None)."""
    nodes = _t(problem.nodes, device)
    el = torch.as_tensor(problem.elements, dtype=torch.int64, device=device)
    d = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = torch.hypot(d[:, 0], d[:, 1])
    pos = length > 0.0
    c = torch.where(pos, d[:, 0] / length, torch.ones_like(length))
    s = torch.where(pos, d[:, 1] / length, torch.zeros_like(length))
    return length, c, s


def _rotation(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(m, 6, 6) local <- global transformation."""
    t = torch.zeros((c.shape[0], 6, 6), dtype=c.dtype, device=c.device)
    for off in (0, 3):
        t[:, off + 0, off + 0] = c
        t[:, off + 0, off + 1] = s
        t[:, off + 1, off + 0] = -s
        t[:, off + 1, off + 1] = c
        t[:, off + 2, off + 2] = 1.0
    return t


_BEND = (1, 2, 4, 5)      # (v1, t1, v2, t2) rows / columns


def _fill4(mat: torch.Tensor, rows, block: torch.Tensor) -> None:
    """mat[:, rows, rows] += block (m, 4, 4), in place."""
    idx = torch.as_tensor(rows, device=mat.device)
    mat[:, idx[:, None], idx[None, :]] += block


def _sym4(a, b, c, d, e, f, g, h, i, j):
    """(m, 4, 4) symmetric block [[a, b, c, d], [b, e, f, g],
    [c, f, h, i], [d, g, i, j]]."""
    return torch.stack([torch.stack([a, b, c, d], dim=-1),
                        torch.stack([b, e, f, g], dim=-1),
                        torch.stack([c, f, h, i], dim=-1),
                        torch.stack([d, g, i, j], dim=-1)], dim=-2)


def _hermite_k(ei: torch.Tensor, length: torch.Tensor,
               sign: float = 1.0) -> torch.Tensor:
    """(m, 4, 4) Hermite bending stiffness; sign flips the v-theta coupling
    terms (+1 in the x-y plane, -1 in x-z)."""
    b12 = 12.0 * ei / length ** 3
    b6 = sign * 6.0 * ei / length ** 2
    b4 = 4.0 * ei / length
    b2 = 2.0 * ei / length
    return _sym4(b12, b6, -b12, b6, b4, -b6, b2, b12, -b6, b4)


def _hermite_m(rho_al: torch.Tensor, length: torch.Tensor,
               sign: float = 1.0) -> torch.Tensor:
    """(m, 4, 4) consistent Hermite mass (rho A L / 420), same sign rule."""
    f = rho_al / 420.0
    l1 = sign * length
    return _sym4(156.0 * f, 22.0 * f * l1, 54.0 * f, -13.0 * f * l1,
                    4.0 * f * length ** 2, 13.0 * f * l1,
                    -3.0 * f * length ** 2, 156.0 * f, -22.0 * f * l1,
                    4.0 * f * length ** 2)


def _hermite_g(axial_n: torch.Tensor, length: torch.Tensor,
               sign: float = 1.0) -> torch.Tensor:
    """(m, 4, 4) geometric stiffness N / (30 L) (36, 3L, 4L^2, -L^2),
    same sign rule."""
    f = axial_n / (30.0 * length)
    l1 = sign * length
    return _sym4(36.0 * f, 3.0 * f * l1, -36.0 * f, 3.0 * f * l1,
                    4.0 * f * length ** 2, -3.0 * f * l1, -f * length ** 2,
                    36.0 * f, -3.0 * f * l1, 4.0 * f * length ** 2)


def _k_local(young, area, inertia, length) -> torch.Tensor:
    """(m, 6, 6) local stiffness (closed form)."""
    ea = young * area / length
    k = torch.zeros((length.shape[0], 6, 6), dtype=length.dtype,
                    device=length.device)
    k[:, 0, 0] = k[:, 3, 3] = ea
    k[:, 0, 3] = k[:, 3, 0] = -ea
    _fill4(k, _BEND, _hermite_k(young * inertia, length))
    return k


def _m_local(density, area, length) -> torch.Tensor:
    """(m, 6, 6) consistent mass (rho A L / 420 closed form + axial
    rho A L / 6)."""
    rho_al = density * area * length
    mm = torch.zeros((length.shape[0], 6, 6), dtype=length.dtype,
                     device=length.device)
    ax = rho_al / 6.0
    mm[:, 0, 0] = mm[:, 3, 3] = 2.0 * ax
    mm[:, 0, 3] = mm[:, 3, 0] = ax
    _fill4(mm, _BEND, _hermite_m(rho_al, length))
    return mm


def _kg_local(axial_n, length) -> torch.Tensor:
    """(m, 6, 6) geometric stiffness from member axial force N (tension
    positive; N / (30 L) closed form)."""
    kg = torch.zeros((length.shape[0], 6, 6), dtype=length.dtype,
                     device=length.device)
    _fill4(kg, _BEND, _hermite_g(axial_n, length))
    return kg


def _to_global(t: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """T' B T for (m, w, w) blocks."""
    return torch.einsum("mji,mjk,mkl->mil", t, local, t)


def _scatter_vec(problem, f_loc: torch.Tensor, t: torch.Tensor
                 ) -> torch.Tensor:
    """(ndof,) sum over members of T' f_local, float64 on f_loc's device."""
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                         device=f_loc.device)
    return scatter_add(problem.ndof, dm,
                       torch.einsum("mji,mj->mi", t, f_loc))


def _member_load_vectors(problem: FrameProblem, device=None):
    """(f_nodal (3n,), f_fixed_local (m, 6)) of uniform member loads: the
    consistent [wL/2, wL^2/12] pair of the local transverse load at each
    end (moments opposing) and qL/2 of the axial one; the recovery
    subtracts f_fixed_local from k_local T u_e."""
    f_loc = torch.zeros((problem.nelm, 6), dtype=_F64, device=device)
    if problem.member_loads is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device), f_loc
    length, c, s = _geometry(problem, device)
    w_glob = _t(problem.member_loads, device)
    q = c * w_glob[:, 0] + s * w_glob[:, 1]
    w = -s * w_glob[:, 0] + c * w_glob[:, 1]
    f_loc[:, 0] = f_loc[:, 3] = q * length / 2.0
    f_loc[:, 1] = f_loc[:, 4] = w * length / 2.0
    f_loc[:, 2] = w * length ** 2 / 12.0
    f_loc[:, 5] = -w * length ** 2 / 12.0
    return _scatter_vec(problem, f_loc, _rotation(c, s)), f_loc


def _thermal_member_vectors(problem: FrameProblem, device=None):
    """(f_nodal (3n,), f_fixed_local (m, 6)) of the thermal load case: a
    uniform dT pushes the ends outward by EA alpha dT, a gradient dT/dy
    gives the end-moment pair EI alpha dT/dy [-1, +1] (restrained members
    recover N = -EA alpha dT and |M| = EI alpha dT/dy exactly)."""
    f_loc = torch.zeros((problem.nelm, 6), dtype=_F64, device=device)
    if problem.temperature is None \
            and problem.temperature_gradient is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device), f_loc
    young, area, inertia, alpha = _material(
        problem, device, "young", "area", "inertia", "alpha_cte")
    if problem.temperature is not None:
        na = young * area * alpha * _t(problem.temperature, device)
        f_loc[:, 0] -= na
        f_loc[:, 3] += na
    if problem.temperature_gradient is not None:
        mk = young * inertia * alpha * _t(problem.temperature_gradient,
                                          device)
        f_loc[:, 2] -= mk
        f_loc[:, 5] += mk
    _, c, s = _geometry(problem, device)
    return _scatter_vec(problem, f_loc, _rotation(c, s)), f_loc


def _static_loads(problem: FrameProblem, device):
    """(f (3n,), f_fixed (m, 6)): nodal + member + thermal loads and the
    fixed-end vectors the member-force recovery subtracts."""
    f_member, f_fixed = _member_load_vectors(problem, device)
    f_th, f_th_fixed = _thermal_member_vectors(problem, device)
    return (_t(problem.loads, device) + f_member + f_th,
            f_fixed + f_th_fixed)


def _require_no_thermal_frame(problem: FrameProblem, kind: str):
    """The dynamic analyses refuse a thermal load case: its load is
    static."""
    if problem.temperature is not None \
            or problem.temperature_gradient is not None:
        raise ValueError(
            f"frame {kind} does not take a thermal load case — "
            "thermoelastic loads are static; use analysis type "
            '"static" (or "modal"/"buckling" with prestress, which '
            "inherit ΔT through the static state)")


def _assemble(ndof: int, dof_map: np.ndarray,
              blocks: torch.Tensor) -> torch.Tensor:
    """(m, w, w) global-axes blocks -> dense (ndof, ndof), one float64
    scatter on the blocks' device."""
    dm = torch.as_tensor(dof_map, dtype=torch.int64, device=blocks.device)
    flat = dm[:, :, None] * ndof + dm[:, None, :]
    return scatter_add(ndof * ndof, flat, blocks).reshape(ndof, ndof)


def _local_stiffness(problem: FrameProblem, device):
    """(k_local (m, 6, 6), T (m, 6, 6)) float64 on `device`."""
    length, c, s = _geometry(problem, device)
    young, area, inertia = _material(problem, device, "young", "area",
                                     "inertia")
    return _k_local(young, area, inertia, length), _rotation(c, s)


def _matrices(problem: FrameProblem, with_mass: bool, device):
    kl, t = _local_stiffness(problem, device)
    dm = problem.dof_map()
    k = _assemble(problem.ndof, dm, _to_global(t, kl))
    mmat = None
    if with_mass:
        length, _, _ = _geometry(problem, device)
        rho, area = _material(problem, device, "density", "area")
        mmat = _assemble(problem.ndof, dm,
                         _to_global(t, _m_local(rho, area, length)))
        if problem.point_masses is not None:
            pm = torch.zeros(problem.ndof, dtype=_F64, device=device)
            pmn = _t(problem.point_masses, device)
            pm[0::3] += pmn
            pm[1::3] += pmn
            mmat = mmat + torch.diag(pm)
    return k, mmat


def frame_matrices(problem: FrameProblem, with_mass: bool = True,
                   device=None):
    """(K, M) dense global float64 tensors on `device` ("cuda" when None);
    M is None unless with_mass.  The one assembly every dense frame
    analysis shares."""
    return _matrices(problem, with_mass, resolve_device(device))


@dataclass
class FrameStaticResult:
    displacements: np.ndarray      # (3n,)
    member_end_forces: np.ndarray  # (m, 6) LOCAL [N1,V1,M1,N2,V2,M2]
    axial: np.ndarray              # (m,) axial force (tension +)
    moments: np.ndarray            # (m, 2) end bending moments
    reactions: np.ndarray          # (3n,) K u - f on fixed DOFs
    max_stress: Optional[np.ndarray] = None   # (m,) |N|/A + max|M|/S


def _end_forces(problem: FrameProblem, u: torch.Tensor,
                f_fixed: torch.Tensor) -> torch.Tensor:
    """(m, 6) local member end forces k_local T u_e - f_fixed, on u's
    device."""
    kl, t = _local_stiffness(problem, u.device)
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                         device=u.device)
    u_loc = torch.einsum("mij,mj->mi", t, u[dm])
    return torch.einsum("mij,mj->mi", kl, u_loc) - f_fixed


def _static_result(problem: FrameProblem, u: torch.Tensor,
                   f_fixed: torch.Tensor,
                   reactions: torch.Tensor) -> FrameStaticResult:
    f_loc = _end_forces(problem, u, f_fixed)
    max_stress = None
    if problem.section_modulus is not None:
        # Extreme-fiber stress at the governing end (the end moments
        # bound |M(x)| for nodal loading).
        m_max = f_loc[:, [2, 5]].abs().amax(dim=1)
        max_stress = _numpy(
            f_loc[:, 0].abs() / _t(problem.area, u.device)
            + m_max / _t(problem.section_modulus, u.device))
    f_np = _numpy(f_loc)
    return FrameStaticResult(
        displacements=_numpy(u), member_end_forces=f_np,
        axial=-f_np[:, 0], moments=f_np[:, [2, 5]],
        reactions=_numpy(reactions), max_stress=max_stress)


def _dense_static(problem: FrameProblem, device):
    """(u, K, f, f_fixed, mask) of the dense masked solve, float64 on
    `device`."""
    k, _ = _matrices(problem, False, device)
    mask = _t(problem.free_mask(), device)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    f, f_fixed = _static_loads(problem, device)
    u = torch.linalg.solve(km, f * mask) * mask
    return u, k, f, f_fixed, mask


def solve_frame_static(problem: FrameProblem,
                       device=None) -> FrameStaticResult:
    """Dense masked static solve and local member end-force recovery,
    float64 on `device` ("cuda" when None)."""
    u, k, f, f_fixed, mask = _dense_static(problem, resolve_device(device))
    return _static_result(problem, u, f_fixed, (k @ u - f) * (1.0 - mask))


@dataclass
class FrameModalResult:
    frequencies_hz: np.ndarray
    omegas: np.ndarray
    eigenvalues: np.ndarray
    mode_shapes: np.ndarray        # (n_modes, 3n)


def _modal_result(lam: np.ndarray, shapes: np.ndarray) -> FrameModalResult:
    om = np.sqrt(lam)
    return FrameModalResult(frequencies_hz=om / (2.0 * np.pi), omegas=om,
                            eigenvalues=lam, mode_shapes=shapes)


def _geometric(problem: FrameProblem, u: torch.Tensor) -> torch.Tensor:
    """Dense K_g(N(u)) on u's device: the member axial forces of the
    static recovery, then the Hermite K_g blocks."""
    _, f_fixed = _static_loads(problem, u.device)
    f_loc = _end_forces(problem, u, f_fixed)
    length, c, s = _geometry(problem, u.device)
    return _assemble(problem.ndof, problem.dof_map(), _to_global(
        _rotation(c, s), _kg_local(-f_loc[:, 0], length)))


def frame_geometric_stiffness(problem: FrameProblem, u,
                              device=None) -> torch.Tensor:
    """Dense P-Delta geometric stiffness K_g(N(u)), float64 on `device`
    ("cuda" when None): member axial forces recovered from u (the
    solve_frame_static recovery, fixed-end vectors included), then the
    cubic-Hermite K_g blocks."""
    dev = resolve_device(device)
    return _geometric(problem, _t(u, dev))


def _dense_modal(k: torch.Tensor, m: torch.Tensor, problem,
                 n_modes: int):
    """(eigenvalues (n_modes,), shapes (n_modes, ndof)) numpy of the
    pencil on the free block, scipy.linalg.eigh's normalization."""
    free = _free_index(problem, k.device)
    lam, vec = _general_eigh(k[free][:, free], m[free][:, free])
    n_modes = min(n_modes, lam.numel())
    lam = torch.clamp_min(lam[:n_modes], 0.0)
    shapes = torch.zeros((n_modes, problem.ndof), dtype=_F64,
                         device=k.device)
    shapes[:, free] = vec[:, :n_modes].T
    return _numpy(lam), _numpy(shapes)


def frame_modal(problem: FrameProblem, n_modes: int = 4, prestress_u=None,
                device=None) -> FrameModalResult:
    """Generalized K phi = lambda M phi on the free block (consistent mass),
    dense float64 on `device` ("cuda" when None), through M_ff's Cholesky
    factor.  prestress_u adds the P-Delta K_g(N(u0)): tension stiffens,
    compression softens toward the frame_buckling factor."""
    dev = resolve_device(device)
    k, m = _matrices(problem, True, dev)
    if prestress_u is not None:
        k = k + _geometric(problem, _t(prestress_u, dev))
    return _modal_result(*_dense_modal(k, m, problem, n_modes))


@dataclass
class FrameBucklingResult:
    load_factors: np.ndarray       # ascending positive lambda_cr
    modes: np.ndarray              # (n_modes, 3n)
    axial: np.ndarray              # (m,) member N at unit load


def _buckling_pencil(problem, k: torch.Tensor, kg: torch.Tensor,
                     n_modes: int):
    """(load factors, modes (n, ndof)) numpy of (K + lambda K_g) phi = 0 on
    the free block, through K_ff's Cholesky factor: the symmetric pencil
    -K_g phi = mu K phi, lambda = 1 / mu for the positive mu (those above
    1e-12 of the largest |mu|, and lambda > 1e-9), ascending lambda; the
    modes scaled to unit 2-norm (scipy.linalg.eig's)."""
    free = _free_index(problem, k.device)
    mu, vec = _general_eigh(-kg[free][:, free], k[free][:, free])
    mu_h = _numpy(mu)
    pos = np.flatnonzero((mu_h > 1e-12 * np.abs(mu_h).max())
                         & (mu_h < 1e9))
    order = pos[np.argsort(mu_h[pos])[::-1]][:n_modes]  # largest mu first
    sel = vec[:, torch.as_tensor(order, dtype=torch.int64, device=k.device)]
    sel = sel / torch.linalg.vector_norm(sel, dim=0, keepdim=True)
    modes = torch.zeros((order.size, problem.ndof), dtype=_F64,
                        device=k.device)
    modes[:, free] = sel.T
    return 1.0 / mu_h[order], _numpy(modes)


def frame_buckling(problem: FrameProblem, n_modes: int = 2,
                   device=None) -> FrameBucklingResult:
    """Linearized (P-Delta) buckling, float64 on `device` ("cuda" when
    None): statics gives the member axial forces N, K_g(N) is assembled,
    and (K + lambda K_g) phi = 0 on the free block; lambda_cr scales the
    applied load pattern."""
    dev = resolve_device(device)
    u, k, f, f_fixed, mask = _dense_static(problem, dev)
    stat = _static_result(problem, u, f_fixed, (k @ u - f) * (1.0 - mask))
    length, c, s = _geometry(problem, dev)
    kg = _assemble(problem.ndof, problem.dof_map(), _to_global(
        _rotation(c, s), _kg_local(_t(stat.axial, dev), length)))
    lam, modes = _buckling_pencil(problem, k, kg, n_modes)
    return FrameBucklingResult(load_factors=lam, modes=modes,
                               axial=stat.axial)


@dataclass
class FrameTransientResult:
    times: np.ndarray
    displacements: np.ndarray      # (n_rec, n_probe)
    dt: float
    n_steps: int


def _free_block(k, m, f0, problem, damping):
    """(K_ff, M_ff, C_ff, f_ff, free) of a dynamic analysis, Rayleigh C =
    alpha M + beta K."""
    alpha, beta = (float(damping[0]), float(damping[1]))
    c = alpha * m + beta * k
    free = _free_index(problem, k.device)
    return (k[free][:, free], m[free][:, free], c[free][:, free], f0[free],
            free)


def newmark_frame(kf, mf, cf, ff, free, ndof: int, dt: float, n_steps: int,
                  amplitude, probe_dofs, record_every: int):
    """The frame families' Newmark (average acceleration) on the dense free
    block, float64 on kf's device: one LU factorization of the effective
    stiffness serves every step, no host read in the loop.  A record after
    each step whose index is a multiple of record_every (the first step's
    included), at time (step + 1) dt.  Returns (times, rec_u) numpy."""
    dev = kf.device
    amp = (np.ones(n_steps) if amplitude is None
           else np.broadcast_to(np.asarray(amplitude, dtype=float),
                                (n_steps,)))
    a0 = 4.0 / dt ** 2
    a1 = 2.0 / dt
    lu, piv = torch.linalg.lu_factor(kf + a0 * mf + a1 * cf)
    probe = torch.as_tensor(
        np.arange(ndof) if probe_dofs is None
        else np.asarray(probe_dofs, dtype=int).reshape(-1),
        dtype=torch.int64, device=dev)
    n = free.numel()
    u = torch.zeros(n, dtype=_F64, device=dev)
    v = torch.zeros_like(u)
    a_acc = (torch.linalg.solve(mf, ff * float(amp[0])) if n
             else torch.zeros_like(u))
    steps = np.arange(0, n_steps, record_every)
    rec_u = torch.empty((steps.size, probe.numel()), dtype=_F64, device=dev)
    full = torch.zeros(ndof, dtype=_F64, device=dev)
    r = 0
    for step in range(n_steps):
        f_t = ff * float(amp[min(step + 1, n_steps - 1)])
        rhs = f_t + mf @ (a0 * u + 2.0 * a1 * v + a_acc) \
            + cf @ (a1 * u + v)
        u_new = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
        v_new = a1 * (u_new - u) - v
        a_new = a0 * (u_new - u) - 2.0 * a1 * v - a_acc
        u, v, a_acc = u_new, v_new, a_new
        if step % record_every == 0:
            full[free] = u
            rec_u[r] = full[probe]
            r += 1
    return (steps + 1) * dt, _numpy(rec_u)


def solve_frame_transient(problem: FrameProblem, dt: float, n_steps: int,
                          damping=(0.0, 0.0), amplitude=None,
                          probe_dofs=None, record_every: int = 1,
                          device=None) -> FrameTransientResult:
    """Newmark (average acceleration) on the dense frame K / M, float64 on
    `device` ("cuda" when None), by `newmark_frame`.  amplitude: (n_steps,)
    load scale of the nodal + member loads (None = unit step); Rayleigh C
    = alpha M + beta K."""
    if dt <= 0.0 or n_steps <= 0:
        raise ValueError("transient needs positive dt and n_steps")
    _require_no_thermal_frame(problem, "transient")
    dev = resolve_device(device)
    k, m = _matrices(problem, True, dev)
    f0 = _t(problem.loads, dev) + _member_load_vectors(problem, dev)[0]
    times, rec_u = newmark_frame(
        *_free_block(k, m, f0, problem, damping), problem.ndof, dt,
        n_steps, amplitude, probe_dofs, record_every)
    return FrameTransientResult(times=times, displacements=rec_u,
                                dt=float(dt), n_steps=int(n_steps))


@dataclass
class FrameHarmonicResult:
    omegas: np.ndarray
    amplitude: np.ndarray          # (n_freq, n_probe) |X|
    real: np.ndarray
    imag: np.ndarray


def frame_harmonic(problem: FrameProblem, omegas, damping=(0.0, 0.0),
                   probe_dofs=None, device=None) -> FrameHarmonicResult:
    """Steady-state X(omega) to the frame's load pattern: the complex
    systems (K - omega^2 M + i omega C) X = f on the free block, Rayleigh
    C = alpha M + beta K, complex128 on `device` ("cuda" when None)."""
    om = np.asarray(omegas, dtype=float).reshape(-1)
    _require_no_thermal_frame(problem, "harmonic")
    dev = resolve_device(device)
    k, m = _matrices(problem, True, dev)
    f0 = _t(problem.loads, dev) + _member_load_vectors(problem, dev)[0]
    xs = harmonic_solves(*_free_block(k, m, f0, problem, damping),
                         problem.ndof, om, probe_dofs)
    return FrameHarmonicResult(omegas=om, amplitude=np.abs(xs),
                               real=xs.real, imag=xs.imag)


# --------------------------------------------------------------------
# The banded tier (large frames): the DIA pipeline with 6 x 6 blocks


def _frame_dia_layout(problem: FrameProblem):
    """The problem's DIA layout (ops/dia.dia_layout of its DOF map), built
    on the host once and kept on the instance: it depends only on the
    connectivity, fixed at construction."""
    from ..ops.dia import dia_layout

    layout = getattr(problem, "_dia_layout_cache", None)
    if layout is None:
        layout = dia_layout(problem.dof_map(), problem.ndof)
        problem._dia_layout_cache = layout
    return layout


def _banded_operator(problem: FrameProblem, dtype, dev):
    """(layout, diagonals in dtype, mask) on `dev`: float64 blocks, one
    float64 scatter into DIA storage, rounded once."""
    from ..ops.dia import assemble_dia_blocks

    layout = _frame_dia_layout(problem)
    kl, t = _local_stiffness(problem, dev)
    diags = assemble_dia_blocks(layout, _to_global(t, kl)
                                ).to(dtype).contiguous()
    return layout, diags, _t(problem.free_mask(), dev, dtype)


def banded_static(layout, diags, mask, f, tol: float, max_iter: int,
                  precond: str, components: int):
    """(u, reactions) float64 on the CPU from one fetch, iterations and
    the relative recurrence residual of the banded PCG solve of K u = f
    (ops/dia.dia_cg_solve) and its reaction matvec (kernel 1 on a card)."""
    from ..ops.dia import dia_cg_solve, dia_matvec

    if precond == "auto":
        precond = "jacobi"
    x, iters, rel = dia_cg_solve(layout, diags, f, mask, tol=float(tol),
                                 max_iter=int(max_iter), precond=precond,
                                 components=components)
    reac = (dia_matvec(layout, diags, x) - f) * (1.0 - mask)
    u, reac = torch.stack([x, reac]).double().cpu()
    return u, reac, int(iters), float(rel)


def solve_frame_static_banded(problem: FrameProblem, tol: float = 1e-7,
                              max_iter: int = 20000,
                              use_pallas: bool = False,
                              precond: str = "auto", dtype=None,
                              mesh=None, device=None):
    """Large-mesh frame statics on `device` ("cuda" when None) in `dtype`
    (the working dtype when None): the float64 T'KT blocks scattered once
    into DIA storage, the PCG of ops/dia.dia_cg_solve with components=3
    ("auto" is Jacobi: on a card the fused kernels 1-3; "mg" the banded
    multigrid), the reactions by one matvec.  use_pallas is the JAX
    package's switch for its TPU kernels and has no effect: a CUDA tensor
    always runs the repo's kernels.  mesh= (a device mesh) is ROADMAP item
    15's multi-device row and raises.

    Returns (FrameStaticResult, iterations, relative recurrence residual);
    the member end forces are recovered on the host from one fetch of u
    and the reactions."""
    from ..parallel import refuse_mesh

    del use_pallas
    refuse_mesh(mesh, "the banded frame solve")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    f, f_fixed = _static_loads(problem, "cpu")
    u, reac, iters, rel = banded_static(layout, diags, mask,
                                        f.to(dev, dtype), tol, max_iter,
                                        precond, 3)
    return _static_result(problem, u, f_fixed, reac), iters, rel


def _lumped_mass(problem: FrameProblem, device) -> torch.Tensor:
    """(3n,) HRZ-lumped mass diagonal, float64 on `device`."""
    length, _, _ = _geometry(problem, device)
    rho, area = _material(problem, device, "density", "area")
    rho_al = rho * area * length
    tr = 0.5 * rho_al
    rot = rho_al * length ** 2 / 78.0
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                         device=device)
    diag = scatter_add(problem.ndof, dm,
                       torch.stack([tr, tr, rot, tr, tr, rot], dim=-1))
    if problem.point_masses is not None:
        pmn = _t(problem.point_masses, device)
        diag[0::3] += pmn
        diag[1::3] += pmn
    return diag


def frame_lumped_mass_diag(problem: FrameProblem,
                           device=None) -> np.ndarray:
    """(3n,) HRZ-lumped mass diagonal: rho A L / 2 per end translation and
    rho A L^3 / 78 rotary inertia (the 4 L^2 / 420 consistent diagonal
    through the 420 / 312 HRZ factor); point masses add translationally.
    Float64 on `device` ("cuda" when None), returned as numpy."""
    return _numpy(_lumped_mass(problem, resolve_device(device)))


def banded_modal(layout, diags, mask, m_diag, n_modes: int, n_iter: int,
                 cg_tol: float, seed: int, n_free: int):
    """(eigenvalues, shapes (n_modes, ndof)) numpy of inverse subspace
    iteration (solvers/modal._subspace_iteration) on a banded operator with
    a lumped mass: each block solve a fused PCG on a card (kernels 1-3)."""
    from ..solvers.modal import _subspace_iteration

    m_diag = m_diag * mask + (1.0 - mask)
    w, y, _change = _subspace_iteration(layout, diags, m_diag, mask,
                                        int(n_modes), int(n_iter), cg_tol,
                                        int(seed), n_free)
    lam = np.maximum(w.cpu().numpy().astype(float), 0.0)
    return lam, _numpy((y * mask[:, None]).T)


def frame_modal_banded(problem: FrameProblem, n_modes: int = 4,
                       n_iter: int = 30, cg_tol: float = 1e-7,
                       seed: int = 0, dtype=None, mesh=None,
                       device=None) -> FrameModalResult:
    """Large-mesh frame modal analysis on `device` ("cuda" when None) in
    the working dtype: inverse subspace iteration on the banded operator
    with the HRZ-lumped mass, each block solve a fused PCG on a card.
    Lumped-mass frequencies converge from below under refinement, the
    consistent dense tier's from above.  mesh= raises (item 15)."""
    from ..parallel import refuse_mesh

    refuse_mesh(mesh, "the banded frame modal analysis")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    if dev.type == "cuda":
        require_float32(dtype, "banded frame modal analysis (kernels 1-3)")
    layout, diags, mask = _banded_operator(problem, dtype, dev)
    return _modal_result(*banded_modal(
        layout, diags, mask, _lumped_mass(problem, dev).to(dtype), n_modes,
        n_iter, cg_tol, seed, int(problem.free_dofs().size)))


def identify_frame_properties(problem: FrameProblem, measured_dofs,
                              measured_disp, param: str = "inertia",
                              n_iter: int = 400,
                              learning_rate: float = 0.05, device=None):
    """Recover per-element frame properties from measured static
    displacements.  param "inertia" recovers the I profile at known E
    (bending determines only the product EI), "young" recovers E at known
    A and I.  ADAM on log-values through the dense masked solve of the
    T'KT blocks (nodal and member loads, the JAX frame_static_response);
    the loss is normalized by max |measurement|.  device: where to solve
    ("cuda" when None).  Returns (values (m,), loss_history)."""
    from ..solvers.banded_inverse import adam_fit, dense_masked_solve

    if param not in ("inertia", "young"):
        raise ValueError('param must be "inertia" or "young"')
    dev = resolve_device(device)
    dtype = default_dtype()
    meas_np = np.asarray(measured_disp, dtype=float)
    idx = torch.as_tensor(np.asarray(measured_dofs, dtype=np.int64),
                          device=dev)
    meas = torch.as_tensor(meas_np, dtype=dtype, device=dev)
    scale = float(np.max(np.abs(meas_np))) or 1.0
    length, c, s = _geometry(problem, dev)
    t = _rotation(c, s)
    fixed = {name: v for name, v in zip(
        ("young", "area", "inertia"),
        _material(problem, dev, "young", "area", "inertia"))}
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64, device=dev)
    f = (_t(problem.loads, dev)
         + _member_load_vectors(problem, dev)[0]).to(dtype)
    mask = _t(problem.free_mask(), dev, dtype)

    def loss_of(vals):
        props = dict(fixed, **{param: vals.to(_F64)})
        blocks = _to_global(t, _k_local(props["young"], props["area"],
                                        props["inertia"], length))
        u = dense_masked_solve(blocks, dm, problem.ndof, f, mask)
        return torch.mean(((u[idx] - meas) / scale) ** 2)

    log0 = torch.log(torch.as_tensor(getattr(problem, param), dtype=dtype,
                                     device=dev))
    (log_p,), hist = adam_fit(lambda ps: loss_of(torch.exp(ps[0])), [log0],
                              n_iter, learning_rate)
    return torch.exp(log_p).double().cpu().numpy(), hist


# --------------------------------------------------------------------
# The differentiable frame statics and the design functions


def frame_static_response(problem: FrameProblem, young_e=None, area_e=None,
                          inertia_e=None, loads=None, load_scale=None,
                          dtype=None, device=None):
    """Differentiable frame statics with per-element properties (the JAX
    package's traced twin): (u, end moments (m, 2), axial (m,)) from the
    masked dense solve K(E, A, I) u = f (float64 T'KT blocks, one float64
    scatter rounded once to `dtype`, torch.linalg.solve) and the local
    member-force recovery, each differentiable in the property tensors.
    The loads are the nodal and member loads (consistent vector and
    fixed-end correction); an explicit `loads` replaces them, correction
    included; `load_scale` scales the whole load model.  device: "cuda"
    when None."""
    from ..solvers.banded_inverse import dense_masked_solve

    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    m = problem.nelm

    def prop(v, name):
        return torch.broadcast_to(_t(getattr(problem, name) if v is None
                                     else v, dev), (m,))

    young, area, inertia = (prop(young_e, "young"), prop(area_e, "area"),
                            prop(inertia_e, "inertia"))
    length, c, s = _geometry(problem, dev)
    kl = _k_local(young, area, inertia, length)
    t = _rotation(c, s)
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64, device=dev)
    f_member, f_fixed = _member_load_vectors(problem, dev)
    if loads is None:
        f = (_t(problem.loads, dev) + f_member).to(dtype)
        f_fixed = f_fixed.to(dtype)
    else:
        f = _t(loads, dev, dtype)
        f_fixed = torch.zeros((m, 6), dtype=dtype, device=dev)
    if load_scale is not None:
        scale = _t(load_scale, dev, dtype)
        f = f * scale
        f_fixed = f_fixed * scale
    mask = _t(problem.free_mask(), dev, dtype)
    u = dense_masked_solve(_to_global(t, kl), dm, problem.ndof, f, mask)
    u_loc = torch.einsum("mij,mj->mi", t.to(dtype), u[dm])
    f_loc = torch.einsum("mij,mj->mi", kl.to(dtype), u_loc) - f_fixed
    return u, f_loc[:, [2, 5]], -f_loc[:, 0]


def _al_minimize(obj_g, t0: torch.Tensor, n_con: int, n_iter: int,
                 outer_rounds: int, penalty: float, learning_rate: float):
    """Shared augmented-Lagrangian ADAM driver (Rockafellar multipliers, a
    fresh Adam state and a halved learning rate each outer round, as
    solvers/sizing.optimize_sizing).  obj_g(t) returns (objective,
    constraint vector g <= 0).  The losses stay on the device and are
    fetched once.  Returns (t, history)."""
    from ..solvers.phases import Adam

    dtype, dev = t0.dtype, t0.device

    def loss_fn(t, lam, mu):
        obj, g = obj_g(t)
        return obj + mu * torch.sum(torch.clamp_min(
            g + lam / (2.0 * mu), 0.0) ** 2)

    lam = torch.zeros(n_con, dtype=dtype, device=dev)
    mu = torch.as_tensor(float(penalty), dtype=dtype, device=dev)
    t = t0.detach()
    hist = []
    for r in range(int(outer_rounds)):
        lr = float(np.asarray(learning_rate * 0.5 ** r, dtype=(
            np.float64 if dtype == _F64 else np.float32)))
        opt = Adam(t)
        for _ in range(int(n_iter)):
            leaf = t.detach().requires_grad_()
            loss = loss_fn(leaf, lam, mu)
            grad, = torch.autograd.grad(loss, leaf)
            with torch.no_grad():
                t = t - lr * opt.direction(grad)
            hist.append(loss.detach())
        with torch.no_grad():
            _, g = obj_g(t)
            lam = torch.clamp_min(lam + 2.0 * mu * g, 0.0)
        mu = 2.0 * mu
    return t, (torch.stack(hist).double().cpu().numpy() if hist
               else np.zeros(0))


def _frame_with_inertia(problem: FrameProblem, inertia,
                        keep_section: bool = False) -> FrameProblem:
    """The JAX package's polish problem: the frame with `inertia`, its
    nodal and member loads, no thermal case (the section modulus only when
    asked)."""
    return FrameProblem(problem.nodes, problem.elements, problem.young,
                        problem.area, inertia, problem.density,
                        problem.loads, problem.fixed_dofs,
                        problem.point_masses, problem.member_loads,
                        problem.section_modulus if keep_section else None)


def optimize_frame_inertia(problem: FrameProblem, displacement_limit: float,
                           probe_dofs, weight_exponent: float = 0.5,
                           min_inertia: float = 1e-8, n_iter: int = 300,
                           outer_rounds: int = 4, penalty: float = 10.0,
                           learning_rate: float = 0.05, device=None):
    """Minimum-weight inertia profile under a deflection limit: objective
    sum I_e^q L_e (section area ~ I^q), |u_p| <= limit on `probe_dofs` by
    the augmented Lagrangian on log(I - min_inertia), then a uniform
    float64 polish (solve_frame_static) until the limit holds; an axial
    deflection floor the inertia cannot cross raises.  Returns (inertia
    (m,), weight, history)."""
    if displacement_limit <= 0.0:
        raise ValueError("displacement_limit must be positive")
    dev = resolve_device(device)
    dtype = default_dtype()
    probe_np = np.asarray(probe_dofs, dtype=int).reshape(-1)
    probe = torch.as_tensor(probe_np, dtype=torch.int64, device=dev)
    length_np = _numpy(_geometry(problem)[0])
    lengths = _t(length_np, dev, dtype)
    q = float(weight_exponent)
    # Clamp the start above the gauge: log(I - min) must be finite.
    i_start = np.maximum(np.asarray(problem.inertia),
                         min_inertia * (1.0 + 1e-9))
    t0 = torch.log(_t(i_start, dev, dtype) - min_inertia)
    w0 = float(np.sum(i_start ** q * length_np))

    def obj_g(t):
        i_e = min_inertia + torch.exp(t)
        u, _, _ = frame_static_response(problem, inertia_e=i_e, dtype=dtype,
                                        device=dev)
        g = torch.abs(u[probe]) / displacement_limit - 1.0
        return torch.sum(i_e ** q * lengths) / w0, g

    t, hist = _al_minimize(obj_g, t0, int(probe_np.size), n_iter,
                           outer_rounds, penalty, learning_rate)
    i_e = (min_inertia + torch.exp(t)).double().cpu().numpy()
    # Uniform polish: the deflection falls under a uniform inertia scale.
    for _ in range(20):
        st = solve_frame_static(_frame_with_inertia(problem, i_e),
                                device=dev)
        ratio = float(np.max(np.abs(st.displacements[probe_np]))
                      / displacement_limit)
        if ratio <= 1.0 + 1e-9:
            break
        i_e = i_e * ratio
    else:
        raise ValueError(
            f"displacement_limit {displacement_limit} unreachable by "
            f"inertia scaling (residual ratio {ratio:.3f}) — the "
            f"probe deflection has an axial component EA cannot "
            f"reduce; raise the limit or size areas too")
    weight = float(np.sum(i_e ** q * length_np))
    return i_e, weight, hist


def frame_reliability(problem: FrameProblem, variables, limit_state,
                      n_iter: int = 50, tol: float = 1e-4,
                      mc_samples: int = 0, mc_seed: int = 0,
                      correlation=None, device=None):
    """FORM on the frame family (solvers/reliability.form_core over
    `frame_static_response`, one dense solve a row): variables young /
    inertia / area over element subsets, load_scale and a resistance
    ("density" refused); limit states {"type": "displacement", "limit",
    "probe_dofs"} or {"type": "stress", "limit" | "variable",
    "elements"}, the extreme-fiber |N| / A + max |M| / S (needs the
    section modulus).  device: "cuda" when None."""
    from ..solvers.reliability import (VariableMap, _nataf_cholesky,
                                       _parse_variables, form_core,
                                       rowwise)

    m = problem.nelm
    # The truss parser with "inertia" aliased onto its "density" slot (a
    # per-element field with an optional subset).
    alias, kinds = [], []
    for spec in variables or ():
        sp = dict(spec)
        if sp.get("kind") == "density":
            raise ValueError('"density" does not enter frame statics '
                             '— use young / inertia / area / '
                             'load_scale / resistance')
        kinds.append(sp.get("kind"))
        if sp.get("kind") == "inertia":
            sp["kind"] = "density"
        alias.append(sp)
    varspecs = _parse_variables(alias, m)
    for v, orig_kind in zip(varspecs, kinds):
        v["kind"] = orig_kind
    chol = _nataf_cholesky(varspecs, correlation)
    dev = resolve_device(device)
    dtype = default_dtype()
    vm = VariableMap(varspecs, chol, m, dtype, dev)

    ls = dict(limit_state or {})
    ls_type = ls.get("type", "displacement")
    var_names = [v["name"] for v in varspecs]
    res_var = None
    if ls_type == "displacement":
        if ls.get("limit") is None or ls.get("probe_dofs") is None:
            raise ValueError('frame displacement limit state needs '
                             '"limit" and "probe_dofs"')
        limit = float(ls["limit"])
        probe = np.asarray(ls["probe_dofs"], dtype=int).reshape(-1)
        if probe.size and (probe.min() < 0
                           or probe.max() >= problem.ndof):
            raise ValueError("probe_dofs out of range")
        labels = [f"displacement dof{int(d)}" for d in probe]
    elif ls_type == "stress":
        if problem.section_modulus is None:
            raise ValueError("frame stress limit state needs the "
                             "problem's section_modulus")
        if ls.get("variable") is not None:
            rn = ls["variable"]
            if rn not in var_names:
                raise ValueError(f"resistance variable {rn!r} is not "
                                 f"defined")
            res_var = var_names.index(rn)
            if varspecs[res_var]["kind"] != "resistance":
                raise ValueError(f'{rn!r} must have kind "resistance"')
            limit = None
        elif ls.get("limit") is not None:
            limit = float(ls["limit"])
        else:
            raise ValueError('frame stress limit state needs "limit" '
                             'or "variable"')
        elems = ls.get("elements")
        probe = (np.arange(m) if elems is None
                 else np.asarray(elems, dtype=int).reshape(-1))
        if probe.size and (probe.min() < 0 or probe.max() >= m):
            raise ValueError("limit-state elements out of range")
        labels = [f"stress e{int(e)}" for e in probe]
    else:
        raise ValueError('frame limit_state type must be '
                         '"displacement" or "stress"')
    probe_d = torch.as_tensor(probe, dtype=torch.int64, device=dev)
    base = {name: _t(getattr(problem, name), dev, dtype)
            for name in ("young", "area", "inertia")}
    s_mod = (None if problem.section_modulus is None
             else _t(problem.section_modulus, dev, dtype))

    def single(u):
        x = vm.physical(u[None])
        young, area, inertia = (vm.field(x, kind, base[kind])[0]
                                for kind in ("young", "area", "inertia"))
        # load_scale= keeps the member-load fixed-end correction
        # consistent with the scaled loads.
        uu, mom, ax = frame_static_response(
            problem, young_e=young, area_e=area, inertia_e=inertia,
            load_scale=vm.load_scale(x)[0], dtype=dtype, device=dev)
        if ls_type == "stress":
            sigma = torch.abs(ax) / area \
                + torch.amax(torch.abs(mom), dim=1) / s_mod
            r = x[0, res_var] if res_var is not None else limit
            return sigma[probe_d] / r
        return torch.abs(uu)[probe_d] / limit

    return form_core(rowwise(single), varspecs, chol, labels,
                     n_iter=n_iter, tol=tol, mc_samples=mc_samples,
                     mc_seed=mc_seed, dtype=dtype, device=dev)


def optimize_frame_inertia_rbdo(problem: FrameProblem, variables,
                                limit: float, probe_dofs,
                                target_beta: float,
                                weight_exponent: float = 0.5,
                                min_inertia: float = 1e-8,
                                n_iter: int = 300, outer_rounds: int = 4,
                                penalty: float = 10.0,
                                learning_rate: float = 0.05,
                                n_amv: int = 10, device=None):
    """RBDO on frames: the minimum-weight inertia profile with every
    probed displacement at a FORM index >= target_beta under uncertain E /
    load (young / load_scale variables; I is the design vector).  PMA:
    an AMV fixpoint on the target-beta sphere for each probe, on detached
    inertias (Danskin), the constraint the displacement ratio there; a
    uniform polish; the achieved betas from `frame_reliability`.  Returns
    (inertia, weight, achieved_betas, history)."""
    from ..solvers.reliability import VariableMap, _parse_variables, rowwise

    if limit <= 0.0 or target_beta <= 0.0:
        raise ValueError("limit and target_beta must be positive")
    for spec in variables or ():
        if spec.get("kind") in ("inertia", "density", "area",
                                "resistance"):
            raise ValueError('frame RBDO variables must be young or '
                             'load_scale ("inertia" is the design '
                             'vector; a resistance cannot bind a '
                             'displacement limit state)')
    varspecs = _parse_variables(variables, problem.nelm)
    n_vars = len(varspecs)
    dev = resolve_device(device)
    dtype = default_dtype()
    vm = VariableMap(varspecs, None, problem.nelm, dtype, dev)
    probe = np.asarray(probe_dofs, dtype=int).reshape(-1)
    if probe.size and (probe.min() < 0 or probe.max() >= problem.ndof):
        raise ValueError("probe_dofs out of range")
    probe_d = torch.as_tensor(probe, dtype=torch.int64, device=dev)
    rows = torch.arange(probe.size, device=dev)
    bt = torch.as_tensor(float(target_beta), dtype=dtype, device=dev)
    length_np = _numpy(_geometry(problem)[0])
    lengths = _t(length_np, dev, dtype)
    q = float(weight_exponent)
    w0 = float(np.sum(np.maximum(np.asarray(problem.inertia),
                                 min_inertia) ** q * length_np))
    young0 = _t(problem.young, dev, dtype)

    def ratios(i_e, u):
        """(n_probe, n_probe) displacement ratios, row k at u[k]."""
        def single(row):
            x = vm.physical(row[None])
            uu, _, _ = frame_static_response(
                problem, young_e=vm.field(x, "young", young0)[0],
                inertia_e=i_e, load_scale=vm.load_scale(x)[0],
                dtype=dtype, device=dev)
            return torch.abs(uu)[probe_d] / limit
        return rowwise(single)(u)

    def pma_ratios(i_e):
        i_d = i_e.detach()
        u = torch.zeros((probe.size, n_vars), dtype=dtype, device=dev)
        for _ in range(int(n_amv)):
            leaf = u.detach().requires_grad_()
            with torch.enable_grad():
                g = 1.0 - ratios(i_d, leaf)[rows, rows]
                dg, = torch.autograd.grad(torch.sum(g), leaf)
            nrm = torch.clamp_min(torch.linalg.vector_norm(dg, dim=1),
                                  1e-30)
            u = -bt * dg / nrm[:, None]
        return ratios(i_e, u.detach())[rows, rows]   # Danskin

    i_start = np.maximum(np.asarray(problem.inertia),
                         min_inertia * (1.0 + 1e-9))
    t0 = torch.log(_t(i_start, dev, dtype) - min_inertia)

    def obj_g(t):
        i_e = min_inertia + torch.exp(t)
        return torch.sum(i_e ** q * lengths) / w0, pma_ratios(i_e) - 1.0

    t, hist = _al_minimize(obj_g, t0, int(probe.size), n_iter,
                           outer_rounds, penalty, learning_rate)
    i_e = (min_inertia + torch.exp(t)).double().cpu().numpy()
    # Uniform PMA polish: the ratio at the fixed design point falls ~1/s.
    for _ in range(20):
        with torch.no_grad():
            r_max = float(torch.max(pma_ratios(_t(i_e, dev, dtype))
                                    ).double().cpu())
        if r_max <= 1.0 + 1e-6:
            break
        i_e = i_e * r_max
    else:
        raise ValueError(
            f"target_beta {target_beta} at limit {limit} unreachable "
            f"by inertia scaling (residual PMA ratio {r_max:.3f}) — "
            f"the probe deflection has an axial component EA cannot "
            f"reduce; raise the limit or size areas too")
    rres = frame_reliability(
        _frame_with_inertia(problem, i_e, keep_section=True), variables,
        {"type": "displacement", "limit": limit,
         "probe_dofs": probe.tolist()}, device=dev)
    weight = float(np.sum(i_e ** q * length_np))
    return i_e, weight, np.asarray(rres.beta, dtype=float), hist
