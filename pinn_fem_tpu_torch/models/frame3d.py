"""3D space-frame family (counterpart of pinn_fem_tpu/models/frame3d.py):
two-node beams with 6 DOFs a node (u, v, w, tx, ty, tz): axial EA,
St-Venant torsion GJ, and cubic-Hermite bending in both principal planes
(EIz in the local x-y plane, EIy in the local x-z plane).

Local DOF order per node [u, v, w, tx, ty, tz], standard sign conventions:

    axial (rows 0, 6)            EA/L [[1, -1], [-1, 1]]
    torsion (rows 3, 9)          GJ/L [[1, -1], [-1, 1]]
    bending x-y (1, 5, 7, 11)    EIz Hermite block, +6L coupling
    bending x-z (2, 4, 8, 10)    EIy Hermite block, -6L coupling (w' = -ty)

Orientation: local x along the member; local y = a x x, z = x x y with the
auxiliary vector a = global Z, global X for members within 1e-8 of
vertical, or the member's `ref_vector` where one is given (a zero row keeps
the default).  The 12 x 12 transformation is block-diag(R, R, R, R), R's
rows the local axes.  Consistent mass: axial and torsional rho A L / 6
(rho I_p L / 6) pairs and the rho A L / 420 Hermite blocks per bending
plane; I_p defaults to J.

The element library is plain functions on float64 tensors, batched over
members (the 2D family's Hermite blocks with the plane's sign).  The dense
analyses (statics, modal, Newmark, harmonic, buckling) assemble K and M by
one float64 scatter on the caller's device, the card by default; their
results are numpy float64.  The banded tier
(`solve_space_frame_static_banded`, components=6, and
`space_frame_modal_banded`) runs kernels 1-3 on a card, as the 2D frame's
does, on a layout of at most 160 diagonals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.assembly import scatter_add
from ..utils.runtime import default_dtype, require_float32, resolve_device
from .frame import (_F64, _assemble, _hermite_g, _hermite_k, _hermite_m,
                    _buckling_pencil, _dense_modal, _fill4, _free_block,
                    _modal_result, _scatter_vec, _to_global,
                    banded_modal, banded_static, newmark_frame)
from .plane import _material, _numpy, _t, harmonic_solves

__all__ = [
    "SpaceFrameProblem",
    "SpaceFrameStaticResult",
    "SpaceFrameModalResult",
    "SpaceFrameTransientResult",
    "SpaceFrameHarmonicResult",
    "space_frame_matrices",
    "solve_space_frame_static",
    "space_frame_modal",
    "solve_space_frame_transient",
    "space_frame_harmonic",
    "SpaceFrameBucklingResult",
    "space_frame_buckling",
    "space_frame_end_forces",
    "solve_space_frame_static_banded",
    "space_frame_modal_banded",
    "space_frame_lumped_mass_diag",
]

_VERT_TOL = 1e-8
# A 3D space grid has up to 7 node-neighbour classes x 11 block diagonals
# each: more than the 2D default budget of 64.
_FRAME3D_MAX_DIAGS = 160


@dataclass
class SpaceFrameProblem:
    """3D space frame: nodes (n, 3), elements (m, 2), per-element section
    and material values (scalars broadcast), nodal loads (6n,) as [Fx, Fy,
    Fz, Mx, My, Mz]*n, fixed DOFs on the 6-DOF-a-node numbering; the shear
    modulus G, or poisson (G = E / 2(1 + nu)); optional per-node
    translational point masses, per-member ref_vector (m, 3), polar
    inertia I_p (default J), uniform member loads [wx, wy, wz] in global
    axes (m, 3), and a static thermal load case (alpha_cte with a uniform
    dT and / or local gradients dT/dy', dT/dz')."""
    nodes: np.ndarray
    elements: np.ndarray
    young: np.ndarray            # (m,) or scalar
    area: np.ndarray
    inertia_y: np.ndarray        # bending in the local x-z plane
    inertia_z: np.ndarray        # bending in the local x-y plane
    torsion_j: np.ndarray        # St-Venant torsion constant
    density: np.ndarray
    loads: np.ndarray            # (6n,)
    fixed_dofs: np.ndarray
    shear_modulus: Optional[np.ndarray] = None
    poisson: Optional[float] = None
    point_masses: Optional[np.ndarray] = None
    ref_vector: Optional[np.ndarray] = None
    polar_inertia: Optional[np.ndarray] = None
    member_loads: Optional[np.ndarray] = None
    alpha_cte: Optional[np.ndarray] = None
    temperature: Optional[np.ndarray] = None
    temperature_gradient_y: Optional[np.ndarray] = None
    temperature_gradient_z: Optional[np.ndarray] = None

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=float)
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 3:
            raise ValueError("space-frame nodes must be (n, 3)")
        self.elements = np.asarray(self.elements, dtype=int)
        if self.elements.ndim != 2 or self.elements.shape[1] != 2:
            raise ValueError("space-frame elements must be (m, 2)")
        m = self.elements.shape[0]
        for name in ("young", "area", "inertia_y", "inertia_z",
                     "torsion_j", "density"):
            setattr(self, name, np.broadcast_to(
                np.asarray(getattr(self, name), dtype=float),
                (m,)).copy())
            if np.any(getattr(self, name) <= 0.0):
                raise ValueError(f"{name} must be positive")
        if self.shear_modulus is None:
            if self.poisson is None:
                raise ValueError('space frame needs "shear_modulus" '
                                 'or "poisson" (G = E/2(1+ν))')
            self.shear_modulus = self.young \
                / (2.0 * (1.0 + float(self.poisson)))
        self.shear_modulus = np.broadcast_to(
            np.asarray(self.shear_modulus, dtype=float), (m,)).copy()
        if np.any(self.shear_modulus <= 0.0):
            raise ValueError("shear_modulus must be positive")
        self.loads = np.asarray(self.loads, dtype=float).reshape(-1)
        if self.loads.size != self.ndof:
            raise ValueError(f"loads must have {self.ndof} entries "
                             f"(6 per node), got {self.loads.size}")
        self.fixed_dofs = np.asarray(self.fixed_dofs,
                                     dtype=int).reshape(-1)
        if self.point_masses is not None:
            self.point_masses = np.broadcast_to(
                np.asarray(self.point_masses, dtype=float),
                (self.nnode,)).copy()
        if self.ref_vector is not None:
            self.ref_vector = np.broadcast_to(
                np.asarray(self.ref_vector, dtype=float), (m, 3)).copy()
        if self.polar_inertia is None:
            self.polar_inertia = self.torsion_j.copy()
        else:
            self.polar_inertia = np.broadcast_to(
                np.asarray(self.polar_inertia, dtype=float), (m,)).copy()
        if self.member_loads is not None:
            self.member_loads = np.broadcast_to(
                np.asarray(self.member_loads, dtype=float), (m, 3)).copy()
        if (self.temperature is not None
                or self.temperature_gradient_y is not None
                or self.temperature_gradient_z is not None) \
                and self.alpha_cte is None:
            raise ValueError('a thermal load case needs the thermal '
                             'expansion coefficient (material '
                             '"alpha")')
        for name in ("alpha_cte", "temperature", "temperature_gradient_y",
                     "temperature_gradient_z"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, np.broadcast_to(
                    np.asarray(v, dtype=float), (m,)).copy())
        if bool(torch.any(_geometry3d(self)[0] <= 0.0)):
            raise ValueError("zero-length space-frame element")

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
        """(m, 12) global DOF indices per element."""
        i, j = self.elements[:, 0], self.elements[:, 1]
        return np.stack([6 * i + d for d in range(6)]
                        + [6 * j + d for d in range(6)], axis=1)


def _geometry3d(problem: SpaceFrameProblem, device=None):
    """(length (m,), R (m, 3, 3)) float64 on `device` (CPU when None); R's
    rows are the local axes."""
    nodes = _t(problem.nodes, device)
    el = torch.as_tensor(problem.elements, dtype=torch.int64, device=device)
    d = nodes[el[:, 1]] - nodes[el[:, 0]]
    length = torch.linalg.vector_norm(d, dim=1)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=_F64, device=device)
    xh = torch.where(length[:, None] > 0.0, d / length[:, None], x_axis)
    aux = torch.tensor([0.0, 0.0, 1.0], dtype=_F64,
                       device=device).repeat(problem.nelm, 1)
    vertical = torch.abs(torch.abs(xh[:, 2]) - 1.0) < _VERT_TOL
    aux[vertical] = x_axis
    if problem.ref_vector is not None:
        rv = _t(problem.ref_vector, device)
        given = torch.linalg.vector_norm(rv, dim=1) > 0.0
        aux[given] = rv[given]
    yh = torch.linalg.cross(aux, xh, dim=1)
    ny = torch.linalg.vector_norm(yh, dim=1)
    if bool(torch.any(ny < _VERT_TOL)):
        raise ValueError("ref_vector parallel to a member axis")
    yh = yh / ny[:, None]
    zh = torch.linalg.cross(xh, yh, dim=1)
    return length, torch.stack([xh, yh, zh], dim=1)


def _transformation3d(r: torch.Tensor) -> torch.Tensor:
    """(m, 12, 12) local <- global: block-diag(R, R, R, R)."""
    t = torch.zeros((r.shape[0], 12, 12), dtype=r.dtype, device=r.device)
    for off in (0, 3, 6, 9):
        t[:, off:off + 3, off:off + 3] = r
    return t


_BEND_XY = (1, 5, 7, 11)     # v, tz: EIz, +6L coupling
_BEND_XZ = (2, 4, 8, 10)     # w, ty: EIy, -6L coupling (w' = -ty)


def _k_local3d(length, young, area, inertia_y, inertia_z,
               torsion_gj) -> torch.Tensor:
    """(m, 12, 12) local stiffness (module docstring); torsion_gj is G J."""
    k = torch.zeros((length.shape[0], 12, 12), dtype=length.dtype,
                    device=length.device)
    ea = young * area / length
    k[:, 0, 0] = k[:, 6, 6] = ea
    k[:, 0, 6] = k[:, 6, 0] = -ea
    gj = torsion_gj / length
    k[:, 3, 3] = k[:, 9, 9] = gj
    k[:, 3, 9] = k[:, 9, 3] = -gj
    _fill4(k, _BEND_XY, _hermite_k(young * inertia_z, length, 1.0))
    _fill4(k, _BEND_XZ, _hermite_k(young * inertia_y, length, -1.0))
    return k


def _section(problem: SpaceFrameProblem, device):
    """(length, R, k_local) float64 on `device`."""
    length, r = _geometry3d(problem, device)
    young, area, iy, iz, g, j = _material(
        problem, device, "young", "area", "inertia_y", "inertia_z",
        "shear_modulus", "torsion_j")
    return length, r, _k_local3d(length, young, area, iy, iz, g * j)


def _m_local3d(problem: SpaceFrameProblem, length: torch.Tensor
               ) -> torch.Tensor:
    """(m, 12, 12) local consistent mass (module docstring)."""
    rho, area, ip = _material(problem, length.device, "density", "area",
                              "polar_inertia")
    mm = torch.zeros((length.shape[0], 12, 12), dtype=_F64,
                     device=length.device)
    rho_al = rho * area * length
    ax = rho_al / 6.0
    mm[:, 0, 0] = mm[:, 6, 6] = 2.0 * ax
    mm[:, 0, 6] = mm[:, 6, 0] = ax
    tor = rho * ip * length / 6.0
    mm[:, 3, 3] = mm[:, 9, 9] = 2.0 * tor
    mm[:, 3, 9] = mm[:, 9, 3] = tor
    _fill4(mm, _BEND_XY, _hermite_m(rho_al, length, 1.0))
    _fill4(mm, _BEND_XZ, _hermite_m(rho_al, length, -1.0))
    return mm


def _kg_local3d(axial_n, length) -> torch.Tensor:
    """(m, 12, 12) geometric stiffness from member axial force N (tension
    positive): the Hermite K_g blocks in both bending planes (flexural
    buckling only; torsional buckling needs Wagner terms this element
    does not carry)."""
    kg = torch.zeros((length.shape[0], 12, 12), dtype=length.dtype,
                     device=length.device)
    _fill4(kg, _BEND_XY, _hermite_g(axial_n, length, 1.0))
    _fill4(kg, _BEND_XZ, _hermite_g(axial_n, length, -1.0))
    return kg


def _member_load_vectors3(problem: SpaceFrameProblem, device=None):
    """(f_nodal (6n,), f_fixed_local (m, 12)) of uniform member loads: the
    global [wx, wy, wz] resolved to local (q, wy', wz'), each transverse
    component the consistent [wL/2, wL^2/12] pair in its bending plane with
    the plane's sign."""
    f_loc = torch.zeros((problem.nelm, 12), dtype=_F64, device=device)
    if problem.member_loads is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device), f_loc
    length, r = _geometry3d(problem, device)
    w_loc = torch.einsum("mij,mj->mi", r, _t(problem.member_loads, device))
    q, wy, wz = w_loc[:, 0], w_loc[:, 1], w_loc[:, 2]
    f_loc[:, 0] = f_loc[:, 6] = q * length / 2.0
    f_loc[:, 1] = f_loc[:, 7] = wy * length / 2.0
    f_loc[:, 5] = wy * length ** 2 / 12.0
    f_loc[:, 11] = -wy * length ** 2 / 12.0
    f_loc[:, 2] = f_loc[:, 8] = wz * length / 2.0
    f_loc[:, 4] = -wz * length ** 2 / 12.0      # x-z sign conjugation
    f_loc[:, 10] = wz * length ** 2 / 12.0
    return _scatter_vec(problem, f_loc, _transformation3d(r)), f_loc


def _thermal_member_vectors3(problem: SpaceFrameProblem, device=None):
    """(f_nodal (6n,), f_fixed_local (m, 12)) of the thermal load case: a
    uniform dT pushes the ends outward by EA alpha dT; dT/dy' gives the
    end-moment pair +-EIz alpha g on tz, dT/dz' the pair on ty with the x-z
    plane's sign."""
    f_loc = torch.zeros((problem.nelm, 12), dtype=_F64, device=device)
    if problem.temperature is None \
            and problem.temperature_gradient_y is None \
            and problem.temperature_gradient_z is None:
        return torch.zeros(problem.ndof, dtype=_F64, device=device), f_loc
    young, area, iy, iz, alpha = _material(
        problem, device, "young", "area", "inertia_y", "inertia_z",
        "alpha_cte")
    if problem.temperature is not None:
        na = young * area * alpha * _t(problem.temperature, device)
        f_loc[:, 0] -= na
        f_loc[:, 6] += na
    if problem.temperature_gradient_y is not None:
        mk = young * iz * alpha * _t(problem.temperature_gradient_y, device)
        f_loc[:, 5] -= mk
        f_loc[:, 11] += mk
    if problem.temperature_gradient_z is not None:
        mk = young * iy * alpha * _t(problem.temperature_gradient_z, device)
        f_loc[:, 4] += mk                       # x-z sign conjugation
        f_loc[:, 10] -= mk
    _, r = _geometry3d(problem, device)
    return _scatter_vec(problem, f_loc, _transformation3d(r)), f_loc


def _static_loads3(problem: SpaceFrameProblem, device):
    """(f (6n,), f_fixed (m, 12)): nodal + member + thermal loads and the
    fixed-end vectors the recovery subtracts."""
    f_member, f_fixed = _member_load_vectors3(problem, device)
    f_th, f_th_fixed = _thermal_member_vectors3(problem, device)
    return (_t(problem.loads, device) + f_member + f_th,
            f_fixed + f_th_fixed)


def _require_no_thermal3(problem: SpaceFrameProblem, kind: str):
    """The dynamic analyses refuse a thermal load case."""
    if problem.temperature is not None \
            or problem.temperature_gradient_y is not None \
            or problem.temperature_gradient_z is not None:
        raise ValueError(
            f"space-frame {kind} does not take a thermal load case — "
            "thermoelastic loads are static; use analysis type "
            '"static" (buckling inherits ΔT through its static '
            "state)")


def _matrices3(problem: SpaceFrameProblem, with_mass: bool, device):
    length, r, kl = _section(problem, device)
    t = _transformation3d(r)
    dm = problem.dof_map()
    k = _assemble(problem.ndof, dm, _to_global(t, kl))
    mmat = None
    if with_mass:
        mmat = _assemble(problem.ndof, dm,
                         _to_global(t, _m_local3d(problem, length)))
        if problem.point_masses is not None:
            pm = torch.zeros(problem.ndof, dtype=_F64, device=device)
            pmn = _t(problem.point_masses, device)
            for d in range(3):                     # translational DOFs
                pm[d::6] += pmn
            mmat = mmat + torch.diag(pm)
    return k, mmat


def space_frame_matrices(problem: SpaceFrameProblem, with_mass: bool = True,
                         device=None):
    """(K, M) dense global float64 tensors on `device` ("cuda" when None);
    M is None unless with_mass.  The one assembly every dense space-frame
    analysis shares."""
    return _matrices3(problem, with_mass, resolve_device(device))


@dataclass
class SpaceFrameStaticResult:
    displacements: np.ndarray      # (6n,)
    member_end_forces: np.ndarray  # (m, 12) LOCAL [N, Vy, Vz, T, My, Mz]
    axial: np.ndarray              # (m,) axial force (tension +)
    torque: np.ndarray             # (m,) St-Venant torque
    moments_y: np.ndarray          # (m, 2) end moments, local y
    moments_z: np.ndarray          # (m, 2) end moments, local z
    reactions: np.ndarray          # (6n,) K u - f on fixed DOFs


def _end_forces3(problem: SpaceFrameProblem, u: torch.Tensor
                 ) -> torch.Tensor:
    """(m, 12) local k_local T u_e on u's device (no fixed-end terms)."""
    _, r, kl = _section(problem, u.device)
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                         device=u.device)
    u_loc = torch.einsum("mij,mj->mi", _transformation3d(r), u[dm])
    return torch.einsum("mij,mj->mi", kl, u_loc)


def _static_result3(problem: SpaceFrameProblem, u: torch.Tensor,
                    f_fixed: torch.Tensor,
                    reactions: torch.Tensor) -> SpaceFrameStaticResult:
    f_loc = _numpy(_end_forces3(problem, u) - f_fixed)
    return SpaceFrameStaticResult(
        displacements=_numpy(u), member_end_forces=f_loc,
        axial=-f_loc[:, 0], torque=-f_loc[:, 3],
        moments_y=f_loc[:, [4, 10]], moments_z=f_loc[:, [5, 11]],
        reactions=_numpy(reactions))


def _dense_static3(problem: SpaceFrameProblem, device):
    k, _ = _matrices3(problem, False, device)
    mask = _t(problem.free_mask(), device)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    f, f_fixed = _static_loads3(problem, device)
    u = torch.linalg.solve(km, f * mask) * mask
    return u, k, f, f_fixed, mask


def solve_space_frame_static(problem: SpaceFrameProblem,
                             device=None) -> SpaceFrameStaticResult:
    """Dense masked static solve and local member end-force recovery,
    float64 on `device` ("cuda" when None)."""
    u, k, f, f_fixed, mask = _dense_static3(problem,
                                            resolve_device(device))
    return _static_result3(problem, u, f_fixed, (k @ u - f) * (1.0 - mask))


@dataclass
class SpaceFrameModalResult:
    frequencies_hz: np.ndarray
    omegas: np.ndarray
    eigenvalues: np.ndarray
    mode_shapes: np.ndarray        # (n_modes, 6n)


def _modal3(lam, shapes) -> SpaceFrameModalResult:
    r = _modal_result(lam, shapes)
    return SpaceFrameModalResult(r.frequencies_hz, r.omegas, r.eigenvalues,
                                 r.mode_shapes)


def space_frame_modal(problem: SpaceFrameProblem, n_modes: int = 6,
                      device=None) -> SpaceFrameModalResult:
    """Generalized K phi = lambda M phi on the free block (consistent
    mass), dense float64 on `device` ("cuda" when None)."""
    k, m = _matrices3(problem, True, resolve_device(device))
    return _modal3(*_dense_modal(k, m, problem, n_modes))


@dataclass
class SpaceFrameTransientResult:
    times: np.ndarray
    displacements: np.ndarray      # (n_rec, n_probe)
    dt: float
    n_steps: int


def solve_space_frame_transient(problem: SpaceFrameProblem, dt: float,
                                n_steps: int, damping=(0.0, 0.0),
                                amplitude=None, probe_dofs=None,
                                record_every: int = 1, device=None
                                ) -> SpaceFrameTransientResult:
    """Newmark (average acceleration) on the dense space-frame K / M,
    float64 on `device` ("cuda" when None): the 2D frame's recurrence
    (models/frame.newmark_frame).  amplitude: (n_steps,) load scale of the
    nodal + member loads (None = unit step); Rayleigh C = alpha M +
    beta K."""
    if dt <= 0.0 or n_steps <= 0:
        raise ValueError("transient needs positive dt and n_steps")
    _require_no_thermal3(problem, "transient")
    dev = resolve_device(device)
    k, m = _matrices3(problem, True, dev)
    f0 = _t(problem.loads, dev) + _member_load_vectors3(problem, dev)[0]
    times, rec_u = newmark_frame(
        *_free_block(k, m, f0, problem, damping), problem.ndof, dt,
        n_steps, amplitude, probe_dofs, record_every)
    return SpaceFrameTransientResult(times=times, displacements=rec_u,
                                     dt=float(dt), n_steps=int(n_steps))


@dataclass
class SpaceFrameHarmonicResult:
    omegas: np.ndarray
    amplitude: np.ndarray          # (n_freq, n_probe) |X|
    real: np.ndarray
    imag: np.ndarray


def space_frame_harmonic(problem: SpaceFrameProblem, omegas,
                         damping=(0.0, 0.0), probe_dofs=None,
                         device=None) -> SpaceFrameHarmonicResult:
    """Steady-state X(omega) to the space frame's load pattern: the complex
    systems (K - omega^2 M + i omega C) X = f on the free block, complex128
    on `device` ("cuda" when None), Rayleigh C = alpha M + beta K."""
    om = np.asarray(omegas, dtype=float).reshape(-1)
    _require_no_thermal3(problem, "harmonic")
    dev = resolve_device(device)
    k, m = _matrices3(problem, True, dev)
    f0 = _t(problem.loads, dev) + _member_load_vectors3(problem, dev)[0]
    xs = harmonic_solves(*_free_block(k, m, f0, problem, damping),
                         problem.ndof, om, probe_dofs)
    return SpaceFrameHarmonicResult(omegas=om, amplitude=np.abs(xs),
                                    real=xs.real, imag=xs.imag)


@dataclass
class SpaceFrameBucklingResult:
    load_factors: np.ndarray       # ascending positive lambda_cr
    modes: np.ndarray              # (n_modes, 6n)
    axial: np.ndarray              # (m,) member N at unit load


def space_frame_buckling(problem: SpaceFrameProblem, n_modes: int = 2,
                         device=None) -> SpaceFrameBucklingResult:
    """Linearized (P-Delta) buckling, float64 on `device` ("cuda" when
    None): statics gives the member axial forces N, K_g(N) in both bending
    planes, and (K + lambda K_g) phi = 0 on the free block through K_ff's
    Cholesky factor (models/frame._buckling_pencil)."""
    dev = resolve_device(device)
    u, k, f, f_fixed, mask = _dense_static3(problem, dev)
    stat = _static_result3(problem, u, f_fixed, (k @ u - f) * (1.0 - mask))
    length, r = _geometry3d(problem, dev)
    kg = _assemble(problem.ndof, problem.dof_map(), _to_global(
        _transformation3d(r), _kg_local3d(_t(stat.axial, dev), length)))
    lam, modes = _buckling_pencil(problem, k, kg, n_modes)
    return SpaceFrameBucklingResult(load_factors=lam, modes=modes,
                                    axial=stat.axial)


def space_frame_end_forces(problem: SpaceFrameProblem, u,
                           device=None) -> np.ndarray:
    """(m, 12) local member end forces k_local T u_e of a displacement
    state (no fixed-end corrections), float64 on `device` ("cuda" when
    None)."""
    return _numpy(_end_forces3(problem, _t(u, resolve_device(device))))


# --------------------------------------------------------------------
# The banded tier: the DIA pipeline with 12 x 12 blocks


def _frame3d_dia_layout(problem: SpaceFrameProblem):
    """The problem's DIA layout (at most 160 diagonals), built on the host
    once and kept on the instance."""
    from ..ops.dia import dia_layout

    layout = getattr(problem, "_dia_layout_cache", None)
    if layout is None:
        layout = dia_layout(problem.dof_map(), problem.ndof,
                            max_diags=_FRAME3D_MAX_DIAGS)
        problem._dia_layout_cache = layout
    return layout


def _banded_operator3(problem: SpaceFrameProblem, dtype, dev):
    """(layout, diagonals in dtype, mask) on `dev`: float64 blocks, one
    float64 scatter into DIA storage, rounded once."""
    from ..ops.dia import assemble_dia_blocks

    layout = _frame3d_dia_layout(problem)
    length, r, kl = _section(problem, dev)
    blocks = _to_global(_transformation3d(r), kl)
    diags = assemble_dia_blocks(layout, blocks).to(dtype).contiguous()
    return layout, diags, _t(problem.free_mask(), dev, dtype)


def solve_space_frame_static_banded(problem: SpaceFrameProblem,
                                    tol: float = 1e-7,
                                    max_iter: int = 20000,
                                    use_pallas: bool = False,
                                    precond: str = "auto", dtype=None,
                                    mesh=None, device=None):
    """Large-mesh space-frame statics on `device` ("cuda" when None) in
    `dtype` (the working dtype when None): the float64 12 x 12 T'KT blocks
    scattered once into DIA storage, the PCG of ops/dia.dia_cg_solve with
    components=6 ("auto" is Jacobi: on a card the fused kernels 1-3), the
    reactions by one matvec.  use_pallas has no effect; mesh= raises
    (ROADMAP item 15's multi-device row).

    Returns (SpaceFrameStaticResult, iterations, relative recurrence
    residual); the member end forces are recovered on the host from one
    fetch of u and the reactions."""
    from ..parallel import refuse_mesh

    del use_pallas
    refuse_mesh(mesh, "the banded space-frame solve")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    layout, diags, mask = _banded_operator3(problem, dtype, dev)
    f, f_fixed = _static_loads3(problem, "cpu")
    u, reac, iters, rel = banded_static(layout, diags, mask,
                                        f.to(dev, dtype), tol, max_iter,
                                        precond, 6)
    return _static_result3(problem, u, f_fixed, reac), iters, rel


def _lumped_mass3(problem: SpaceFrameProblem, device) -> torch.Tensor:
    """(6n,) HRZ-lumped mass diagonal, float64 on `device`."""
    length, _ = _geometry3d(problem, device)
    rho, area, ip = _material(problem, device, "density", "area",
                              "polar_inertia")
    rho_al = rho * area * length
    tr = 0.5 * rho_al
    rot = (0.5 * rho * ip * length + 2.0 * rho_al * length ** 2 / 78.0) / 3.0
    dm = torch.as_tensor(problem.dof_map(), dtype=torch.int64,
                         device=device)
    diag = scatter_add(problem.ndof, dm, torch.stack(
        [tr, tr, tr, rot, rot, rot, tr, tr, tr, rot, rot, rot], dim=-1))
    if problem.point_masses is not None:
        pmn = _t(problem.point_masses, device)
        for d in range(3):
            diag[d::6] += pmn
    return diag


def space_frame_lumped_mass_diag(problem: SpaceFrameProblem,
                                 device=None) -> np.ndarray:
    """(6n,) HRZ-lumped mass diagonal: rho A L / 2 per end translation;
    the rotary block isotropized to its trace mean (rho I_p L / 2 + 2 rho
    A L^3 / 78) / 3 per rotation DOF, which keeps the global diagonal
    rotation-invariant; point masses add translationally.  Float64 on
    `device` ("cuda" when None), returned as numpy."""
    return _numpy(_lumped_mass3(problem, resolve_device(device)))


def space_frame_modal_banded(problem: SpaceFrameProblem,
                             n_modes: int = 4, n_iter: int = 30,
                             cg_tol: float = 1e-7, seed: int = 0,
                             dtype=None, mesh=None,
                             device=None) -> SpaceFrameModalResult:
    """Large-mesh space-frame modal analysis on `device` ("cuda" when None)
    in the working dtype: inverse subspace iteration on the banded
    operator with the HRZ-lumped mass, each block solve a fused PCG on a
    card (kernels 1-3).  mesh= raises (item 15)."""
    from ..parallel import refuse_mesh

    refuse_mesh(mesh, "the banded space-frame modal analysis")
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    if dev.type == "cuda":
        require_float32(dtype, "banded space-frame modal analysis "
                        "(kernels 1-3)")
    layout, diags, mask = _banded_operator3(problem, dtype, dev)
    return _modal3(*banded_modal(
        layout, diags, mask, _lumped_mass3(problem, dev).to(dtype), n_modes,
        n_iter, cg_tol, seed, int(problem.free_dofs().size)))
