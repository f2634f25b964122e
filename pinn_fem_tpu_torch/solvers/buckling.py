"""Linearized (eigenvalue) buckling: K phi = -lambda K_g phi (counterpart
of pinn_fem_tpu/solvers/buckling.py).

  1. linear static solve at the problem's loads -> u0;
  2. element axial forces N_e at u0 -> geometric stiffness K_g
     (ops/geometric.py);
  3. smallest load multipliers lambda with (K + lambda K_g) phi = 0.

With K_ff = L L^T the pencil becomes the standard symmetric problem
A = L^-1 (-K_g,ff) L^-T, whose eigenvalues mu give lambda = 1 / mu: the
largest positive mu is the critical load factor.

Paths, chosen as in the JAX package:

  * dense float64 (ndof <= DENSE_DOF_LIMIT and no `data`, the default):
    K and K_g are ops/host's float64 operators (the JAX host tier's); the
    static solve, the Cholesky congruence and eigh run in float64 torch on
    the caller's device (host=True: on the CPU);
  * dense traced (host=False, or a given `data`): the same in the working
    dtype, differentiable (`buckling_eigenvalues`);
  * banded (above the dense limit): shifted subspace iteration on
    A = K^-1 (-K_g), the machinery of solvers/modal.py.  The base state is
    one Jacobi-PCG, each iteration k warm-started block solves (on a card
    the fused PCG, kernels 1-3), and the K and K_g block products are
    kernel 1, one launch a column.  The k x k projected problem is solved
    on the host in float64 (`_ritz`, rank-robust).

Float32 accuracy floor (the JAX package's measurement on braced towers):
the banded load-factor error is ~eps32 kappa(K_ff).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.problem import TrussProblem
from ..ops.assembly import assemble_system
from ..ops.geometric import assemble_geometric, element_axial_forces
from ..utils.progress import PACKAGE_LOGGER
from ..utils.runtime import require_float32, resolve_device
from ..parallel import refuse_mesh
from .modal import BANDED_KERNELS, block_solve

logger = logging.getLogger(PACKAGE_LOGGER)


class BucklingResult(NamedTuple):
    load_factors: np.ndarray   # (n_modes,) ascending positive multipliers
                               # (inf where fewer destabilizing modes exist)
    modes: np.ndarray          # (ndof, n_modes) buckling shapes, zeros on
                               # fixed DOFs, K-orthonormal on the free block
    axial_forces: np.ndarray   # (nelm,) N_e of the base state (tension > 0)
    u_base: np.ndarray         # (ndof,) the linear static base state
    ok: bool = True            # False on the banded float32 path when the
                               # Ritz values had not converged


def _pencil(k_ff, kg_ff, n_modes: int):
    """(load factors, K-orthonormal modes) of (K + lambda K_g) phi = 0 on
    the free block: eigh of L^-1 (-K_g) L^-T, K = L L^T, largest mu first,
    lambda = 1 / mu where mu > 0 and inf elsewhere."""
    lo = torch.linalg.cholesky(k_ff)
    b = torch.linalg.solve_triangular(lo, -kg_ff, upper=False)
    a = torch.linalg.solve_triangular(lo, b.T, upper=False).T
    mu, y = torch.linalg.eigh(0.5 * (a + a.T))            # ascending
    mu_desc = mu.flip(0)[:n_modes]
    lam = torch.where(mu_desc > 0, 1.0 / torch.where(mu_desc > 0, mu_desc,
                                                     torch.ones_like(mu_desc)),
                      torch.full_like(mu_desc, float("inf")))
    return lam, torch.linalg.solve_triangular(lo.T, y.flip(1)[:, :n_modes],
                                              upper=True)


def buckling_eigenvalues(problem: TrussProblem, n_modes: int = 4, data=None,
                         material=None, u_base=None,
                         device=None) -> torch.Tensor:
    """The smallest positive buckling load factors as a tensor
    (differentiable).  `material` overrides problem.material; `u_base`
    skips the static solve.  Entries are inf when the pencil has fewer
    destabilizing directions than n_modes."""
    return _buckling_traced(problem, n_modes, data, material, u_base,
                            device)[0]


def _buckling_traced(problem, n_modes, data, material, u_base, device=None):
    from ..ops.linalg import masked_solve
    from . import newton

    if problem.ndof > newton.DENSE_DOF_LIMIT:
        raise ValueError(
            f"buckling analysis is dense-only ({problem.ndof} DOFs > "
            f"{newton.DENSE_DOF_LIMIT}); a 2M-DOF dense K is 16 TB — reduce "
            "the mesh or track compression via modal_analysis(prestress_u="
            "...) on the banded path")
    data = data if data is not None else problem.to_device(device)
    material = (material if material is not None
                else problem.material.to(data.device))
    free = torch.as_tensor(problem.free_fixed()[0]).to(data.device)
    k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
    if u_base is None:
        u_base = masked_solve(k, data.loads, data.free_mask)[0]
    n_e = element_axial_forces(data, material, u_base)
    kg = assemble_geometric(data, n_e)
    lam, v = _pencil(k[free][:, free], kg[free][:, free], n_modes)
    return lam, v, n_e, u_base


def _float64_buckling(problem: TrussProblem, n_modes: int,
                      device) -> BucklingResult:
    """Dense buckling in float64: ops/host's K and K_g, the static solve,
    congruence and eigh in torch on `device` (the JAX package's
    _host_buckling)."""
    from ..ops import host as H

    free_idx, _ = problem.free_fixed()
    f64 = dict(dtype=torch.float64, device=device)
    k = H.host_stiffness(problem)
    mask = torch.as_tensor(H.host_masks(problem), **f64)
    kt = torch.as_tensor(k, **f64)
    km = mask[:, None] * kt * mask[None, :] + torch.diag(1.0 - mask)
    f = torch.as_tensor(problem.loads, **f64)
    u_base = (torch.linalg.solve(km, f * mask) * mask).cpu().numpy()
    n_e = H.host_axial_forces(problem, u_base)
    kg = H.host_geometric_stiffness(problem, n_e)
    ix = np.ix_(free_idx, free_idx)
    k_ff = torch.as_tensor(k[ix], **f64)
    lam, v = _pencil(0.5 * (k_ff + k_ff.T), torch.as_tensor(kg[ix], **f64),
                     n_modes)
    shapes = np.zeros((problem.ndof, n_modes))
    shapes[free_idx] = v.cpu().numpy()
    return BucklingResult(load_factors=lam.cpu().numpy(), modes=shapes,
                          axial_forces=n_e, u_base=u_base)


def _ritz(ag: np.ndarray, kk: np.ndarray):
    """Rank-robust projected generalized eigensolve in float64: float32
    CG noise can leave the K-Gram indefinite at high kappa, so whiten
    through kk's own eigendecomposition and drop near-null directions
    instead of trusting a Cholesky."""
    w, u = np.linalg.eigh(0.5 * (kk + kk.T))
    keep = w > max(float(w.max()), 0.0) * 1e-8
    if not np.any(keep):
        raise ValueError("buckling subspace collapsed — K-Gram has no "
                         "positive directions (float32 could not resolve "
                         "this pencil; see docstring)")
    wh = u[:, keep] / np.sqrt(w[keep])[None, :]       # wh^T kk wh = I
    b = wh.T @ ag @ wh
    mu_all, z = np.linalg.eigh(0.5 * (b + b.T))
    order = np.argsort(mu_all)[::-1]                   # largest mu first
    return mu_all[order], wh @ z[:, order]             # q^T kk q = I


def _banded_buckling(problem, n_modes, data, n_iter, cg_tol, seed,
                     device=None) -> BucklingResult:
    """Large-mesh buckling on the banded DIA operator: subspace iteration
    Y = A X + s X on A = K^-1 (-K_g), s = 2 max|mu_Ritz| after the first
    pass, so that dominance follows algebraic mu and the destabilizing
    directions converge first (the pencil's left side is indefinite).
    Rayleigh-Ritz always extracts mu of the original pencil."""
    from ..ops import dia
    from ..ops.cg import stiffness_coefficients
    from ..ops.dia import assemble_dia
    from ..ops.geometric import assemble_geometric_dia
    from ..ops.kernels.dia_kernel import dia_matvec
    from ..ops.mg import mask_dia
    from ..utils import prng
    from . import newton
    from .modal import _start_vectors

    data = data if data is not None else problem.to_device(device)
    dtype = data.loads.dtype
    mask = data.free_mask
    layout = newton._dia_layout_of(problem, data)
    if layout is None:
        raise ValueError("large-mesh buckling requires a banded (DIA) "
                         "operator; renumber the mesh (ops/reorder.py)")
    if data.device.type == "cuda":
        require_float32(dtype, f"banded buckling analysis ({BANDED_KERNELS})")
    offsets = tuple(int(o) for o in layout.offsets)
    material = problem.material.to(data.device)
    s = stiffness_coefficients(data, material, 1.0)
    kd = mask_dia(offsets, assemble_dia(layout, s, data.gvec),
                  mask).contiguous()
    ndof = layout.ndof

    def block_mv(diags, x):
        return torch.stack([dia_matvec(layout, diags, x[j])
                            for j in range(x.shape[0])])

    u_base = dia.dia_cg_solve(layout, kd, data.loads * mask, mask,
                              tol=cg_tol, max_iter=40 * ndof)[0]
    n_e = element_axial_forces(data, material, u_base)
    kgd = mask_dia(offsets, assemble_geometric_dia(layout, data, n_e), mask)
    kgd[offsets.index(0)] -= 1.0 - mask    # pure M K_g M (no identity rows)
    kgd = kgd.contiguous()

    n_free = int(problem.free_fixed()[0].size)
    k_block = min(2 * n_modes + 4, n_free)
    x = _start_vectors(prng.PRNGKey(seed), ndof, k_block, mask) \
        * mask[None, :]

    shift = 0.0
    mu = mu_prev = None
    key = prng.PRNGKey(seed + 1)
    for it in range(n_iter):
        y = block_solve(layout, kd, -block_mv(kgd, x), mask, cg_tol, x)
        if shift:
            y = y + shift * x
        kk = (y @ block_mv(kd, y).T).cpu().double().numpy()
        ag = (y @ (-block_mv(kgd, y)).T).cpu().double().numpy()
        mu_prev = mu
        mu, q = _ritz(ag, kk)
        x = torch.as_tensor(np.ascontiguousarray(q.T),
                            dtype=dtype).to(data.device) @ y
        if q.shape[1] < k_block:
            # Refill rank-truncated directions with fresh random masked
            # vectors so the subspace keeps its breadth.
            key, sub = prng.split(key)
            fresh = _start_vectors(sub, ndof, k_block - q.shape[1], mask) \
                * mask[None, :]
            x = torch.cat([x, fresh])
        if it == 0:
            shift = 2.0 * float(np.max(np.abs(mu))) + 1e-12

    # Ritz-value change over the last iteration; only the destabilizing
    # (positive-mu) directions gate ok.
    if mu_prev is None:
        ok = False      # n_iter < 2: no convergence evidence at all
    else:
        ok = True
        n_cmp = min(mu.size, mu_prev.size, n_modes)
        pos = mu[:n_cmp] > 0
        if np.any(pos):
            change = np.abs(mu[:n_cmp] - mu_prev[:n_cmp]) / np.maximum(
                np.abs(mu[:n_cmp]), 1e-30)
            ok = bool(np.all(change[pos] < 1e-3))
    if not ok:
        logger.warning(
            "buckling_analysis: Ritz values not converged after %d "
            "subspace iterations — BucklingResult.ok=False (raise n_iter)",
            n_iter)

    if mu.size < n_modes:   # rank truncation on the last iteration
        mu = np.concatenate([mu, np.full(n_modes - mu.size, -np.inf)])
    mu_m = mu[:n_modes]
    with np.errstate(divide="ignore"):
        lam = np.where(mu_m > 0, 1.0 / np.where(mu_m > 0, mu_m, 1.0), np.inf)
    return BucklingResult(
        load_factors=np.asarray(lam, dtype=float),
        modes=x[:n_modes].T.cpu().numpy(),
        axial_forces=n_e.cpu().numpy(), u_base=u_base.cpu().numpy(), ok=ok)


def buckling_analysis(problem: TrussProblem, n_modes: int = 4, data=None,
                      host: Optional[bool] = None, n_iter: int = 30,
                      cg_tol: float = 1e-8, seed: int = 0, mesh=None,
                      device=None) -> BucklingResult:
    """Critical load factors and buckling modes (see module docstring):
    the structure loses stability at loads = load_factors[0] * loads.

    The JAX package's arguments: banded subspace iteration above
    DENSE_DOF_LIMIT; below it the dense float64 path when host is None
    and no `data` is given (a ProblemData may carry replaced loads, which
    the float64 path, reading problem.loads, would ignore), host=True for
    it on the CPU, host=False for the dense path in the working dtype.
    mesh= is not ported.  The port's own: device, where to solve when
    `data` is not given ("cuda" when None)."""
    from . import newton

    refuse_mesh(mesh, "the block solves")
    free_idx, _ = problem.free_fixed()
    n_modes = min(n_modes, free_idx.size)
    if problem.ndof > newton.DENSE_DOF_LIMIT:
        return _banded_buckling(problem, n_modes, data, n_iter, cg_tol, seed,
                                device)
    if host is None or host:
        if data is not None:
            if host:
                raise ValueError("host buckling reads problem.loads; pass "
                                 "host=False to honor a custom ProblemData")
        else:
            where = torch.device("cpu") if host else resolve_device(device)
            return _float64_buckling(problem, n_modes, where)
    data = data if data is not None else problem.to_device(device)
    lam, v, n_e, u_base = _buckling_traced(problem, n_modes, data, None,
                                           None)
    free = torch.as_tensor(free_idx).to(v.device)
    shapes = torch.zeros((problem.ndof, n_modes), dtype=v.dtype,
                         device=v.device).index_copy(0, free, v)
    return BucklingResult(
        load_factors=lam.detach().cpu().numpy(),
        modes=shapes.detach().cpu().numpy(),
        axial_forces=n_e.detach().cpu().numpy(),
        u_base=u_base.detach().cpu().numpy())
