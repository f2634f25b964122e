"""Batched solving: many independent problems on one mesh at once
(counterpart of pinn_fem_tpu/parallel/batched.py).

The JAX package vmaps its jitted solvers over a leading problem axis.
Here every batched solve is one loop over B members that share the mesh
(nodes, elements, BCs and material structure) and differ in loads,
measured data, load factor and NN parameter values, with vmap's meaning
for the JAX while_loop: the loop runs while any member is active and a
finished member's state stays as it was (solvers/phases.py:
gd_phase_batched, nr_phase_batched).  Where three MLP fields run kernel 4
(ops/kernels/material_kernel.py), each evaluation of the members' material
is one batched launch of kernel 4, and each gradient one of kernel 4b, for
all B members.

Every function takes `device` ("cuda" when None, as everywhere in the
port) and returns torch tensors on it, under the JAX package's result
keys.  `mesh=` (sharding the batch over a device mesh) belongs to the
multi-device modules, which are not yet ported: any value but None
raises NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..models.problem import TrussProblem
from ..solvers.gd import get_theta
from ..solvers.phases import (gd_phase_batched, nr_phase_batched,
                              reactions_of_batched, theta_param_list)
from . import refuse_mesh


def _stack(xs):
    first = xs[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([x[i] for x in xs])
                           for i in range(len(first)))
    return torch.stack([x if isinstance(x, torch.Tensor)
                        else torch.from_numpy(np.array(x)) for x in xs])


def stack_thetas(thetas: List[list]) -> list:
    """Stack per-problem theta pytrees along a new leading batch axis.

    Each theta is `solvers.gd.get_theta`'s list of field layers [(W, b),
    ...]; its leaves may be torch tensors or arrays (the JAX package's
    theta through numpy), all on one device."""
    return _stack(list(thetas))


def _flat_members(theta_b: list, device, dtype) -> Optional[torch.Tensor]:
    """(B, P) flat parameters of a stacked theta, in theta order."""
    leaves = theta_param_list(theta_b)
    if not leaves:
        return None
    b = leaves[0].shape[0]
    return torch.cat([t.reshape(b, -1) for t in leaves], dim=1).to(
        device=device, dtype=dtype).contiguous()


def _unflat_members(flat: Optional[torch.Tensor], like: list) -> list:
    """A stacked theta (leaves (B, ...)) of views of flat (B, P), shaped
    as the one-member theta `like`."""
    if flat is None:
        return []
    b, k = flat.shape[0], 0
    out = []
    for layers in like:
        field = []
        for w, bias in layers:
            nw, nb = w.numel(), bias.numel()
            field.append((flat[:, k:k + nw].reshape(b, *w.shape),
                          flat[:, k + nw:k + nw + nb].reshape(b, *bias.shape)))
            k += nw + nb
        out.append(field)
    return out


def _members(problem: TrussProblem, loads_batch, config, thetas,
             measured_batch, measured_dofs, device):
    """What both GD solves set up: data, material, (B, ndof) loads, flat
    (B, P) parameters, the one-member theta and the measurements."""
    data = problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    material = problem.material.to(dev)
    loads_b = torch.as_tensor(np.asarray(loads_batch, dtype=float),
                              dtype=dtype).to(dev)
    b = loads_b.shape[0]
    theta0 = get_theta(material)
    params = _flat_members(stack_thetas(thetas if thetas is not None
                                        else [theta0] * b), dev, dtype)
    has_meas = (measured_batch is not None and measured_dofs is not None
                and config.alpha_data > 0.0
                and len(np.asarray(measured_dofs)) > 0)
    mvals = mdofs = None
    if has_meas:
        mvals = torch.as_tensor(np.asarray(measured_batch, dtype=float),
                                dtype=dtype).to(dev)
        mdofs = torch.as_tensor(np.asarray(measured_dofs, dtype=np.int64)
                                ).to(dev)
    return data, material, loads_b, params, theta0, bool(has_meas), mvals, \
        mdofs


def solve_gd_batched(problem: TrussProblem, loads_batch: np.ndarray,
                     config: Optional[SolverConfig] = None,
                     thetas: Optional[List[list]] = None,
                     measured_batch: Optional[np.ndarray] = None,
                     measured_dofs: Optional[np.ndarray] = None,
                     load_factors: Optional[np.ndarray] = None,
                     mesh=None, device=None):
    """Solve a batch of GD problems sharing one mesh topology.

    Args:
        problem: template problem (geometry, BCs, material structure).
        loads_batch: (B, ndof) per-problem external loads.
        thetas: optional list of B theta pytrees (defaults to B copies of
            the template's).
        measured_batch: optional (B, m) measured displacements at shared
            measured_dofs.
        load_factors: optional (B,) target load factors (default all 1.0).
        mesh: not yet ported (must be None).
        device: where to solve ("cuda" when None).

    Returns:
        dict with u (B, ndof), theta (stacked), reactions, iterations,
        converged, residual_norm: all batched.
    """
    refuse_mesh(mesh)
    config = config or SolverConfig()
    data, material, loads_b, params, theta0, has_meas, mvals, mdofs = \
        _members(problem, loads_batch, config, thetas, measured_batch,
                 measured_dofs, device)
    b = loads_b.shape[0]
    lf_b = torch.as_tensor(np.asarray(
        load_factors if load_factors is not None else np.ones(b),
        dtype=float), dtype=loads_b.dtype).to(data.device)
    out = gd_phase_batched(
        data, material, loads_b, torch.zeros_like(loads_b), params, lf_b,
        mvals, mdofs, has_meas, config.max_iterations, config.tolerance,
        config.learning_rate_u, config.learning_rate_theta,
        config.alpha_physics, config.alpha_data)
    reac = reactions_of_batched(data, material, loads_b, out.u, lf_b,
                                out.theta)
    return {
        "u": out.u, "theta": _unflat_members(out.theta, theta0),
        "reactions": reac, "iterations": out.n_iters,
        "converged": out.converged, "residual_norm": out.rnorm,
    }


def solve_gd_batched_incremental(problem: TrussProblem,
                                 loads_batch: np.ndarray,
                                 config: Optional[SolverConfig] = None,
                                 thetas: Optional[List[list]] = None,
                                 measured_batch: Optional[np.ndarray] = None,
                                 measured_dofs: Optional[np.ndarray] = None,
                                 mesh=None, device=None):
    """Full multi-increment GD solves for B problems at once.

    The batched analogue of driver.solve(method="gd"): every member steps
    through config.n_increments load increments with warm starts (u and
    theta; fresh Adam moments each increment).  A member freezes at its
    first failed increment: the failing increment's state is what it
    returns, and it runs no iteration after it.  Returns dict with u,
    theta, reactions, converged (no increment failed), residual_norm (the
    last increment the member ran), total_iterations: all batched (B, ...).
    """
    refuse_mesh(mesh)
    config = config or SolverConfig()
    data, material, loads_b, params, theta0, has_meas, mvals, mdofs = \
        _members(problem, loads_batch, config, thetas, measured_batch,
                 measured_dofs, device)
    b, dtype, dev = loads_b.shape[0], loads_b.dtype, data.device
    npf = np.float64 if dtype == torch.float64 else np.float32
    lf_initial = npf(config.load_factor_initial)
    lf_final = npf(config.load_factor_final)
    n_inc = config.n_increments
    u = torch.zeros_like(loads_b)
    th = params
    dead = torch.zeros(b, dtype=torch.bool, device=dev)
    rnorm = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    total = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(n_inc):
        # The JAX scan's load factor, in the working precision.
        lf = lf_initial + (npf(i + 1) / npf(n_inc)) * (lf_final - lf_initial)
        lf_b = torch.full((b,), float(lf), dtype=dtype, device=dev)
        out = gd_phase_batched(
            data, material, loads_b, u, th, lf_b, mvals, mdofs, has_meas,
            config.max_iterations, config.tolerance, config.learning_rate_u,
            config.learning_rate_theta, config.alpha_physics,
            config.alpha_data, active=~dead)
        u, th = out.u, out.theta
        rnorm = torch.where(dead, rnorm, out.rnorm)
        total = total + out.n_iters
        dead = dead | ~out.converged
    lf_f = torch.full((b,), float(lf_final), dtype=dtype, device=dev)
    reac = reactions_of_batched(data, material, loads_b, u, lf_f, th)
    return {
        "u": u, "theta": _unflat_members(th, theta0), "reactions": reac,
        "converged": ~dead, "residual_norm": rnorm,
        "total_iterations": total,
    }


def solve_nr_batched(problem: TrussProblem, loads_batch: np.ndarray,
                     config: Optional[SolverConfig] = None,
                     load_factors: Optional[np.ndarray] = None,
                     mesh=None, device=None):
    """Batched classic NR: B load cases solved simultaneously (dense
    tangent).  With all load factors equal (the default) the members share
    one tangent, factored once; otherwise each member factors its own.
    A member whose tangent does not factor returns u all NaN and
    converged false; nothing raises."""
    refuse_mesh(mesh)
    config = config or SolverConfig()
    data = problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    loads_b = torch.as_tensor(np.asarray(loads_batch, dtype=float),
                              dtype=dtype).to(dev)
    b = loads_b.shape[0]
    npf = np.float64 if dtype == torch.float64 else np.float32
    lf = np.asarray(load_factors if load_factors is not None
                    else np.ones(b), dtype=float).astype(npf)
    shared = bool(np.all(lf == lf[0]))
    out = nr_phase_batched(
        data, problem.material.to(dev), loads_b, torch.zeros_like(loads_b),
        torch.as_tensor(lf).to(dev), config.max_iterations, config.tolerance,
        config.min_denominator,
        tangent_load_factor=float(lf[0]) if shared else None)
    return {"u": out.u, "iterations": out.n_iters,
            "converged": out.converged}


def solve_transient_batched(problem: TrussProblem, dt: float, n_steps: int,
                            amplitudes: Optional[np.ndarray] = None,
                            loads_batch: Optional[np.ndarray] = None,
                            damping=(0.0, 0.0),
                            probe_dofs: Optional[np.ndarray] = None,
                            record_every: int = 1, mesh=None,
                            geometric_nonlinear: bool = False,
                            device=None):
    """B transient load cases at once (ensemble dynamics: seismic suites,
    load-history Monte Carlo).

    Args:
        amplitudes: (B, n_steps) load-scale histories (default: unit
            steps); rows may instead vary spatially via loads_batch
            (B, ndof).  Exactly one of the two may be batched; giving
            neither means B must come from the other.
        geometric_nonlinear: Green-Lagrange internal force instead of
            K u (2D/3D only, central difference).
        mesh: not yet ported (must be None).
        device: where to integrate ("cuda" when None).

    Central differences on the dense K (`assemble_system`), the lumped
    mass and Rayleigh damping (beta through K), the recurrence of the JAX
    package's batched core: one K U product a step for all members (a
    matmul; beta damping adds one), no host read in the step loop.

    Returns dict with displacements (B, n_rec, n_probe), u_final/v_final
    (B, ndof), and max_stress (B, nelm): the per-element |stress|
    envelope over the whole history (every step, not just snapshots;
    Green-Lagrange strain stress on the nonlinear path).
    """
    from ..ops.assembly import (assemble_system, material_values,
                                scatter_add_members)
    from ..ops.elements import truss2d_green_lagrange_batch
    from ..ops.mass import lumped_mass

    refuse_mesh(mesh)
    if amplitudes is None and loads_batch is None:
        raise ValueError("give amplitudes (B, n_steps) and/or "
                         "loads_batch (B, ndof)")
    if n_steps % record_every:
        raise ValueError("n_steps must be a multiple of record_every")
    if geometric_nonlinear and problem.dimension not in (2, 3):
        raise ValueError("geometric nonlinearity requires a 2D or 3D "
                         "truss (like the static GL path)")
    data = problem.to_device(device)
    dtype, dev = data.loads.dtype, data.device
    npf = np.float64 if dtype == torch.float64 else np.float32
    b = (np.asarray(amplitudes).shape[0] if amplitudes is not None
         else np.asarray(loads_batch).shape[0])
    amp_b = (torch.ones((b, n_steps), dtype=dtype, device=dev)
             if amplitudes is None
             else torch.as_tensor(np.asarray(amplitudes, dtype=float),
                                  dtype=dtype).to(dev))
    loads_b = (data.loads.expand(b, data.ndof) if loads_batch is None
               else torch.as_tensor(np.asarray(loads_batch, dtype=float),
                                    dtype=dtype).to(dev))
    if amp_b.shape != (b, n_steps) or loads_b.shape != (b, data.ndof):
        raise ValueError("amplitudes must be (B, n_steps) and loads_batch "
                         "(B, ndof) with matching B")
    probe = (torch.arange(data.ndof, device=dev) if probe_dofs is None
             else torch.as_tensor(np.asarray(probe_dofs, dtype=np.int64)
                                  ).to(dev))

    material = problem.material.to(dev)
    k = assemble_system(data, material, torch.zeros_like(data.loads))[0]
    mask = data.free_mask
    m = lumped_mass(data, material) * mask + (1.0 - mask)
    young_e, area_e = material_values(data, material, 1.0)
    alpha, beta = float(npf(damping[0])), float(npf(damping[1]))
    dt_w = float(npf(dt))
    dt2 = float(npf(dt) * npf(dt))
    inv_m = torch.where(m > 0, 1.0 / m, 0.0)
    dt2_inv_m = dt2 * inv_m
    k_t = k.T

    if geometric_nonlinear:
        # Rest nodal coordinates per element, reconstructed from the SoA
        # fields; the element constants repeated for the B members.
        dim = data.dimension
        dx0 = data.gvec[:, dim:] / data.inv_len[:, None]
        x0 = torch.stack([data.mid - 0.5 * dx0, data.mid + 0.5 * dx0],
                         dim=1).repeat(b, 1, 1)
        inv_len_b, young_b, area_b = (t.repeat(b) for t in
                                      (data.inv_len, young_e, area_e))

        def eval_state(u):
            """(f_int, |stress|) at u (B, ndof)."""
            u_e = u[:, data.dof_map].reshape(-1, data.dof_map.shape[1])
            elem = truss2d_green_lagrange_batch(x0, u_e, inv_len_b, young_b,
                                                area_b)
            f_int = scatter_add_members(
                data.ndof, data.dof_map,
                elem.fe_int.reshape(b, *data.dof_map.shape))
            return f_int, torch.abs(young_e * elem.strain.reshape(b, -1))
    else:
        def eval_state(u):
            strain = (torch.sum(data.gvec * u[:, data.dof_map], dim=-1)
                      * data.inv_len)
            return u @ k_t, torch.abs(young_e * strain)

    def residual(i, fint_u, v_lag):
        r = amp_b[:, min(i, n_steps - 1), None] * loads_b - fint_u
        if alpha != 0.0:
            r = r - alpha * (m * v_lag)
        if beta != 0.0:
            r = r - beta * (v_lag @ k_t)
        return r

    n_rec = n_steps // record_every
    records = torch.empty((b, n_rec, probe.numel()), dtype=dtype, device=dev)
    u = torch.zeros((b, data.ndof), dtype=dtype, device=dev)
    fint = torch.zeros_like(u)
    # a0 = M^-1 f_0 on the free DOFs (u0 = v0 = 0); u_prev = dt^2 a0 / 2.
    u_prev = (0.5 * dt2) * (inv_m * residual(0, fint, u) * mask)
    env = torch.zeros((b, data.nelm), dtype=dtype, device=dev)
    for i in range(n_steps):
        v_lag = (u - u_prev) / dt_w
        u, u_prev = (2.0 * u - u_prev
                     + dt2_inv_m * residual(i, fint, v_lag)) * mask, u
        fint, stress = eval_state(u)
        env = torch.maximum(env, stress)
        if (i + 1) % record_every == 0:
            records[:, (i + 1) // record_every - 1] = u[:, probe]
    return {"displacements": records, "u_final": u,
            "v_final": (u - u_prev) / dt_w, "max_stress": env}


def solve_batch_request(body: dict, device=None) -> dict:
    """JSON-payload batched solve: the process entry point the Node
    backend spawns (cli/api_batch.py).

    Payload: {"problem": <generic problem schema, the template>,
              "loads_batch": [[...], ...]      (B, ndof)
              "measured_batch": [[...], ...]?  (B, m) at the template's
                                               measured DOFs
              "incremental": bool?             full multi-increment GD}
    """
    from ..io.schema import parse_problem_dict

    parsed = parse_problem_dict(body.get("problem", {}))
    loads_b = np.asarray(body["loads_batch"], dtype=float)
    measured_b = body.get("measured_batch")
    if measured_b is not None:
        measured_b = np.asarray(measured_b, dtype=float)
        if parsed.measured_dofs is None or parsed.measured_dofs.size == 0:
            # parse_problem_dict only extracts measured DOFs for pinn*
            # solver types; a measured_batch with no resolvable DOFs
            # would otherwise be silently ignored.
            raise ValueError(
                "measured_batch given but the template problem defines "
                "no measured DOFs — set solver_type to a pinn* variant "
                "and include measured displacements in the template")
    has_nn = parsed.problem.material.has_trainable_params

    if measured_b is None and not has_nn and not body.get("incremental"):
        out = solve_nr_batched(parsed.problem, loads_b, parsed.config,
                               device=device)
        iters = out["iterations"]
    elif body.get("incremental"):
        out = solve_gd_batched_incremental(
            parsed.problem, loads_b, parsed.config,
            measured_batch=measured_b, measured_dofs=parsed.measured_dofs,
            device=device)
        iters = out["total_iterations"]
    else:
        out = solve_gd_batched(
            parsed.problem, loads_b, parsed.config,
            measured_batch=measured_b, measured_dofs=parsed.measured_dofs,
            device=device)
        iters = out["iterations"]

    return {
        "batch": int(loads_b.shape[0]),
        "converged": out["converged"].cpu().numpy().astype(bool).tolist(),
        "iterations": iters.cpu().numpy().astype(int).tolist(),
        "displacements": out["u"].cpu().numpy().astype(float).tolist(),
    }
