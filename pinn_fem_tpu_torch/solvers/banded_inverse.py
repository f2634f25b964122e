"""Young-modulus identification from measured static displacements
(counterpart of pinn_fem_tpu/solvers/banded_inverse.py), on the banded
adjoint and on the dense traced solve.

`identify_young_banded` is the large-mesh loop behind the plane, solid,
plate and shell families' `identify_*_young_banded`: the forward model is
u(E) = K(E)^-1 f through ops/dia.dia_solve_diff, so every ADAM iteration
runs exactly two banded solves, forward and adjoint (on a card the fused
PCG, kernels 1-3, twice), and memory stays O(band * ndof).  The element
family enters only through `blocks_of(young_e) -> (m, w, w)` stiffness
blocks, built in float64 and scattered once into DIA storage
(ops/dia.assemble_dia_blocks, whose float64 scatter transposes to a gather
back onto the blocks); the diagonals are rounded once to the working
dtype.  The JAX package's DiaLayoutView (a proxy that passes the scatter
map as a traced jit argument) has no role here: the layout goes in as it
is.

`identify_young_dense` is the dense tier of the same contract (the JAX
package's `identify_plane_young` / `identify_plate_young` /
`identify_shell_young`, each a traced `*_static_response`): the blocks
scattered into a dense K in the working dtype, masked, and solved by
`torch.linalg.solve` under autograd.

Parameterizations (most- to least-determined):
  zones=[[elem ids..], ..]: one log-E per zone (damage localization);
  field=True: a smooth E(x) MLP (models/fields.make_mlp_field, the JAX
      package's initial weights from the same seed) at the element
      centroids; its scale trains with the weights, as optax trains every
      leaf of the JAX MLPField;
  default: per-element log-E.

ADAM is optax.adam(learning_rate): solvers/phases.Adam (optax's
scale_by_adam) on each parameter tensor.  The loss is normalized by the
measurement scale, mean(u_meas^2), so SI-unit micrometre deflections do
not stall ADAM at its eps floor.  One host read an iteration, the loss
row, as the JAX loop's float(loss).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..models.fields import make_mlp_field
from ..ops.dia import assemble_dia_blocks, dia_solve_diff
from ..utils import prng
from ..utils.runtime import default_dtype, resolve_device
from .phases import Adam


def zone_index(zones, m: int, field: bool = False) -> np.ndarray:
    """(m,) zone of each element, -1 outside every zone; raises the JAX
    package's errors for zones with a field, ids outside [0, m) and
    overlapping zones."""
    if field:
        raise ValueError("zones and field are mutually exclusive "
                         "parameterizations")
    zone_of = np.full(m, -1, dtype=int)
    for z, ids in enumerate(zones):
        ids = np.asarray(ids, dtype=int).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= m):
            raise ValueError(f"zone {z} has element ids outside [0, {m})")
        if np.any(zone_of[ids] >= 0):
            raise ValueError(f"zone {z} overlaps an earlier zone")
        zone_of[ids] = z
    return zone_of


def young_parameterization(base_young, centroids, zones=None,
                           field: bool = False, seed: int = 0,
                           hidden_layers: int = 2,
                           neurons_per_layer: int = 16, input_dim: int = 2,
                           dtype=None, device=None):
    """(params, young_of, field_of): the starting parameter tensors, the
    map params -> (m,) Young's moduli, and params -> the trained MLPField
    (None unless field=True).  Raises the JAX package's errors for
    conflicting or malformed zones."""
    dtype = dtype or default_dtype()
    base_young = np.asarray(base_young, dtype=float)
    m = int(base_young.shape[0])
    if zones is not None:
        zone_of = zone_index(zones, m, field)
        starts = np.array([max(float(np.mean(base_young[zone_of == z])),
                               1e-12) for z in range(len(zones))])
        zone_t = torch.as_tensor(np.clip(zone_of, 0, None), device=device)
        in_zone = torch.as_tensor(zone_of >= 0, device=device)
        base_t = torch.as_tensor(base_young, dtype=dtype, device=device)

        def young_of(params):
            return torch.where(in_zone, torch.exp(params[0])[zone_t],
                               base_t)

        params = [torch.log(torch.as_tensor(starts, dtype=dtype,
                                            device=device))]
        return params, young_of, lambda params: None
    if field:
        fld = make_mlp_field(prng.PRNGKey(int(seed)),
                             hidden_layers=hidden_layers,
                             neurons_per_layer=neurons_per_layer,
                             input_dim=input_dim,
                             scale=float(np.mean(base_young)), dtype=dtype,
                             device=device)
        cent = torch.as_tensor(np.asarray(centroids, dtype=float),
                               dtype=dtype, device=device)

        def field_of(params):
            pairs = list(zip(params[:-1:2], params[1:-1:2]))
            return fld.replace(layers=pairs, scale=params[-1])

        return (fld.trainable_params() + [fld.scale],
                lambda params: field_of(params).eval_batch(cent), field_of)
    params = [torch.log(torch.as_tensor(base_young, dtype=dtype,
                                        device=device))]
    return params, lambda params: torch.exp(params[0]), lambda params: None


def value_and_grad(loss_fn: Callable, params: List[torch.Tensor]):
    """(loss, [d loss / d p]) with the parameters as fresh leaves."""
    leaves = [p.detach().requires_grad_() for p in params]
    loss = loss_fn(leaves)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def adam_step(opts: List[Adam], params: List[torch.Tensor],
              grads: List[torch.Tensor], learning_rate: float):
    """optax.adam's update p - lr * mu_hat / (sqrt(nu_hat) + eps), one
    Adam state a tensor."""
    with torch.no_grad():
        return [p - learning_rate * o.direction(g)
                for o, p, g in zip(opts, params, grads)]


def adam_fit(loss_fn: Callable, params: List[torch.Tensor], n_iter: int,
             learning_rate: float, read_each_iteration: bool = True):
    """n_iter ADAM iterations of loss_fn(params); (params, loss history
    (n_iter,) float64).  read_each_iteration: one host read an iteration,
    the loss row (the JAX Young-modulus loops' float(loss)); else the
    losses stay on the device and are read once, at the end (the JAX
    truss identification loops' one fetch)."""
    opts = [Adam(p) for p in params]
    hist = []
    for _ in range(int(n_iter)):
        loss, grads = value_and_grad(loss_fn, params)
        params = adam_step(opts, params, grads, learning_rate)
        hist.append(float(loss) if read_each_iteration else loss)
    if hist and not read_each_iteration:
        hist = torch.stack(hist).double().cpu().tolist()
    return params, np.asarray(hist, dtype=float)


def measurement(measured_dofs, measured_disp, dtype, device):
    """(index tensor, values tensor, mean-square scale) of a measurement."""
    idx = torch.as_tensor(np.asarray(measured_dofs, dtype=np.int64)
                          .reshape(-1), device=device)
    disp = np.asarray(measured_disp, dtype=float).reshape(-1)
    scale = float(max(np.mean(disp ** 2), 1e-300))
    return idx, torch.as_tensor(disp, dtype=dtype, device=device), scale


def identify_young_banded(layout, blocks_of: Callable, base_young,
                          centroids, f_np, mask_np, measured_dofs,
                          measured_disp, n_iter: int = 300,
                          learning_rate: float = 0.05, tol: float = 1e-7,
                          max_iter: int = 20000, zones=None,
                          field: bool = False, seed: int = 0,
                          hidden_layers: int = 2,
                          neurons_per_layer: int = 16, input_dim: int = 2,
                          device=None):
    """Returns (young (m,), loss_history, mlp_field_or_None).

    blocks_of(young_e (m,) working dtype) -> (m, w, w) float64 blocks on
    the device.  Each iteration: the blocks, one float64 scatter into the
    diagonals (rounded once to the working dtype), the forward
    dia_solve_diff, the loss, and the backward (the adjoint PCG, the
    diagonals' gradient, the gather back through the scatter and the
    blocks); then Adam.  device: where to solve ("cuda" when None)."""
    dev = resolve_device(device)
    dtype = default_dtype()
    idx, meas, meas_scale = measurement(measured_dofs, measured_disp,
                                        dtype, dev)
    f = torch.as_tensor(np.asarray(f_np, dtype=float), dtype=dtype,
                        device=dev)
    mask = torch.as_tensor(np.asarray(mask_np, dtype=float), dtype=dtype,
                           device=dev)
    params, young_of, field_of = young_parameterization(
        base_young, centroids, zones, field, seed, hidden_layers,
        neurons_per_layer, input_dim, dtype, dev)

    def loss_fn(params):
        diags = assemble_dia_blocks(layout, blocks_of(young_of(params)))
        u = dia_solve_diff(layout, diags.to(dtype), f, mask, tol=tol,
                           max_iter=int(max_iter))
        return torch.mean((u[idx] - meas) ** 2) / meas_scale

    params, hist = adam_fit(loss_fn, params, n_iter, learning_rate)
    with torch.no_grad():
        young = young_of(params).double().cpu().numpy()
    return young, hist, field_of(params)


def dense_masked_solve(blocks: torch.Tensor, dof_map: torch.Tensor,
                       ndof: int, f: torch.Tensor, mask: torch.Tensor,
                       u_p: torch.Tensor = None) -> torch.Tensor:
    """u = (M K M + I - M)^-1 M (f - K u_p) + u_p in f's dtype, K the
    dense float64 scatter of the blocks rounded once, u_p the prescribed
    values on the fixed DOFs (zero when None): the traced
    `*_static_response` solve of the JAX package, differentiable in the
    blocks."""
    from ..ops.assembly import scatter_add

    flat = dof_map[:, :, None] * ndof + dof_map[:, None, :]
    k = scatter_add(ndof * ndof, flat, blocks).reshape(ndof, ndof).to(
        f.dtype)
    km = mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)
    if u_p is None:
        return solve_or_nan(km, f * mask) * mask
    return solve_or_nan(km, (f - k @ u_p) * mask) * mask + u_p


def solve_or_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.linalg.solve (batched too) that returns NaN for a singular
    system instead of raising, as the JAX package's LU does (a FORM
    search that walks into a singular model then resets that limit state
    as unreachable); no host read."""
    x, info = torch.linalg.solve_ex(a, b)
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def identify_young_dense(blocks_of: Callable, dof_map, base_young,
                         centroids, f_np, mask_np, measured_dofs,
                         measured_disp, n_iter: int = 800,
                         learning_rate: float = 0.05, field: bool = False,
                         seed: int = 0, hidden_layers: int = 2,
                         neurons_per_layer: int = 16, input_dim: int = 2,
                         u_p_np=None, loads_of: Callable = None,
                         device=None):
    """The dense tier: identify_young_banded's loop with the masked dense
    solve of `dense_masked_solve` as the forward model (no zones, as in
    the JAX package; u_p_np the prescribed displacements, (ndof,) zero
    off the fixed DOFs, or None; loads_of(young_e), when given, the
    young-dependent loads added to f_np, a float64 tensor).  Returns
    (young (m,), loss_history, mlp_field_or_None)."""
    dev = resolve_device(device)
    dtype = default_dtype()
    idx, meas, meas_scale = measurement(measured_dofs, measured_disp,
                                        dtype, dev)
    f = torch.as_tensor(np.asarray(f_np, dtype=float), dtype=dtype,
                        device=dev)
    mask = torch.as_tensor(np.asarray(mask_np, dtype=float), dtype=dtype,
                           device=dev)
    dm = torch.as_tensor(np.asarray(dof_map), dtype=torch.int64,
                         device=dev)
    u_p = (None if u_p_np is None else torch.as_tensor(
        np.asarray(u_p_np, dtype=float), dtype=dtype, device=dev))
    params, young_of, field_of = young_parameterization(
        base_young, centroids, None, field, seed, hidden_layers,
        neurons_per_layer, input_dim, dtype, dev)

    def loss_fn(params):
        young_e = young_of(params)
        f_e = f if loads_of is None else f + loads_of(young_e).to(dtype)
        u = dense_masked_solve(blocks_of(young_e), dm, f.shape[0], f_e,
                               mask, u_p)
        return torch.mean((u[idx] - meas) ** 2) / meas_scale

    params, hist = adam_fit(loss_fn, params, n_iter, learning_rate)
    with torch.no_grad():
        young = young_of(params).double().cpu().numpy()
    return young, hist, field_of(params)


__all__ = ["identify_young_banded", "identify_young_dense",
           "young_parameterization", "adam_fit", "dense_masked_solve",
           "solve_or_nan",
           "measurement", "value_and_grad", "adam_step", "zone_index"]
