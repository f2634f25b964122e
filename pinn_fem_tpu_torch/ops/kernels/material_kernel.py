"""MLP material fields at element midpoints: two CUDA kernels, their twin.

Replaces pinn_fem_tpu/ops/pallas/material_kernel.py: `_material_kernel`
(launched by `_run_kernel`, entry `fused_material_coefficients`), which
evaluates the three MLP fields (E, A, rho) and s = E A / L in one pass.
The JAX package differentiates the XLA form of the same computation
(ops/assembly.material_values); here the forward sits on the GD loss's
differentiated path, so its gradient is a kernel too:

  material_coefficients           (E, A, rho, s) from (lf, x, y) and 1/L
  material_coefficients_backward  d loss / d theta from the upstream
                                  gradients of (E, A, rho, s)

`MaterialCoefficients` binds the two as one autograd.Function.  The TPU
layout (8 x TILE lane packing, weights zero-padded to 32) is not carried:
one thread per element, the nets' weights in shared memory, loops over the
nets' own widths (csrc/material.cu says what bounds each kernel).

`fused_material_coefficients(data, material, load_factor)` is the entry the
assembly calls when `fused_coefficients_supported` holds: CUDA tensors take
the kernels, CPU tensors the twin `material_coefficients_reference`, whose
autograd is the backward's twin.  A 3D truss never takes them: the kernel
feeds each net (lf, x, y), as the TPU kernel does, while the assembly gives
an input_dim=3 net on a 3D truss (x, y, z) (ROADMAP fault 3.6).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from ...models.fields import Material, MLPField
from . import _build

MAX_WIDTH = 32   # kMaxWidth in csrc/material.cu (the TPU kernel's PAD_W)
FIELDS = ("young", "area", "density")


def fused_coefficients_supported(material: Material, dimension: int) -> bool:
    """The JAX predicate (three positive MLP fields with input_dim 3, the
    same depth of 1 or 2 hidden layers, widths <= 32), plus dimension <= 2."""
    if dimension > 2:
        return False
    fields = [getattr(material, name) for name in FIELDS]
    if not all(isinstance(f, MLPField) for f in fields):
        return False
    depths = {len(f.layers) for f in fields}
    if len(depths) != 1 or depths.pop() not in (2, 3):
        return False
    for f in fields:
        if f.input_dim != 3 or not f.enforce_positive:
            return False
        if any(max(w.shape) > MAX_WIDTH for w, _ in f.layers):
            return False
    return True


def _fields(material: Material) -> List[MLPField]:
    return [getattr(material, name) for name in FIELDS]


def _kernel_inputs(mid: torch.Tensor, load_factor) -> torch.Tensor:
    """(n, 3) rows (lf, x, y), with y = 0 on a 1D truss."""
    n = mid.shape[0]
    x = torch.zeros((n, 3), dtype=mid.dtype, device=mid.device)
    x[:, 0] = float(load_factor)
    x[:, 1:1 + mid.shape[1]] = mid
    return x


def material_coefficients_reference(mid: torch.Tensor, inv_len: torch.Tensor,
                                    load_factor, material: Material
                                    ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of the forward kernel: (E, A, rho, s), each (n,).

    The kernel's arithmetic in torch ops, softplus(o) written as
    log1p(exp(-|o|)) + max(o, 0); autograd through it is the twin of the
    backward kernel."""
    x = _kernel_inputs(mid, load_factor)
    values = []
    for field in _fields(material):
        h = x
        for w, b in field.layers[:-1]:
            h = torch.tanh(h @ w + b)
        w, b = field.layers[-1]
        o = (h @ w + b)[:, 0]
        values.append((torch.log1p(torch.exp(-o.abs())) + o.clamp_min(0.0))
                      * field.scale)
    e, a, rho = values
    return e, a, rho, e * a * inv_len


def _widths(material: Material):
    """ctypes int[6]: (h1, h2) per net, h2 = 0 with one hidden layer."""
    widths = []
    for field in _fields(material):
        hidden = [w.shape[1] for w, _ in field.layers[:-1]]
        widths += [hidden[0], hidden[1] if len(hidden) > 1 else 0]
    return (ctypes.c_int * 6)(*widths)


def _check(mid: torch.Tensor, vectors=(), others=()) -> None:
    """Validate what the kernels take: contiguous float32 tensors on one
    device, (n, 1) or (n, 2) midpoints and (n,) per-element vectors."""
    n = vectors[0].shape[0] if vectors else mid.shape[0]
    for t in (mid, *vectors, *others):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if t.device != mid.device:
            raise ValueError("operands lie on different devices")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if mid.dim() != 2 or mid.shape[0] != n or mid.shape[1] not in (1, 2):
        raise ValueError("midpoints must be (n, 1) or (n, 2)")
    if any(v.shape != (n,) for v in vectors):
        raise ValueError(f"per-element vectors must be ({n},)")


def _library(widths, n_params: int):
    lib = _build.load_library()
    if lib.pft_material_n_params(widths) != n_params:
        raise ValueError("flat parameters do not match the nets' widths")
    return lib


def material_coefficients(mid: torch.Tensor, inv_len: torch.Tensor,
                          load_factor: float, params: torch.Tensor,
                          scales: torch.Tensor, widths
                          ) -> Tuple[torch.Tensor, ...]:
    """Forward kernel: (E, A, rho, s) at n elements, on the card.

    params: the three nets' flat parameters (theta order); scales: (3,);
    widths: from `_widths`."""
    n = inv_len.shape[0]
    _check(mid, (inv_len,), (params, scales))
    lib = _library(widths, params.numel())
    out = [torch.empty_like(inv_len) for _ in range(4)]
    stream = torch.cuda.current_stream(mid.device).cuda_stream
    _build.check(lib.pft_material_forward(
        mid.device.index, mid.data_ptr(), mid.shape[1], inv_len.data_ptr(),
        float(load_factor), n, params.data_ptr(), scales.data_ptr(), widths,
        *(t.data_ptr() for t in out), stream), "material_coefficients")
    material_coefficients.launches += 1
    return tuple(out)


material_coefficients.launches = 0


def material_coefficients_backward(mid, inv_len, load_factor: float,
                                   params, scales, widths, e, a,
                                   grads) -> torch.Tensor:
    """Backward kernel (with its block-partials pass): the (n_params,)
    gradient of the flat parameters.  grads: upstream (gE, gA, grho, gs),
    each (n,) or None."""
    n = inv_len.shape[0]
    grads = [None if g is None else g.contiguous() for g in grads]
    _check(mid, (inv_len, e, a, *(g for g in grads if g is not None)),
           (params, scales))
    lib = _library(widths, params.numel())
    partial = torch.empty((lib.pft_material_grad_blocks(n), params.numel()),
                          dtype=torch.float64, device=mid.device)
    grad = torch.empty_like(params)
    ptrs = [None if g is None else g.data_ptr() for g in grads]
    stream = torch.cuda.current_stream(mid.device).cuda_stream
    _build.check(lib.pft_material_backward(
        mid.device.index, mid.data_ptr(), mid.shape[1], inv_len.data_ptr(),
        float(load_factor), n, params.data_ptr(), scales.data_ptr(), widths,
        e.data_ptr(), a.data_ptr(), *ptrs, partial.data_ptr(),
        grad.data_ptr(), stream), "material_coefficients_backward")
    material_coefficients_backward.launches += 1
    return grad


material_coefficients_backward.launches = 0


class MaterialCoefficients(torch.autograd.Function):
    """(E, A, rho, s) = kernel(mid, 1/L, lf; params), differentiable in the
    flat parameters only (midpoints, lengths and lf are data; the scales
    are not trained)."""

    @staticmethod
    def forward(ctx, mid, inv_len, params, scales, load_factor, widths):
        e, a, rho, s = material_coefficients(mid, inv_len, load_factor,
                                             params, scales, widths)
        ctx.save_for_backward(mid, inv_len, params, scales, e, a)
        ctx.load_factor, ctx.widths = load_factor, widths
        ctx.set_materialize_grads(False)
        return e, a, rho, s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_e, g_a, g_rho, g_s):
        mid, inv_len, params, scales, e, a = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[2]:
            grad = material_coefficients_backward(
                mid, inv_len, ctx.load_factor, params, scales, ctx.widths,
                e, a, (g_e, g_a, g_rho, g_s))
        return None, None, grad, None, None, None


def fused_material_coefficients(data, material: Material, load_factor
                                ) -> Tuple[torch.Tensor, ...]:
    """(E, A, rho, s) at every element midpoint, each (nelm,).

    Requires fused_coefficients_supported(material, data.dimension).  CPU
    tensors take the twin; CUDA tensors the kernels (or raise)."""
    dev = data.inv_len.device
    if dev.type == "cpu":
        return material_coefficients_reference(data.mid, data.inv_len,
                                                load_factor, material)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    fields = _fields(material)
    params = torch.cat([p.reshape(-1) for f in fields
                        for p in f.trainable_params()])
    scales = torch.stack([f.scale for f in fields]).detach()
    return MaterialCoefficients.apply(data.mid, data.inv_len, params,
                                      scales.to(dev), float(load_factor),
                                      _widths(material))
