"""MLP material fields at element midpoints: two CUDA kernels, their twin.

Replaces pinn_fem_tpu/ops/pallas/material_kernel.py: `_material_kernel`
(launched by `_run_kernel`, entry `fused_material_coefficients`), which
evaluates the three MLP fields (E, A, rho) and s = E A / L in one pass.
The JAX package differentiates the XLA form of the same computation
(ops/assembly.material_values); here the forward sits on the GD loss's
differentiated path, so its gradient is a kernel too:

  material_coefficients           (E, A, rho, s) from (lf, x, y) and 1/L
  material_coefficients_backward  d loss / d theta from the upstream
                                  gradients of (E, A, rho, s): one launch

`MaterialCoefficients` binds the two as one autograd.Function.  The TPU
layout (8 x TILE lane packing, weights zero-padded to 32) is not carried:
both kernels pad each net to a multiple of 4 and run it through one
routine that keeps the activations in registers; the backward sums its
parameter terms as 4 x 4 outer products (csrc/material.cu says what bounds
each kernel).  The forward's grid is planned once per device, widths and
element count (`forward_plan` on the card's occupancy, `_forward_plan`);
the backward's launch likewise, per stream too (`_grad_plan`: grid,
float64 scratch, tickets), so a call is one ctypes call and calls on two
streams never share scratch.

`fused_material_coefficients(data, material, load_factor)` is the entry the
assembly calls when `fused_coefficients_supported` holds: CUDA tensors take
the kernels, CPU tensors the twin `material_coefficients_reference`, whose
autograd is the backward's twin.  `material_coefficients_backward_reference`
is the backward's plain form, the kernel's arithmetic and summation order
in torch ops; the tests and chip_smoke.py hold the kernel to it, the main
path never calls it.  A 3D truss never takes the kernels: the kernel
feeds each net (lf, x, y), as the TPU kernel does, while the assembly gives
an input_dim=3 net on a 3D truss (x, y, z) (ROADMAP fault 3.6).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import List, NamedTuple, Tuple

import torch

from ...models.fields import Material, MLPField
from . import _build

MAX_WIDTH = 32   # kMaxWidth in csrc/material.cu (the TPU kernel's PAD_W)
TILE = 128       # kTile: the backward's rows a tile and threads a block
# The plain backward's default grid off the card: one block per tile, at
# most the H100's 132 SMs x 3 resident blocks.
CPU_BLOCKS = 3 * 132
# The forward kernel's two builds (csrc/material.cu): nets of at most
# NARROW_QUADS quads (widths <= 20) take two elements a thread in blocks of
# up to 256 threads, wider nets one element in blocks of up to 128.
NARROW_QUADS = 5
FORWARD_MAX_THREADS = {2: 256, 1: 128}
# Warps an SM needs to issue without pause (two a scheduler): the plan
# counts a scheduler with fewer as if it had them.
FORWARD_MIN_WARPS = 8
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


def _widths(material: Material) -> Tuple[int, ...]:
    """(h1, h2) per net, h2 = 0 with one hidden layer: six ints."""
    widths = []
    for field in _fields(material):
        hidden = [w.shape[1] for w, _ in field.layers[:-1]]
        widths += [hidden[0], hidden[1] if len(hidden) > 1 else 0]
    return tuple(widths)


# ------------------------------------------------- the backward's plain form

def _grad_net(h1: int, h2: int) -> Tuple[int, int]:
    """(jobs, slices) of one net in the backward kernel (grad_net in
    csrc/material.cu): 4 x 4 outer-product jobs over the hidden layers
    padded to P = 4 q, and kTile // jobs row slices per job."""
    q = -(-max(h1, h2) // 4)
    jobs = q * q + 3 * q + 1 if h2 else 2 * q + 1
    return jobs, TILE // jobs


def grad_groups(blocks: int) -> Tuple[int, int]:
    """(group size, groups) of the backward's final sums: groups of
    ceil(sqrt(blocks)) consecutive blocks."""
    size = math.isqrt(blocks - 1) + 1 if blocks > 1 else 1
    return size, -(-blocks // size)


def _nets(widths):
    """(h1, h2, first parameter, parameter count) per net."""
    out, offset = [], 0
    for f in range(len(FIELDS)):
        h1, h2 = widths[2 * f], widths[2 * f + 1]
        count = 4 * h1 + (h1 * h2 + h2 if h2 else 0) + (h2 or h1) + 1
        out.append((h1, h2, offset, count))
        offset += count
    return out


def _nets_on(grads) -> List[bool]:
    """Which nets carry a gradient: young needs gE or gs, area gA or gs,
    density grho.  A net without one has exactly zero gradient."""
    g_e, g_a, g_rho, g_s = grads
    return [g_e is not None or g_s is not None,
            g_a is not None or g_s is not None, g_rho is not None]


def _slice_rows(slices: int) -> torch.Tensor:
    """(slices, longest) row offsets of each row slice of a tile, -1 past
    a slice's end: slice s holds rows [s T / S, (s + 1) T / S)."""
    bounds = [s * TILE // slices for s in range(slices + 1)]
    longest = max(b - a for a, b in zip(bounds, bounds[1:]))
    rows = torch.full((slices, longest), -1, dtype=torch.int64)
    for s in range(slices):
        rows[s, :bounds[s + 1] - bounds[s]] = torch.arange(bounds[s],
                                                           bounds[s + 1])
    return rows


def _block_rows(n: int, blocks: int, slices: int) -> torch.Tensor:
    """(blocks, tiles, slices, longest) element of each row of each slice
    of each tile of each block, n where there is none: block b takes the
    elements [b n / B, (b + 1) n / B), TILE at a time."""
    b = torch.arange(blocks)
    first, end = b * n // blocks, (b + 1) * n // blocks
    tiles = -(-int((end - first).max()) // TILE)
    offsets = _slice_rows(slices)
    rows = (first[:, None, None, None]
            + torch.arange(tiles)[None, :, None, None] * TILE
            + offsets[None, None])
    valid = (offsets >= 0) & (rows < end[:, None, None, None])
    return torch.where(valid, rows, n)


def _segment_sums(columns, rows: torch.Tensor) -> torch.Tensor:
    """float32 sums of a net's parameter terms over each row slice:
    (blocks, tiles, slices, n_params_net).  columns: [(left, right)], each
    (n, k) and (n, m), whose outer products summed over rows give a block
    of parameters in row-major order; rows: from `_block_rows`."""
    rows = rows.to(columns[0][1].device)
    out = []
    for left, right in columns:
        lz = torch.cat([left, left.new_zeros(1, left.shape[1])])[rows]
        rz = torch.cat([right, right.new_zeros(1, right.shape[1])])[rows]
        lz = lz.reshape(-1, *lz.shape[-2:])
        rz = rz.reshape(-1, *rz.shape[-2:])
        out.append(torch.bmm(lz.transpose(1, 2), rz)
                   .reshape(*rows.shape[:3], -1))
    return torch.cat(out, dim=3)


def _block_order_sum(seg: torch.Tensor) -> torch.Tensor:
    """The kernel's float64 order over (blocks, tiles, slices, k) float32
    sums: each block adds its tiles' sums in tile order per slice (a tile
    it does not have adds +0), then its slices in slice order; each group
    adds its blocks in block order, and the groups are added in group
    order.  Returns (k,) float64."""
    blocks, tiles, slices, k = seg.shape
    acc = torch.zeros(blocks, slices, k, dtype=torch.float64,
                      device=seg.device)
    for j in range(tiles):
        acc += seg[:, j].double()
    partial = torch.zeros(blocks, k, dtype=torch.float64, device=seg.device)
    for s in range(slices):
        partial += acc[:, s]
    size, groups = grad_groups(blocks)
    total = torch.zeros(k, dtype=torch.float64, device=seg.device)
    for g in range(groups):
        group = torch.zeros(k, dtype=torch.float64, device=seg.device)
        for b in range(g * size, min((g + 1) * size, blocks)):
            group += partial[b]
        total += group
    return total


def material_coefficients_backward_reference(mid, inv_len, load_factor,
                                             params, scales, widths, e, a,
                                             grads, blocks=None
                                             ) -> torch.Tensor:
    """Plain version of the backward kernel: the (n_params,) gradient of
    the flat parameters from the upstream gradients (gE, gA, grho, gs),
    each (n,) or None.

    It recomputes each net's activations, backpropagates to the deltas,
    sums the parameter terms over each row slice of each tile of each
    block's elements in float32 and adds those sums in float64 in the
    kernel's tile, slice, block and group order; nets without an upstream
    gradient are skipped (exact zeros).  blocks: the kernel's grid
    (default: the plan the kernel takes on a CUDA device, else one block
    per tile up to CPU_BLOCKS).  The float32 sums within a slice are taken
    in another order than the kernel's, so the two agree to rounding, not
    bit for bit."""
    n = inv_len.shape[0]
    widths = tuple(widths)
    tiles = -(-n // TILE)
    if blocks is None:
        blocks = (_grad_plan(mid.device, _build.current_stream(mid.device),
                             widths, n)[0].blocks
                  if mid.device.type == "cuda"
                  else max(1, min(tiles, CPU_BLOCKS)))
    x = _kernel_inputs(mid, load_factor)
    ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    g_rho, g_s = grads[2], grads[3]
    on = _nets_on(grads)
    grad = torch.zeros_like(params)
    for f, (h1, h2, off, count) in enumerate(_nets(widths)):
        if not on[f] or n == 0:
            continue
        p = params[off:off + count]
        w1, b1 = p[:3 * h1].reshape(3, h1), p[3 * h1:4 * h1]
        q = p[4 * h1:]
        a1 = torch.tanh(x @ w1 + b1)
        last = a1
        if h2:
            w2, b2 = q[:h1 * h2].reshape(h1, h2), q[h1 * h2:h1 * h2 + h2]
            q = q[h1 * h2 + h2:]
            a2 = torch.tanh(a1 @ w2 + b2)
            last = a2
        w3, b3 = q[:-1], q[-1]
        o = last @ w3 + b3
        if f == 2:
            dv = g_rho
        else:
            dv = (grads[f] if grads[f] is not None
                  else torch.zeros_like(inv_len))
            if g_s is not None:
                dv = dv + g_s * (a if f == 0 else e) * inv_len
        d_out = (dv * torch.sigmoid(o) * scales[f])[:, None]
        if h2:
            d2 = d_out * w3 * (1.0 - a2 * a2)
            d1 = (d2 @ w2.T) * (1.0 - a1 * a1)
            columns = [(x, d1), (ones, d1), (a1, d2), (ones, d2),
                       (a2, d_out), (ones, d_out)]
        else:
            d1 = d_out * w3 * (1.0 - a1 * a1)
            columns = [(x, d1), (ones, d1), (a1, d_out), (ones, d_out)]
        seg = _segment_sums(columns,
                            _block_rows(n, blocks, _grad_net(h1, h2)[1]))
        grad[off:off + count] = _block_order_sum(seg).to(grad.dtype)
    return grad


# --------------------------------------------------- the forward's grid

class ForwardPlan(NamedTuple):
    per_thread: int   # elements a thread at a time (1 or 2)
    threads: int      # threads a block (a multiple of 32)
    blocks: int


def forward_elements(widths) -> int:
    """Elements a thread of the forward kernel for these widths."""
    quads = max(-(-h // 4) for h in widths)
    return 2 if quads <= NARROW_QUADS else 1


def forward_form(n: int, per_thread: int, resident: int, sms: int
                 ) -> Tuple[int, int]:
    """(elements a thread, threads a block) for n elements.  128 threads
    while one pass of every warp covers n with `resident` blocks of 128 on
    each of the sms SMs (more, smaller blocks spread one pass evenly);
    beyond, with two elements a thread, 256 (on the H100 a million
    elements ran 9-18 % faster in blocks of 256 than of 128)."""
    if n <= sms * resident * 128 * per_thread or per_thread == 1:
        return per_thread, 128
    return per_thread, 256


def forward_plan(n: int, resident: int, sms: int, per_thread: int,
                 threads: int) -> ForwardPlan:
    """The forward kernel's grid for n elements, given the blocks of this
    form one SM holds (`resident`, the card's occupancy) and the SM count.

    The kernel splits the elements evenly over the grid's warps, each
    taking 32 * per_thread at a time.  Up to one block an SM: a block per
    32 * per_thread elements a warp.  Beyond: m blocks an SM (m <=
    resident), so every SM and every warp scheduler gets the same work;
    m is the one with the least (warps an SM, at least FORWARD_MIN_WARPS)
    x (passes of the longest warp), the time of an SM that issues without
    pause, the larger m on a tie (more warps to hide latency)."""
    if per_thread not in FORWARD_MAX_THREADS or threads % 32 or not (
            32 <= threads <= FORWARD_MAX_THREADS[per_thread]):
        raise ValueError(f"no forward form ({per_thread}, {threads})")
    step = 32 * per_thread
    warps_block = threads // 32
    tiles = -(-n // (step * warps_block))
    if tiles <= sms:
        return ForwardPlan(per_thread, threads, max(tiles, 1))
    best_cost, best_m = None, 1
    for m in range(1, max(resident, 1) + 1):
        warps = sms * m * warps_block
        passes = -(-(-(-n // warps)) // step)
        cost = max(m * warps_block, FORWARD_MIN_WARPS) * passes
        if best_cost is None or cost <= best_cost:
            best_cost, best_m = cost, m
    return ForwardPlan(per_thread, threads, sms * best_m)


# ------------------------------------------------------------ the kernels

class GradPlan(ctypes.Structure):
    """Mirror of struct GradPlan in csrc/material.cu: the backward's grid
    and scratch for one device, widths and element count."""
    _fields_ = [("device", ctypes.c_int), ("blocks", ctypes.c_int),
                ("group_size", ctypes.c_int), ("shared_bytes", ctypes.c_int),
                ("widths", ctypes.c_int * 6), ("n", ctypes.c_int64),
                ("partial", ctypes.c_void_p), ("group_part", ctypes.c_void_p),
                ("tickets", ctypes.c_void_p)]


assert ctypes.sizeof(GradPlan) == 72


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


_WIDTHS = {}   # (widths, n_params) -> ctypes int[6], checked by the library
_FORWARD_PLANS = {}  # (device, widths, n) -> (ForwardPlan, occupancy)
_PLANS = {}    # (device, stream, widths, n) -> (GradPlan, its scratch)
_PLANS_LOCK = threading.Lock()


def _library(widths, n_params: int):
    """The kernel library and the widths as a ctypes array, checked
    against the flat parameter count once per widths."""
    lib = _build.load_library()
    key = (tuple(widths), n_params)
    arr = _WIDTHS.get(key)
    if arr is None:
        arr = (ctypes.c_int * 6)(*key[0])
        if lib.pft_material_n_params(arr) != n_params:
            raise ValueError("flat parameters do not match the nets' widths")
        _WIDTHS[key] = arr
    return lib, arr


def _grad_plan(device: torch.device, stream: int, widths, n: int):
    """The backward's plan for one device, stream, widths and n, made
    once: the grid from the card's occupancy, the float64 partials, the
    group sums and the zeroed tickets (reset by the kernel's last block).
    Launches on one stream run in turn, so each stream's scratch is used
    by one launch at a time; launches on two streams may overlap and get
    two scratch sets.  The plans are never freed."""
    key = (device.index, stream, tuple(widths), n)
    entry = _PLANS.get(key)
    if entry is not None:
        return entry
    with _PLANS_LOCK:
        entry = _PLANS.get(key)
        if entry is not None:
            return entry
        lib = _build.load_library()
        plan = GradPlan(device=device.index, widths=(ctypes.c_int * 6)(
            *key[2]), n=n)
        sizes = (ctypes.c_int64 * 3)()
        _build.check(lib.pft_material_grad_plan(ctypes.byref(plan), sizes),
                     "material_coefficients_backward plan")
        scratch = (torch.empty(sizes[0], dtype=torch.float64, device=device),
                   torch.empty(sizes[1], dtype=torch.float64, device=device),
                   torch.zeros(sizes[2], dtype=torch.int32, device=device))
        plan.partial, plan.group_part, plan.tickets = (
            t.data_ptr() for t in scratch)
        entry = _PLANS[key] = (plan, scratch)
    return entry


def _forward_occupancy(device: torch.device, form, widths):
    """(blocks an SM, SMs, registers a thread, local-memory bytes a thread)
    of the forward kernel in this form for these widths, from the
    library."""
    occ = (ctypes.c_int * 4)()
    _build.check(_build.load_library().pft_material_forward_occupancy(
        device.index, *form, (ctypes.c_int * 6)(*widths), occ),
        "material_coefficients plan")
    return tuple(occ)


def _forward_plan(device: torch.device, widths, n: int):
    """(ForwardPlan, occupancy) of the forward kernel for one device,
    widths and n, made once (occupancy: `_forward_occupancy` of the
    plan's form)."""
    key = (device.index, tuple(widths), n)
    entry = _FORWARD_PLANS.get(key)
    if entry is None:
        first = (forward_elements(key[1]), 128)
        occ = _forward_occupancy(device, first, key[1])
        form = forward_form(n, first[0], occ[0], occ[1])
        if form != first:
            occ = _forward_occupancy(device, form, key[1])
        entry = _FORWARD_PLANS[key] = (forward_plan(n, occ[0], occ[1], *form),
                                       occ)
    return entry


def material_coefficients(mid: torch.Tensor, inv_len: torch.Tensor,
                          load_factor: float, params: torch.Tensor,
                          scales: torch.Tensor, widths
                          ) -> Tuple[torch.Tensor, ...]:
    """Forward kernel: (E, A, rho, s) at n elements, on the card.

    params: the three nets' flat parameters (theta order); scales: (3,);
    widths: from `_widths`."""
    n = inv_len.shape[0]
    _check(mid, (inv_len,), (params, scales))
    lib, arr = _library(widths, params.numel())
    out = [torch.empty_like(inv_len) for _ in range(4)]
    if n == 0:
        return tuple(out)
    plan, _ = _forward_plan(mid.device, widths, n)
    _build.check(lib.pft_material_forward(
        mid.device.index, mid.data_ptr(), mid.shape[1], inv_len.data_ptr(),
        float(load_factor), n, params.data_ptr(), scales.data_ptr(), arr,
        *plan, *(t.data_ptr() for t in out),
        _build.current_stream(mid.device)), "material_coefficients")
    material_coefficients.launches += 1
    return tuple(out)


material_coefficients.launches = 0


def material_coefficients_backward(mid, inv_len, load_factor: float,
                                   params, scales, widths, e, a,
                                   grads) -> torch.Tensor:
    """Backward kernel, one launch: the (n_params,) gradient of the flat
    parameters.  grads: upstream (gE, gA, grho, gs), each (n,) or None."""
    grads = [None if g is None else g.contiguous() for g in grads]
    _check(mid, (inv_len, e, a, *(g for g in grads if g is not None)),
           (params, scales))
    _library(widths, params.numel())
    return _backward_launch(mid, inv_len, load_factor, params, scales,
                            widths, e, a, grads)


def _backward_launch(mid, inv_len, load_factor, params, scales, widths, e,
                     a, grads) -> torch.Tensor:
    """The launch itself, on operands the forward has checked (grads
    contiguous and of the outputs' shape)."""
    stream = _build.current_stream(mid.device)
    plan, _ = _grad_plan(mid.device, stream, widths, inv_len.shape[0])
    grad = torch.empty_like(params)
    _build.check(_build.load_library().pft_material_backward(
        ctypes.byref(plan), mid.data_ptr(), mid.shape[1], inv_len.data_ptr(),
        float(load_factor), inv_len.shape[0], params.data_ptr(),
        scales.data_ptr(), e.data_ptr(), a.data_ptr(),
        *(None if g is None else g.data_ptr() for g in grads),
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
            grad = _backward_launch(
                mid, inv_len, ctx.load_factor, params, scales, ctx.widths,
                e, a, [None if g is None else g.contiguous()
                       for g in (g_e, g_a, g_rho, g_s)])
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
