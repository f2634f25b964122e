"""Fused Jacobi-PCG iteration on the banded operator: two CUDA kernels.

Replaces pinn_fem_tpu/ops/pallas/cg_kernel.py: `_dir_matvec_kernel`
(launched by `_dir_matvec`) and `_update_kernel` (launched by `_update`),
driven by `fused_cg_solve`.  One PCG iteration is two kernel passes:

  dia_dir_matvec:  p_new = z + beta * p ; ap = mask * (K p_new) ;
                   per-block partials of p_new . ap
  cg_update:       x += alpha p ; r -= alpha ap ; z = inv_diag * r (in place)
                   per-block partials of r . z and r . r

Both are bound by memory: about (nd + 5) * ndof * 4 bytes per direction
pass and 8 * ndof * 4 bytes per update.  Folding the direction update into
the stencil pass and the dot products into both passes keeps each vector to
one trip through memory per iteration (see csrc/dia_cg.cu).

The scalar recurrences (alpha = rz / pAp, beta = rz' / rz), the sums of
the block partials, the iteration count and the stop test stay on the
device as 0-d tensors.  When the stop test holds, a device flag makes both
kernels return without writing, which freezes the state; the host reads the
flag only every CHECK_EVERY iterations, so the iteration count is that of a
loop that tested every iteration.

The twins sum each block of THREADS rows by the kernels' own pairwise tree,
so kernel and twin agree bit for bit, partials included, and
`fused_cg_solve` and its twin recurrence `fused_cg_solve_reference` run the
same iterations.  Against the plain recurrence
(ops.dia.dia_cg_solve_reference) the sums are taken in another order, so
values agree to float32 rounding; the contract and the breakdown guards are
the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .dia_kernel import check_operands, dia_matvec, dia_matvec_reference

CHECK_EVERY = 32
THREADS = 256  # rows per block: kThreads in csrc/dia_cg.cu


def block_sums(v: torch.Tensor) -> torch.Tensor:
    """(nb,) sums of consecutive blocks of THREADS entries of v, each taken
    by the pairwise tree of the kernels' shared-memory reduction."""
    n = v.shape[0]
    nb = max(-(-n // THREADS), 1)
    buf = torch.nn.functional.pad(v, (0, nb * THREADS - n)).reshape(nb, THREADS)
    s = THREADS // 2
    while s:
        buf = buf[:, :s] + buf[:, s:2 * s]
        s //= 2
    return buf[:, 0]


def _library():
    lib = _build.load_library()
    if lib.pft_threads_per_block() != THREADS:
        raise RuntimeError("kernel library and THREADS disagree")
    return lib


def _flag_ptr(stop: Optional[torch.Tensor], device) -> Optional[int]:
    if stop is None:
        return None
    if stop.dtype != torch.bool or stop.numel() != 1 or stop.device != device:
        raise ValueError("stop must be a one-element bool tensor on the "
                         "kernel's device")
    return stop.data_ptr()


def dir_matvec_reference(beta, z, p, layout, diags, mask, stop=None):
    """Plain twin of the direction kernel: (p_new, ap, partials).

    Where `stop` is set the kernel writes nothing and its outputs are
    undefined; the twin computes them all the same."""
    p_new = z + beta * p
    ap = dia_matvec_reference(layout, diags, p_new) * mask
    return p_new, ap, block_sums(p_new * ap)


def dia_dir_matvec(beta: torch.Tensor, z: torch.Tensor, p: torch.Tensor,
                   layout, diags: torch.Tensor, mask: torch.Tensor,
                   stop: Optional[torch.Tensor] = None):
    """p_new = z + beta p, ap = mask (K p_new), and per-block p_new . ap.

    beta: 0-d float32 tensor on the device (never read on the host).
    stop: optional one-element bool tensor; when true nothing is written.
    Returns (p_new, ap, partials); partials has one entry per block.
    """
    if z.device.type == "cpu":
        return dir_matvec_reference(beta, z, p, layout, diags, mask, stop)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")
    ndof = layout.ndof
    check_operands(ndof, vectors=(z, p, mask), scalars=(beta,), diags=diags,
                   nd=layout.n_diags)
    lib = _library()
    p_new = torch.empty_like(z)
    ap = torch.empty_like(z)
    partials = torch.empty(-(-ndof // THREADS), dtype=z.dtype, device=z.device)
    offsets = layout.offsets_on(z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    _build.check(lib.pft_dia_dir_matvec(
        z.device.index, beta.data_ptr(), z.data_ptr(), p.data_ptr(),
        diags.data_ptr(), offsets.data_ptr(), layout.n_diags, ndof,
        mask.data_ptr(), p_new.data_ptr(), ap.data_ptr(), partials.data_ptr(),
        _flag_ptr(stop, z.device), stream), "dia_dir_matvec")
    dia_dir_matvec.launches += 1
    return p_new, ap, partials


dia_dir_matvec.launches = 0


def cg_update_reference(alpha, x, r, p, ap, inv_diag, z, stop=None):
    """Plain twin of the update kernel: updates x, r and z in place (left
    as they are where `stop` is set) and returns the (nb, 2) partials
    [r . z, r . r]."""
    x_new = x + alpha * p
    r_new = r - alpha * ap
    z_new = inv_diag * r_new
    partials = torch.stack([block_sums(r_new * z_new),
                            block_sums(r_new * r_new)], dim=1)
    if stop is not None:
        x_new = torch.where(stop, x, x_new)
        r_new = torch.where(stop, r, r_new)
        z_new = torch.where(stop, z, z_new)
    x.copy_(x_new)
    r.copy_(r_new)
    z.copy_(z_new)
    return partials


def cg_update(alpha: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
              p: torch.Tensor, ap: torch.Tensor, inv_diag: torch.Tensor,
              z: torch.Tensor, stop: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """x += alpha p, r -= alpha ap, z = inv_diag r, all three in place.

    Returns the (nb, 2) per-block partials [r . z, r . r].  alpha and stop
    as in dia_dir_matvec.
    """
    if x.device.type == "cpu":
        return cg_update_reference(alpha, x, r, p, ap, inv_diag, z, stop)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n = x.shape[0]
    check_operands(n, vectors=(x, r, p, ap, inv_diag, z), scalars=(alpha,))
    lib = _library()
    partials = torch.empty(-(-n // THREADS), 2, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.pft_cg_update(
        x.device.index, alpha.data_ptr(), x.data_ptr(), r.data_ptr(),
        p.data_ptr(), ap.data_ptr(), inv_diag.data_ptr(), z.data_ptr(), n,
        partials.data_ptr(), _flag_ptr(stop, x.device), stream), "cg_update")
    cg_update.launches += 1
    return partials


cg_update.launches = 0


def _pcg(matvec, dir_matvec, update, layout, diags, rhs, free_mask, tol,
         max_iter, x0):
    """The fused PCG recurrence over the given matvec / direction / update
    operations (kernels or twins)."""
    from ..dia import dia_diagonal

    mask = free_mask
    dev, dt = rhs.device, rhs.dtype
    b_vec = rhs * mask
    diag = dia_diagonal(layout, diags) * mask + (1.0 - mask)
    inv_diag = (1.0 / diag) * mask  # fixed rows: r == 0 anyway
    b_norm = torch.clamp_min(torch.linalg.vector_norm(b_vec), 1e-30)
    tol_b = torch.as_tensor(tol, dtype=dt, device=dev) * b_norm
    tiny = torch.tensor(1e-30, dtype=dt, device=dev)

    if x0 is None:
        x = torch.zeros_like(b_vec)
        r = b_vec.clone()
    else:
        x = (x0 * mask).contiguous()
        r = b_vec - matvec(layout, diags, x) * mask
    z = inv_diag * r
    rz = torch.dot(r, z)
    rn2 = torch.dot(r, r)
    p = torch.zeros_like(z)  # beta = 0 on the first step: p_new = z0
    beta = torch.zeros((), dtype=dt, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)

    def live_of(it, rz, rn2):
        return ((it < max_iter) & torch.isfinite(rz) & (rz > 0)
                & (torch.sqrt(rn2) > tol_b))

    live = live_of(it, rz, rn2)
    n = 0
    while n % CHECK_EVERY or bool(live):
        n += 1
        stop = torch.logical_not(live)
        p, ap, pap_parts = dir_matvec(beta, z, p, layout, diags, mask, stop)
        pap = torch.sum(pap_parts)
        alpha = rz / torch.where(pap.abs() > 0, pap, tiny)
        red = torch.sum(update(alpha, x, r, p, ap, inv_diag, z, stop), dim=0)
        rz_new, rn2_new = red[0], red[1]
        beta = torch.where(live, rz_new / torch.where(rz != 0, rz, tiny), beta)
        rz = torch.where(live, rz_new, rz)
        rn2 = torch.where(live, rn2_new, rn2)
        it = it + live
        live = live & live_of(it, rz, rn2)
    return x * mask, it, torch.sqrt(rn2) / b_norm


def fused_cg_solve(
    layout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi-PCG with the fused two-kernel iteration.

    Returns (x * mask, iterations, relative recurrence-residual norm) with
    the convergence and float32 breakdown gates of ops.dia.dia_cg_solve;
    iterations and residual are 0-d device tensors.  On CUDA tensors every
    iteration launches the two kernels (and r0 = b - A x0 the stencil).
    """
    return _pcg(dia_matvec, dia_dir_matvec, cg_update, layout, diags, rhs,
                free_mask, tol, max_iter, x0)


def fused_cg_solve_reference(
    layout,
    diags: torch.Tensor,
    rhs: torch.Tensor,
    free_mask: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 100000,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The twin recurrence: `fused_cg_solve` on the plain twins, on any
    device.  Bit-identical to the kernel path."""
    return _pcg(dia_matvec_reference, dir_matvec_reference,
                cg_update_reference, layout, diags, rhs, free_mask, tol,
                max_iter, x0)
