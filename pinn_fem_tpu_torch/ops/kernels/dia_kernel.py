"""Banded (DIA) stencil matvec: the CUDA kernel and its plain twin.

Replaces pinn_fem_tpu/ops/pallas/dia_kernel.py:_dia_kernel (launched by
`_run`).  The TPU kernel needed a diag-minor interleaved copy of the
diagonals and a 128-lane packing of u to make its DMAs contiguous; on this
card the plain (nd, ndof) row-major diagonals already give coalesced loads
(neighbouring threads own neighbouring rows), so the kernel reads the
diagonals where they lie.

Bound by memory: one call moves about (nd + 2) * ndof * 4 bytes (every
diagonal once, u once, y once) for nd multiply-adds per row.  The kernel
(`stencil_kernel` in csrc/dia_cg.cu) stages each block's window of u,
tile plus halo, in shared memory with asynchronous copies, as the TPU
kernel staged it in VMEM, and reads the diagonals as float4, four rows a
thread.  `stencil_plan` sizes the tile from the layout; a band too wide
for shared memory takes the kernel's second path, which reads u from
global memory.

Bit-identical to `dia_matvec_reference`: the kernel sums the diagonals in
the same order, with separately rounded multiplies and adds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build

SMS = 132                 # streaming multiprocessors of the H100 SXM
ROWS_PER_THREAD = 4       # kRowsPerThread in csrc/dia_cg.cu
MAX_THREADS = 256         # kThreads
SHARED_BYTES = 232_448    # the most shared memory a block may ask for


def dia_matvec_reference(layout, diags: torch.Tensor, u: torch.Tensor
                         ) -> torch.Tensor:
    """K @ u as a sum of shifted contiguous slices of zero-padded u."""
    b = layout.bandwidth
    ndof = layout.ndof
    u_pad = torch.nn.functional.pad(u, (b, b))
    acc = torch.zeros_like(u)
    for k, off in enumerate(layout.offsets.tolist()):
        start = b + off
        acc = acc + diags[k] * u_pad[start:start + ndof]
    return acc


@dataclass(frozen=True)
class StencilPlan:
    """Launch shape of the stencil kernel for one layout.

    threads: threads a block (a multiple of 32); tile: rows a block, a
    multiple of ROWS_PER_THREAD * threads; halo_lo / halo_hi: rows of u
    staged below and above the tile (the largest negative and positive
    offsets, rounded up to whole 16-byte chunks); staged: whether the
    window tile + halos fits in shared memory (else u is read from global
    memory); window: its length in floats (0 when not staged).
    """

    threads: int
    tile: int
    halo_lo: int
    halo_hi: int
    window: int
    staged: bool
    n_diags: int
    ndof: int

    @property
    def blocks(self) -> int:
        return -(-self.ndof // self.tile)

    @property
    def shared_bytes(self) -> int:
        return 4 * (self.window + self.n_diags)


def _ceil4(v: int) -> int:
    return -(-v // 4) * 4


def stencil_plan(layout) -> StencilPlan:
    """The tile for `layout`.  Filling the card comes first: the largest
    block (256 threads down to 32) that still gives SMS blocks.  Then a
    tile shorter than four bandwidths grows (a block walks it in passes)
    while the grid keeps SMS blocks and the window fits, so that the
    halo, read once per tile, stays a small share.  A window that does not
    fit at all takes the unstaged path."""
    nd, n = layout.n_diags, layout.ndof
    offs = np.asarray(layout.offsets)
    lo = max(0, -int(offs.min())) if offs.size else 0
    hi = max(0, int(offs.max())) if offs.size else 0
    halo_lo, halo_hi = _ceil4(lo), _ceil4(hi)

    def fits(tile):
        return 4 * (tile + halo_lo + halo_hi + nd) <= SHARED_BYTES

    threads = MAX_THREADS
    while threads > 32 and -(-n // (ROWS_PER_THREAD * threads)) < SMS:
        threads //= 2
    tile = ROWS_PER_THREAD * threads
    while (tile < 4 * max(lo, hi) and -(-n // (2 * tile)) >= SMS
           and fits(2 * tile)):
        tile *= 2
    staged = fits(tile)
    return StencilPlan(threads=threads, tile=tile, halo_lo=halo_lo,
                       halo_hi=halo_hi,
                       window=tile + halo_lo + halo_hi if staged else 0,
                       staged=staged, n_diags=nd, ndof=n)


@dataclass(frozen=True)
class DirectionPlan(StencilPlan):
    """Launch shape of the direction kernel (kernel 2) for one layout: a
    StencilPlan whose threads own `rows` consecutive rows each (1, 2 or
    4) and whose staged path holds two windows (z and p) and the offsets.
    One float32 partial of p_new . ap a block."""

    rows: int = ROWS_PER_THREAD

    @property
    def shared_bytes(self) -> int:
        return 4 * (2 * self.window + self.n_diags)


DIRECTION_MIN_WARPS = 8   # resident warps an SM the direction plan aims at
DIRECTION_MAX_THREADS = 128


def direction_plan(layout) -> DirectionPlan:
    """The direction kernel's partition for `layout`, a pure function of
    the layout and SMS (the CPU twin sums by it).  Rows a thread: the most
    of 4, 2, 1 that still gives DIRECTION_MIN_WARPS warps an SM over the
    whole grid (four at 2M DOFs, one at 40k, where four would leave about
    2.4).  Then the largest block of at most DIRECTION_MAX_THREADS that
    gives SMS blocks (on the H100, 128-thread blocks ran the 2M chain 2-4
    us faster than 256-thread ones and the 40k grid as fast), and, as in
    stencil_plan, a tile shorter than four bandwidths grows while the
    warps stay and two windows fit.  A band whose two windows do not fit
    takes the unstaged path."""
    nd, n = layout.n_diags, layout.ndof
    offs = np.asarray(layout.offsets)
    lo = max(0, -int(offs.min())) if offs.size else 0
    hi = max(0, int(offs.max())) if offs.size else 0
    halo_lo, halo_hi = _ceil4(lo), _ceil4(hi)
    want = DIRECTION_MIN_WARPS * SMS

    def fits(tile):
        return 4 * (2 * (tile + halo_lo + halo_hi) + nd) <= SHARED_BYTES

    def warps(tile, threads):
        return -(-n // tile) * (threads // 32)

    rows = next((r for r in (4, 2) if -(-n // (32 * r)) >= want), 1)
    threads = DIRECTION_MAX_THREADS
    while threads > 32 and -(-n // (rows * threads)) < SMS:
        threads //= 2
    tile = rows * threads
    while (tile < 4 * max(lo, hi) and warps(2 * tile, threads) >= want
           and fits(2 * tile)):
        tile *= 2
    staged = fits(tile)
    return DirectionPlan(threads=threads, tile=tile, halo_lo=halo_lo,
                         halo_hi=halo_hi,
                         window=tile + halo_lo + halo_hi if staged else 0,
                         staged=staged, n_diags=nd, ndof=n, rows=rows)


def window_offsets(layout, plan: StencilPlan, device) -> torch.Tensor:
    """The int32 offsets a kernel of `plan` reads: relative to the staged
    window (+ halo_lo), or as they are on the unstaged path."""
    shift = plan.halo_lo if plan.staged else 0
    return torch.as_tensor(np.asarray(layout.offsets) + shift,
                           dtype=torch.int32, device=device)


def check_operands(ndof: int, vectors=(), scalars=(), diags=None, nd=0
                   ) -> None:
    """Validate what the CUDA kernels take: contiguous float32 tensors on
    one card, (ndof,) vectors, 0-d scalars and (nd, ndof) diagonals."""
    tensors = [*vectors, *scalars] + ([diags] if diags is not None else [])
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError("operands lie on different devices")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for v in vectors:
        if v.shape != (ndof,):
            raise ValueError(f"vectors must be ({ndof},), got {tuple(v.shape)}")
    for s in scalars:
        if s.numel() != 1:
            raise ValueError("scalar operands must have one element")
    if diags is not None and diags.shape != (nd, ndof):
        raise ValueError(f"diagonals must be ({nd}, {ndof}), got "
                         f"{tuple(diags.shape)}")


def operand_ok(t: torch.Tensor, shape, device) -> bool:
    """The launch path's cheap test of one operand: float32, `shape`,
    contiguous, on `device`.  Where it fails, check_operands says why."""
    return (t.dtype == torch.float32 and t.shape == shape
            and t.is_contiguous() and t.device == device)


def _stencil_launch(layout, device):
    """(plan, int32 offsets on the device, the C entry point), made once
    per (layout, device)."""
    plan = stencil_plan(layout)
    return (plan, window_offsets(layout, plan, device),
            _build.load_library().pft_dia_matvec)


def dia_matvec(layout, diags: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K @ u.  CPU tensors take the plain twin; CUDA tensors the kernel.
    u may be any contiguous view (the kernel handles a misaligned start)."""
    dev = u.device
    if dev.type == "cpu":
        return dia_matvec_reference(layout, diags, u)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n, nd = layout.ndof, layout.n_diags
    if not (operand_ok(u, (n,), dev) and operand_ok(diags, (nd, n), dev)):
        check_operands(n, vectors=(u,), diags=diags, nd=nd)
        raise ValueError("operands do not fit the stencil kernel")
    plan, offsets, fn = layout.cached(("stencil", dev),
                                      lambda: _stencil_launch(layout, dev))
    y = torch.empty_like(u)
    _build.check(fn(
        dev.index, diags.data_ptr(), offsets.data_ptr(), nd, n,
        u.data_ptr(), y.data_ptr(), plan.threads, plan.tile, plan.halo_lo,
        plan.window, int(plan.staged),
        _build.current_stream(dev)), "dia_matvec")
    dia_matvec.launches += 1
    return y


dia_matvec.launches = 0
