"""Banded (DIA) stencil matvec: the CUDA kernel and its plain twin.

Replaces pinn_fem_tpu/ops/pallas/dia_kernel.py:_dia_kernel (launched by
`_run`).  The TPU kernel needed a diag-minor interleaved copy of the
diagonals and a 128-lane packing of u to make its DMAs contiguous; on this
card the plain (nd, ndof) row-major diagonals already give coalesced loads
(neighbouring threads own neighbouring rows), so the kernel reads the
diagonals and u where they lie and needs no packing and no halo limit.

Bound by memory: one call moves about (nd + 2) * ndof * 4 bytes (every
diagonal once, u once through the cache, y once) for nd multiply-adds per
row.  The design keeps it to that one pass; see csrc/dia_cg.cu.

Bit-identical to `dia_matvec_reference`: the kernel sums the diagonals in
the same order, with separately rounded multiplies and adds.
"""

from __future__ import annotations

import torch

from . import _build


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


def dia_matvec(layout, diags: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K @ u.  CPU tensors take the plain twin; CUDA tensors the kernel."""
    if u.device.type == "cpu":
        return dia_matvec_reference(layout, diags, u)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    check_operands(layout.ndof, vectors=(u,), diags=diags, nd=layout.n_diags)
    lib = _build.load_library()
    y = torch.empty_like(u)
    offsets = layout.offsets_on(u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    _build.check(lib.pft_dia_matvec(
        u.device.index, diags.data_ptr(), offsets.data_ptr(), layout.n_diags,
        layout.ndof, u.data_ptr(), y.data_ptr(), stream), "dia_matvec")
    dia_matvec.launches += 1
    return y


dia_matvec.launches = 0
