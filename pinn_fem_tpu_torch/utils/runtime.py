"""Device and dtype selection.

The JAX package's runtime module also carried platform plumbing for the
TPU attachment (compilation cache, platform pinning, `tpu_likely`); the
port needs none of it, only these selectors and the float64 policy.

Float64 is the JAX package's opt-in (PINN_FEM_TPU_X64=1,
pinn_fem_tpu/utils/runtime.py), a cross-check mode.  The port reads the
variable at each call of `default_dtype`.  Under it the CPU runs every
path in float64 and the card runs the paths that use no repo kernel (the
dense Newton path, the gather-based PCG of meshes without a banded
layout, the torch forms); the CUDA kernels compute in float32
only, and a float64 tensor at their dispatch raises `require_float32`'s
error instead of running anywhere else.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

X64_VARIABLE = "PINN_FEM_TPU_X64"


def default_dtype() -> torch.dtype:
    """float64 when PINN_FEM_TPU_X64=1, else float32 (the reference's)."""
    if os.environ.get(X64_VARIABLE, "0") == "1":
        return torch.float64
    return torch.float32


def require_float32(dtype: torch.dtype, kernel: str) -> None:
    """The refusal at a CUDA kernel's dispatch: the kernels take float32."""
    if dtype != torch.float32:
        raise ValueError(
            f"{kernel}: the CUDA kernel computes in float32, got {dtype}. "
            f"{X64_VARIABLE}=1 computes in float64 on the CPU and, on a "
            "card, only on paths without a repo kernel (the dense Newton "
            "path, the gather-based PCG); unset "
            f"{X64_VARIABLE} to run this path on the card")


def resolve_device(name: DeviceLike = None) -> torch.device:
    """torch.device for `name` ("cuda" when None).

    Asking for CUDA on a machine without a usable card raises: nothing
    falls back to the CPU silently.
    """
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is false")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
