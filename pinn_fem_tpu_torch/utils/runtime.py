"""Device and dtype selection.

The JAX package's runtime module also carried platform plumbing for the
TPU attachment (compilation cache, platform pinning, `tpu_likely`); the
port needs none of it, only these two selectors.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_dtype() -> torch.dtype:
    """The port computes in float32, as the reference does."""
    return torch.float32


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
