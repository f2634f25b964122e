"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Counterpart of pinn_fem_tpu/ops/pallas/.  A wrapper given CPU tensors runs
its twin; given CUDA tensors it launches its kernel (built from csrc/ on
first use) or raises.  Each wrapper counts its kernel launches in its
`launches` attribute.
"""

from .cg_kernel import (cg_update, dia_dir_matvec, fused_cg_solve,
                        fused_cg_solve_reference)
from .dia_kernel import dia_matvec
from .material_kernel import (fused_material_coefficients,
                              material_coefficients,
                              material_coefficients_backward,
                              material_coefficients_reference)

WRAPPERS = {
    "dia_matvec": dia_matvec,
    "dia_dir_matvec": dia_dir_matvec,
    "cg_update": cg_update,
    "material_coefficients": material_coefficients,
    "material_coefficients_backward": material_coefficients_backward,
}


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


__all__ = ["WRAPPERS", "cg_update", "dia_dir_matvec", "dia_matvec",
           "fused_cg_solve", "fused_cg_solve_reference",
           "fused_material_coefficients", "launch_counts",
           "material_coefficients", "material_coefficients_backward",
           "material_coefficients_reference", "reset_launch_counts"]
