"""Build and load the CUDA kernels: nvcc into a shared library, ctypes.

Every source in csrc/ (*.cu) has a plain C interface, so it compiles in
seconds without PyTorch's headers.  The sources compile in parallel, one
nvcc each, and link into one shared library.  The library is built at
first use, in a source checkout into ``build/pinn_fem_tpu_torch/`` at its
root, in an installed package into ``pinn_fem_tpu_torch/`` of the user's
cache directory ($XDG_CACHE_HOME, else ~/.cache).  Its name carries a hash
of every source and the flags: an edited source is rebuilt, an unchanged
set is loaded as it is.  Nothing is compiled or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

# --fmad=false keeps every multiply and add separately rounded, which makes
# the stencil bit-identical to its plain PyTorch version (material.cu asks
# for its fused multiply-adds explicitly).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pft_threads_per_block": [],
    "pft_update_blocks": [],
    "pft_dia_matvec": [_I, _P, _P, _I, ctypes.c_int64, _P, _P, _I, _I, _I,
                       _I, _I, _P],
    "pft_dia_dir_matvec": [_P],   # a DirectionArgs (cg_kernel.py)
    "pft_cg_update": [_P],        # an UpdateArgs
    "pft_material_forward": [ctypes.c_int, _P, ctypes.c_int, _P,
                             ctypes.c_float, _P, _I, ctypes.c_int64, _P, _P,
                             _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "pft_material_forward_occupancy": [_I, _I, _I, _P, _P],
    "pft_material_backward": [_P, _P, ctypes.c_int, _P, ctypes.c_float, _P,
                              ctypes.c_int64, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P],
    "pft_material_grad_plan": [_P, _P],
    "pft_material_n_params": [_P],
}
_library = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build_dir() -> Path:
    """build/pinn_fem_tpu_torch of the source checkout holding the package
    (its root has pyproject.toml and is writable), else the user's cache."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root / "build" / "pinn_fem_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pinn_fem_tpu_torch"


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return build_dir() / f"libpft_kernels_{h.hexdigest()[:16]}.so"


def _run_nvcc(procs) -> None:
    """Wait for every nvcc process; raise with the output of a failed one."""
    failed = []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(proc.args)}\n{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Objects in a private directory and the library under a private name,
    # then a rename: concurrent builders never see a half-written library.
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objects = [Path(tmp, src.stem + ".o") for src in sources()]
        _run_nvcc([subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources(), objects)])
        lib = Path(tmp, target.name)
        _run_nvcc([subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
             *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
        os.replace(lib, target)
    return target


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pft_error_string.argtypes = [ctypes.c_int]
        lib.pft_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device (the
    lean form of torch.cuda.current_stream(device).cuda_stream)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load_library().pft_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
