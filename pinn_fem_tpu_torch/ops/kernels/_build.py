"""Build and load the CUDA kernels: nvcc into a shared library, ctypes.

The source (csrc/dia_cg.cu) has a plain C interface, so it compiles in
seconds without PyTorch's headers.  The library is built at first use, in
a source checkout into ``build/pinn_fem_tpu_torch/`` at its root, in an
installed package into ``pinn_fem_tpu_torch/`` of the user's cache
directory ($XDG_CACHE_HOME, else ~/.cache).  Its name carries a hash of the
source and the flags: an edited source is rebuilt, an unchanged one is
loaded as it is.  Nothing is compiled or loaded when this module is
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "dia_cg.cu"

# --fmad=false keeps every multiply and add separately rounded, which makes
# the stencil bit-identical to its plain PyTorch version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    "pft_threads_per_block": [],
    "pft_dia_matvec": [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int64,
                       _P, _P, _P],
    "pft_dia_dir_matvec": [ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
                           ctypes.c_int64, _P, _P, _P, _P, _P, _P],
    "pft_cg_update": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
                      ctypes.c_int64, _P, _P, _P],
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


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"libdia_cg_{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this exact source exists."""
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent builders never see
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load_library().pft_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
