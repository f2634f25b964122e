"""ctypes binding to the native mesh-preprocessing library (counterpart of
pinn_fem_tpu/utils/native.py, for `rcm_order` and `build_gather_map`).

The library is native/libmeshprep.so of the repository (`make -C native`
builds it from native/mesh_preprocess.cpp).  The port never builds it: it
uses the library when it is present and otherwise the numpy paths
(ops/reorder.rcm_permutation_numpy, ops/scatter.build_gather_map), which
give the same result bit for bit.  This is a host-side acceleration, not a
device path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libmeshprep.so"
_lib = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not LIB_PATH.exists():
        return None
    i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.max_valence.restype = ctypes.c_int64
        lib.max_valence.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                    i64p]
        lib.build_gather_map.restype = None
        lib.build_gather_map.argtypes = [i64p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         i32p, i64p]
        lib.rcm_order.restype = ctypes.c_int
        lib.rcm_order.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                  i32p, i64p]
    except (OSError, AttributeError):
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_gather_map_native(dof_map: np.ndarray,
                            ndof: int) -> Optional[np.ndarray]:
    """The (ndof, V) int32 transposed incidence; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(dof_map, dtype=np.int64).reshape(-1)
    scratch = np.empty(ndof, dtype=np.int64)
    valence = max(int(lib.max_valence(_ptr(flat, ctypes.c_int64), flat.size,
                                      ndof, _ptr(scratch, ctypes.c_int64))),
                  1)
    out = np.empty((ndof, valence), dtype=np.int32)
    lib.build_gather_map(_ptr(flat, ctypes.c_int64), flat.size, ndof,
                         valence, _ptr(out, ctypes.c_int32),
                         _ptr(scratch, ctypes.c_int64))
    return out


def rcm_order_native(elements: np.ndarray,
                     nnode: int) -> Optional[np.ndarray]:
    """Reverse Cuthill-McKee order (order[new] = old node id, int64); None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    elements = np.ascontiguousarray(elements, dtype=np.int64)
    nelm = elements.shape[0]
    order = np.empty(nnode, dtype=np.int32)
    scratch = np.empty(2 * nnode + 2 + 2 * nelm, dtype=np.int64)
    rc = lib.rcm_order(_ptr(elements, ctypes.c_int64), nelm, nnode,
                       _ptr(order, ctypes.c_int32),
                       _ptr(scratch, ctypes.c_int64))
    if rc != 0:
        raise ValueError("element references an out-of-range node id")
    return order.astype(np.int64)
