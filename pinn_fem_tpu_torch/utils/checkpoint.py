"""Checkpoint / resume of incremental solves (counterpart of the increment
state of pinn_fem_tpu/utils/checkpoint.py).

The (increment, u, theta) state of a solve is written after every
converged increment and restored to continue a killed or preempted run.
The files are the JAX package's, byte for byte, so either package resumes
the other's checkpoint:

  * state.msgpack: flax's msgpack serialization of {"u": u, "theta":
    theta}, written here with msgpack alone (flax imports JAX).  Lists and
    tuples become maps keyed "0", "1", ...; an array becomes
    ExtType(1, packb((shape, dtype name, C-order bytes))), a numpy scalar
    ExtType(3, ...) of the same form; an array above 2**30 bytes is split
    into flax's chunked form.  Written to .state.tmp and renamed.
  * meta.json: {"increment": n, **meta}.

u is stored as the driver holds it (float64 from the result, as the JAX
driver's np.asarray(u, dtype=float)) and theta's leaves in the working
dtype (float32, or float64 under PINN_FEM_TPU_X64).

The transient state of solvers/dynamics.solve_transient_checkpointed is
the JAX package's too: transient.npz (numpy's savez of u and v, written to
.transient.tmp and renamed) and transient_meta.json ({"step": n, **meta}).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


def _index_map(items) -> dict:
    return {str(i): x for i, x in enumerate(items)}


def _chunk(arr: np.ndarray) -> dict:
    chunk = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True, "shape": _index_map(arr.shape),
            "chunks": _index_map(flat[i:i + chunk]
                                 for i in range(0, flat.size, chunk))}


def _state_dict(x):
    """flax's state dict of a tree of lists, tuples, dicts and arrays:
    containers as maps with string keys, tensors as numpy arrays, arrays
    above MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray) and x.nbytes > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    import msgpack

    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(EXT_NDARRAY, _ndarray_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _ndarray_from(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _ext_unpack(code, data):
    import msgpack

    if code == EXT_NDARRAY:
        return _ndarray_from(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def save_increment_state(directory, increment: int, u, theta: Any,
                         meta: Optional[Dict] = None) -> Path:
    """Persist the post-increment state (atomic rename) and its
    meta.json."""
    import msgpack

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    state = _state_dict({"u": np.asarray(u), "theta": theta})
    tmp = directory / ".state.tmp"
    tmp.write_bytes(msgpack.packb(state, default=_ext_pack,
                                  strict_types=True))
    path = directory / "state.msgpack"
    tmp.replace(path)
    (directory / "meta.json").write_text(json.dumps({
        "increment": increment, **(meta or {})}))
    return path


def _restore(template, state, path: str):
    """state shaped as template: lists and tuples rebuilt, tensors on the
    template's device and in its dtype, other leaves as read."""
    if isinstance(template, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(template):
            raise ValueError(f"checkpoint does not match theta at {path}: "
                             f"{len(template)} entries expected")
        items = [_restore(t, state[str(i)], f"{path}/{i}")
                 for i, t in enumerate(template)]
        return type(template)(items) if isinstance(template, tuple) else items
    if isinstance(template, dict):
        return {k: _restore(t, state[str(k)], f"{path}/{k}")
                for k, t in template.items()}
    if isinstance(template, torch.Tensor):
        arr = np.asarray(state)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {arr.shape} at {path}, "
                             f"theta has {tuple(template.shape)}")
        return torch.from_numpy(arr.copy()).to(device=template.device,
                                               dtype=template.dtype)
    return state


def load_increment_state(directory, theta_template: Any):
    """(increment, u, theta), or None when the directory holds no
    checkpoint.  u is a copy of the stored numpy array; theta has
    theta_template's structure, its tensors on the template's device and in
    its dtype."""
    import msgpack

    directory = Path(directory)
    state_file = directory / "state.msgpack"
    meta_file = directory / "meta.json"
    if not state_file.exists() or not meta_file.exists():
        return None
    meta = json.loads(meta_file.read_text())
    state = _unchunk(msgpack.unpackb(state_file.read_bytes(),
                                     ext_hook=_ext_unpack, raw=False))
    theta = _restore(theta_template, state["theta"], "theta")
    return int(meta["increment"]), np.array(state["u"]), theta


def save_transient_state(directory, step: int, u, v,
                         meta: Optional[Dict] = None) -> Path:
    """Persist (step, u, v) of a transient integration (atomic rename)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    u, v = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in (u, v))
    tmp = directory / ".transient.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, u=u, v=v)
    path = directory / "transient.npz"
    tmp.replace(path)
    (directory / "transient_meta.json").write_text(json.dumps({
        "step": int(step), **(meta or {})}))
    return path


def load_transient_state(directory):
    """(step, u, v, meta), or None when the directory holds no transient
    checkpoint."""
    directory = Path(directory)
    state_file = directory / "transient.npz"
    meta_file = directory / "transient_meta.json"
    if not state_file.exists() or not meta_file.exists():
        return None
    meta = json.loads(meta_file.read_text())
    with np.load(state_file) as z:
        u, v = z["u"], z["v"]
    return int(meta["step"]), u, v, meta
