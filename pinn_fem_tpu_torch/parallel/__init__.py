"""Batched solving: B problems on one mesh at once (counterpart of
pinn_fem_tpu/parallel/).  The multi-device modules of the JAX package
(mesh.py, sharded.py, dia_sharded.py) are not yet ported, ROADMAP item 15's
multi-device row."""


def refuse_mesh(mesh, what: str = "the batch") -> None:
    """mesh= (`what` sharded over a device mesh) is ROADMAP item 15's
    multi-device row: anything but None raises."""
    if mesh is not None:
        raise NotImplementedError(
            f"mesh= ({what} sharded over a device mesh: parallel/mesh.py, "
            "sharded.py, dia_sharded.py) is not yet ported, ROADMAP item "
            "15's multi-device row; give mesh=None")
