"""Batched solving: B problems on one mesh at once (counterpart of
pinn_fem_tpu/parallel/).  The multi-device modules of the JAX package
(mesh.py, sharded.py, dia_sharded.py) are not yet ported, ROADMAP item 15's
multi-device row."""
