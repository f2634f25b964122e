"""Material property fields (counterpart of pinn_fem_tpu/models/fields.py).

A field maps a batch of input rows to a batch of property values, so the
assembly evaluates every element's material in one batched call.

Contracts kept from the JAX package:
  * inputs are column-stacked in alphabetical key order, (load_factor,
    x[, y]) (see `assembly_inputs`); trained weights are only meaningful
    with respect to that order;
  * positive-constrained outputs are softplus(raw) * scale;
  * MLP: Linear/Tanh stacks with weights W shaped (fan_in, fan_out), so the
    forward pass is x @ W + b; the last layer starts at W = 0.1, b = 1, and
    the hidden layers draw W and b from U(-1/sqrt(fan_in), +1/sqrt(fan_in)).

Given a jax.random key (a numpy one, from utils.prng) the hidden layers are
drawn exactly as the JAX package draws them, so the same key gives the same
weights bit for bit; a `torch.Generator` is also taken, and gives other
numbers.  `material_from_numpy` builds a material from given arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Mapping, Tuple, Union

import numpy as np
import torch

from ..utils import prng
from ..utils.runtime import default_dtype


@dataclass
class ScalarField:
    """Constant material property."""

    value: float

    def eval_batch(self, x: torch.Tensor) -> torch.Tensor:
        """(n, k) inputs -> (n,) constant values."""
        return torch.full((x.shape[0],), self.value, dtype=x.dtype,
                          device=x.device)

    def eval_scalar(self) -> float:
        return float(self.value)

    @property
    def is_trainable(self) -> bool:
        return False

    def trainable_params(self) -> list:
        return []

    def to(self, device=None, dtype=None) -> "ScalarField":
        return self


@dataclass
class MLPField:
    """MLP-parameterized material property.

    ``layers`` is a list of (W, b) with W shaped (fan_in, fan_out): inputs
    are row vectors and the forward pass is x @ W + b.
    """

    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    scale: torch.Tensor  # 0-d
    input_dim: int = 1
    enforce_positive: bool = True

    def raw_forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for w, b in self.layers[:-1]:
            h = torch.tanh(h @ w + b)
        w, b = self.layers[-1]
        return h @ w + b

    def _adapt_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Match the assembly's (load_factor, x[, y]) columns to input_dim.

        Narrower nets receive the spatial columns first (x[, y], then
        load_factor), so input_dim=1 is the E(x) field; input_dim == dim+1
        keeps the alphabetical (load_factor, x, y) order; wider nets are
        zero-padded (pinn_fem_tpu/models/fields.py:77-99).
        """
        width = x.shape[1]
        if self.input_dim == width:
            return x
        if self.input_dim < width:
            cols = torch.cat([x[:, 1:], x[:, :1]], dim=1)  # spatial, then lf
            return cols[:, : self.input_dim]
        pad = torch.zeros((x.shape[0], self.input_dim - width), dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, pad], dim=1)

    def eval_batch(self, x: torch.Tensor) -> torch.Tensor:
        """(n, k) assembly inputs -> (n,) property values."""
        out = self.raw_forward(self._adapt_inputs(x))
        if self.enforce_positive:
            out = torch.nn.functional.softplus(out)
        return (out * self.scale)[:, 0]

    def to(self, device=None, dtype=None) -> "MLPField":
        return replace(
            self,
            layers=[(w.to(device=device, dtype=dtype),
                     b.to(device=device, dtype=dtype)) for w, b in self.layers],
            scale=self.scale.to(device=device, dtype=dtype),
        )

    def replace(self, **changes) -> "MLPField":
        return replace(self, **changes)

    @property
    def is_trainable(self) -> bool:
        return True

    def trainable_params(self) -> list:
        """Flat list in the reference's parameter order: W, b per layer."""
        return [t for layer in self.layers for t in layer]

    def n_params(self) -> int:
        return sum(w.numel() + b.numel() for w, b in self.layers)


Field = Union[ScalarField, MLPField]


def make_mlp_field(
    key: Union[np.ndarray, torch.Generator],
    hidden_layers: int = 2,
    neurons_per_layer: int = 20,
    input_dim: int = 1,
    scale: float = 1.0,
    enforce_positive: bool = True,
    dtype: torch.dtype = None,
    device=None,
) -> MLPField:
    """Build an MLP field with the reference's architecture and init.

    Architecture: Linear(input_dim, n) + Tanh, then (hidden_layers - 1) x
    [Linear(n, n) + Tanh], then Linear(n, 1).  The hidden layers draw on
    the host: from `key`, a utils.prng key, as jax.random does (float32
    only), or from a CPU torch.Generator.  The result is moved to `device`.
    """
    dtype = dtype or default_dtype()
    sizes = [input_dim] + [neurons_per_layer] * hidden_layers + [1]
    layers = []
    n_lin = len(sizes) - 1
    for i in range(n_lin):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        if i == n_lin - 1:
            # Deterministic last layer: softplus(~1) * scale ~= scale at start.
            w = torch.full((fan_in, fan_out), 0.1, dtype=dtype)
            b = torch.full((fan_out,), 1.0, dtype=dtype)
        elif isinstance(key, torch.Generator):
            bound = 1.0 / np.sqrt(fan_in)
            w = (torch.rand((fan_in, fan_out), generator=key,
                            dtype=dtype) * 2.0 - 1.0) * bound
            b = (torch.rand((fan_out,), generator=key, dtype=dtype)
                 * 2.0 - 1.0) * bound
        else:
            if dtype != torch.float32:
                raise NotImplementedError(
                    "the jax.random draw is reproduced in float32 only")
            key, kw, kb = prng.split(key, 3)
            bound = 1.0 / np.sqrt(fan_in)
            w = torch.from_numpy(prng.uniform(kw, (fan_in, fan_out), -bound,
                                              bound))
            b = torch.from_numpy(prng.uniform(kb, (fan_out,), -bound, bound))
        layers.append((w, b))
    return MLPField(layers=layers, scale=torch.tensor(scale, dtype=dtype),
                    input_dim=input_dim,
                    enforce_positive=enforce_positive).to(device=device)


def to_field(value) -> Field:
    """Coerce float/int/Field -> Field."""
    if isinstance(value, (ScalarField, MLPField)):
        return value
    if isinstance(value, (int, float)):
        return ScalarField(value=float(value))
    raise TypeError(f"Cannot convert {type(value)} to a material field")


def _field_from_numpy(spec, dtype, device) -> Field:
    if isinstance(spec, Mapping):
        layers = [(torch.tensor(np.asarray(w), dtype=dtype, device=device),
                   torch.tensor(np.asarray(b), dtype=dtype, device=device))
                  for w, b in spec["layers"]]
        return MLPField(
            layers=layers,
            scale=torch.as_tensor(float(np.asarray(spec["scale"])),
                                  dtype=dtype, device=device),
            input_dim=int(spec.get("input_dim", 1)),
            enforce_positive=bool(spec.get("enforce_positive", True)),
        )
    return ScalarField(value=float(np.asarray(spec)))


def material_from_numpy(young, area, density, dtype: torch.dtype = None,
                        device=None) -> "Material":
    """The port's Material from the JAX Material's leaves as numpy arrays.

    Each field is a scalar (a number or 0-d array), or a mapping with
    ``layers`` [(W, b), ...], ``scale``, ``input_dim`` and
    ``enforce_positive``.
    """
    dtype = dtype or default_dtype()
    return Material(young=_field_from_numpy(young, dtype, device),
                    area=_field_from_numpy(area, dtype, device),
                    density=_field_from_numpy(density, dtype, device))


@dataclass
class Material:
    """The three truss material fields; numbers become ScalarFields."""

    young: Field
    area: Field
    density: Field

    def __post_init__(self):
        for name in ("young", "area", "density"):
            setattr(self, name, to_field(getattr(self, name)))

    @property
    def has_trainable_params(self) -> bool:
        return (self.young.is_trainable or self.area.is_trainable
                or self.density.is_trainable)

    def trainable_params(self) -> list:
        """All trainable tensors, young -> area -> density."""
        return (self.young.trainable_params() + self.area.trainable_params()
                + self.density.trainable_params())

    def to(self, device=None, dtype=None) -> "Material":
        """The material with every net's tensors on `device` in `dtype`."""
        return Material(young=self.young.to(device, dtype),
                        area=self.area.to(device, dtype),
                        density=self.density.to(device, dtype))


def assembly_inputs(mid_coords: torch.Tensor, dimension: int,
                    load_factor) -> torch.Tensor:
    """(nelm, dimension + 1) input rows (load_factor, x[, y[, z]]) for
    material evaluation at element midpoints."""
    n = mid_coords.shape[0]
    lf = torch.as_tensor(load_factor, dtype=mid_coords.dtype,
                         device=mid_coords.device)
    return torch.cat([lf.reshape(1, 1).expand(n, 1),
                      mid_coords[:, :dimension]], dim=1)


def point_inputs_dict_order(coords: np.ndarray, dimension: int,
                            load_factor: float, dtype: torch.dtype = None,
                            device=None) -> torch.Tensor:
    """Rows (load_factor, x[, y]) as assembly_inputs builds them, for
    evaluating identified properties at nodes and centroids."""
    dtype = dtype or default_dtype()
    coords = np.atleast_2d(np.asarray(coords, dtype=float))
    n = coords.shape[0]
    cols = [np.full((n, 1), load_factor), coords[:, :1]]
    for c in range(1, dimension):
        cols.append(coords[:, c:c + 1] if coords.shape[1] > c
                    else np.zeros((n, 1)))
    return torch.as_tensor(np.concatenate(cols, axis=1), dtype=dtype,
                           device=device)


def point_inputs_direct(coords: np.ndarray, input_dim: int,
                        dtype: torch.dtype = None, device=None
                        ) -> torch.Tensor:
    """Coordinates zero-padded (or cut) to input_dim columns."""
    dtype = dtype or default_dtype()
    coords = np.atleast_2d(np.asarray(coords, dtype=float))
    if coords.shape[1] < input_dim:
        pad = np.zeros((coords.shape[0], input_dim - coords.shape[1]))
        coords = np.concatenate([coords, pad], axis=1)
    return torch.as_tensor(coords[:, :input_dim], dtype=dtype, device=device)
