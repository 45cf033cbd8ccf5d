"""Device meshes of the dry run (``repro/launch/mesh.py``).

A ``Mesh`` here is geometry only -- ordered axis names and sizes -- with
no devices behind it: the dry run reckons shards from it on the ``meta``
device, so the production meshes need no 256 or 512 devices (JAX's
"found N devices" error has no counterpart).  The shapes and axis names
are JAX's:

  single-pod:  (16, 16)      axes (data, model)          = 256 chips
  multi-pod:   (2, 16, 16)   axes (pod, data, model)     = 512 chips
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class Mesh(NamedTuple):
    """Axis names and sizes, in order; ``shape[name]`` is an axis's size
    (``jax.sharding.Mesh.shape``'s mapping) and ``size`` the device count."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh_compat(shape, axes) -> Mesh:
    """The mesh of ``shape`` over ``axes`` (``jax.make_mesh``'s
    arguments)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return Mesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_local_mesh(n_model: int = 1) -> Mesh:
    """Mesh over the CUDA devices present (one card: (1, 1))."""
    n = max(torch.cuda.device_count(), 1)
    n_model = min(n_model, n)
    return make_mesh_compat((n // n_model, n_model), ("data", "model"))


def elastic_mesh(n_devices: int, model_parallel: int = 16) -> Mesh:
    """The mesh as a pure function of the device count: the model axis
    takes gcd(model_parallel, n_devices), the data axis the rest."""
    mp = math.gcd(model_parallel, n_devices)
    return make_mesh_compat((n_devices // mp, mp), ("data", "model"))
