"""Device mesh helpers.

The reference has no distributed layer at all (SURVEY.md §2.12); parallelism
here is greenfield: a ``jax.sharding.Mesh`` with a ``data`` axis
for batch/corpus parallelism and an optional ``model`` axis for sharding the
wide asin-embedding table. Collectives are inserted by XLA from sharding
annotations (GSPMD), riding the device interconnect (NVLink on GPUs).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """1-D data mesh over all local devices by default; pass ``shape`` for
    multi-axis layouts (e.g. (4, 2) with ('data', 'model'))."""
    devices = devices if devices is not None else jax.devices()
    if shape is None or len(shape) == 0:
        shape = (len(devices),)
        axis_names = tuple(axis_names)[:1]
    arr = np.asarray(devices[: int(np.prod(shape))]).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Leading-axis (batch) sharding."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """Place a host batch pytree with the leading axis split over ``axis``.
    Batch size must divide the axis size."""
    sh = batch_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sh), batch)
