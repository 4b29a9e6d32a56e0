"""Device mesh + sharding helpers: the framework's entire distributed layer.

The reference delegates distribution to PyTorch Lightning DDP + a custom
``all_gather`` wrapper (util/tensor_utils.py:48-66) and manual distributed
samplers (SURVEY §2.8). Under JAX all of that collapses into GSPMD: one
``Mesh``, batch arrays sharded on the leading axis over ``"data"``, parameters
replicated, and XLA inserts the collectives (gradient psum, the
global-batch embedding all-gather inside the contrastive loss) automatically;
on several GPUs XLA hands them to NCCL.
The gather-with-gradients subtlety the reference handled with
``sync_grads=True`` is free here: collectives under ``jit`` differentiate.
"""

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def create_mesh(devices: Optional[Sequence] = None,
                axis_names: Sequence[str] = (DATA_AXIS,)) -> Mesh:
    """A 1-D data mesh over all local devices by default; pass a reshaped
    device array for multi-axis meshes (e.g. ("data", "model"))."""
    if devices is None:
        devices = jax.devices()
    device_array = np.asarray(devices)
    if device_array.ndim == 1 and len(axis_names) > 1:
        raise ValueError("Pass an ndarray of devices shaped like axis_names for multi-axis meshes")
    return Mesh(device_array, axis_names)


def sharded_along(mesh: Mesh, axis: str = DATA_AXIS, dim: int = 0) -> NamedSharding:
    spec = [None] * (dim + 1)
    spec[dim] = axis
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: Any, mesh: Mesh, axis: str = DATA_AXIS) -> Any:
    """Place a host batch pytree onto the mesh, sharded on the leading dim."""
    sharding = sharded_along(mesh, axis)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), batch)


def pad_batch_to_divisible(batch: Any, num_shards: int):
    """Right-pad every leading dim to a multiple of the mesh size; returns the
    padded pytree and the original length (for masking metrics)."""
    def pad(x):
        n = x.shape[0]
        target = -(-n // num_shards) * num_shards
        if target == n:
            return x
        widths = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths)

    first = jax.tree_util.tree_leaves(batch)[0]
    return jax.tree_util.tree_map(pad, batch), first.shape[0]
