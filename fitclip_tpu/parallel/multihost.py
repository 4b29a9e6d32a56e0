"""Multi-host (multi-process SPMD) entry points.

A multi-host run has one process per host; each process sees only its local
devices but jit operates on GLOBAL arrays over the full mesh. This module holds the
three pieces a single-host run doesn't need (reference parallel: PL DDP spawn
+ DistributedSampler, SURVEY §2.8):

- ``maybe_initialize_distributed``: ``jax.distributed.initialize`` when the
  run is multi-process (explicit config or coordinator env vars). Called
  before any backend touch by the CLI.
- ``process_local_rows``: which rows of a global batch THIS process must
  load — the loaders feed only their slice (the distributed-sampler
  equivalent, but per-batch so global batch composition is identical to
  single-host).
- ``global_batch_from_local``: assemble the per-process host rows into one
  global jax.Array over the mesh (``jax.make_array_from_process_local_data``).
- ``is_main_process``: gate for logging/checkpointing (process-0-only).

Tested with a 2-process CPU mesh in tests/test_multihost.py.
"""

import logging
import os
from typing import Any, Optional

import jax
import numpy as np

from fitclip_tpu.parallel.mesh import DATA_AXIS, sharded_along

LOGGER = logging.getLogger(__name__)


def maybe_initialize_distributed(cfg: Optional[dict] = None) -> bool:
    """Initialize JAX's multi-process runtime when configured. Returns True
    when running multi-process.

    Sources, in priority order:
    1. cfg["distributed"] = {coordinator_address, num_processes, process_id}
    2. env JAX_COORDINATOR_ADDRESS (+ JAX_NUM_PROCESSES, JAX_PROCESS_ID)

    The coordinator address, process count and process id are always
    given: nothing in the environment tells JAX of a cluster.
    """
    dist = (cfg or {}).get("distributed")
    if dist is None and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        dist = {
            "coordinator_address": os.environ["JAX_COORDINATOR_ADDRESS"],
            "num_processes": int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            "process_id": int(os.environ.get("JAX_PROCESS_ID", "0")),
        }
    if not dist:
        return jax.process_count() > 1
    jax.distributed.initialize(
        coordinator_address=dist["coordinator_address"],
        num_processes=int(dist["num_processes"]),
        process_id=int(dist["process_id"]),
        local_device_ids=dist.get("local_device_ids"),
    )
    LOGGER.info("Distributed runtime up: process %d/%d, %d local / %d global devices",
                jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())
    return jax.process_count() > 1


def is_main_process() -> bool:
    return jax.process_index() == 0


def process_local_rows(n_rows: int,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> slice:
    """The contiguous row block of a global batch this process loads.
    Global batches are laid out [proc0 rows | proc1 rows | ...], matching the
    mesh's device order when devices are enumerated process-major (jax's
    default), so make_array_from_process_local_data needs no reshuffle."""
    p = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    if n_rows % n:
        raise ValueError(f"global batch of {n_rows} rows is not divisible by "
                         f"{n} processes")
    per = n_rows // n
    return slice(p * per, (p + 1) * per)


def host_array(x) -> np.ndarray:
    """A fully-materialized host copy of a (possibly multi-process global)
    jax.Array — np.asarray alone fails on non-addressable shards."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def global_batch_from_local(mesh, local_batch: Any,
                            global_rows: Optional[int] = None) -> Any:
    """Per-process host rows -> one global jax.Array pytree sharded on the
    leading axis over the data mesh axis. global_rows defaults to
    local_rows * process_count per leaf (leaves may differ in batch size)."""
    sharding = sharded_along(mesh, DATA_AXIS)
    count = jax.process_count()

    def assemble(x):
        x = np.asarray(x)
        rows = global_rows if global_rows is not None else x.shape[0] * count
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape=(rows,) + x.shape[1:])

    return jax.tree_util.tree_map(assemble, local_batch)
