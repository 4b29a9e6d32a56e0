"""Pipeline parallelism (GPipe) over a scan-stacked layer tower.

The reference never pipelines (SURVEY §2.8: PP absent — ViT-B-scale towers
fit one device), but a TPU-native framework scales past a pod slice by
splitting LAYERS across a ``pipe`` mesh axis: stage s holds layers
[s·L/S, (s+1)·L/S), microbatches stream through the ring, and activations
hop stage-to-stage over ICI via ``ppermute``.

Written entirely with differentiable primitives (``shard_map`` + ``lax.scan``
+ ``ppermute`` + masked ``psum``), so ``jax.grad`` of a pipelined forward IS
the reverse pipeline — the backward schedule needs no hand-written 1F1B; XLA
transposes the permutes. The cost model is the classic GPipe bubble:
M microbatches over S stages run M+S-1 steps, utilization M/(M+S-1).

Layout contract: the stacked layer params carry the layer axis LEADING on
every leaf (exactly what ``nn.scan``/``fast_eval`` produce); they arrive
sharded ``P("pipe")`` so each stage's weights live only on its own devices —
an S-fold parameter-memory drop, which is the point of PP.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


PIPE_AXIS = "pipe"


def stage_shardings(layer_params: Any, mesh: Mesh,
                    axis: str = PIPE_AXIS) -> Any:
    """NamedShardings placing each leaf's leading (layer) axis on the pipe
    mesh axis — stage s holds only its own layers' weights."""
    return jax.tree_util.tree_map(
        lambda _: NamedSharding(mesh, P(axis)), layer_params)


def pipeline_apply(layer_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
                   layer_params: Any, x: jnp.ndarray, mesh: Mesh,
                   num_microbatches: int, axis: str = PIPE_AXIS) -> jnp.ndarray:
    """Run ``x`` through all stacked layers, pipelined over ``mesh[axis]``.

    layer_fn(one_layer_params, activations) -> activations applies a single
    layer; layer_params is the stacked tree (leading layer axis, length L);
    x is the full batch (B, ...), B divisible by num_microbatches. L must be
    divisible by the pipe axis size. Returns the same value as the plain
    sequential scan (parity-tested in tests/test_pipeline.py), replicated
    over the pipe axis, and is differentiable end-to-end.
    """
    num_layers = jax.tree_util.tree_leaves(layer_params)[0].shape[0]
    stages = mesh.shape[axis]
    batch = x.shape[0]
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible by {stages} stages")
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by {num_microbatches} microbatches")
    microbatches = x.reshape((num_microbatches, batch // num_microbatches)
                             + x.shape[1:])

    def stage_program(local_params, mb):
        stage = jax.lax.axis_index(axis)
        first, last = stage == 0, stage == stages - 1

        def run_local(h):
            def body(carry, one_layer):
                return layer_fn(one_layer, carry), None
            return jax.lax.scan(body, h, local_params)[0]

        shift = [(i, i + 1) for i in range(stages - 1)]

        def step(carry, t):
            prev_out, out_buf = carry
            # Stage i's last output becomes stage i+1's input; stage 0 takes
            # microbatch t from the source (clamped past the drain steps —
            # those results are masked out of the collection below).
            inbound = jax.lax.ppermute(prev_out, axis, shift)
            idx = jnp.clip(t, 0, num_microbatches - 1)
            feed = jax.lax.dynamic_index_in_dim(mb, idx, keepdims=False)
            h = jnp.where(first, feed, inbound)
            out = run_local(h)
            done = jnp.logical_and(last, t >= stages - 1)
            slot = jnp.clip(t - (stages - 1), 0, num_microbatches - 1)
            updated = jax.lax.dynamic_update_slice(
                out_buf, out[None].astype(out_buf.dtype),
                (slot,) + (0,) * out.ndim)
            out_buf = jnp.where(done, updated, out_buf)
            return (out, out_buf), None

        zero = jnp.zeros_like(mb[0])
        (_, out_buf), _ = jax.lax.scan(
            step, (zero, jnp.zeros_like(mb)),
            jnp.arange(num_microbatches + stages - 1))
        # Only the last stage holds real outputs; the masked psum replicates
        # them ring-wide (differentiable broadcast).
        return jax.lax.psum(jnp.where(last, out_buf, 0.0), axis)

    # Memory model: parameters shard S-fold (the point of PP — stage s holds
    # only its layers); the microbatched INPUT and the psum'd output replicate
    # across stages (in/out_specs P()) — for the deep-tower use case the
    # layer weights dominate, and the batch arrives replicated anyway.
    param_specs = jax.tree_util.tree_map(lambda _: P(axis), layer_params)
    program = jax.shard_map(stage_program, mesh=mesh, check_vma=False,
                            in_specs=(param_specs, P()), out_specs=P())
    return program(layer_params, microbatches).reshape((batch,) + x.shape[1:])
