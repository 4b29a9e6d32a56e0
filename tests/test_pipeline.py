"""GPipe pipeline parallelism (parallel/pipeline.py) on the CPU mesh.

Parity: a pipelined tower must equal the plain sequential layer scan, both
in the forward AND through jax.grad (the reverse pipeline is the autodiff
transpose of the forward's ppermutes — no hand-written backward schedule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.models.clip.model import (BlockSpec, init_blocks, residual_block,
                                           transformer)
from fitclip_tpu.parallel import create_mesh
from fitclip_tpu.parallel.pipeline import pipeline_apply, stage_shardings


def _pipe_mesh(stages):
    return create_mesh(np.asarray(jax.devices()[:stages]), axis_names=("pipe",))


def _toy_params(rng, layers, dim):
    return {
        "w": rng.normal(size=(layers, dim, dim)).astype(np.float32) / np.sqrt(dim),
        "b": rng.normal(size=(layers, dim)).astype(np.float32) * 0.1,
    }


def _toy_layer(lp, h):
    return jnp.tanh(h @ lp["w"] + lp["b"])


def _sequential(params, x):
    def body(c, lp):
        return _toy_layer(lp, c), None
    return jax.lax.scan(body, x, params)[0]


def test_pipeline_forward_matches_sequential():
    rng = np.random.default_rng(0)
    layers, dim, batch = 8, 16, 8
    params = _toy_params(rng, layers, dim)
    x = rng.normal(size=(batch, dim)).astype(np.float32)
    mesh = _pipe_mesh(4)

    expected = _sequential(params, jnp.asarray(x))
    got = jax.jit(lambda p, v: pipeline_apply(_toy_layer, p, v, mesh,
                                              num_microbatches=4))(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               rtol=1e-6, atol=1e-6)


def test_pipeline_gradients_match_sequential():
    rng = np.random.default_rng(1)
    layers, dim, batch = 8, 8, 8
    params = _toy_params(rng, layers, dim)
    x = rng.normal(size=(batch, dim)).astype(np.float32)
    mesh = _pipe_mesh(4)
    target = rng.normal(size=(batch, dim)).astype(np.float32)

    def loss_seq(p, v):
        return jnp.sum((_sequential(p, v) - target) ** 2)

    def loss_pp(p, v):
        out = pipeline_apply(_toy_layer, p, v, mesh, num_microbatches=4)
        return jnp.sum((out - target) ** 2)

    g_seq = jax.grad(loss_seq, argnums=(0, 1))(params, jnp.asarray(x))
    g_pp = jax.jit(jax.grad(loss_pp, argnums=(0, 1)))(params, jnp.asarray(x))
    for a, b in zip(jax.tree_util.tree_leaves(g_seq),
                    jax.tree_util.tree_leaves(g_pp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)


def test_pipeline_runs_real_clip_blocks():
    """The production residual block pipelined across 4 stages equals the
    scanned tower, with stage-sharded weights (each stage holds L/S layers)."""
    width, heads, layers = 32, 4, 8
    spec = BlockSpec(heads=heads, causal=False, quick_gelu=True,
                     dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(8, 5, width)).astype(np.float32))
    stacked = init_blocks(jax.random.PRNGKey(0), layers, width)
    expected, _ = transformer(x, stacked, spec)

    def layer_fn(lp, h):
        return residual_block(h, lp, spec)[0]

    mesh = _pipe_mesh(4)
    placed = jax.device_put(stacked, stage_shardings(stacked, mesh))
    leaf = jax.tree_util.tree_leaves(placed)[0]
    assert leaf.addressable_shards[0].data.shape[0] == layers // 4

    got = jax.jit(lambda p, v: pipeline_apply(layer_fn, p, v, mesh,
                                              num_microbatches=4))(placed, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               rtol=2e-5, atol=2e-5)


def test_pipeline_validates_divisibility():
    params = _toy_params(np.random.default_rng(0), 6, 8)
    mesh = _pipe_mesh(4)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(_toy_layer, params, np.zeros((8, 8), np.float32),
                       mesh, num_microbatches=4)
