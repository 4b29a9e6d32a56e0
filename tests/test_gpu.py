"""Tests that need an NVIDIA GPU: the GPU attention route, the int8 denses
and fp32 precision as the card compiles them. They skip without a card
(conftest.py); on the card:

    python -m pytest tests/test_gpu.py -m gpu --device=gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.ops.attention import ROUTES, attention, route_for

pytestmark = pytest.mark.gpu


def _cosine(a, b):
    """One cosine over the whole tensor (causal row 0 has dq == 0)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("shape,causal", [((8, 197, 12, 64), False),
                                          ((8, 77, 8, 64), True),
                                          ((4, 50, 12, 64), False)])
def test_gpu_route_matches_fp32_reference(shape, causal):
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    q, k, v, g = (jax.random.normal(kk, shape, jnp.float32) for kk in keys)

    def run(q, k, v, g, impl, dtype):
        def f(q, k, v):
            return attention(q.astype(dtype), k.astype(dtype), v.astype(dtype),
                             causal=causal, implementation=impl).astype(jnp.float32)
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(g)

    run = jax.jit(run, static_argnums=(4, 5))
    got = run(q, k, v, g, ROUTES["gpu"], jnp.bfloat16)
    ref = run(q, k, v, g, "xla", jnp.float32)
    for a, b in zip(got, ref):
        assert _cosine(a, b) >= 0.999


def test_default_route_on_gpu_is_the_table_route():
    assert jax.default_backend() == "gpu"
    assert route_for("gpu", jnp.bfloat16) == ROUTES["gpu"]
    q = jnp.ones((2, 197, 12, 64), jnp.bfloat16)
    hlo = jax.jit(lambda q: attention(q, q, q)).lower(q).compile().as_text()
    if ROUTES["gpu"] == "cudnn":
        assert "cudnn" in hlo.lower()


def test_fp32_forward_matches_cpu_at_highest_precision():
    """fp32 is the parity configuration: no TF32 anywhere in the tower."""
    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder

    encoder = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=2)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        params = jax.device_get(encoder.init_params(jax.random.PRNGKey(0)))
    video = np.random.default_rng(0).normal(size=(4, 2, 32, 32, 3)).astype(np.float32)
    outs = []
    for device in (jax.devices()[0], cpu):
        p, v = jax.device_put((params, video), device)
        outs.append(np.asarray(jax.jit(encoder.encode_video)(p, v)))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_int8_dense_matches_bf16_dense_on_gpu():
    from fitclip_tpu.ops.quant import int8_dense_static, quantize_weight

    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 768)).astype(np.float32)
    kernel = (rng.normal(size=(768, 3072)) * 768 ** -0.5).astype(np.float32)
    bias = np.zeros((3072,), np.float32)
    q = quantize_weight(kernel)
    act_scale = np.abs(x).max().reshape(1)
    got = jax.jit(int8_dense_static)(jnp.asarray(x, jnp.bfloat16), q["kernel_q"],
                                     q["scale"], bias, act_scale)
    ref = jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(kernel, jnp.bfloat16)
    assert _cosine(np.asarray(got, np.float32), np.asarray(ref, np.float32)) >= 0.999
