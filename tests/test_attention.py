"""ops/attention.py on the CPU: the xla route against a plain fp32 einsum
reference (forward and VJP) at the shapes the model heads use, the route
table, and the cuDNN route's odd-length padding (run here through the xla
implementation in its place)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.ops import attention as attention_module
from fitclip_tpu.ops.attention import IMPLEMENTATIONS, ROUTES, attention, route_for

# (name, (batch, length, heads, head_dim), causal, padded keys per row)
SHAPES = [
    ("clip_vision", (2, 197, 12, 64), False, None),
    ("clip_text_causal", (2, 77, 8, 64), True, None),
    ("distilbert_padded", (3, 12, 4, 16), False, (12, 7, 1)),
    ("mmbert_padded", (2, 10, 4, 16), False, (3, 10)),
    ("tiny_odd", (1, 5, 2, 8), True, None),
]


def reference(q, k, v, causal=False, key_mask=None):
    """softmax(q k^T / sqrt(d)) v in fp32 numpy-exact einsums."""
    q, k, v = (jnp.asarray(t, jnp.float32) for t in (q, k, v))
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        precision=jax.lax.Precision.HIGHEST) / np.sqrt(q.shape[-1])
    length = q.shape[1]
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((length, length), bool)), logits, -1e30)
    if key_mask is not None:
        logits = jnp.where(key_mask[:, None, None, :], logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", weights, v,
                      precision=jax.lax.Precision.HIGHEST)


def _inputs(shape, valid, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    q, k, v, g = (jax.random.normal(kk, shape, jnp.float32) for kk in keys)
    mask = None
    if valid is not None:
        mask = jnp.arange(shape[1])[None, :] < jnp.asarray(valid)[:, None]
    return q, k, v, g, mask


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("name,shape,causal,valid", SHAPES, ids=[s[0] for s in SHAPES])
def test_xla_route_matches_reference(name, shape, causal, valid, dtype, tol):
    q, k, v, _, mask = _inputs(shape, valid)
    got = attention(q.astype(dtype), k.astype(dtype), v.astype(dtype),
                    causal=causal, key_mask=mask, implementation="xla")
    assert got.shape == shape and got.dtype == dtype
    want = reference(q.astype(dtype), k.astype(dtype), v.astype(dtype), causal, mask)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name,shape,causal,valid", SHAPES, ids=[s[0] for s in SHAPES])
def test_xla_route_vjp_matches_reference_vjp(name, shape, causal, valid):
    q, k, v, g, mask = _inputs(shape, valid, seed=1)
    _, vjp_got = jax.vjp(lambda q, k, v: attention(
        q, k, v, causal=causal, key_mask=mask, implementation="xla"), q, k, v)
    _, vjp_ref = jax.vjp(lambda q, k, v: reference(q, k, v, causal, mask), q, k, v)
    for a, b in zip(vjp_got(g), vjp_ref(g)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("backend,dtype,route", [
    ("cpu", jnp.float32, "xla"),
    ("cpu", jnp.bfloat16, "xla"),
    ("gpu", jnp.float32, "xla"),
    ("gpu", jnp.bfloat16, ROUTES["gpu"]),
    ("gpu", jnp.float16, ROUTES["gpu"]),
])
def test_route_for(backend, dtype, route):
    assert route_for(backend, dtype) == route


def test_backend_without_a_route_raises():
    with pytest.raises(NotImplementedError, match="no attention route"):
        route_for("rocm", jnp.bfloat16)


def test_unknown_implementation_raises():
    q = jnp.ones((1, 4, 2, 8))
    with pytest.raises(ValueError, match="unknown attention implementation"):
        attention(q, q, q, implementation="pallas_mosaic")
    assert "xla" in IMPLEMENTATIONS


def test_default_route_on_cpu_is_xla_at_highest_precision():
    q = jnp.ones((1, 6, 2, 8), jnp.float32)
    jaxpr = str(jax.make_jaxpr(lambda q: attention(q, q, q))(q))
    assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in jaxpr


@pytest.mark.parametrize("length,causal,masked", [(197, False, False),
                                                  (77, True, False),
                                                  (12, False, True),
                                                  (9, False, True)])
def test_cudnn_route_pads_odd_lengths(monkeypatch, length, causal, masked):
    """The cudnn route hands cuDNN only even lengths: odd ones gain one
    masked key/query row that is sliced off again. Run here with the xla
    implementation standing in for cuDNN, which also checks the lengths it
    is given."""
    real = jax.nn.dot_product_attention
    seen = []

    def fake(q, k, v, mask=None, is_causal=False, query_seq_lengths=None,
             key_value_seq_lengths=None, implementation=None):
        assert implementation == "cudnn"
        assert q.shape[1] % 2 == 0
        seen.append(q.shape[1])
        if key_value_seq_lengths is not None:
            valid = jnp.arange(q.shape[1])[None, :] < key_value_seq_lengths[:, None]
            valid = valid[:, None, None, :]
            mask = valid if mask is None else (mask & valid)
        return real(q, k, v, mask=mask, is_causal=is_causal, implementation="xla")

    monkeypatch.setattr(attention_module.jax.nn, "dot_product_attention", fake)
    shape = (2, length, 4, 16)
    q, k, v, _, mask = _inputs(shape, (length - 3, length) if masked else None)
    got = attention(q, k, v, causal=causal, key_mask=mask, implementation="cudnn")
    assert seen == [length + length % 2]
    assert got.shape == shape
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(reference(q, k, v, causal, mask)),
                               atol=1e-5, rtol=1e-5)
