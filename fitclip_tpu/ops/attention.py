"""Scaled dot-product attention: one function and one route table.

Every head with plain softmax attention (CLIP, SLIP, DistilBERT, MMBert)
calls ``attention``. The route comes from ``ROUTES`` by backend unless the
caller names one; a backend or route outside the table raises. There is no
fallback: a route that cannot run fails where it is called.

- ``xla``: ``jax.nn.dot_product_attention(implementation="xla")`` — einsum,
  fp32 logits and softmax, einsum. fp32 inputs run their two matmuls at
  HIGHEST precision, so the fp32 configuration stays true fp32 (no TF32).
- ``cudnn``: cuDNN's fused flash attention, for 16-bit inputs only. Its
  backward with the implicit bias the JAX wrapper passes takes only even
  sequence lengths, so odd lengths (CLIP's 197 and 77) are padded by one
  masked key and query row, and the padded row is sliced off again.

fp32 inputs (the parity configuration) take ``xla`` on every backend.

Frozen-in-Time's divided space/time attention with its global CLS key is not
plain attention and keeps its einsum path (frozen_in_time/video_transformer).
"""

from typing import Optional

import jax
import jax.numpy as jnp

# The route each backend takes for 16-bit inputs (chosen from H100
# timings, PERF.md).
ROUTES = {"cpu": "xla", "gpu": "cudnn"}
IMPLEMENTATIONS = ("xla", "cudnn")


def route_for(backend: str, dtype) -> str:
    """The attention route for ``dtype`` inputs on ``backend``; raises for a
    backend with no route."""
    if backend not in ROUTES:
        raise NotImplementedError(
            f"no attention route for backend {backend!r}; routes: {ROUTES}")
    if jnp.dtype(dtype) == jnp.float32:
        return "xla"
    return ROUTES[backend]


def attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray, *,
              causal: bool = False, key_mask: Optional[jnp.ndarray] = None,
              implementation: Optional[str] = None) -> jnp.ndarray:
    """softmax(q k^T / sqrt(d)) v over (B, L, H, D) inputs -> (B, L, H, D).

    ``key_mask``: optional (B, L) boolean, True where a key may be attended
    (DistilBERT/MMBert padding). ``implementation`` overrides the backend's
    route; it must be one of ``IMPLEMENTATIONS``."""
    if implementation is None:
        implementation = route_for(jax.default_backend(), q.dtype)
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"unknown attention implementation {implementation!r}; "
                         f"expected one of {IMPLEMENTATIONS}")
    mask = None if key_mask is None else key_mask[:, None, None, :]
    if implementation == "xla":
        with jax.default_matmul_precision("highest"):
            return jax.nn.dot_product_attention(q, k, v, mask=mask,
                                                is_causal=causal,
                                                implementation="xla")
    length = q.shape[1]
    if length % 2 == 0:
        return jax.nn.dot_product_attention(q, k, v, mask=mask,
                                            is_causal=causal,
                                            implementation="cudnn")
    pad = ((0, 0), (0, 1), (0, 0), (0, 0))
    q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
    if mask is not None:
        mask = jnp.pad(mask, ((0, 0), (0, 0), (0, 0), (0, 1)))
    lengths = jnp.full((q.shape[0],), length, jnp.int32)
    out = jax.nn.dot_product_attention(q, k, v, mask=mask, is_causal=causal,
                                       query_seq_lengths=lengths,
                                       key_value_seq_lengths=lengths,
                                       implementation="cudnn")
    return out[:, :length]
