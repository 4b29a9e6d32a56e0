"""SpaceTimeTransformer (Frozen-in-Time's divided space-time ViT) in Flax.

Reference: aligner/encoder/video_transformer.py:81-340. Per block:
temporal attention (norm3 -> attn over frames at each spatial location) added
to the input, spatial attention (norm1 -> attn over patches within each frame)
ALSO added to the original input ("frozen-in-time" style), then MLP. The CLS
token attends over all tokens and its keys/values join every group. Positional
embedding = per-frame spatial embed tiled over time + temporal embed repeated
per frame. LN eps 1e-6, qkv bias, exact GELU.

The parameter tree mirrors torch module names (converter is a rename).
"""

from typing import Any, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

PRECISION = jax.lax.Precision.HIGHEST


class LayerNormTorch(nn.Module):
    """LN with torch param names (weight/bias) for 1:1 checkpoint mapping."""
    eps: float = 1e-6

    @nn.compact
    def __call__(self, x):
        dim = x.shape[-1]
        weight = self.param("weight", nn.initializers.ones, (dim,))
        bias = self.param("bias", nn.initializers.zeros, (dim,))
        xf = x.astype(jnp.float32)
        # Two-pass form reusing `centered` (same biased variance as
        # torch/jnp.var, which recomputes the mean internally).
        mean = xf.mean(-1, keepdims=True)
        centered = xf - mean
        var = (centered * centered).mean(-1, keepdims=True)
        normed = centered * jax.lax.rsqrt(var + self.eps)
        return (normed * weight + bias).astype(x.dtype)


def _cls_global_attention(qkv, heads: int, dim: int):
    """The CLS token's attention over the FULL sequence: one query row,
    sliced before any head reshape so no full-tensor pass is spent on it.
    Returns (B, 1, dim) in the compute dtype."""
    b, n, _ = qkv.shape
    d = dim // heads
    cls_q = qkv[:, 0, :dim].reshape(b, heads, d) * (d ** -0.5)
    k = qkv[:, :, dim:2 * dim].reshape(b, n, heads, d)
    v = qkv[:, :, 2 * dim:].reshape(b, n, heads, d)
    logits = jnp.einsum("bhd,bnhd->bhn", cls_q, k, precision=PRECISION,
                        preferred_element_type=jnp.float32)
    weights = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhn,bnhd->bhd", weights, v, precision=PRECISION,
                     preferred_element_type=jnp.float32)
    return out.reshape(b, 1, dim).astype(qkv.dtype)


class QuantDense(nn.Module):
    """int8 W8A8 dense (ops/quant.py). Init yields zero weights — real
    parameters arrive via quantize_fit_video_params on a float tree.

    Static mode (default) quantizes with the calibrated per-tensor
    ``act_scale``; ``dynamic`` computes per-row scales on the fly (the
    calibration mode). Every call sows the observed activation abs-max so a
    calibration pass (mutable=["intermediates"]) can collect scales."""
    features: int
    dtype: Any
    dynamic: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        from fitclip_tpu.ops.quant import int8_dense, int8_dense_static

        kernel_q = self.param("kernel_q", nn.initializers.zeros,
                              (x.shape[-1], self.features), jnp.int8)
        scale = self.param("scale", nn.initializers.ones,
                           (self.features,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros,
                          (self.features,), jnp.float32)
        act_scale = self.param("act_scale", nn.initializers.ones,
                               (1,), jnp.float32)
        amax = jnp.max(jnp.abs(x.astype(jnp.float32))).reshape(1)
        self.sow("intermediates", "act_amax", amax)
        if self.dynamic:
            return int8_dense(x.astype(self.dtype), kernel_q, scale, bias)
        return int8_dense_static(x.astype(self.dtype), kernel_q, scale, bias,
                                 act_scale)


def _dense(quantized, features: int, dtype, name: str):
    """quantized: False (float Dense), True ("static" int8) or "dynamic"."""
    if quantized:
        return QuantDense(features, dtype, dynamic=(quantized == "dynamic"),
                          name=name)
    return nn.Dense(features, dtype=dtype, param_dtype=jnp.float32,
                    precision=PRECISION, name=name)


class VarAttention(nn.Module):
    """Attention over a chosen axis (time or space) with global CLS
    (video_transformer.py:81-138).

    Layout-free formulation: heads and groups ride dot_general BATCH dims
    via einsum (no head-fold/regroup transposes, no repeated K/V), so
    the only data movement is pure reshapes; the CLS key/value joins each
    group in LOGIT space (one lane-axis concat of the scores) instead of
    materializing repeated K/V tensors. Same math: softmax over
    [cls | group] in fp32, weights cast to the compute dtype, per-head
    outputs accumulated in fp32."""
    dim: int
    num_heads: int
    dtype: jnp.dtype = jnp.float32
    # quantized: False (float denses), True (int8 W8A8 with calibrated static
    # activation scales) or "dynamic" (per-row scales — calibration mode).
    # Only the qkv/proj/mlp denses quantize; LN/softmax/attention stay
    # bf16/fp32 (same scheme as the CLIP/SLIP towers, ops/quant.py).
    quantized: Any = False

    @nn.compact
    def __call__(self, x, mode: str, frames: int, patches: int):
        h = self.num_heads
        d = self.dim // h
        b, n, _ = x.shape
        qkv = _dense(self.quantized, 3 * self.dim, self.dtype, name="qkv")(x)

        q, k, v = jnp.split(qkv, 3, axis=-1)
        q = q.reshape(b, n, h, d) * (d ** -0.5)
        k = k.reshape(b, n, h, d)
        v = v.reshape(b, n, h, d)

        cls_out = _cls_global_attention(qkv, h, self.dim)

        # Patch tokens grouped (B, F, P, H, d) — reshapes only.
        q_ = q[:, 1:].reshape(b, frames, patches, h, d)
        k_ = k[:, 1:].reshape(b, frames, patches, h, d)
        v_ = v[:, 1:].reshape(b, frames, patches, h, d)
        cls_k, cls_v = k[:, 0], v[:, 0]

        if mode == "time":  # attend over frames at each spatial location
            # ONE explicit relayout to time-major (B, P, H, F, d) per
            # operand; every contraction below is then a native batched
            # matmul with its batch dims leading.
            tq = q_.transpose(0, 2, 3, 1, 4)
            tk = k_.transpose(0, 2, 3, 1, 4)
            tv = v_.transpose(0, 2, 3, 1, 4)
            logits = jnp.einsum("bphfd,bphgd->bphfg", tq, tk,
                                precision=PRECISION,
                                preferred_element_type=jnp.float32)
            cls_l = jnp.einsum("bphfd,bhd->bphf", tq, cls_k,
                               precision=PRECISION,
                               preferred_element_type=jnp.float32)
            w = jax.nn.softmax(
                jnp.concatenate([cls_l[..., None], logits], axis=-1),
                axis=-1).astype(v.dtype)
            out = jnp.einsum("bphfg,bphgd->bphfd", w[..., 1:], tv,
                             precision=PRECISION,
                             preferred_element_type=jnp.float32)
            out = out + jnp.einsum("bphf,bhd->bphfd", w[..., 0], cls_v,
                                   precision=PRECISION,
                                   preferred_element_type=jnp.float32)
            out = out.transpose(0, 3, 1, 2, 4)  # back to (B, F, P, H, d)
        else:  # space: attend over patches within each frame
            logits = jnp.einsum("bfphd,bfqhd->bfhpq", q_, k_,
                                precision=PRECISION,
                                preferred_element_type=jnp.float32)
            cls_l = jnp.einsum("bfphd,bhd->bfhp", q_, cls_k,
                               precision=PRECISION,
                               preferred_element_type=jnp.float32)
            w = jax.nn.softmax(
                jnp.concatenate([cls_l[..., None], logits], axis=-1),
                axis=-1).astype(v.dtype)
            out = jnp.einsum("bfhpq,bfqhd->bfphd", w[..., 1:], v_,
                             precision=PRECISION,
                             preferred_element_type=jnp.float32)
            out = out + jnp.einsum("bfhp,bhd->bfphd", w[..., 0], cls_v,
                                   precision=PRECISION,
                                   preferred_element_type=jnp.float32)

        out = jnp.concatenate(
            [cls_out, out.reshape(b, frames * patches, self.dim)],
            axis=1).astype(x.dtype)
        return _dense(self.quantized, self.dim, self.dtype, name="proj")(out)


class SpaceTimeBlock(nn.Module):
    dim: int
    num_heads: int
    dtype: jnp.dtype = jnp.float32
    quantized: Any = False

    @nn.compact
    def __call__(self, x, frames: int, patches: int):
        time_out = VarAttention(self.dim, self.num_heads, dtype=self.dtype,
                                quantized=self.quantized, name="timeattn")(
            LayerNormTorch(name="norm3")(x), "time", frames, patches)
        time_residual = x + time_out
        space_out = VarAttention(self.dim, self.num_heads, dtype=self.dtype,
                                 quantized=self.quantized, name="attn")(
            LayerNormTorch(name="norm1")(time_residual), "space", frames, patches)
        space_residual = x + space_out  # frozen-in-time: residual from the input
        h = LayerNormTorch(name="norm2")(space_residual)
        h = _dense(self.quantized, 4 * self.dim, self.dtype, name="mlp_fc1")(h)
        h = nn.gelu(h, approximate=False)
        h = _dense(self.quantized, self.dim, self.dtype, name="mlp_fc2")(h)
        return space_residual + h


class SpaceTimeTransformer(nn.Module):
    """Input: (B, F, H, W, 3) -> (B, embed_dim) CLS feature
    (video_transformer.py:181-340 with head/pre_logits = identity as the
    FrozenInTime wrapper sets them)."""
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    img_size: int = 224
    num_frames: int = 4
    # Compute dtype: fp32 (default) is the torch-oracle parity configuration;
    # bf16 the throughput one. LayerNorms/softmax stay fp32 either way.
    dtype: jnp.dtype = jnp.float32
    quantized: Any = False

    @nn.compact
    def __call__(self, video: jnp.ndarray) -> jnp.ndarray:
        video = video.astype(self.dtype)
        b, f = video.shape[0], video.shape[1]
        g, p = self.img_size // self.patch_size, self.patch_size
        patches_per_frame = g * g

        x = video.reshape(b * f, g, p, g, p, 3).transpose(0, 1, 3, 2, 4, 5) \
                 .reshape(b * f, g * g, p * p * 3)
        x = nn.Dense(self.embed_dim, name="patch_embed", precision=PRECISION,
                     dtype=self.dtype)(x)
        x = x.reshape(b, f * patches_per_frame, self.embed_dim)

        cls_token = self.param("cls_token", nn.initializers.zeros,
                               (self.embed_dim,))
        pos_embed = self.param("pos_embed", nn.initializers.normal(0.02),
                               (patches_per_frame + 1, self.embed_dim))
        temporal_embed = self.param("temporal_embed", nn.initializers.zeros,
                                    (self.num_frames, self.embed_dim))

        x = jnp.concatenate(
            [jnp.broadcast_to(cls_token.astype(self.dtype),
                              (b, 1, self.embed_dim)), x], axis=1)
        tile_pos = jnp.tile(pos_embed[1:], (self.num_frames, 1))
        tile_temporal = jnp.repeat(temporal_embed, patches_per_frame, axis=0)
        total = jnp.concatenate([pos_embed[:1], tile_pos + tile_temporal], axis=0)
        x = x + total[: x.shape[1]].astype(self.dtype)

        for i in range(self.depth):
            x = SpaceTimeBlock(self.embed_dim, self.num_heads, dtype=self.dtype,
                               quantized=self.quantized,
                               name=f"blocks_{i}")(
                x, frames=f, patches=patches_per_frame)
        x = LayerNormTorch(name="norm")(x)
        return x[:, 0]
