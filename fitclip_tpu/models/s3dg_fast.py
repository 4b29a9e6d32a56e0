"""Fast-eval S3DG forward: same parameter tree as `models/s3dg.py`'s Flax
module, restructured to read each activation fewer times.

The Flax forward spends its non-stem time in many narrow ops: every
Inception block launches three independent 1x1x1 convs over the SAME input
(output widths as small as 16), a BatchNorm affine pass per conv, and four
per-branch gating multiplies. This forward:

  * folds the frozen BatchNorm affines into the conv kernels (fp32 fold,
    then cast: conv + bias + ReLU is one op, no separate affine pass);
  * merges each block's three parallel 1x1x1 branch convs into ONE conv
    whose output width is the branches' sum — one read of the input
    activation instead of three, and a full-width matmul for the MXU;
  * applies self-gating as a single broadcast multiply on the
    concatenated block output (gate vectors are computed from the
    per-branch means, concatenated once) instead of four separate
    multiply passes.

Numerics match the Flax module to bf16 tolerance (tests/test_s3dg_fast.py)
— the contraction sets are identical; only fusion boundaries move.

Reference semantics: aligner/encoder/s3dg.py:11-218 (vendored S3D-G).
"""

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.models.s3dg import (Size3, _triple, max_pool_3d_tf_padding,
                                     space_to_depth)


def _bn_affine(bn, eps: float = 1e-5) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(inv, shift) of the frozen-stats BatchNorm, computed in fp32."""
    var = bn["running_var"].astype(jnp.float32)
    inv = jax.lax.rsqrt(var + eps) * bn["weight"].astype(jnp.float32)
    shift = bn["bias"].astype(jnp.float32) - bn["running_mean"].astype(jnp.float32) * inv
    return inv, shift


def _folded(conv_params, bn_params, dtype):
    """BN folded into the conv: kernel' = kernel * inv[c_out], bias = shift."""
    inv, shift = _bn_affine(bn_params)
    kernel = conv_params["kernel"].astype(jnp.float32) * inv
    return kernel.astype(dtype), shift.astype(dtype)


def _conv3d(x, kernel, stride: Size3 = 1, padding: Size3 = 0):
    s, p = _triple(stride), _triple(padding)
    dn = jax.lax.conv_dimension_numbers(
        x.shape, kernel.shape, ("NTHWC", "THWIO", "NTHWC"))
    return jax.lax.conv_general_dilated(
        x, kernel, window_strides=s, padding=[(q, q) for q in p],
        dimension_numbers=dn)


def _st_conv(params, x, kernel_size: Size3, stride: Size3 = 1,
             padding: Size3 = 0, separable: bool = False, dtype=jnp.bfloat16):
    """STConv3D with the BN affines folded into the kernels."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    if separable:
        kern, bias = _folded(params["conv1"], params["bn1"], dtype)
        x = jax.nn.relu(_conv3d(x, kern, (1, s[1], s[2]), (0, p[1], p[2])) + bias)
        kern, bias = _folded(params["conv2"], params["bn2"], dtype)
        return jax.nn.relu(_conv3d(x, kern, (s[0], 1, 1), (p[0], 0, 0)) + bias)
    kern, bias = _folded(params["conv1"], params["bn1"], dtype)
    return jax.nn.relu(_conv3d(x, kern, s, p) + bias)


def _gate(params, pooled):
    """sigmoid(fc(pooled)) for one branch; pooled is fp32, gate in fp32."""
    return jax.nn.sigmoid(
        pooled @ params["fc"]["kernel"].astype(jnp.float32)
        + params["fc"]["bias"].astype(jnp.float32))


def _spatial_mean(x):
    """(B, T, H, W, C) -> (B, C) fp32 mean over (T, H, W)."""
    return x.mean(axis=tuple(range(1, x.ndim - 1)), dtype=jnp.float32)


# ---------------------------------------------------------------------------
# W8A8 on the tower's matmul-shaped convs.
#
# After the merged-branch restructuring every Inception block's 1x1x1 convs
# are plain (rows, C_in) @ (C_in, C_out) matmuls over the flattened
# spatio-temporal axes — exactly the shape class ops/quant.py already
# handles for the transformer families. Quantized sites: conv_2b, each
# block's merged branch stem, each block's post-pool b3 conv, and the final
# FC. The separable 3D convs (conv_2c, conv_b1_b/conv_b2_b) and the stem
# stay in the compute dtype. Calibration rides the generic K-batch
# machinery (merge_act_amax / apply_act_scales / save_act_scales): the
# "int8" subtree's {act_scale} nodes and the mirrored {"act_amax": (x,)}
# collection tree are the same shapes cli/runners.py drives for CLIP.
# ---------------------------------------------------------------------------


def _quantized_matmul_site(kernel2d: jnp.ndarray, bias: jnp.ndarray) -> dict:
    from fitclip_tpu.ops.quant import quantize_weight

    node = quantize_weight(np.asarray(kernel2d, np.float32))
    node["bias"] = np.asarray(bias, np.float32)
    node["act_scale"] = np.ones((1,), np.float32)
    return node


def quantize_s3dg_fast(params, from_block: str = "mixed_4b") -> dict:
    """S3DG param tree -> same tree + an "int8" subtree of quantized
    matmul sites (BN folded fp32 first; per-out-channel weight scales;
    per-tensor activation scales, ones until calibrated).

    from_block bounds quantization to blocks from that point on (+ the FC):
    the 56^2-stage sites are bandwidth-bound (400k activation rows, 64-192
    channels), where the extra quantize/requant passes cost more than the
    narrow int8 matmuls save. From mixed_4b the spatial grid is 14^2 (~12k
    rows, 480-832 channels): matmul-bound. from_block=None or "conv_2b"
    quantizes every site."""
    if "int8" in params:  # idempotent: already-quantized tree passes through
        return params
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    names = list(_BLOCK_WIDTHS)
    start = 0 if from_block in (None, "conv_2b") else names.index(from_block)

    def folded2d(conv, bn):
        kern, bias = _folded(conv, bn, jnp.float32)
        kern = np.asarray(kern)
        return kern.reshape(kern.shape[-2], kern.shape[-1]), np.asarray(bias)

    q = {}
    if start == 0:
        q["conv_2b"] = _quantized_matmul_site(
            *folded2d(params["conv_2b"]["conv1"], params["conv_2b"]["bn1"]))
    for name in names[start:]:
        block = params[name]
        kernels, biases = zip(*(folded2d(block[b]["conv1"], block[b]["bn1"])
                                for b in ("conv_b0", "conv_b1_a", "conv_b2_a")))
        q[name] = {
            "merged": _quantized_matmul_site(np.concatenate(kernels, axis=-1),
                                             np.concatenate(biases)),
            "b3": _quantized_matmul_site(
                *folded2d(block["conv_b3_b"]["conv1"], block["conv_b3_b"]["bn1"])),
        }
    q["fc"] = _quantized_matmul_site(params["fc"]["kernel"],
                                     params["fc"]["bias"])
    out = dict(params)
    out["int8"] = q
    return out


def _int8_conv1x1(node: dict, x: jnp.ndarray, collect: Optional[dict],
                  site: str, relu: bool = True) -> jnp.ndarray:
    """A quantized 1x1x1 conv site: contracts the trailing channel dim.
    In collection mode records the fp32 activation abs-max and runs the
    DYNAMIC per-row quant (accurate intermediates, same as the CLIP
    calibration path)."""
    from fitclip_tpu.ops.quant import int8_dense, int8_dense_static

    if collect is not None:
        amax = jnp.max(jnp.abs(x.astype(jnp.float32))).reshape((1,))
        parts = site.split("/")
        leaf = collect
        for p in parts[:-1]:
            leaf = leaf.setdefault(p, {})
        leaf[parts[-1]] = {"act_amax": (amax,)}
        out = int8_dense(x, node["kernel_q"], node["scale"], node["bias"])
    else:
        out = int8_dense_static(x, node["kernel_q"], node["scale"],
                                node["bias"], node["act_scale"])
    return jax.nn.relu(out) if relu else out


def _inception_block(params, x, widths, dtype, defer_gate=False,
                     q_block=None, collect=None, site=""):
    b0, b1a, b1b, b2a, b2b, b3b = widths
    if q_block is not None:
        merged = _int8_conv1x1(q_block["merged"], x, collect, f"{site}/merged")
        branch3 = _int8_conv1x1(q_block["b3"], max_pool_3d_tf_padding(x, 3, 1),
                                collect, f"{site}/b3")
    else:
        # One merged 1x1x1 conv for the three parallel branch stems.
        kernels, biases = zip(*(
            _folded(params[name]["conv1"], params[name]["bn1"], dtype)
            for name in ("conv_b0", "conv_b1_a", "conv_b2_a")))
        merged = jax.nn.relu(
            _conv3d(x, jnp.concatenate(kernels, axis=-1))
            + jnp.concatenate(biases))
        branch3 = _st_conv(params["conv_b3_b"], max_pool_3d_tf_padding(x, 3, 1),
                           1, dtype=dtype)
    branch0 = merged[..., :b0]
    branch1 = _st_conv(params["conv_b1_b"], merged[..., b0:b0 + b1a],
                       3, padding=1, separable=True, dtype=dtype)
    branch2 = _st_conv(params["conv_b2_b"], merged[..., b0 + b1a:],
                       3, padding=1, separable=True, dtype=dtype)
    parts = [branch0, branch1, branch2, branch3]
    out = jnp.concatenate(parts, axis=-1)
    if "gating_b0" not in params:
        return (out, None) if defer_gate else out
    # Gate vectors from the per-branch means (fp32 accumulation, same as
    # SelfGating), applied as ONE multiply on the concatenated output. The
    # channel mean of concat(parts) IS the concat of per-branch means, and
    # the four per-branch gate FCs run as one block-diagonal matmul, so the
    # gating costs one reduce over the block output instead of four slice
    # reduces and four narrow matmuls. Off-diagonal zeros contribute
    # exactly 0: the same math.
    pooled = _spatial_mean(out)
    kernel = jax.scipy.linalg.block_diag(*(
        params[f"gating_b{i}"]["fc"]["kernel"].astype(jnp.float32)
        for i in range(4)))
    bias = jnp.concatenate([
        params[f"gating_b{i}"]["fc"]["bias"].astype(jnp.float32)
        for i in range(4)])
    gates = jax.nn.sigmoid(pooled @ kernel + bias).astype(dtype)
    if defer_gate:
        # The caller max-pools next: sigmoid gates are positive per-channel
        # scales, and max commutes with positive scaling, so the multiply
        # moves AFTER the pool onto the 4-8x smaller tensor (the gate MEANS
        # still come from the pre-pool activation, exactly as the module).
        return out, gates
    return out * gates[:, None, None, None, :]


def _gated(pair):
    out, gates = pair
    return out if gates is None else out * gates[:, None, None, None, :]


_BLOCK_WIDTHS = {
    "mixed_3b": (64, 96, 128, 16, 32, 32),
    "mixed_3c": (128, 128, 192, 32, 96, 64),
    "mixed_4b": (192, 96, 208, 16, 48, 64),
    "mixed_4c": (160, 112, 224, 24, 64, 64),
    "mixed_4d": (128, 128, 256, 24, 64, 64),
    "mixed_4e": (112, 144, 288, 32, 64, 64),
    "mixed_4f": (256, 160, 320, 32, 128, 128),
    "mixed_5b": (256, 160, 320, 32, 128, 128),
    "mixed_5c": (384, 192, 384, 48, 128, 128),
}


def s3dg_fast_apply(params, video: jnp.ndarray, dtype=jnp.bfloat16,
                    use_space_to_depth: bool = True,
                    use_last_layer: bool = True,
                    int8: bool = False,
                    collect: Optional[dict] = None) -> jnp.ndarray:
    """Drop-in for `S3DG(...).apply({"params": params}, video)` at eval.

    video: (B, T, H, W, 3) raw pixels; returns (B, 512) embeddings.
    int8=True runs the matmul-shaped convs W8A8 (params must come from
    quantize_s3dg_fast); pass a dict as ``collect`` to record per-site
    activation abs-maxes for calibration (dynamic-quant forward).
    """
    q = params.get("int8") if int8 else None
    if int8 and q is None:
        raise ValueError("int8 forward needs quantize_s3dg_fast params")
    x = video.astype(dtype)
    conv = partial(_st_conv, dtype=dtype)
    if use_space_to_depth:
        x = space_to_depth(x)
        x = conv(params["conv1"], x, (2, 4, 4), stride=1, padding=(1, 2, 2))
        x = x[:, 1:, 1:, 1:, :]
        x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2))
    else:
        x = conv(params["conv1"], x, (3, 7, 7), stride=2, padding=(1, 3, 3))
        x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2))
    q_2b = q.get("conv_2b") if q is not None else None
    if q_2b is not None:
        x = _int8_conv1x1(q_2b, x, collect, "conv_2b")
    else:
        x = conv(params["conv_2b"], x, 1)
    x = conv(params["conv_2c"], x, 3, padding=1, separable=True)
    # Self-gating deferred past the pool (see _inception_block defer_gate):
    # the gate mean reads the 56^2 activation, the multiply runs at 28^2.
    gate = _gate(params["gating"], _spatial_mean(x)).astype(dtype)
    x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2))
    x = x * gate[:, None, None, None, :]

    def block(name, x, defer_gate=False):
        return _inception_block(params[name], x, _BLOCK_WIDTHS[name], dtype,
                                defer_gate=defer_gate,
                                q_block=q.get(name) if q is not None else None,
                                collect=collect, site=name)

    x = block("mixed_3b", x)
    x, gate = block("mixed_3c", x, defer_gate=True)
    x = _gated((max_pool_3d_tf_padding(x, 3, 2), gate))
    for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e"):
        x = block(name, x)
    x, gate = block("mixed_4f", x, defer_gate=True)
    x = _gated((max_pool_3d_tf_padding(x, 2, 2), gate))
    x = block("mixed_5b", x)
    # The global mean is linear, so mixed_5c's gate commutes through it and
    # multiplies a (B, C) vector instead of the (B, T, H, W, C) tensor.
    x, gate = block("mixed_5c", x, defer_gate=True)
    x = _spatial_mean(x).astype(dtype)
    if gate is not None:
        x = x * gate
    if use_last_layer:
        if q is not None:
            x = _int8_conv1x1(q["fc"], x, collect, "fc", relu=False)
        else:
            x = x @ params["fc"]["kernel"].astype(dtype) + params["fc"]["bias"].astype(dtype)
    return x
