"""W8A8 int8 inference path for the transformer's dense layers.

The H100's tensor cores run int8 at twice their bf16 rate, but XLA's
s8 x s8 -> s32 dot here comes with a quantize pass before and a dequantize
epilogue after each dense. On an H100 80GB HBM3 (700 W limit) the
calibrated int8 ViT-B/16 encode ran at 2219 clips/s against 2577 in bf16
(bench.py, PERF.md): slower, so bf16 is the throughput configuration and
int8 a quality-gated option (cosine >= 0.999 against bf16). Scheme:

- **Weights**: symmetric per-output-channel int8, quantized offline by
  ``quantize_clip_params`` (kernel -> kernel_q int8 + scale fp32).
- **Activations**: symmetric dynamic per-token (per-row) int8, computed
  on the fly in fp32.
- **Accumulation** in int32; the dequant epilogue fuses the row and
  channel scales in fp32 and casts to the compute dtype.
- LayerNorm statistics, softmax and the attention core stay in bf16/fp32.

Eval-only: the round() in activation quantization has zero gradient, so the
training path keeps the bf16/fp32 dense layers (the CLI only selects int8
via ``encoder.dtype=int8`` for evaluate/predict-style commands).
"""

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

QUANT_EPS = 1e-8


def quantize_weight(kernel: np.ndarray) -> Dict[str, np.ndarray]:
    """fp32 (..., in, out) -> {kernel_q int8, scale fp32 (..., out)} with
    symmetric per-output-channel scales. Leading axes (e.g. the scan layer
    axis) are preserved."""
    kernel = np.asarray(kernel, np.float32)
    amax = np.maximum(np.abs(kernel).max(axis=-2), QUANT_EPS)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.rint(kernel / scale[..., None, :]), -127, 127).astype(np.int8)
    return {"kernel_q": q, "scale": scale}


def int8_dense(x: jnp.ndarray, kernel_q: jnp.ndarray, scale: jnp.ndarray,
               bias: jnp.ndarray) -> jnp.ndarray:
    """Quantized dense: DYNAMIC per-row activation quant + int32-accumulating
    int8 matmul + fused dequant. Most accurate, but the row abs-max reduction
    costs a full extra pass over the activations per dense. Used for
    calibration; the serving path is ``int8_dense_static``."""
    x32 = x.astype(jnp.float32)
    amax = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True), QUANT_EPS)
    row_scale = amax / 127.0
    x_q = jnp.clip(jnp.round(x32 / row_scale), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        x_q, kernel_q,
        dimension_numbers=(((x_q.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    out = acc.astype(jnp.float32) * (row_scale * scale.astype(jnp.float32))
    out = out + bias.astype(jnp.float32)
    return out.astype(x.dtype)


def int8_dense_static(x: jnp.ndarray, kernel_q: jnp.ndarray, scale: jnp.ndarray,
                      bias: jnp.ndarray, act_scale: jnp.ndarray) -> jnp.ndarray:
    """Quantized dense with a CALIBRATED per-tensor activation scale: the
    quantize step is a single elementwise op XLA fuses into the producer
    (LN / GELU epilogue), no reduction pass. act_scale is the calibrated
    activation abs-max (see calibrate_act_scales)."""
    inv = 127.0 / jnp.maximum(act_scale.astype(jnp.float32), QUANT_EPS)
    x_q = jnp.clip(jnp.round(x.astype(jnp.float32) * inv), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        x_q, kernel_q,
        dimension_numbers=(((x_q.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    out_scale = (act_scale.astype(jnp.float32) / 127.0) * scale.astype(jnp.float32)
    out = acc.astype(jnp.float32) * out_scale + bias.astype(jnp.float32)
    return out.astype(x.dtype)


# Dense layers inside each transformer block that carry the FLOPs and get
# quantized; everything else (patch embed, final projections, embeddings,
# LN) stays in the compute dtype. The CLIP/SLIP trees name them
# in_proj/out_proj/mlp_fc/mlp_proj; Frozen-in-Time's SpaceTimeTransformer
# uses qkv/proj (under attn/timeattn) and mlp_fc1/mlp_fc2.
_BLOCK_DENSE_NAMES = ("mlp_fc", "mlp_proj")
_ATTN_DENSE_NAMES = ("in_proj", "out_proj")
FIT_DENSE_NAMES = ("qkv", "proj", "mlp_fc1", "mlp_fc2")


def _quantize_dense_node(node: Dict[str, Any]) -> Dict[str, Any]:
    quantized = quantize_weight(node["kernel"])
    kernel = np.asarray(node["kernel"])
    # act_scale: (leading scan axes..., 1); ones until calibrated.
    act_shape = kernel.shape[:-2] + (1,)
    return {"kernel_q": quantized["kernel_q"], "scale": quantized["scale"],
            "bias": np.asarray(node["bias"], np.float32),
            "act_scale": np.ones(act_shape, np.float32)}


def quantize_clip_params(params, names: tuple = None) -> Any:
    """fp32/converted CLIP param tree -> int8-dense tree (the shape the
    quantized CLIPModel expects). Works on the scan-stacked layout: block
    kernels carry a leading `layers` axis, which per-channel quantization
    preserves. `names` overrides the set of dense node names to quantize
    (e.g. FIT_DENSE_NAMES for the SpaceTimeTransformer tree)."""
    params = jax.tree_util.tree_map(np.asarray, params)
    if names is None:
        names = _BLOCK_DENSE_NAMES + _ATTN_DENSE_NAMES

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, value in node.items():
            if key in names and isinstance(value, dict) and "kernel" in value:
                out[key] = _quantize_dense_node(value)
            else:
                out[key] = walk(value)
        return out

    return walk(params)


def merge_act_amax(a, b):
    """Elementwise-max merge of two sown act-amax trees (running abs-max over
    calibration batches). Either side may be None."""
    if a is None:
        return b
    if b is None:
        return a
    return jax.tree_util.tree_map(lambda x, y: np.maximum(np.asarray(x),
                                                          np.asarray(y)), a, b)


def _act_scale_items(params, prefix=""):
    for key, value in params.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            if "act_scale" in value:
                yield path, value
            else:
                yield from _act_scale_items(value, path + "/")


def save_act_scales(path: str, params) -> None:
    """Persist the calibrated activation scales (only) to an .npz so a later
    run can skip calibration entirely."""
    arrays = {p: np.asarray(node["act_scale"], np.float32)
              for p, node in _act_scale_items(params)}
    np.savez(path, **arrays)


def load_act_scales(path: str, params):
    """Write persisted activation scales back into a quantized params tree.
    Raises KeyError if the file doesn't cover every quantized dense (scales
    from a different architecture must not half-apply)."""
    loaded = np.load(path)
    params = jax.tree_util.tree_map(np.asarray, params)
    for p, node in _act_scale_items(params):
        node["act_scale"] = np.asarray(loaded[p], np.float32).reshape(
            node["act_scale"].shape)
    return params


def apply_act_scales(params, intermediates, margin: float = 1.0):
    """Write calibration-observed activation abs-maxes into the act_scale
    leaves. `intermediates` is the flax sow tree from a dynamic-quant forward
    (mutable=["intermediates"]); its structure mirrors the params tree with
    {"act_amax": (array,)} leaves (stacked along the scan axis inside scanned
    blocks, matching the stacked act_scale params)."""
    params = jax.tree_util.tree_map(np.asarray, params)

    def walk(p_node, i_node):
        if not isinstance(p_node, dict):
            return p_node
        out = {}
        for key, value in p_node.items():
            sub_i = (i_node or {}).get(key)
            if isinstance(value, dict) and "act_scale" in value:
                new = dict(value)
                if sub_i and "act_amax" in sub_i:
                    amax = np.asarray(sub_i["act_amax"][0], np.float32)
                    new["act_scale"] = np.maximum(
                        amax.reshape(new["act_scale"].shape) * margin, QUANT_EPS)
                out[key] = new
            else:
                out[key] = walk(value, sub_i)
        return out

    return walk(params, intermediates)


def require_calibrated(params, context: str = "serving") -> None:
    """Fail closed on an int8 tree whose activation scales were never
    calibrated. Freshly quantized sites carry the all-ones act_scale
    sentinel (_quantize_dense_node); running them "calibrated" would
    silently clip activations at abs-max 1.0. Serving paths call this after
    loading persisted scales — serving never calibrates on live traffic.

    (A genuinely calibrated site whose every observed abs-max is exactly
    1.0 would false-positive here; real activation maxima are continuous
    fp32 values, so this does not occur in practice.)"""
    stale = [path for path, node in _act_scale_items(params)
             if np.all(np.asarray(node["act_scale"]) == 1.0)]
    if stale:
        raise ValueError(
            f"{context}: {len(stale)} quantized site(s) have uncalibrated "
            f"activation scales (all-ones sentinel), e.g. {stale[:3]} — "
            "calibrate offline (command=evaluate ++encoder.dtype=int8 "
            "++quant.scales_path=...) and load the persisted .npz first")
