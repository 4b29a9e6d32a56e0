"""CLIP dual encoder (ViT vision tower + causal text transformer) in plain JAX.

Same math as OpenAI CLIP (the reference wraps the `clip` package,
aligner/encoder/clip_video_text_encoder.py). No module library: parameters
are a nested dict, the layout the torch converter writes
(convert/torch_state_dict.py), and every function here is pure.

- Patch embedding as an unfold + matmul, bit-equivalent to a stride-p conv.
- Transformer blocks are stacked along a leading ``layers`` axis and run
  with ``lax.scan`` (one compiled block body); ``remat`` recomputes the
  block in the backward pass to save activation memory in training.
- Parameters live in fp32; activations run in a configurable compute dtype.
  LayerNorm statistics and the softmax are fp32 in every dtype.
- A dense node is either float ``{kernel, bias}`` or int8
  ``{kernel_q, scale, bias, act_scale}`` (ops/quant.quantize_clip_params);
  the leaves decide which path runs.
- The pixel normalization ((x/255 - mean) / std) can be folded into the patch
  embedding weights (`fold_pixel_normalization`) so the device-side input
  stays uint8.

The transformer here is shared: SLIP's towers and the ResNet-CLIP text tower
run the same ``transformer`` over the same block layout.

`logit_scale` is intentionally not a model parameter: the framework owns the
temperature in its train state, mirroring the reference deleting CLIP's own
scale (clip_video_text_encoder.py:76-77).
"""

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from fitclip_tpu.ops.attention import attention
from fitclip_tpu.ops.quant import int8_dense, int8_dense_static

Dtype = Any
Params = Dict[str, Any]

# Explicit matmul precision: without it an fp32 matmul may run in a reduced
# precision (TF32 on the GPU), which breaks the fp32 parity bar. For bf16
# operands HIGHEST changes nothing.
PRECISION = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()
    quick_gelu: bool = True

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig(vision=VisionConfig(patch_size=32))

    @staticmethod
    def vit_b_16() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_l_14(image_size: int = 224) -> "CLIPConfig":
        return CLIPConfig(
            embed_dim=768,
            vision=VisionConfig(image_size=image_size, patch_size=14, width=1024, layers=24, heads=16),
            text=TextConfig(width=768, heads=12, layers=12))

    @staticmethod
    def tiny_test(vocab_size: int = 64) -> "CLIPConfig":
        """Small config for unit tests: fast init/compile on CPU."""
        return CLIPConfig(
            embed_dim=32,
            vision=VisionConfig(image_size=32, patch_size=16, width=48, layers=2, heads=4),
            text=TextConfig(context_length=16, vocab_size=vocab_size, width=32, layers=2, heads=4))


def quick_gelu(x: jnp.ndarray) -> jnp.ndarray:
    return x * jax.nn.sigmoid(1.702 * x)


def layer_norm(x: jnp.ndarray, node: Params, out_dtype: Dtype,
               eps: float = 1e-5) -> jnp.ndarray:
    """LayerNorm over the last axis with fp32 statistics and arithmetic.
    ``node`` is the {scale, bias} leaf pair."""
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    centered = x32 - mean
    var = jnp.mean(centered * centered, axis=-1, keepdims=True)
    y = centered * jax.lax.rsqrt(var + eps)
    return (y * node["scale"].astype(jnp.float32)
            + node["bias"].astype(jnp.float32)).astype(out_dtype)


def dense(x: jnp.ndarray, node: Params, dtype: Dtype,
          observed: Optional[Dict[str, Any]] = None,
          name: str = "") -> jnp.ndarray:
    """x @ kernel + bias in ``dtype``. An int8 node runs ops/quant's static
    W8A8 dense; with ``observed`` (calibration) it runs the dynamic one and
    records the input's abs-max under ``observed[name]`` in the layout
    ops.quant.apply_act_scales reads."""
    if "kernel_q" not in node:
        y = jnp.matmul(x.astype(dtype), node["kernel"].astype(dtype),
                       precision=PRECISION)
        return y + node["bias"].astype(dtype)
    x = x.astype(dtype)
    if observed is not None:
        amax = jnp.max(jnp.abs(x.astype(jnp.float32))).reshape(1)
        observed[name] = {"act_amax": (amax,)}
        return int8_dense(x, node["kernel_q"], node["scale"], node["bias"])
    return int8_dense_static(x, node["kernel_q"], node["scale"], node["bias"],
                             node["act_scale"])


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """The static shape of one residual attention block."""
    heads: int
    causal: bool
    quick_gelu: bool
    dtype: Dtype
    ln_eps: float = 1e-5
    attention_impl: Optional[str] = None


def residual_block(x: jnp.ndarray, p: Params, spec: BlockSpec,
                   calibrate: bool = False) -> Tuple[jnp.ndarray, Any]:
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x)). Returns
    (x, observed) where observed is the calibration tree or None."""
    dtype = spec.dtype
    attn_obs = {} if calibrate else None
    mlp_obs = {} if calibrate else None
    b, length, width = x.shape
    head_dim = width // spec.heads

    h = layer_norm(x, p["ln_1"]["ln"], dtype, spec.ln_eps)
    qkv = dense(h, p["attn"]["in_proj"], dtype, attn_obs, "in_proj")
    q, k, v = (t.reshape(b, length, spec.heads, head_dim)
               for t in jnp.split(qkv, 3, axis=-1))
    a = attention(q, k, v, causal=spec.causal,
                  implementation=spec.attention_impl).reshape(b, length, width)
    x = x + dense(a, p["attn"]["out_proj"], dtype, attn_obs, "out_proj")

    h = layer_norm(x, p["ln_2"]["ln"], dtype, spec.ln_eps)
    h = dense(h, p["mlp_fc"], dtype, mlp_obs, "mlp_fc")
    h = quick_gelu(h) if spec.quick_gelu else jax.nn.gelu(h, approximate=False)
    x = x + dense(h, p["mlp_proj"], dtype, mlp_obs, "mlp_proj")
    if not calibrate:
        return x, None
    return x, {"attn": attn_obs, **mlp_obs}


def transformer(x: jnp.ndarray, blocks: Params, spec: BlockSpec,
                remat: Union[bool, str] = False,
                calibrate: bool = False) -> Tuple[jnp.ndarray, Any]:
    """Scan ``residual_block`` over layer-stacked ``blocks``. remat=True
    recomputes everything in the backward pass (least memory); remat="dots"
    keeps the matmul outputs and recomputes only the elementwise work.
    Returns (x, observed) with observed stacked along the layers."""
    body = functools.partial(residual_block, spec=spec, calibrate=calibrate)
    if remat:
        policy = (jax.checkpoint_policies.dots_with_no_batch_dims_saveable
                  if remat == "dots" else None)
        body = jax.checkpoint(body, prevent_cse=False, policy=policy)
    return jax.lax.scan(lambda h, p: body(h, p), x, blocks)


def _ln_init(width: int) -> Params:
    return {"ln": {"scale": jnp.ones((width,), jnp.float32),
                   "bias": jnp.zeros((width,), jnp.float32)}}


def init_blocks(rng, layers: int, width: int) -> Params:
    """Layer-stacked block params: lecun-normal kernels, zero biases, unit
    LayerNorms (the initializers a torch/flax Linear default to)."""
    kernel_init = jax.nn.initializers.lecun_normal()
    shapes = {"in_proj": (width, 3 * width), "out_proj": (width, width),
              "mlp_fc": (width, 4 * width), "mlp_proj": (4 * width, width)}
    keys = dict(zip(shapes, jax.random.split(rng, len(shapes))))

    def linear(name):
        fan_in, fan_out = shapes[name]
        layer_keys = jax.random.split(keys[name], layers)
        kernel = jax.vmap(lambda k: kernel_init(k, (fan_in, fan_out),
                                                jnp.float32))(layer_keys)
        return {"kernel": kernel,
                "bias": jnp.zeros((layers, fan_out), jnp.float32)}

    def stacked_ln():
        return jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (layers,) + a.shape), _ln_init(width))

    return {"attn": {"in_proj": linear("in_proj"), "out_proj": linear("out_proj")},
            "ln_1": stacked_ln(), "ln_2": stacked_ln(),
            "mlp_fc": linear("mlp_fc"), "mlp_proj": linear("mlp_proj")}


def init_text_tower(rng, cfg: TextConfig, embed_dim: int) -> Params:
    k_tok, k_pos, k_blocks, k_proj = jax.random.split(rng, 4)
    return {
        "token_embedding": 0.02 * jax.random.normal(
            k_tok, (cfg.vocab_size, cfg.width), jnp.float32),
        "positional_embedding": 0.01 * jax.random.normal(
            k_pos, (cfg.context_length, cfg.width), jnp.float32),
        "transformer": {"blocks": init_blocks(k_blocks, cfg.layers, cfg.width)},
        "ln_final": _ln_init(cfg.width),
        "text_projection": cfg.width ** -0.5 * jax.random.normal(
            k_proj, (cfg.width, embed_dim), jnp.float32),
    }


def encode_text_tower(t: Params, input_ids: jnp.ndarray, cfg: TextConfig,
                      spec: BlockSpec, remat: Union[bool, str] = False,
                      calibrate: bool = False) -> Tuple[jnp.ndarray, Any]:
    """(B, context) ids -> (B, embed_dim). The EOT token must carry the
    largest id in each row (CLIP BPE convention): pooling is argmax(ids)."""
    dtype = spec.dtype
    x = t["token_embedding"][input_ids].astype(dtype)
    x = x + t["positional_embedding"][: x.shape[1]].astype(dtype)
    x, observed = transformer(x, t["transformer"]["blocks"], spec, remat,
                              calibrate)
    x = layer_norm(x, t["ln_final"]["ln"], dtype)
    eot = jnp.argmax(input_ids, axis=-1)
    x = jnp.take_along_axis(x, eot[:, None, None], axis=1)[:, 0]
    x = jnp.matmul(x, t["text_projection"].astype(dtype), precision=PRECISION)
    return x, ({"transformer": {"blocks": observed}} if calibrate else None)


def unfold_patches(images: jnp.ndarray, patch: int) -> jnp.ndarray:
    """(B, H, W, 3) -> (B, (H/p)*(W/p), p*p*3), patch vectors ordered
    (ph, pw, c) like the converted patch kernels' rows."""
    b, size = images.shape[0], images.shape[1]
    g = size // patch
    return images.reshape(b, g, patch, g, patch, 3).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, g * g, patch * patch * 3)


@dataclasses.dataclass(frozen=True)
class CLIPModel:
    """The CLIP ViT tower pair. ``attention_impl`` names an attention route
    (ops/attention.py); None takes the backend's route."""
    config: CLIPConfig
    dtype: Dtype = jnp.float32
    remat: Union[bool, str] = False
    attention_impl: Optional[str] = None

    def _spec(self, heads: int, causal: bool) -> BlockSpec:
        return BlockSpec(heads=heads, causal=causal,
                         quick_gelu=self.config.quick_gelu, dtype=self.dtype,
                         attention_impl=self.attention_impl)

    def init(self, rng) -> Params:
        cfg = self.config
        v = cfg.vision
        k_patch, k_cls, k_pos, k_blocks, k_proj, k_text = jax.random.split(rng, 6)
        patch_in = v.patch_size * v.patch_size * 3
        visual = {
            "patch_embed": {
                "kernel": jax.nn.initializers.lecun_normal()(
                    k_patch, (patch_in, v.width), jnp.float32),
                "bias": jnp.zeros((v.width,), jnp.float32)},
            "class_embedding": 0.02 * jax.random.normal(k_cls, (v.width,), jnp.float32),
            "positional_embedding": 0.01 * jax.random.normal(
                k_pos, (v.num_patches + 1, v.width), jnp.float32),
            "ln_pre": _ln_init(v.width),
            "transformer": {"blocks": init_blocks(k_blocks, v.layers, v.width)},
            "ln_post": _ln_init(v.width),
            "proj": v.width ** -0.5 * jax.random.normal(
                k_proj, (v.width, cfg.embed_dim), jnp.float32),
        }
        return {"visual": visual,
                "text": init_text_tower(k_text, cfg.text, cfg.embed_dim)}

    def _encode_image(self, params: Params, images: jnp.ndarray,
                      calibrate: bool) -> Tuple[jnp.ndarray, Any]:
        cfg, dtype = self.config.vision, self.dtype
        v = params["visual"]
        b = images.shape[0]
        x = unfold_patches(images.astype(dtype), cfg.patch_size)
        x = dense(x, v["patch_embed"], dtype)
        cls = jnp.broadcast_to(v["class_embedding"].astype(dtype), (b, 1, cfg.width))
        x = jnp.concatenate([cls, x], axis=1)
        x = x + v["positional_embedding"].astype(dtype)
        x = layer_norm(x, v["ln_pre"]["ln"], dtype)
        x, observed = transformer(x, v["transformer"]["blocks"],
                                  self._spec(cfg.heads, causal=False),
                                  self.remat, calibrate)
        x = layer_norm(x[:, 0], v["ln_post"]["ln"], dtype)
        x = jnp.matmul(x, v["proj"].astype(dtype), precision=PRECISION)
        return x, ({"visual": {"transformer": {"blocks": observed}}}
                   if calibrate else None)

    def _encode_text(self, params: Params, input_ids: jnp.ndarray,
                     calibrate: bool) -> Tuple[jnp.ndarray, Any]:
        cfg = self.config.text
        x, observed = encode_text_tower(params["text"], input_ids, cfg,
                                        self._spec(cfg.heads, causal=True),
                                        self.remat, calibrate)
        return x, ({"text": observed} if calibrate else None)

    def encode_image(self, params: Params, images: jnp.ndarray) -> jnp.ndarray:
        """images: (B, H, W, 3) normalized floats, or uint8 pixels when the
        normalization is folded into the patch kernel."""
        return self._encode_image(params, images, calibrate=False)[0]

    def encode_text(self, params: Params, input_ids: jnp.ndarray) -> jnp.ndarray:
        return self._encode_text(params, input_ids, calibrate=False)[0]

    def image_act_amax(self, params: Params, images: jnp.ndarray) -> Params:
        """Calibration observation of an int8 tree: every quantized dense runs
        dynamic quantization and reports its input abs-max."""
        return self._encode_image(params, images, calibrate=True)[1]

    def text_act_amax(self, params: Params, input_ids: jnp.ndarray) -> Params:
        return self._encode_text(params, input_ids, calibrate=True)[1]


def fold_pixel_normalization(params, mean, std, scale_255: bool = True):
    """Fold ((x / 255) - mean) / std into the patch-embedding kernel + bias.

    After folding, `encode_image` takes raw uint8 pixels (cast to the compute
    dtype) instead of normalized floats: W' = W * (1/(255*std_c)) per input
    channel, b' = b - sum_patch W . (mean/std). Equivalent because the patch
    embed is affine in the pixels.
    """
    import numpy as np

    params = jax.tree_util.tree_map(np.asarray, params)
    kernel = params["visual"]["patch_embed"]["kernel"]  # (p*p*3, width)
    bias = params["visual"]["patch_embed"]["bias"]
    mean = np.asarray(mean, dtype=kernel.dtype)
    std = np.asarray(std, dtype=kernel.dtype)
    ppc = kernel.shape[0] // 3  # patch pixels per channel group (ordered ph*pw, 3)
    # kernel rows are ordered (ph, pw, c): channel varies fastest.
    chan = np.tile(np.arange(3), ppc)
    denom = (255.0 if scale_255 else 1.0) * std
    new_kernel = kernel / denom[chan][:, None]
    shift = (mean / std)[chan][:, None]
    new_bias = bias - (kernel * shift).sum(axis=0)
    params["visual"]["patch_embed"]["kernel"] = new_kernel
    params["visual"]["patch_embed"]["bias"] = new_bias
    return params
