"""SLIP encoder family (facebookresearch/SLIP's CLIP/SLIP variants) in plain JAX.

Reference: the vendored slip.py (aligner/encoder/slip.py:399-544,566-637) and
its wrapper (slip_video_text_encoder.py). Architecture = timm-style ViT vision
tower (patch conv with bias, cls token, pos embed including cls, LN eps 1e-6,
exact GELU, final norm, CLS pooling) + a CLIP-style causal text transformer
(QuickGELU, LN eps 1e-5) + separate image/text projection matrices. The SSL
(SimCLR) heads of SLIP checkpoints are dropped: they don't participate in
encode_image/encode_text. Both towers run the CLIP model's transformer
(models/clip/model.py) over the same block layout.

Tokenizer: SLIP's SimpleTokenizer is the same byte-BPE as CLIP's — reuse
ClipTokenizer. Preprocessing: imagenet normalization, bilinear resize, 224
center crop, eval only (the reference raises on train transforms).
"""

import dataclasses
from typing import Any, Iterator, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.data.frame_sampler import UniformFrameSampler
from fitclip_tpu.models.api import PreprocessSpec, VideoTextEncoder
from fitclip_tpu.models.clip.encoder import l2_normalize
from fitclip_tpu.models.clip.model import (PRECISION, BlockSpec, TextConfig,
                                           _ln_init, dense, encode_text_tower,
                                           init_blocks, init_text_tower,
                                           layer_norm, transformer,
                                           unfold_patches)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SlipConfig:
    embed_dim: int = 512
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    text: TextConfig = TextConfig()

    @staticmethod
    def vit_s16() -> "SlipConfig":
        return SlipConfig(vision_width=384, vision_heads=12)

    @staticmethod
    def vit_b16() -> "SlipConfig":
        return SlipConfig()

    @staticmethod
    def vit_l16() -> "SlipConfig":
        return SlipConfig(vision_width=1024, vision_layers=24, vision_heads=16)

    @staticmethod
    def tiny_test(vocab_size: int = 64) -> "SlipConfig":
        return SlipConfig(embed_dim=32, vision_width=48, vision_layers=2,
                          vision_heads=4, image_size=32, patch_size=16,
                          text=TextConfig(context_length=16, vocab_size=vocab_size,
                                          width=32, layers=2, heads=4))


@dataclasses.dataclass(frozen=True)
class SlipModel:
    """SLIP's tower pair over a nested-dict param tree (the layout
    ``slip_params_from_torch`` writes)."""
    config: SlipConfig
    dtype: Any = jnp.float32

    def init(self, rng):
        cfg = self.config
        k_patch, k_pos, k_blocks, k_text, k_img = jax.random.split(rng, 5)
        patch_in = cfg.patch_size * cfg.patch_size * 3
        grid = cfg.image_size // cfg.patch_size
        text = init_text_tower(k_text, cfg.text, cfg.embed_dim)
        visual = {
            "patch_embed": {
                "kernel": jax.nn.initializers.lecun_normal()(
                    k_patch, (patch_in, cfg.vision_width), jnp.float32),
                "bias": jnp.zeros((cfg.vision_width,), jnp.float32)},
            "cls_token": jnp.zeros((cfg.vision_width,), jnp.float32),
            "pos_embed": 0.02 * jax.random.normal(
                k_pos, (grid * grid + 1, cfg.vision_width), jnp.float32),
            "blocks": {"blocks": init_blocks(k_blocks, cfg.vision_layers,
                                             cfg.vision_width)},
            "norm": _ln_init(cfg.vision_width),
        }
        return {"visual": visual, **text,
                "image_projection": cfg.vision_width ** -0.5 * jax.random.normal(
                    k_img, (cfg.vision_width, cfg.embed_dim), jnp.float32)}

    def _encode_image(self, params, images, calibrate: bool):
        cfg, dtype = self.config, self.dtype
        v = params["visual"]
        b = images.shape[0]
        x = dense(unfold_patches(images.astype(dtype), cfg.patch_size),
                  v["patch_embed"], dtype)
        cls = jnp.broadcast_to(v["cls_token"].astype(dtype), (b, 1, cfg.vision_width))
        x = jnp.concatenate([cls, x], axis=1) + v["pos_embed"].astype(dtype)
        spec = BlockSpec(heads=cfg.vision_heads, causal=False, quick_gelu=False,
                         dtype=dtype, ln_eps=1e-6)
        x, observed = transformer(x, v["blocks"]["blocks"], spec,
                                  calibrate=calibrate)
        x = layer_norm(x, v["norm"]["ln"], dtype, 1e-6)[:, 0]
        x = jnp.matmul(x, params["image_projection"].astype(dtype),
                       precision=PRECISION)
        return x, ({"visual": {"blocks": {"blocks": observed}}}
                   if calibrate else None)

    def _encode_text(self, params, input_ids, calibrate: bool):
        cfg = self.config.text
        spec = BlockSpec(heads=cfg.heads, causal=True, quick_gelu=True,
                         dtype=self.dtype)
        return encode_text_tower(params, input_ids, cfg, spec,
                                 calibrate=calibrate)

    def encode_image(self, params, images: jnp.ndarray) -> jnp.ndarray:
        return self._encode_image(params, images, calibrate=False)[0]

    def encode_text(self, params, input_ids: jnp.ndarray) -> jnp.ndarray:
        return self._encode_text(params, input_ids, calibrate=False)[0]

    def image_act_amax(self, params, images: jnp.ndarray):
        return self._encode_image(params, images, calibrate=True)[1]

    def text_act_amax(self, params, input_ids: jnp.ndarray):
        return self._encode_text(params, input_ids, calibrate=True)[1]


def _stack(arrays):
    return np.stack(arrays, axis=0)


def _timm_blocks_to_flax(sd: Mapping[str, np.ndarray], prefix: str, layers: int) -> dict:
    def pick(fmt):
        return [np.asarray(sd[fmt.format(prefix=prefix, i=i)]) for i in range(layers)]

    return {
        "attn": {
            "in_proj": {"kernel": _stack([w.T for w in pick("{prefix}.{i}.attn.qkv.weight")]),
                        "bias": _stack(pick("{prefix}.{i}.attn.qkv.bias"))},
            "out_proj": {"kernel": _stack([w.T for w in pick("{prefix}.{i}.attn.proj.weight")]),
                         "bias": _stack(pick("{prefix}.{i}.attn.proj.bias"))},
        },
        "ln_1": {"ln": {"scale": _stack(pick("{prefix}.{i}.norm1.weight")),
                        "bias": _stack(pick("{prefix}.{i}.norm1.bias"))}},
        "ln_2": {"ln": {"scale": _stack(pick("{prefix}.{i}.norm2.weight")),
                        "bias": _stack(pick("{prefix}.{i}.norm2.bias"))}},
        "mlp_fc": {"kernel": _stack([w.T for w in pick("{prefix}.{i}.mlp.fc1.weight")]),
                   "bias": _stack(pick("{prefix}.{i}.mlp.fc1.bias"))},
        "mlp_proj": {"kernel": _stack([w.T for w in pick("{prefix}.{i}.mlp.fc2.weight")]),
                     "bias": _stack(pick("{prefix}.{i}.mlp.fc2.bias"))},
    }


def slip_params_from_torch(state_dict: Mapping[str, np.ndarray],
                           config: SlipConfig) -> dict:
    """SLIP checkpoint state dict (module. prefix already stripped) -> params."""
    from fitclip_tpu.convert.torch_state_dict import _openai_tower_blocks, _patch_kernel

    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    visual = {
        "patch_embed": {"kernel": _patch_kernel(sd["visual.patch_embed.proj.weight"]),
                        "bias": sd["visual.patch_embed.proj.bias"]},
        "cls_token": sd["visual.cls_token"].reshape(-1),
        "pos_embed": sd["visual.pos_embed"].reshape(-1, config.vision_width),
        "blocks": {"blocks": _timm_blocks_to_flax(sd, "visual.blocks",
                                                  config.vision_layers)},
        "norm": {"ln": {"scale": sd["visual.norm.weight"],
                        "bias": sd["visual.norm.bias"]}},
    }
    return {
        "visual": visual,
        "transformer": {"blocks": _openai_tower_blocks(sd, "transformer",
                                                       config.text.layers)},
        "ln_final": {"ln": {"scale": sd["ln_final.weight"],
                            "bias": sd["ln_final.bias"]}},
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "image_projection": sd["image_projection"],
        "text_projection": sd["text_projection"],
    }


_SLIP_MODEL_CONFIGS = {
    "VITS16": SlipConfig.vit_s16,
    "VITB16": SlipConfig.vit_b16,
    "VITL16": SlipConfig.vit_l16,
}


class SlipVideoTextEncoder(VideoTextEncoder):
    """Eval-only wrapper: frame-mean of L2-normalized per-frame embeddings
    (slip_video_text_encoder.py:25-99; the reference's train sampler/transform
    raise, slip_video_text_encoder.py:66-75)."""

    trainable = False

    def __init__(self, config: Optional[SlipConfig] = None, num_frames: int = 4,
                 dtype=jnp.float32, quantized: bool = False,
                 tokenizer=None, bpe_path: Optional[str] = None) -> None:
        self.config = config or SlipConfig.vit_b16()
        # quantized = int8 W8A8 block denses (ops/quant.py; params from
        # quantize_clip_params — it walks the SLIP tree too).
        self.quantized = quantized
        self.model = SlipModel(self.config, dtype=dtype)
        self.num_frames = num_frames
        self._tokenizer = tokenizer
        self._bpe_path = bpe_path
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=self.config.image_size,
            mean=IMAGENET_MEAN,
            std=IMAGENET_STD,
            train_frame_sampler=_raise_train_sampler,
            eval_frame_sampler=UniformFrameSampler(num_frames),
            resize_mode="bilinear",
            max_tokens=self.config.text.context_length,
        )

    def init_params(self, rng):
        params = self.model.init(rng)
        if self.quantized:
            # Quantize the float init so random-init runs carry real
            # (nonzero) weights in the int8 structure.
            from fitclip_tpu.ops.quant import quantize_clip_params

            return quantize_clip_params(params)
        return params

    def _prepare_frames(self, video: jnp.ndarray) -> jnp.ndarray:
        if video.dtype == jnp.uint8:
            dtype = self.model.dtype
            mean = jnp.asarray(self.preprocess.mean, dtype) * 255.0
            inv_std = 1.0 / (jnp.asarray(self.preprocess.std, dtype) * 255.0)
            video = (video.astype(dtype) - mean) * inv_std
        b, t = video.shape[0], video.shape[1]
        return video.reshape(b * t, *video.shape[2:])

    def encode_video(self, params, video: jnp.ndarray) -> jnp.ndarray:
        b, t = video.shape[0], video.shape[1]
        emb = l2_normalize(self.model.encode_image(params,
                                                   self._prepare_frames(video)))
        return emb.reshape(b, t, -1).mean(axis=1)

    def encode_text(self, params, text: jnp.ndarray) -> jnp.ndarray:
        return l2_normalize(self.model.encode_text(params, text))

    def collect_act_amax(self, params, video: jnp.ndarray,
                         text: Optional[jnp.ndarray] = None):
        """One calibration observation: both towers in DYNAMIC-quant mode,
        returning the activation abs-max tree (same protocol as
        ClipVideoTextEncoder, consumed by the CLI runners' multi-batch
        calibration)."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        observed = dict(self.model.image_act_amax(params,
                                                  self._prepare_frames(video)))
        if text is not None:
            observed.update(self.model.text_act_amax(params, text))
        return observed

    def calibrate(self, params, video: jnp.ndarray,
                  text: Optional[jnp.ndarray] = None, margin: float = 1.0):
        """Single-batch PTQ calibration; returns the calibrated params tree."""
        from fitclip_tpu.ops.quant import apply_act_scales

        return apply_act_scales(
            params, self.collect_act_amax(params, video, text), margin=margin)

    def get_tokenizer(self):
        if self._tokenizer is None:
            from fitclip_tpu.models.clip.tokenizer import ClipTokenizer

            self._tokenizer = ClipTokenizer(
                bpe_path=self._bpe_path,
                context_length=self.config.text.context_length)
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.decode(row[row != 0])


def _raise_train_sampler(*args, **kwargs):
    raise NotImplementedError("SLIP encoders are evaluation-only (reference "
                              "slip_video_text_encoder.py:66-75)")


def load_slip_encoder(checkpoint_path: Optional[str] = None,
                      model: str = "SLIP_VITB16", num_frames: int = 4,
                      dtype: str = "float32",
                      bpe_path: Optional[str] = None,
                      seed: int = 0):
    """config/encoder/slip_* factory. The released checkpoints carry their
    factory name in args.model (slip_video_text_encoder.py:17-22).

    encoder.dtype=int8 selects the W8A8 inference path (bf16 activations,
    int8 block denses), same semantics as on the CLIP loader."""
    from fitclip_tpu.models.clip.load import LoadedEncoder, _DTYPES

    state_dict = None
    if checkpoint_path:
        import torch

        checkpoint = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        if "args" in checkpoint:
            model = checkpoint["args"].model
        raw = checkpoint.get("state_dict", checkpoint)
        state_dict = {k.replace("module.", ""): v.float().numpy()
                      for k, v in raw.items()}
    variant = model.split("_")[-1]
    config = _SLIP_MODEL_CONFIGS[variant]()
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    compute_dtype = _DTYPES["bfloat16" if quantized else str(dtype)]
    encoder = SlipVideoTextEncoder(config, num_frames=num_frames,
                                   dtype=compute_dtype, quantized=quantized,
                                   bpe_path=bpe_path)
    if state_dict is not None:
        params = slip_params_from_torch(state_dict, config)
        if quantized:
            from fitclip_tpu.ops.quant import quantize_clip_params

            params = quantize_clip_params(params)
    else:
        params = encoder.init_params(jax.random.PRNGKey(seed))
    return LoadedEncoder(encoder=encoder, params=params)
