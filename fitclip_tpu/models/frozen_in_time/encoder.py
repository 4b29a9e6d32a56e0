"""Frozen-in-Time video-text encoder: SpaceTimeTransformer + DistilBERT +
minimal projections, with checkpoint conversion incl. temporal-embed inflation.

Reference: aligner/encoder/frozen_in_time.py + frozen_in_time_video_text_encoder.py.
Video = divided space-time ViT CLS -> Linear(768, 256); text = distilbert CLS
-> ReLU -> Linear(768, 256); both eps-guarded L2-normalized (eps 1e-8).
Preprocessing: ImageNet normalization, 4 uniform frames (random for train),
224 center crop; tokenizer = WordPiece (distilbert-base-uncased vocab),
max_tokens 77.
"""

import dataclasses
from typing import Iterator, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.data.frame_sampler import (
    RandomFromUniformIntervalsFrameSampler, UniformFrameSampler)
from fitclip_tpu.models.api import PreprocessSpec, VideoTextEncoder
from fitclip_tpu.models.frozen_in_time.distilbert import (
    DistilBertConfig, DistilBertModel, distilbert_params_from_torch)
from fitclip_tpu.models.frozen_in_time.video_transformer import SpaceTimeTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

PRECISION = jax.lax.Precision.HIGHEST


def _eps_normalize(x: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    norm = jnp.linalg.norm(x.astype(jnp.float32), axis=1, keepdims=True)
    return (x.astype(jnp.float32) / jnp.maximum(norm, eps)).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class FrozenInTimeConfig:
    projection_dim: int = 256
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    img_size: int = 224
    num_frames: int = 4
    text: DistilBertConfig = DistilBertConfig()

    @staticmethod
    def tiny_test(vocab_size: int = 100) -> "FrozenInTimeConfig":
        return FrozenInTimeConfig(projection_dim=16, embed_dim=48, depth=2,
                                  num_heads=4, patch_size=16, img_size=32,
                                  num_frames=2,
                                  text=DistilBertConfig.tiny_test(vocab_size))


class FrozenInTimeVideoTextEncoder(VideoTextEncoder):
    def __init__(self, config: Optional[FrozenInTimeConfig] = None,
                 num_frames: int = 4, max_tokens: int = 77,
                 tokenizer=None, vocab_path: Optional[str] = None,
                 dtype=jnp.float32) -> None:
        # dtype: fp32 (default) matches the torch oracle to <=1e-4; bf16 is
        # the throughput config; "int8" runs the VIDEO tower's qkv/proj/mlp
        # denses as W8A8 (bf16 activations, calibrated static activation
        # scales — ops/quant.py, same scheme as the CLIP/SLIP int8 paths; the
        # DistilBERT text tower stays bf16). Both towers' LayerNorms and
        # softmaxes stay fp32 regardless. The divided space/time attention
        # runs its einsum formulation (video_transformer.VarAttention).
        self.config = config or FrozenInTimeConfig()
        cfg = self.config
        self.quantized = str(dtype) == "int8"
        if self.quantized:
            dtype = jnp.bfloat16
        elif isinstance(dtype, str):
            from fitclip_tpu.models.clip.load import _DTYPES

            if dtype not in _DTYPES:
                raise ValueError(f"Unknown encoder dtype {dtype!r} — expected "
                                 f"one of {sorted(_DTYPES)} or 'int8'")
            dtype = _DTYPES[dtype]
        self.dtype = dtype
        self.video_model = SpaceTimeTransformer(
            embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
            patch_size=cfg.patch_size, img_size=cfg.img_size,
            num_frames=cfg.num_frames, dtype=self.dtype,
            quantized=self.quantized)
        self.text_model = DistilBertModel(cfg.text, dtype=self.dtype)
        self._tokenizer = tokenizer
        self._vocab_path = vocab_path
        self.num_frames = num_frames
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=cfg.img_size,
            mean=IMAGENET_MEAN,
            std=IMAGENET_STD,
            train_frame_sampler=RandomFromUniformIntervalsFrameSampler(num_frames),
            eval_frame_sampler=UniformFrameSampler(num_frames),
            max_tokens=max_tokens,
        )

    def init_params(self, rng):
        cfg = self.config
        rng_v, rng_t, rng_p = jax.random.split(rng, 3)
        if self.quantized:
            # Init a float twin and quantize so random-init tests carry real
            # (nonzero) weights in the int8 structure.
            float_model = SpaceTimeTransformer(
                embed_dim=cfg.embed_dim, depth=cfg.depth,
                num_heads=cfg.num_heads, patch_size=cfg.patch_size,
                img_size=cfg.img_size, num_frames=cfg.num_frames,
                dtype=self.dtype)
            video = quantize_fit_video_params(float_model.init(
                rng_v, jnp.zeros((1, cfg.num_frames, cfg.img_size,
                                  cfg.img_size, 3)))["params"])
        else:
            video = self.video_model.init(
                rng_v, jnp.zeros((1, cfg.num_frames, cfg.img_size, cfg.img_size, 3)))["params"]
        text = self.text_model.init(rng_t, jnp.zeros((1, 8), jnp.int32),
                                    jnp.ones((1, 8), jnp.int32))["params"]
        k1, k2 = jax.random.split(rng_p)
        return {
            "video": video,
            "text": text,
            "vid_proj": {"kernel": jax.random.normal(k1, (cfg.embed_dim, cfg.projection_dim)) * 0.02,
                         "bias": jnp.zeros((cfg.projection_dim,))},
            "txt_proj": {"kernel": jax.random.normal(k2, (cfg.text.dim, cfg.projection_dim)) * 0.02,
                         "bias": jnp.zeros((cfg.projection_dim,))},
        }

    def _prepare_video(self, video: jnp.ndarray) -> jnp.ndarray:
        if video.dtype == jnp.uint8:
            mean = jnp.asarray(self.preprocess.mean, jnp.float32) * 255.0
            inv_std = 1.0 / (jnp.asarray(self.preprocess.std, jnp.float32) * 255.0)
            video = (video.astype(jnp.float32) - mean) * inv_std
        return video

    def collect_act_amax(self, params, video: jnp.ndarray, text=None):
        """One int8-calibration observation: the video tower in DYNAMIC-quant
        mode (per-row scales), returning the sown activation abs-max tree
        keyed like the params tree (consumed by the CLI runners' multi-batch
        calibration + ops.quant.apply_act_scales). The text tower is not
        quantized — `text` is ignored."""
        assert self.quantized, "calibration requires a quantized encoder"
        cfg = self.config
        dynamic_model = SpaceTimeTransformer(
            embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
            patch_size=cfg.patch_size, img_size=cfg.img_size,
            num_frames=cfg.num_frames, dtype=self.dtype, quantized="dynamic")
        _, state = dynamic_model.apply({"params": params["video"]},
                                       self._prepare_video(video),
                                       mutable=["intermediates"])
        return {"video": dict(state["intermediates"])}

    def calibrate(self, params, video: jnp.ndarray, text=None,
                  margin: float = 1.0):
        """Single-batch PTQ calibration; returns the calibrated params tree."""
        from fitclip_tpu.ops.quant import apply_act_scales

        return apply_act_scales(
            params, self.collect_act_amax(params, video, text), margin=margin)

    def encode_video(self, params, video: jnp.ndarray) -> jnp.ndarray:
        features = self.video_model.apply({"params": params["video"]},
                                          self._prepare_video(video))
        projected = jnp.matmul(features, params["vid_proj"]["kernel"],
                               precision=PRECISION) + params["vid_proj"]["bias"]
        return _eps_normalize(projected)

    def encode_text(self, params, text: jnp.ndarray) -> jnp.ndarray:
        """text: (B, L) ids; the attention mask is ids != 0 ([PAD])."""
        attention_mask = (text != 0).astype(jnp.int32)
        hidden = self.text_model.apply({"params": params["text"]}, text, attention_mask)
        cls = hidden[:, 0]
        projected = jnp.matmul(jax.nn.relu(cls), params["txt_proj"]["kernel"],
                               precision=PRECISION) + params["txt_proj"]["bias"]
        return _eps_normalize(projected)

    def get_tokenizer(self):
        if self._tokenizer is None:
            from fitclip_tpu.text.wordpiece import WordPieceTokenizer

            inner = WordPieceTokenizer(vocab_path=self._vocab_path,
                                       max_tokens=self.preprocess.max_tokens)
            self._tokenizer = lambda texts: inner(texts)["input_ids"]
            self._tokenizer.inner = inner
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.inner.decode(row)


def quantize_fit_video_params(video_params):
    """Float SpaceTimeTransformer tree -> int8-dense tree (qkv/proj/mlp_fc1/
    mlp_fc2 nodes become {kernel_q, scale, bias, act_scale}); everything else
    (patch embed, embeddings, LNs) keeps its float leaves."""
    from fitclip_tpu.ops.quant import FIT_DENSE_NAMES, quantize_clip_params

    return quantize_clip_params(video_params, names=FIT_DENSE_NAMES)


def inflate_temporal_embed(temporal_embed: np.ndarray, target_frames: int,
                           mode: str = "zeros") -> np.ndarray:
    """Frame-count mismatch handling for loaded checkpoints
    (frozen_in_time.py:144-186): pad new frames with zeros or interpolate."""
    current = temporal_embed.shape[0]
    if current == target_frames:
        return temporal_embed
    if current > target_frames:
        return temporal_embed[:target_frames]
    if mode == "zeros":
        pad = np.zeros((target_frames - current, temporal_embed.shape[1]),
                       temporal_embed.dtype)
        return np.concatenate([temporal_embed, pad])
    if mode == "interp":
        positions = np.linspace(0, current - 1, target_frames)
        lo = np.floor(positions).astype(int)
        hi = np.minimum(lo + 1, current - 1)
        frac = (positions - lo)[:, None]
        return temporal_embed[lo] * (1 - frac) + temporal_embed[hi] * frac
    raise ValueError(f"Unknown inflation mode: {mode}")


def frozen_in_time_params_from_torch(state_dict: Mapping[str, np.ndarray],
                                     config: FrozenInTimeConfig,
                                     temporal_inflation: str = "zeros") -> dict:
    """FrozenInTime checkpoint (video_model.*, text_model.*, vid_proj.0.*,
    txt_proj.1.*) -> flax params."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}

    def ln(prefix):
        return {"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    conv = sd["video_model.patch_embed.proj.weight"]  # (D, 3, p, p)
    video = {
        "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]),
                        "bias": sd["video_model.patch_embed.proj.bias"]},
        "cls_token": sd["video_model.cls_token"].reshape(-1),
        "pos_embed": sd["video_model.pos_embed"].reshape(-1, config.embed_dim),
        "temporal_embed": inflate_temporal_embed(
            sd["video_model.temporal_embed"].reshape(-1, config.embed_dim),
            config.num_frames, temporal_inflation),
        "norm": ln("video_model.norm"),
    }
    for i in range(config.depth):
        p = f"video_model.blocks.{i}"
        video[f"blocks_{i}"] = {
            "norm1": ln(f"{p}.norm1"),
            "norm2": ln(f"{p}.norm2"),
            "norm3": ln(f"{p}.norm3"),
            "attn": {"qkv": {"kernel": sd[f"{p}.attn.qkv.weight"].T,
                             "bias": sd[f"{p}.attn.qkv.bias"]},
                     "proj": {"kernel": sd[f"{p}.attn.proj.weight"].T,
                              "bias": sd[f"{p}.attn.proj.bias"]}},
            "timeattn": {"qkv": {"kernel": sd[f"{p}.timeattn.qkv.weight"].T,
                                 "bias": sd[f"{p}.timeattn.qkv.bias"]},
                         "proj": {"kernel": sd[f"{p}.timeattn.proj.weight"].T,
                                  "bias": sd[f"{p}.timeattn.proj.bias"]}},
            "mlp_fc1": {"kernel": sd[f"{p}.mlp.fc1.weight"].T,
                        "bias": sd[f"{p}.mlp.fc1.bias"]},
            "mlp_fc2": {"kernel": sd[f"{p}.mlp.fc2.weight"].T,
                        "bias": sd[f"{p}.mlp.fc2.bias"]},
        }

    text_sd = {k[len("text_model."):]: v for k, v in sd.items()
               if k.startswith("text_model.")}
    return {
        "video": video,
        "text": distilbert_params_from_torch(text_sd, config.text),
        "vid_proj": {"kernel": sd["vid_proj.0.weight"].T, "bias": sd["vid_proj.0.bias"]},
        "txt_proj": {"kernel": sd["txt_proj.1.weight"].T, "bias": sd["txt_proj.1.bias"]},
    }


def load_frozen_in_time_encoder(checkpoint_path: Optional[str] = None,
                                num_frames: int = 4, max_tokens: int = 77,
                                vocab_path: Optional[str] = None,
                                temporal_inflation: str = "zeros", seed: int = 0,
                                dtype: str = "float32"):
    """config/encoder/frozen_in_time* factory. ++encoder.dtype=bfloat16
    selects the throughput configuration (see FrozenInTimeVideoTextEncoder)
    and ++encoder.dtype=int8 the W8A8 video-tower path (the CLI runners
    calibrate activation scales on the first eval batches, cli/runners.py)."""
    from fitclip_tpu.models.clip.load import LoadedEncoder

    config = FrozenInTimeConfig(num_frames=num_frames)
    encoder = FrozenInTimeVideoTextEncoder(config, num_frames=num_frames,
                                           max_tokens=max_tokens,
                                           vocab_path=vocab_path, dtype=dtype)
    if checkpoint_path:
        from fitclip_tpu.convert.torch_state_dict import load_torch_state_dict

        state_dict = load_torch_state_dict(checkpoint_path)
        # DataParallel prefix fix (frozen_in_time.py:22-32).
        state_dict = {k.replace("module.", "", 1) if k.startswith("module.") else k: v
                      for k, v in state_dict.items()}
        params = frozen_in_time_params_from_torch(state_dict, config,
                                                  temporal_inflation)
        if encoder.quantized:
            params = dict(params,
                          video=quantize_fit_video_params(params["video"]))
    else:
        params = encoder.init_params(jax.random.PRNGKey(seed))
    return LoadedEncoder(encoder=encoder, params=params)
