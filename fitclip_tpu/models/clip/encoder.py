"""CLIP video-text encoder: per-frame image encoding with frame-mean pooling.

Reference semantics (aligner/encoder/clip_video_text_encoder.py:68-146):
video = fold frames into the batch, encode each frame, L2-normalize, mean over
frames (mean of normalized embeddings == mean of predictions); text = encode +
L2-normalize; eval preprocessing = bicubic resize + center crop + CLIP
normalization; train = RandomResizedCrop(scale 0.5-1) + horizontal flip;
4 uniform frames by default.
"""

from typing import Callable, Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.data.frame_sampler import (
    RandomFromUniformIntervalsFrameSampler, UniformFrameSampler)
from fitclip_tpu.models.api import PreprocessSpec, VideoTextEncoder
from fitclip_tpu.models.clip.model import CLIPConfig, CLIPModel
from fitclip_tpu.models.clip.tokenizer import ClipTokenizer

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def l2_normalize(x: jnp.ndarray, axis: int = -1, eps: float = 0.0) -> jnp.ndarray:
    norm = jnp.linalg.norm(x.astype(jnp.float32), axis=axis, keepdims=True)
    return (x.astype(jnp.float32) / jnp.maximum(norm, eps if eps else 1e-30)).astype(x.dtype)


class ClipVideoTextEncoder(VideoTextEncoder):
    def __init__(self, config: Optional[CLIPConfig] = None, num_frames: int = 4,
                 dtype=jnp.float32, remat: bool = False,
                 pixel_normalization_folded: bool = False,
                 quantized: bool = False,
                 tokenizer: Optional[ClipTokenizer] = None,
                 bpe_path: Optional[str] = None) -> None:
        self.config = config or CLIPConfig.vit_b_16()
        # quantized = int8 W8A8 block denses (eval-only; ops/quant.py). The
        # params tree must then come from quantize_clip_params.
        self.quantized = quantized
        self.model = CLIPModel(self.config, dtype=dtype, remat=remat)
        # True when fold_pixel_normalization was applied to the params: the
        # uint8 path then only casts (the patch kernel normalizes).
        self.pixel_normalization_folded = pixel_normalization_folded
        self.num_frames = num_frames
        self._tokenizer = tokenizer
        self._bpe_path = bpe_path
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=self.config.vision.image_size,
            mean=CLIP_MEAN,
            std=CLIP_STD,
            train_frame_sampler=RandomFromUniformIntervalsFrameSampler(num_frames),
            eval_frame_sampler=UniformFrameSampler(num_frames),
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

    def encode_video(self, params, video: jnp.ndarray) -> jnp.ndarray:
        """(B, T, H, W, C) -> (B, D): frames fold into the batch so the whole
        clip batch rides one matmul chain, then normalized frame embeddings
        are mean-pooled (clip_video_text_encoder.py:80-89).

        uint8 input is normalized on device ((x/255 - mean)/std) — the host
        pipeline ships raw pixels; XLA fuses the normalization into the patch
        embedding's input. Float input is assumed already normalized."""
        b, t = video.shape[0], video.shape[1]
        embeddings = l2_normalize(self.model.encode_image(
            params, self._prepare_frames(video)))
        return embeddings.reshape(b, t, -1).mean(axis=1)

    def _prepare_frames(self, video: jnp.ndarray) -> jnp.ndarray:
        if video.dtype == jnp.uint8:
            dtype = self.model.dtype
            if self.pixel_normalization_folded:
                video = video.astype(dtype)
            else:
                mean = jnp.asarray(self.preprocess.mean, dtype) * 255.0
                inv_std = 1.0 / (jnp.asarray(self.preprocess.std, dtype) * 255.0)
                video = (video.astype(dtype) - mean) * inv_std
        b, t = video.shape[0], video.shape[1]
        return video.reshape(b * t, *video.shape[2:])

    def collect_act_amax(self, params, video: jnp.ndarray,
                         text: Optional[jnp.ndarray] = None):
        """One calibration observation: run both towers in DYNAMIC-quant mode
        (accurate intermediates) and return the activation abs-max tree.
        Merge several observations with ops.quant.merge_act_amax for
        multi-batch calibration."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        observed = dict(self.model.image_act_amax(params,
                                                  self._prepare_frames(video)))
        if text is not None:
            observed.update(self.model.text_act_amax(params, text))
        return observed

    def calibrate(self, params, video: jnp.ndarray,
                  text: Optional[jnp.ndarray] = None,
                  margin: float = 1.0):
        """Post-training quantization calibration on one batch: collect the
        activation abs-maxes and write them into the act_scale leaves.
        Returns the calibrated params tree."""
        from fitclip_tpu.ops.quant import apply_act_scales

        return apply_act_scales(
            params, self.collect_act_amax(params, video, text), margin=margin)

    def encode_text(self, params, text: jnp.ndarray) -> jnp.ndarray:
        return l2_normalize(self.model.encode_text(params, text))

    def get_tokenizer(self) -> Callable[[Sequence[str]], np.ndarray]:
        if self._tokenizer is None:
            self._tokenizer = ClipTokenizer(
                bpe_path=self._bpe_path,
                context_length=self.config.text.context_length)
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.decode(row[row != 0])
