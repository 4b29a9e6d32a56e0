"""MIL-NCE (S3D-G) video-text encoder: tokenizer, converter, framework wrapper.

Reference: aligner/encoder/mil_nce_video_text_encoder.py. Video tower = S3DG
over 16 consecutive frames resampled to 5 fps, raw [0,1] pixels (no mean/std
normalization), no batch padding; text tower = word-embedding MLP with a
regex word tokenizer over the released s3d_dict.npy vocab (ids start at 1,
pad/truncate to 20).
"""

import re
from typing import Iterator, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.data.frame_sampler import ConsecutiveFrameSampler
from fitclip_tpu.models.api import PreprocessSpec, VideoTextEncoder
from fitclip_tpu.models.s3dg import MilNceTextEncoder, S3DG


class MilNceTokenizer:
    """Lowercase [\\w']+ word tokenizer over a {word: id} vocab, fixed length
    (mil_nce_video_text_encoder.py:97-123)."""

    RE_WORD = re.compile(r"[\w']+")

    def __init__(self, vocab: Mapping[str, int], max_tokens: int = 20,
                 lowercase: bool = True) -> None:
        self.vocab = dict(vocab)
        self.max_tokens = max_tokens
        self.lowercase = lowercase
        self.indices_to_tokens = {i: t for t, i in self.vocab.items()}

    @classmethod
    def from_npy(cls, vocab_path: str, **kwargs) -> "MilNceTokenizer":
        words = np.load(vocab_path)
        return cls({str(word): i + 1 for i, word in enumerate(words)}, **kwargs)

    def encode(self, text: str) -> Sequence[int]:
        if self.lowercase:
            text = text.lower()
        ids = [self.vocab[w] for w in self.RE_WORD.findall(text) if w in self.vocab]
        return ids[: self.max_tokens]

    def decode(self, ids) -> str:
        return " ".join(self.indices_to_tokens[int(i)] for i in ids if int(i) != 0)

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.max_tokens), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)
            out[row, : len(ids)] = ids
        return out


def _torch_tree_to_flax(state_dict: Mapping[str, np.ndarray]) -> dict:
    """Dot-path torch state dict -> nested flax tree with kernel transposes.

    5D conv weights (O,I,kD,kH,kW) -> (kD,kH,kW,I,O); 2D linear weights
    transpose; the word embedding keeps its (vocab, dim) layout; BatchNorm
    weight/bias/running stats keep their torch names (model mirrors them).
    """
    tree: dict = {}
    for key, value in state_dict.items():
        value = np.asarray(value, dtype=np.float32)
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        leaf = parts[-1]
        if parts[:-1] and parts[-2] == "word_embd" and leaf == "weight":
            # Embedding table: place at the parent as a bare param.
            parent = tree
            for part in parts[:-2]:
                parent = parent[part]
            parent["word_embd"] = value
            if not node:
                parent.pop("word_embd.", None)
            continue
        if leaf == "weight" and value.ndim == 5:
            node["kernel"] = value.transpose(2, 3, 4, 1, 0)
        elif leaf == "weight" and value.ndim == 2:
            node["kernel"] = value.T
        else:
            node[leaf] = value
    # Drop any empty dict left for word_embd.
    def prune(d):
        return {k: prune(v) for k, v in d.items() if not (isinstance(v, dict) and not v)} \
            if isinstance(d, dict) else d
    return prune(tree)


def mil_nce_params_from_torch(video_state_dict: Mapping[str, np.ndarray],
                              text_state_dict: Mapping[str, np.ndarray]) -> dict:
    return {"video": _torch_tree_to_flax(video_state_dict),
            "text": _torch_tree_to_flax(text_state_dict)}


class MilNceVideoTextEncoder(VideoTextEncoder):
    def __init__(self, tokenizer: Optional[MilNceTokenizer] = None,
                 vocab_path: Optional[str] = None, max_tokens: int = 20,
                 num_frames: int = 16, dtype=jnp.float32,
                 vocab_size: int = 66250, fast: Optional[bool] = None) -> None:
        # "int8" = W8A8 on the tower's matmul-shaped convs (merged branch
        # stems, b3 convs, conv_2b, FC — models/s3dg_fast.py), bf16 compute
        # elsewhere; requires the fast forward and calibrated activation
        # scales (the generic K-batch path in cli/runners.py).
        self.quantized = str(dtype) == "int8"
        dtype = jnp.dtype(jnp.bfloat16 if self.quantized else dtype)
        self.video_model = S3DG(dtype=dtype)
        self.text_model = MilNceTextEncoder(vocab_size=vocab_size)
        self.num_frames = num_frames
        self.dtype = dtype
        # The restructured eval forward (models/s3dg_fast.py: folded BN,
        # merged branch convs) is the default for the bf16 tower; fp32 keeps
        # the Flax module (oracle-parity path). ++encoder.fast=false pins it.
        self.fast = (True if self.quantized
                     else dtype == jnp.bfloat16) if fast is None else bool(fast)
        if self.quantized and not self.fast:
            raise ValueError("int8 S3DG requires the fast eval forward")
        if tokenizer is None and vocab_path:
            tokenizer = MilNceTokenizer.from_npy(vocab_path, max_tokens=max_tokens)
        self._tokenizer = tokenizer
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=224,
            mean=(0.0, 0.0, 0.0),
            std=(1.0, 1.0, 1.0),
            train_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=5),
            eval_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=5),
            resize_mode="bilinear",
            should_pad_batch=False,
            pad_to_min_frames=num_frames,
            max_tokens=max_tokens,
        )

    def init_params(self, rng):
        rng_v, rng_t = jax.random.split(rng)
        video = self.video_model.init(
            rng_v, jnp.zeros((1, self.num_frames, 32, 32, 3)))["params"]
        text = self.text_model.init(rng_t, jnp.zeros((1, 20), jnp.int32))["params"]
        params = {"video": video, "text": text}
        # Zoo convention (CLIP/FiT): quantized encoders init a float twin
        # and quantize, so random-init tests/benches carry real weights.
        return self.quantize_params(params) if self.quantized else params

    def encode_video(self, params, video: jnp.ndarray) -> jnp.ndarray:
        """(B, T, H, W, C) raw pixels -> (B, 512). No L2 norm (the reference
        scores MIL-NCE embeddings unnormalized)."""
        if video.dtype == jnp.uint8:
            video = video.astype(self.dtype) / 255.0
        if self.fast:
            from fitclip_tpu.models.s3dg_fast import s3dg_fast_apply

            return s3dg_fast_apply(params["video"], video, dtype=self.dtype,
                                   int8=self.quantized)
        return self.video_model.apply({"params": params["video"]}, video)

    def quantize_params(self, params) -> dict:
        from fitclip_tpu.models.s3dg_fast import quantize_s3dg_fast

        # Quantize from mixed_4b on: the 56^2/28^2 stages are bandwidth-bound
        # (see quantize_s3dg_fast).
        return {"video": quantize_s3dg_fast(params["video"],
                                            from_block="mixed_4b"),
                "text": params["text"]}

    def collect_act_amax(self, params, video: jnp.ndarray,
                         text=None):
        """One eager calibration observation: dynamic-quant forward over the
        video tower, per-site activation abs-maxes nested to mirror the
        params tree (merge with ops.quant.merge_act_amax). The text tower is
        unquantized (its word-embedding FC is noise in the FLOP budget)."""
        assert self.quantized, "calibration requires a quantized encoder"
        from fitclip_tpu.models.s3dg_fast import s3dg_fast_apply

        if video.dtype == jnp.uint8:
            video = video.astype(self.dtype) / 255.0
        collect: dict = {}
        s3dg_fast_apply(params["video"], video, dtype=self.dtype,
                        int8=True, collect=collect)
        return {"video": {"int8": collect}}

    def calibrate(self, params, video: jnp.ndarray, text=None,
                  margin: float = 1.0):
        """Single-batch PTQ calibration; returns the calibrated params tree."""
        from fitclip_tpu.ops.quant import apply_act_scales

        return apply_act_scales(
            params, self.collect_act_amax(params, video, text), margin=margin)

    def encode_text(self, params, text: jnp.ndarray) -> jnp.ndarray:
        return self.text_model.apply({"params": params["text"]}, text)

    def get_tokenizer(self):
        if self._tokenizer is None:
            raise ValueError("MIL-NCE needs a vocab (s3d_dict.npy) — pass vocab_path")
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.decode(row)


def load_mil_nce_encoder(vocab_path: Optional[str] = None,
                         pretrained_path: Optional[str] = None,
                         max_tokens: int = 20, num_frames: int = 16, seed: int = 0,
                         dtype="float32", fast=None):
    """config/encoder/mil_nce.yaml factory. ++encoder.dtype=bfloat16 runs the
    S3DG tower in bf16 (fp32 stays the oracle-parity default); bf16 also
    defaults to the restructured eval forward (++encoder.fast=false pins the
    Flax module)."""
    from fitclip_tpu.models.clip.load import LoadedEncoder

    encoder = MilNceVideoTextEncoder(vocab_path=vocab_path, max_tokens=max_tokens,
                                     num_frames=num_frames, dtype=dtype, fast=fast)
    if pretrained_path:
        from fitclip_tpu.convert.torch_state_dict import load_torch_state_dict

        full = load_torch_state_dict(pretrained_path)
        video_sd = {k: v for k, v in full.items() if not k.startswith("text_module.")}
        text_sd = {k[len("text_module."):]: v for k, v in full.items()
                   if k.startswith("text_module.")}
        if not text_sd:  # separate text checkpoint layouts
            text_sd = {k: v for k, v in full.items()
                       if k.split(".")[0] in ("word_embd", "fc1", "fc2")}
            video_sd = {k: v for k, v in full.items() if k not in text_sd}
        params = mil_nce_params_from_torch(video_sd, text_sd)
    else:
        params = encoder.init_params(jax.random.PRNGKey(seed))
    if encoder.quantized:
        params = encoder.quantize_params(params)
    return LoadedEncoder(encoder=encoder, params=params)
