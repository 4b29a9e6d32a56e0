"""VideoCLIP (fairseq MMPT's MMFusionSeparate) in Flax.

Reference: aligner/encoder/videoclip.py + videoclip_video_text_encoder.py.
Eval path:
- video: S3DG clip features (32 frames @ 30 fps per clip) -> VideoTokenMLP ->
  a 6-layer BERT over [CLS] v_1..v_n [SEP] with the MMPT position scheme
  (positions 0..n for CLS+videos, then max_video_len+1 for the video [SEP]) ->
  masked mean-pool excluding [CLS] (videoclip.py:633-672).
- text: a 12-layer BERT over [CLS] + caption + [SEP] (the tokenizer prepends
  an extra [SEP] that forward_text drops, videoclip.py:674-713) -> masked
  mean-pool excluding [CLS].

Deviation (documented): the reference wrapper's clip batching is acknowledged
broken for >1 clip (videoclip_video_text_encoder.py:42-45 FIXME); here a video
is split into consecutive non-overlapping 32-frame windows, each becoming one
S3DG clip feature, which is the method described in the VideoCLIP paper.
"""

import dataclasses
from typing import Iterator, Mapping, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.data.frame_sampler import ConsecutiveFrameSampler
from fitclip_tpu.models.api import PreprocessSpec, VideoTextEncoder
from fitclip_tpu.models.s3dg import S3DG
from fitclip_tpu.ops.attention import attention

PRECISION = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2

    @staticmethod
    def tiny_test(vocab_size: int = 100) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                          num_heads=4, intermediate_size=64,
                          max_position_embeddings=64)


class _LayerNorm(nn.Module):
    eps: float = 1e-12

    @nn.compact
    def __call__(self, x):
        dim = x.shape[-1]
        weight = self.param("weight", nn.initializers.ones, (dim,))
        bias = self.param("bias", nn.initializers.zeros, (dim,))
        xf = x.astype(jnp.float32)
        normed = (xf - xf.mean(-1, keepdims=True)) * jax.lax.rsqrt(
            xf.var(-1, keepdims=True) + self.eps)
        return (normed * weight + bias).astype(x.dtype)


class BertLayer(nn.Module):
    """dtype is the matmul compute dtype. fp32 keeps the HF-oracle parity
    path (precision=HIGHEST); bf16 is the throughput configuration.
    Attention logits and softmax stay fp32; LayerNorm always reduces in fp32
    and casts back."""
    config: BertConfig
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, attention_mask):
        cfg = self.config
        head_dim = cfg.hidden_size // cfg.num_heads

        def dense(features, name):
            return nn.Dense(features, name=name, dtype=self.dtype,
                            precision=PRECISION)

        def heads(t):
            return t.reshape(*t.shape[:-1], cfg.num_heads, head_dim)

        q = heads(dense(cfg.hidden_size, "attention_query")(x))
        k = heads(dense(cfg.hidden_size, "attention_key")(x))
        v = heads(dense(cfg.hidden_size, "attention_value")(x))
        attn = attention(q, k, v, key_mask=attention_mask > 0).reshape(*x.shape)
        attn = dense(cfg.hidden_size, "attention_output")(attn)
        x = _LayerNorm(name="attention_layernorm")(x + attn)
        h = dense(cfg.intermediate_size, "intermediate")(x)
        h = nn.gelu(h, approximate=False)
        h = dense(cfg.hidden_size, "output")(h)
        return _LayerNorm(name="output_layernorm")(x + h)


class BertEncoderModel(nn.Module):
    """BERT embeddings + N post-LN layers; inputs_embeds/position_ids are
    explicit so the MMBert video path can interleave its own tokens."""
    config: BertConfig
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, inputs_embeds, position_ids, token_type_ids, attention_mask):
        cfg = self.config
        position = self.param("position_embeddings", nn.initializers.normal(0.02),
                              (cfg.max_position_embeddings, cfg.hidden_size))
        token_type = self.param("token_type_embeddings", nn.initializers.normal(0.02),
                                (cfg.type_vocab_size, cfg.hidden_size))
        x = inputs_embeds + position[position_ids] + token_type[token_type_ids]
        x = _LayerNorm(name="embeddings_layernorm")(x)
        for i in range(cfg.num_layers):
            x = BertLayer(cfg, dtype=self.dtype, name=f"layer_{i}")(x, attention_mask)
        return x


class VideoTokenMLP(nn.Module):
    """Linear -> GELU -> LayerNorm(eps 1e-5) -> Linear (videoclip.py:9-24)."""
    hidden_size: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(self.hidden_size, name="linear1", dtype=self.dtype,
                     precision=PRECISION)(x)
        x = nn.gelu(x, approximate=False)
        x = _LayerNorm(eps=1e-5, name="layernorm")(x)
        return nn.Dense(self.hidden_size, name="linear2", dtype=self.dtype,
                        precision=PRECISION)(x)


class VideoClipModel(nn.Module):
    """MMFusionSeparate: a 6-layer video MMBert + a 12-layer text BERT with
    shared word embeddings per tower (each tower has its own in the released
    checkpoint)."""
    config: BertConfig = BertConfig()
    num_video_layers: int = 6
    max_video_len: int = 32
    video_feature_dim: int = 512
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        cfg = self.config
        self.video_word_embeddings = self.param(
            "video_word_embeddings", nn.initializers.normal(0.02),
            (cfg.vocab_size, cfg.hidden_size))
        self.text_word_embeddings = self.param(
            "text_word_embeddings", nn.initializers.normal(0.02),
            (cfg.vocab_size, cfg.hidden_size))
        self.videomlp = VideoTokenMLP(cfg.hidden_size, dtype=self.dtype)
        self.video_bert = BertEncoderModel(
            dataclasses.replace(cfg, num_layers=self.num_video_layers),
            dtype=self.dtype)
        self.text_bert = BertEncoderModel(cfg, dtype=self.dtype)

    def forward_video(self, vfeats, vmasks, cls_id: int, sep_id: int):
        """vfeats (B, n, feature_dim), vmasks (B, n) -> (B, hidden)."""
        b, n = vfeats.shape[0], vfeats.shape[1]
        video_tokens = self.videomlp(vfeats)
        cls_embed = jnp.broadcast_to(self.video_word_embeddings[cls_id],
                                     (b, 1, self.config.hidden_size))
        sep_embed = jnp.broadcast_to(self.video_word_embeddings[sep_id],
                                     (b, 1, self.config.hidden_size))
        embeds = jnp.concatenate([cls_embed, video_tokens, sep_embed], axis=1)
        positions = jnp.concatenate([jnp.arange(n + 1),
                                     jnp.asarray([self.max_video_len + 1])])
        token_type_ids = jnp.zeros((b, n + 2), jnp.int32)
        attention_mask = jnp.concatenate(
            [jnp.ones((b, 1), jnp.int32), vmasks.astype(jnp.int32),
             jnp.ones((b, 1), jnp.int32)], axis=1)
        hidden = self.video_bert(embeds, positions[None, :], token_type_ids,
                                 attention_mask)
        # Mean-pool over video tokens + [SEP], excluding [CLS].
        pool_mask = jnp.concatenate(
            [jnp.zeros((b, 1), jnp.float32), vmasks.astype(jnp.float32),
             jnp.ones((b, 1), jnp.float32)], axis=1)
        pool_mask = pool_mask / pool_mask.sum(axis=1, keepdims=True)
        return jnp.einsum("bld,bl->bd", hidden.astype(jnp.float32), pool_mask,
                          precision=PRECISION)

    def forward_text(self, input_ids, attention_mask):
        """input_ids framed [CLS] [SEP] caption [SEP] (the extra [SEP] column
        is dropped here, videoclip.py:674-686)."""
        ids = jnp.concatenate([input_ids[:, :1], input_ids[:, 2:]], axis=1)
        mask = jnp.concatenate([attention_mask[:, :1], attention_mask[:, 2:]], axis=1)
        b, length = ids.shape
        embeds = self.text_word_embeddings[ids]
        positions = jnp.arange(length)[None, :]
        token_type_ids = jnp.zeros((b, length), jnp.int32)
        hidden = self.text_bert(embeds, positions, token_type_ids, mask)
        pool_mask = jnp.concatenate(
            [jnp.zeros((b, 1), jnp.float32), mask[:, 1:].astype(jnp.float32)], axis=1)
        pool_mask = pool_mask / pool_mask.sum(axis=1, keepdims=True)
        return jnp.einsum("bld,bl->bd", hidden.astype(jnp.float32), pool_mask,
                          precision=PRECISION)


def _bert_tower_params(sd: Mapping[str, np.ndarray], prefix: str, layers: int) -> dict:
    def ln(p):
        return {"weight": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}

    def lin(p):
        return {"kernel": sd[f"{p}.weight"].T, "bias": sd[f"{p}.bias"]}

    params = {
        "position_embeddings": sd[f"{prefix}.embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd[f"{prefix}.embeddings.token_type_embeddings.weight"],
        "embeddings_layernorm": ln(f"{prefix}.embeddings.LayerNorm"),
    }
    for i in range(layers):
        p = f"{prefix}.encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention_query": lin(f"{p}.attention.self.query"),
            "attention_key": lin(f"{p}.attention.self.key"),
            "attention_value": lin(f"{p}.attention.self.value"),
            "attention_output": lin(f"{p}.attention.output.dense"),
            "attention_layernorm": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": lin(f"{p}.intermediate.dense"),
            "output": lin(f"{p}.output.dense"),
            "output_layernorm": ln(f"{p}.output.LayerNorm"),
        }
    return params


def videoclip_params_from_torch(state_dict: Mapping[str, np.ndarray],
                                config: BertConfig = BertConfig(),
                                num_video_layers: int = 6) -> dict:
    """Released VideoCLIP checkpoint (video_encoder.bert..., videomlp...,
    text_encoder...) -> flax params."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    return {
        "video_word_embeddings":
            sd["video_encoder.bert.embeddings.word_embeddings.weight"],
        "text_word_embeddings": sd["text_encoder.embeddings.word_embeddings.weight"],
        "videomlp": {
            "linear1": {"kernel": sd["video_encoder.videomlp.linear1.weight"].T,
                        "bias": sd["video_encoder.videomlp.linear1.bias"]},
            "layernorm": {"weight": sd["video_encoder.videomlp.LayerNorm.weight"],
                          "bias": sd["video_encoder.videomlp.LayerNorm.bias"]},
            "linear2": {"kernel": sd["video_encoder.videomlp.linear2.weight"].T,
                        "bias": sd["video_encoder.videomlp.linear2.bias"]},
        },
        "video_bert": _bert_tower_params(sd, "video_encoder.bert", num_video_layers),
        "text_bert": _bert_tower_params(sd, "text_encoder", config.num_layers),
    }


class VideoClipVideoTextEncoder(VideoTextEncoder):
    CLS_ID = 101  # bert-base-uncased [CLS]
    SEP_ID = 102  # bert-base-uncased [SEP]

    def __init__(self, config: Optional[BertConfig] = None,
                 num_frames: int = 32, max_tokens: int = 64,
                 frames_per_clip: int = 32,
                 tokenizer=None, vocab_path: Optional[str] = None,
                 dtype=jnp.float32, fast: Optional[bool] = None) -> None:
        self.config = config or BertConfig()
        # dtype runs the S3DG feature extractor AND the MMBert fusion matmuls
        # in that dtype (bf16-vs-fp32 cosine is gated in
        # tests/test_videoclip.py). LayerNorms/softmax/pooling stay fp32.
        # "int8" = W8A8 S3DG matmul-shaped convs (models/s3dg_fast.py) with
        # the fusion in bf16; needs calibrated scales (cli/runners.py).
        self.quantized = str(dtype) == "int8"
        self.dtype = jnp.dtype(jnp.bfloat16 if self.quantized else dtype)
        fusion_dtype = jnp.bfloat16 if self.dtype == jnp.bfloat16 else jnp.float32
        self.model = VideoClipModel(self.config, dtype=fusion_dtype)
        self.s3dg = S3DG(dtype=self.dtype)
        # bf16 defaults to the restructured S3DG eval forward
        # (models/s3dg_fast.py); fp32 keeps the Flax oracle-parity path.
        self.fast = (True if self.quantized else
                     self.dtype == jnp.bfloat16) if fast is None else bool(fast)
        if self.quantized and not self.fast:
            raise ValueError("int8 S3DG requires the fast eval forward")
        self.num_frames = num_frames
        self.frames_per_clip = frames_per_clip
        self._tokenizer = tokenizer
        self._vocab_path = vocab_path
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=224,
            mean=(0.0, 0.0, 0.0),
            std=(1.0, 1.0, 1.0),
            train_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=30),
            eval_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=30),
            resize_mode="bilinear",
            should_pad_batch=False,
            pad_to_min_frames=num_frames,
            max_tokens=max_tokens,
        )

    def init_params(self, rng):
        rng_s, rng_m = jax.random.split(rng)
        cfg = self.config
        s3dg = self.s3dg.init(rng_s, jnp.zeros((1, 16, 32, 32, 3)))["params"]
        model = self.model.init(
            rng_m,
            jnp.zeros((1, 1, 512)), jnp.ones((1, 1), jnp.int32),
            self.CLS_ID, self.SEP_ID,
            method=VideoClipModel.forward_video)["params"]
        # forward_text params initialize lazily on first use with setup();
        # init both passes for a complete tree.
        text = self.model.init(
            rng_m, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
            method=VideoClipModel.forward_text)["params"]
        model.update({k: v for k, v in text.items() if k not in model})
        params = {"s3dg": s3dg, "model": model}
        return self.quantize_params(params) if self.quantized else params

    def encode_video(self, params, video: jnp.ndarray) -> jnp.ndarray:
        """(B, T, H, W, C) raw pixels -> (B, hidden): consecutive
        frames_per_clip windows become S3DG clip features."""
        if video.dtype == jnp.uint8:
            video = video.astype(jnp.float32) / 255.0
        b, t = video.shape[0], video.shape[1]
        n_clips = max(t // self.frames_per_clip, 1)
        usable = n_clips * self.frames_per_clip
        clips = video[:, :usable].reshape(b * n_clips, self.frames_per_clip,
                                          *video.shape[2:])
        if self.fast:
            from fitclip_tpu.models.s3dg_fast import s3dg_fast_apply

            features = s3dg_fast_apply(params["s3dg"], clips, dtype=self.dtype,
                                       int8=self.quantized)
        else:
            features = self.s3dg.apply({"params": params["s3dg"]}, clips)
        features = features.reshape(b, n_clips, -1)
        vmasks = jnp.ones((b, n_clips), jnp.int32)
        return self.model.apply({"params": params["model"]}, features, vmasks,
                                self.CLS_ID, self.SEP_ID,
                                method=VideoClipModel.forward_video)

    def quantize_params(self, params) -> dict:
        from fitclip_tpu.models.s3dg_fast import quantize_s3dg_fast

        # See MilNceVideoTextEncoder.quantize_params / quantize_s3dg_fast.
        return {"s3dg": quantize_s3dg_fast(params["s3dg"], from_block="mixed_4b"),
                "model": params["model"]}

    def collect_act_amax(self, params, video: jnp.ndarray, text=None):
        """One eager calibration observation over the S3DG sites (the MMBert
        fusion stays bf16); mirror of the params tree for apply_act_scales."""
        assert self.quantized, "calibration requires a quantized encoder"
        from fitclip_tpu.models.s3dg_fast import s3dg_fast_apply

        if video.dtype == jnp.uint8:
            video = video.astype(jnp.float32) / 255.0
        b, t = video.shape[0], video.shape[1]
        n_clips = max(t // self.frames_per_clip, 1)
        usable = n_clips * self.frames_per_clip
        clips = video[:, :usable].reshape(b * n_clips, self.frames_per_clip,
                                          *video.shape[2:])
        collect: dict = {}
        s3dg_fast_apply(params["s3dg"], clips, dtype=self.dtype,
                        int8=True, collect=collect)
        return {"s3dg": {"int8": collect}}

    def calibrate(self, params, video: jnp.ndarray, text=None,
                  margin: float = 1.0):
        """Single-batch PTQ calibration; returns the calibrated params tree."""
        from fitclip_tpu.ops.quant import apply_act_scales

        return apply_act_scales(
            params, self.collect_act_amax(params, video, text), margin=margin)

    def encode_text(self, params, text: jnp.ndarray) -> jnp.ndarray:
        attention_mask = (text != 0).astype(jnp.int32)
        return self.model.apply({"params": params["model"]}, text, attention_mask,
                                method=VideoClipModel.forward_text)

    def get_tokenizer(self):
        if self._tokenizer is None:
            from fitclip_tpu.text.wordpiece import WordPieceTokenizer

            inner = WordPieceTokenizer(vocab_path=self._vocab_path,
                                       max_tokens=self.preprocess.max_tokens)
            # VideoCLIP prepends "[SEP] " to every caption
            # (videoclip_video_text_encoder.py:59-61).
            self._tokenizer = lambda texts: inner(texts, prefix_sep=True)["input_ids"]
            self._tokenizer.inner = inner
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.inner.decode(row)


def load_videoclip_encoder(model_pretrained_path: Optional[str] = None,
                           video_encoder_pretrained_path: Optional[str] = None,
                           vocab_path: Optional[str] = None,
                           num_frames: int = 32, max_tokens: int = 64, seed: int = 0,
                           dtype="float32", fast=None):
    """config/encoder/videoclip.yaml factory. ++encoder.dtype=bfloat16 runs
    the S3DG feature tower in bf16 (fp32 stays the oracle-parity default);
    bf16 also defaults to the restructured S3DG eval forward
    (++encoder.fast=false pins the Flax module)."""
    from fitclip_tpu.models.clip.load import LoadedEncoder

    encoder = VideoClipVideoTextEncoder(num_frames=num_frames, max_tokens=max_tokens,
                                        vocab_path=vocab_path, dtype=dtype, fast=fast)
    params = encoder.init_params(jax.random.PRNGKey(seed))
    from fitclip_tpu.convert.torch_state_dict import load_torch_state_dict

    if model_pretrained_path:
        params["model"] = videoclip_params_from_torch(
            load_torch_state_dict(model_pretrained_path))
    if video_encoder_pretrained_path:
        from fitclip_tpu.models.mil_nce import _torch_tree_to_flax

        params["s3dg"] = _torch_tree_to_flax(
            load_torch_state_dict(video_encoder_pretrained_path))
    if encoder.quantized:
        params = encoder.quantize_params(params)
    return LoadedEncoder(encoder=encoder, params=params)
