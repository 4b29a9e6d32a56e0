"""ResNet-CLIP assembly: ModifiedResNet vision tower + CLIP text transformer.

Covers the named OpenAI weights RN50 / RN101 / RN50x4 / RN50x16 / RN50x64
(reference config/encoder/clip_rn*.yaml slots). Evaluation runs frozen-stat
BatchNorm (the released-checkpoint inference form); training runs live
batch-stats BN with EMA running-stat updates threaded through the train step
(see ResNetClipVideoTextEncoder.encode_video_train).
"""

import dataclasses
from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
from fitclip_tpu.models.clip.model import (BlockSpec, TextConfig,
                                           encode_text_tower, init_text_tower)
from fitclip_tpu.models.clip.resnet import (ModifiedResNet, ModifiedResNetConfig,
                                            resnet_params_from_torch)


@dataclasses.dataclass(frozen=True)
class ResNetCLIPConfig:
    embed_dim: int
    vision: ModifiedResNetConfig
    text: TextConfig

    @property
    def quick_gelu(self) -> bool:
        return True


RESNET_PRESETS = {
    "RN50": ResNetCLIPConfig(
        embed_dim=1024,
        vision=ModifiedResNetConfig((3, 4, 6, 3), width=64, output_dim=1024,
                                    input_resolution=224, heads=32),
        text=TextConfig(width=512, heads=8, layers=12)),
    "RN101": ResNetCLIPConfig(
        embed_dim=512,
        vision=ModifiedResNetConfig((3, 4, 23, 3), width=64, output_dim=512,
                                    input_resolution=224, heads=32),
        text=TextConfig(width=512, heads=8, layers=12)),
    "RN50x4": ResNetCLIPConfig(
        embed_dim=640,
        vision=ModifiedResNetConfig((4, 6, 10, 6), width=80, output_dim=640,
                                    input_resolution=288, heads=40),
        text=TextConfig(width=640, heads=10, layers=12)),
    "RN50x16": ResNetCLIPConfig(
        embed_dim=768,
        vision=ModifiedResNetConfig((6, 8, 18, 8), width=96, output_dim=768,
                                    input_resolution=384, heads=48),
        text=TextConfig(width=768, heads=12, layers=12)),
    "RN50x64": ResNetCLIPConfig(
        embed_dim=1024,
        vision=ModifiedResNetConfig((3, 15, 36, 10), width=128, output_dim=1024,
                                    input_resolution=448, heads=64),
        text=TextConfig(width=1024, heads=16, layers=12)),
}


class ResNetCLIPModel(nn.Module):
    """The ModifiedResNet vision tower (a flax module, because of its
    BatchNorm state). The text tower is the plain CLIP text transformer
    (models/clip/model.py), kept under params["text"]."""
    config: ResNetCLIPConfig
    dtype: object = jnp.float32
    train_bn: bool = False

    def setup(self):
        # dtype is the compute dtype for BOTH towers (params stay fp32):
        # bf16 is the throughput configuration (++encoder.dtype=bfloat16);
        # fp32 stays the oracle-parity default. BN statistics math is fp32
        # either way.
        self.visual = ModifiedResNet(self.config.vision, train=self.train_bn,
                                     dtype=self.dtype)

    def __call__(self, images):
        return self.visual(images.astype(self.dtype))


class ResNetClipVideoTextEncoder(ClipVideoTextEncoder):
    """Same preprocessing/pooling contract as the ViT CLIP encoder (frame-mean
    of L2-normalized per-frame embeddings) over the ResNet tower.

    Trainable: evaluation uses folded (frozen) running statistics — the
    inference form of the released checkpoints — while the training path runs
    live batch-stats BatchNorm (torch.train() semantics). The EMA running-stat
    updates come back through ``encode_video_train`` (flax mutable
    "bn_stats" collection) and the train step merges them into the parameter
    tree with ``apply_bn_updates`` after the optimizer update; the running
    stats themselves are optimizer-frozen via ``bn_freeze_patterns``."""

    trainable = True
    # Running statistics update via EMA, not gradient descent: the train
    # runner appends these to the optimizer freeze regexes automatically.
    bn_freeze_patterns = (r"running_(mean|var)$",)

    def __init__(self, config: ResNetCLIPConfig, num_frames: int = 4,
                 dtype=jnp.float32, tokenizer=None,
                 bpe_path: Optional[str] = None) -> None:
        # Intentionally NOT calling super().__init__: the model and image size
        # come from the ResNet config.
        self.config = config
        self.model = ResNetCLIPModel(config, dtype=dtype)
        self.train_model = ResNetCLIPModel(config, dtype=dtype, train_bn=True)
        self.num_frames = num_frames
        self._tokenizer = tokenizer
        self._bpe_path = bpe_path
        from fitclip_tpu.data.frame_sampler import (
            RandomFromUniformIntervalsFrameSampler, UniformFrameSampler)
        from fitclip_tpu.models.api import PreprocessSpec
        from fitclip_tpu.models.clip.encoder import CLIP_MEAN, CLIP_STD

        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=config.vision.input_resolution,
            mean=CLIP_MEAN,
            std=CLIP_STD,
            train_frame_sampler=RandomFromUniformIntervalsFrameSampler(num_frames),
            eval_frame_sampler=UniformFrameSampler(num_frames),
            max_tokens=config.text.context_length,
        )

    def init_params(self, rng):
        size = self.config.vision.input_resolution
        rng_visual, rng_text = jax.random.split(rng)
        params = self.model.init(rng_visual, jnp.zeros((1, size, size, 3)))["params"]
        return {**params, "text": init_text_tower(rng_text, self.config.text,
                                                  self.config.embed_dim)}

    def _visual_params(self, params):
        return {"params": {"visual": params["visual"]}}

    def _frames(self, video):
        if video.dtype == jnp.uint8:
            mean = jnp.asarray(self.preprocess.mean, jnp.float32) * 255.0
            inv_std = 1.0 / (jnp.asarray(self.preprocess.std, jnp.float32) * 255.0)
            video = (video.astype(jnp.float32) - mean) * inv_std
        b, t = video.shape[0], video.shape[1]
        return video.reshape(b * t, *video.shape[2:]), b, t

    def encode_video(self, params, video):
        from fitclip_tpu.models.clip.encoder import l2_normalize

        frames, b, t = self._frames(video)
        emb = l2_normalize(self.model.apply(self._visual_params(params), frames))
        return emb.reshape(b, t, -1).mean(axis=1)

    def encode_video_train(self, params, video):
        """Train-mode video encode: live batch-stats BN. Returns
        (clip_embeddings, bn_stats_updates); pass the updates (possibly from
        inside a grad — they carry stop_gradient) to ``apply_bn_updates``."""
        from fitclip_tpu.models.clip.encoder import l2_normalize

        frames, b, t = self._frames(video)
        emb, mutated = self.train_model.apply(
            self._visual_params(params), frames, mutable=["bn_stats"])
        emb = l2_normalize(emb)
        return emb.reshape(b, t, -1).mean(axis=1), mutated["bn_stats"]

    @staticmethod
    def apply_bn_updates(params, bn_updates):
        """Merge sown EMA running stats back into the parameter tree. The
        bn_stats tree mirrors the module nesting with {"mean": (arr,),
        "var": (arr,)} leaves at each BatchNorm node."""
        if bn_updates is None:
            return params

        def merge(p_node, u_node):
            out = dict(p_node)
            for key, update in u_node.items():
                if key == "mean":
                    out["running_mean"] = update[0]
                elif key == "var":
                    out["running_var"] = update[0]
                else:
                    out[key] = merge(p_node[key], update)
            return out

        return merge(params, bn_updates)

    def encode_text(self, params, text):
        from fitclip_tpu.models.clip.encoder import l2_normalize

        cfg = self.config.text
        spec = BlockSpec(heads=cfg.heads, causal=True,
                         quick_gelu=self.config.quick_gelu,
                         dtype=self.model.dtype)
        emb, _ = encode_text_tower(params["text"], text, cfg, spec)
        return l2_normalize(emb)


def resnet_clip_params_from_torch(state_dict, config: ResNetCLIPConfig) -> dict:
    """OpenAI RN-CLIP state dict -> flax params (visual via the ResNet
    converter, text via the shared tower stacker)."""
    import numpy as np

    from fitclip_tpu.convert.torch_state_dict import _ln, _openai_tower_blocks

    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    return {
        "visual": resnet_params_from_torch(sd),
        "text": {
            "token_embedding": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            "transformer": {"blocks": _openai_tower_blocks(sd, "transformer",
                                                           config.text.layers)},
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": sd["text_projection"],
        },
    }
