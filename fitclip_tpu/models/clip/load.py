"""Encoder factories: the ``_target_``s behind ``config/encoder/*.yaml``.

Replaces the reference's ``load_clip_model`` (clip_video_text_encoder.py:30-61)
which wraps ``clip.load``: here, a preset name or checkpoint determines the
architecture, the torch->JAX converter loads released ``.pt`` state dicts
(README.md:35-54 artifacts), and absent a checkpoint the encoder initializes
randomly (weights are not downloadable in this environment).
"""

import dataclasses
import logging
from typing import Any, Optional

import jax
import jax.numpy as jnp

from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
from fitclip_tpu.models.clip.model import CLIPConfig

LOGGER = logging.getLogger(__name__)

PRESETS = {
    "ViT-B/32": CLIPConfig.vit_b_32,
    "ViT-B/16": CLIPConfig.vit_b_16,
    "ViT-L/14": CLIPConfig.vit_l_14,
    "ViT-L/14@336px": lambda: CLIPConfig.vit_l_14(image_size=336),
}

_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "bf16": jnp.bfloat16,
           "fp32": jnp.float32}


@dataclasses.dataclass
class LoadedEncoder:
    """An encoder plus its parameters — the unit the CLI wires into task
    modules (the functional analogue of the reference's stateful encoder)."""
    encoder: Any
    params: Any

    # Convenience passthroughs so task code can treat this as "the encoder".
    def encode_video(self, video):
        return self.encoder.encode_video(self.params, video)

    def encode_text(self, text):
        return self.encoder.encode_text(self.params, text)

    def get_tokenizer(self):
        return self.encoder.get_tokenizer()

    @property
    def preprocess(self):
        return self.encoder.preprocess


def load_clip_encoder(name: str = "ViT-B/16",
                      checkpoint_path: Optional[str] = None,
                      num_frames: int = 4,
                      dtype: str = "float32",
                      remat: bool = False,
                      bpe_path: Optional[str] = None,
                      seed: int = 0,
                      strip_prefix: Optional[str] = None) -> LoadedEncoder:
    from fitclip_tpu.convert.torch_state_dict import (
        clip_params_from_torch, config_from_openai_state_dict, detect_schema,
        load_torch_state_dict)

    state_dict = None
    if checkpoint_path:
        state_dict = load_torch_state_dict(checkpoint_path, strip_prefix=strip_prefix)
        if "visual.attnpool.q_proj.weight" in state_dict:
            return _load_resnet_clip(name, state_dict, num_frames=num_frames,
                                     dtype=dtype, bpe_path=bpe_path, seed=seed)
        if detect_schema(state_dict) == "openai":
            config = config_from_openai_state_dict(state_dict)
        else:
            config = PRESETS[name]()
    elif name in PRESETS:
        config = PRESETS[name]()
    else:
        # The ResNet towers are flax modules: imported only when asked for.
        from fitclip_tpu.models.clip.resnet_clip import RESNET_PRESETS

        if name not in RESNET_PRESETS:
            raise ValueError(f"Unknown CLIP preset '{name}' and no checkpoint_path "
                             f"given. Presets: {sorted(PRESETS) + sorted(RESNET_PRESETS)}")
        return _load_resnet_clip(name, None, num_frames=num_frames,
                                 dtype=dtype, bpe_path=bpe_path, seed=seed)

    # encoder.dtype=int8 selects the W8A8 inference path: bf16 activations,
    # int8 block denses quantized from the loaded fp32 weights (ops/quant.py).
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    compute_dtype = _DTYPES["bfloat16" if quantized else str(dtype)]
    encoder = ClipVideoTextEncoder(config, num_frames=num_frames,
                                   dtype=compute_dtype, remat=remat,
                                   quantized=quantized, bpe_path=bpe_path)
    if state_dict is not None:
        params = clip_params_from_torch(state_dict, config)
        if quantized:
            from fitclip_tpu.ops.quant import quantize_clip_params

            params = quantize_clip_params(params)
    else:
        LOGGER.warning("No checkpoint_path for CLIP %s: initializing randomly.", name)
        params = encoder.init_params(jax.random.PRNGKey(seed))
    return LoadedEncoder(encoder=encoder, params=params)


def _load_resnet_clip(name, state_dict, num_frames: int, bpe_path, seed: int,
                      dtype: str = "float32") -> LoadedEncoder:
    from fitclip_tpu.models.clip.resnet_clip import (
        RESNET_PRESETS, ResNetClipVideoTextEncoder, resnet_clip_params_from_torch)

    config = RESNET_PRESETS[name]
    if str(dtype) == "int8":
        raise ValueError("encoder.dtype=int8 is transformer-only; CLIP ResNets "
                         "support float dtypes — "
                         "use bfloat16 for the throughput configuration.")
    encoder = ResNetClipVideoTextEncoder(config, num_frames=num_frames,
                                         dtype=_DTYPES[str(dtype)],
                                         bpe_path=bpe_path)
    if state_dict is not None:
        params = resnet_clip_params_from_torch(state_dict, config)
    else:
        LOGGER.warning("No checkpoint_path for CLIP %s: initializing randomly.", name)
        params = encoder.init_params(jax.random.PRNGKey(seed))
    return LoadedEncoder(encoder=encoder, params=params)


def load_clip_from_scratch(name: str = "ViT-B/16", **kwargs) -> LoadedEncoder:
    """Fresh random initialization (config/encoder/clip_from_scratch_* analogue)."""
    return load_clip_encoder(name=name, checkpoint_path=None, **kwargs)


def load_tiny_test_encoder(num_frames: int = 4, seed: int = 0,
                           bpe_path: Optional[str] = None,
                           vocab_path: Optional[str] = None) -> LoadedEncoder:
    """Tiny randomly-initialized CLIP for smoke tests and CLI dry runs."""
    from fitclip_tpu.models.clip.tokenizer import ClipTokenizer

    tokenizer = None
    if bpe_path:
        tokenizer = ClipTokenizer(bpe_path=bpe_path, vocab_path=vocab_path,
                                  context_length=16)
    vocab_size = tokenizer.vocab_size if tokenizer else 64
    encoder = ClipVideoTextEncoder(CLIPConfig.tiny_test(vocab_size=vocab_size),
                                   num_frames=num_frames, tokenizer=tokenizer)
    return LoadedEncoder(encoder=encoder,
                         params=encoder.init_params(jax.random.PRNGKey(seed)))


def load_tiny_rn_test_encoder(num_frames: int = 2, seed: int = 0,
                              bpe_path: Optional[str] = None,
                              vocab_path: Optional[str] = None) -> LoadedEncoder:
    """Tiny randomly-initialized ResNet-CLIP for smoke tests and CLI dry runs
    (exercises the trainable batch-stats BN path end to end)."""
    from fitclip_tpu.models.clip.model import TextConfig
    from fitclip_tpu.models.clip.resnet import ModifiedResNetConfig
    from fitclip_tpu.models.clip.resnet_clip import (ResNetCLIPConfig,
                                                     ResNetClipVideoTextEncoder)
    from fitclip_tpu.models.clip.tokenizer import ClipTokenizer

    tokenizer = None
    if bpe_path:
        tokenizer = ClipTokenizer(bpe_path=bpe_path, vocab_path=vocab_path,
                                  context_length=16)
    vocab_size = tokenizer.vocab_size if tokenizer else 64
    config = ResNetCLIPConfig(
        embed_dim=16,
        vision=ModifiedResNetConfig(layers=(1, 1, 1, 1), width=8,
                                    output_dim=16, input_resolution=32,
                                    heads=4),
        text=TextConfig(context_length=16, vocab_size=vocab_size, width=16,
                        heads=2, layers=2))
    encoder = ResNetClipVideoTextEncoder(config, num_frames=num_frames,
                                         tokenizer=tokenizer)
    return LoadedEncoder(encoder=encoder,
                         params=encoder.init_params(jax.random.PRNGKey(seed)))


def wise_encoder(model1: LoadedEncoder, model2: LoadedEncoder,
                 weight_for_2: float = 0.5) -> LoadedEncoder:
    """WiSE-FT at instantiation time (config/encoder/wise.yaml -> wise.py:19-23;
    released recipe uses weight_for_2=0.4)."""
    from fitclip_tpu.models.wise import wise_params

    return LoadedEncoder(encoder=model1.encoder,
                         params=wise_params(model1.params, model2.params,
                                            weight_for_2=weight_for_2))
