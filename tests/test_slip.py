"""SLIP family parity vs the reference slip.py CLIP class.

The reference factory functions need timm (absent), but the CLIP class takes
any vision module — so the test provides a minimal timm-layout torch ViT
oracle (written here, test-only) and compares both towers after conversion.
"""

import math
import types
import sys

import numpy as np
import pytest

from tests.reference_oracle import _stub_module, install_reference, reference_available

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference tree not mounted")


def _install_timm_stub():
    # Another test may have stubbed timm already (e.g. timm.models.layers for
    # the FiT oracle) — extend whatever is there instead of skipping.
    timm = sys.modules.get("timm") or _stub_module("timm")
    models = getattr(timm, "models", None) or _stub_module("timm.models")
    registry = _stub_module("timm.models.registry")
    vision_transformer = _stub_module("timm.models.vision_transformer")
    registry.register_model = lambda fn: fn
    vision_transformer._create_vision_transformer = None
    models.registry = registry
    models.vision_transformer = vision_transformer
    timm.models = models
    timm.create_model = None
    sys.modules["timm"] = timm
    sys.modules["timm.models"] = models
    sys.modules["timm.models.registry"] = registry
    sys.modules["timm.models.vision_transformer"] = vision_transformer


def _torch_timm_vit(width, layers, heads, patch, image_size):
    """Minimal timm-semantics ViT oracle in torch (test-only)."""
    import torch
    from torch import nn

    class Attention(nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(width, width * 3)
            self.proj = nn.Linear(width, width)

        def forward(self, x):
            b, n, c = x.shape
            head_dim = c // heads
            qkv = self.qkv(x).reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            attn = (q @ k.transpose(-2, -1)) * (head_dim ** -0.5)
            attn = attn.softmax(dim=-1)
            x = (attn @ v).transpose(1, 2).reshape(b, n, c)
            return self.proj(x)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = nn.LayerNorm(width, eps=1e-6)
            self.attn = Attention()
            self.norm2 = nn.LayerNorm(width, eps=1e-6)
            self.mlp = nn.Sequential()
            self.mlp.fc1 = nn.Linear(width, 4 * width)
            self.mlp.fc2 = nn.Linear(4 * width, width)

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            h = self.mlp.fc2(torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x))))
            return x + h

    class ViT(nn.Module):
        def __init__(self):
            super().__init__()
            grid = image_size // patch
            self.patch_embed = nn.Module()
            self.patch_embed.proj = nn.Conv2d(3, width, patch, stride=patch)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
            self.pos_embed = nn.Parameter(torch.randn(1, grid * grid + 1, width) * 0.02)
            self.blocks = nn.ModuleList([Block() for _ in range(layers)])
            self.norm = nn.LayerNorm(width, eps=1e-6)

        def forward(self, x):
            b = x.shape[0]
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
            x = x + self.pos_embed
            for block in self.blocks:
                x = block(x)
            return self.norm(x)[:, 0]

    return ViT()


@pytest.fixture(scope="module")
def reference_slip_model():
    install_reference()
    _install_timm_stub()
    import torch

    from aligner.encoder.slip import CLIP as RefCLIP

    torch.manual_seed(0)
    vision = _torch_timm_vit(width=48, layers=2, heads=4, patch=16, image_size=32)
    model = RefCLIP(embed_dim=32, vision_width=48, vision_model=vision,
                    context_length=16, vocab_size=64, transformer_width=32,
                    transformer_heads=4, transformer_layers=2).eval()
    return model


def test_slip_towers_match_reference(reference_slip_model):
    import jax.numpy as jnp
    import torch

    from fitclip_tpu.models.slip import SlipConfig, SlipModel, slip_params_from_torch

    config = SlipConfig.tiny_test(vocab_size=64)
    sd = {k: v.float().numpy() for k, v in reference_slip_model.state_dict().items()}
    params = slip_params_from_torch(sd, config)
    model = SlipModel(config)

    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(3, 16))
    ids[:, 10] = 63
    with torch.no_grad():
        expected_img = reference_slip_model.encode_image(
            torch.from_numpy(images.transpose(0, 3, 1, 2))).numpy()
        expected_txt = reference_slip_model.encode_text(
            torch.from_numpy(ids)).numpy()

    actual_img = np.asarray(model.encode_image(params, jnp.asarray(images)))
    actual_txt = np.asarray(model.encode_text(params, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(actual_img, expected_img, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(actual_txt, expected_txt, atol=1e-4, rtol=1e-4)


def test_slip_encoder_api():
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.slip import SlipConfig, SlipVideoTextEncoder

    encoder = SlipVideoTextEncoder(SlipConfig.tiny_test(), num_frames=2)
    params = encoder.init_params(jax.random.PRNGKey(0))
    video = np.random.default_rng(0).integers(0, 255, (2, 2, 32, 32, 3), dtype=np.uint8)
    emb = encoder.encode_video(params, jnp.asarray(video))
    assert emb.shape == (2, 32)
    with pytest.raises(NotImplementedError):
        encoder.preprocess.train_frame_sampler(0, 10, 30.0)
