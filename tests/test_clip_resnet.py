"""ModifiedResNet parity vs an OpenAI-layout torch oracle (written in-test).

The oracle reproduces CLIP's ResNet forward with torch built-ins (Conv2d, BN
eval mode, F.multi_head_attention_forward) so conversion layout bugs surface.
"""

import numpy as np
import pytest


def _torch_modified_resnet(layers, width, output_dim, heads, input_resolution):
    import torch
    from torch import nn
    from torch.nn import functional as F

    class Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, inplanes, planes, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
            self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(planes * 4)
            self.downsample = None
            if stride > 1 or inplanes != planes * 4:
                # OpenAI CLIP names these with an OrderedDict ("-1", "0", "1"),
                # so the conv is downsample.0 and the BN downsample.1.
                from collections import OrderedDict

                self.downsample = nn.Sequential(OrderedDict([
                    ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                    ("0", nn.Conv2d(inplanes, planes * 4, 1, stride=1, bias=False)),
                    ("1", nn.BatchNorm2d(planes * 4))]))

        def forward(self, x):
            identity = x
            out = F.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.avgpool(out)
            out = self.bn3(self.conv3(out))
            if self.downsample is not None:
                identity = self.downsample(x)
            return F.relu(out + identity)

    class AttentionPool2d(nn.Module):
        def __init__(self, spacial_dim, embed_dim, num_heads, output_dim):
            super().__init__()
            self.positional_embedding = nn.Parameter(
                torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
            self.k_proj = nn.Linear(embed_dim, embed_dim)
            self.q_proj = nn.Linear(embed_dim, embed_dim)
            self.v_proj = nn.Linear(embed_dim, embed_dim)
            self.c_proj = nn.Linear(embed_dim, output_dim)
            self.num_heads = num_heads

        def forward(self, x):
            x = x.flatten(start_dim=2).permute(2, 0, 1)
            x = torch.cat([x.mean(dim=0, keepdim=True), x], dim=0)
            x = x + self.positional_embedding[:, None, :]
            x, _ = F.multi_head_attention_forward(
                query=x[:1], key=x, value=x,
                embed_dim_to_check=x.shape[-1], num_heads=self.num_heads,
                q_proj_weight=self.q_proj.weight, k_proj_weight=self.k_proj.weight,
                v_proj_weight=self.v_proj.weight, in_proj_weight=None,
                in_proj_bias=torch.cat([self.q_proj.bias, self.k_proj.bias,
                                        self.v_proj.bias]),
                bias_k=None, bias_v=None, add_zero_attn=False, dropout_p=0,
                out_proj_weight=self.c_proj.weight, out_proj_bias=self.c_proj.bias,
                use_separate_proj_weight=True, training=False, need_weights=False)
            return x.squeeze(0)

    class ModifiedResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
            self.bn1 = nn.BatchNorm2d(width // 2)
            self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(width // 2)
            self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
            self.bn3 = nn.BatchNorm2d(width)
            self.avgpool = nn.AvgPool2d(2)
            self._inplanes = width
            self.layer1 = self._make_layer(width, layers[0])
            self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
            self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
            self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
            self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                            heads, output_dim)

        def _make_layer(self, planes, blocks, stride=1):
            layers_ = [Bottleneck(self._inplanes, planes, stride)]
            self._inplanes = planes * 4
            for _ in range(1, blocks):
                layers_.append(Bottleneck(self._inplanes, planes))
            return nn.Sequential(*layers_)

        def forward(self, x):
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.relu(self.bn2(self.conv2(x)))
            x = F.relu(self.bn3(self.conv3(x)))
            x = self.avgpool(x)
            x = self.layer1(x)
            x = self.layer2(x)
            x = self.layer3(x)
            x = self.layer4(x)
            return self.attnpool(x)

    return ModifiedResNet()


def test_modified_resnet_matches_torch_oracle():
    import torch

    import jax.numpy as jnp

    from fitclip_tpu.models.clip.resnet import (
        ModifiedResNet, ModifiedResNetConfig, resnet_params_from_torch)

    torch.manual_seed(0)
    # Tiny RN: width 16 (stem 8), layers (1,1,1,1), input 64 -> spatial 2.
    oracle = _torch_modified_resnet(layers=(1, 1, 1, 1), width=16,
                                    output_dim=24, heads=4, input_resolution=64)
    oracle.eval()
    with torch.no_grad():
        for module in oracle.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.running_mean.normal_(0, 0.05)
                module.running_var.uniform_(0.5, 1.5)

    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        expected = oracle(torch.from_numpy(images.transpose(0, 3, 1, 2))).numpy()

    sd = {f"visual.{k}": v.numpy() for k, v in oracle.state_dict().items()}
    params = resnet_params_from_torch(sd)
    config = ModifiedResNetConfig(layers=(1, 1, 1, 1), width=16, output_dim=24,
                                  input_resolution=64, heads=4)
    actual = np.asarray(ModifiedResNet(config).apply({"params": params},
                                                     jnp.asarray(images)))
    np.testing.assert_allclose(actual, expected, atol=2e-4, rtol=1e-3)


def test_resnet_clip_encoder_and_converter_roundtrip():
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip.model import TextConfig
    from fitclip_tpu.models.clip.resnet import ModifiedResNetConfig
    from fitclip_tpu.models.clip.resnet_clip import (
        ResNetCLIPConfig, ResNetClipVideoTextEncoder)

    config = ResNetCLIPConfig(
        embed_dim=24,
        vision=ModifiedResNetConfig((1, 1, 1, 1), width=16, output_dim=24,
                                    input_resolution=64, heads=4),
        text=TextConfig(context_length=16, vocab_size=64, width=32, layers=2,
                        heads=4))
    encoder = ResNetClipVideoTextEncoder(config, num_frames=2)
    params = encoder.init_params(jax.random.PRNGKey(0))

    video = np.random.default_rng(0).integers(0, 255, (2, 2, 64, 64, 3),
                                              dtype=np.uint8)
    ids = np.random.default_rng(1).integers(1, 64, size=(2, 16)).astype(np.int32)
    emb_v = encoder.encode_video(params, jnp.asarray(video))
    emb_t = encoder.encode_text(params, jnp.asarray(ids))
    assert emb_v.shape == (2, 24)
    assert emb_t.shape == (2, 24)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(emb_t), axis=1), 1.0,
                               atol=1e-5)
    assert encoder.preprocess.image_size == 64


def test_eval_only_encoder_refuses_training(tmp_path):
    """SLIP towers are eval-only (as in the reference, whose SLIP wrapper
    raises on train samplers); the train runner must say so. RN towers now
    TRAIN (live batch-stats BN, tests/test_resnet_train.py) so they are no
    longer refused."""
    import pytest as _pytest

    from fitclip_tpu.cli.train_runner import run_train

    class EvalOnly:
        trainable = False

    class Loaded:
        encoder = EvalOnly()
        params = {}

    with _pytest.raises(ValueError, match="evaluation-only"):
        run_train(Loaded(), data_module=None, model_cfg={}, trainer_cfg={},
                  optimizer_cfg={})


def test_bf16_eval_config_close_to_fp32():
    """++encoder.dtype=bfloat16 (the throughput eval configuration) must stay
    numerically close to the fp32 oracle-parity path: same params, both
    dtypes, cosine > 0.999
    on video AND text."""
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip.model import TextConfig
    from fitclip_tpu.models.clip.resnet import ModifiedResNetConfig
    from fitclip_tpu.models.clip.resnet_clip import (
        ResNetCLIPConfig, ResNetClipVideoTextEncoder)

    config = ResNetCLIPConfig(
        embed_dim=24,
        vision=ModifiedResNetConfig((1, 1, 1, 1), width=16, output_dim=24,
                                    input_resolution=64, heads=4),
        text=TextConfig(context_length=16, vocab_size=64, width=32, layers=2,
                        heads=4))
    fp32 = ResNetClipVideoTextEncoder(config, num_frames=2)
    bf16 = ResNetClipVideoTextEncoder(config, num_frames=2, dtype=jnp.bfloat16)
    params = fp32.init_params(jax.random.PRNGKey(0))

    video = jnp.asarray(np.random.default_rng(0).integers(
        0, 255, (2, 2, 64, 64, 3), dtype=np.uint8))
    ids = jnp.asarray(np.random.default_rng(1).integers(
        1, 64, size=(2, 16)).astype(np.int32))

    def cosine(a, b):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                                   np.linalg.norm(b, axis=-1))).min()

    assert cosine(bf16.encode_video(params, video),
                  fp32.encode_video(params, video)) > 0.999
    assert cosine(bf16.encode_text(params, ids),
                  fp32.encode_text(params, ids)) > 0.999
