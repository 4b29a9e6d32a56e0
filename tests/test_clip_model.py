"""CLIP model parity tests.

A small randomly-initialized HuggingFace ``CLIPModel`` (torch, CPU) serves as
the numeric oracle: its weights are converted through the real checkpoint
converter and both towers must agree to <=1e-3 (the BASELINE weight-loading
fidelity bar) — in practice they agree to ~1e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.models.clip import CLIPConfig, CLIPModel
from fitclip_tpu.convert.torch_state_dict import clip_params_from_torch


@pytest.fixture(scope="module")
def tiny_config():
    return CLIPConfig.tiny_test(vocab_size=64)


@pytest.fixture(scope="module")
def hf_pair(tiny_config):
    import torch
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPModel as HFCLIPModel

    hf_config = HFCLIPConfig(
        projection_dim=tiny_config.embed_dim,
        text_config=dict(
            hidden_size=tiny_config.text.width,
            intermediate_size=4 * tiny_config.text.width,
            num_hidden_layers=tiny_config.text.layers,
            num_attention_heads=tiny_config.text.heads,
            max_position_embeddings=tiny_config.text.context_length,
            vocab_size=tiny_config.text.vocab_size,
            hidden_act="quick_gelu",
            eos_token_id=2,
        ),
        vision_config=dict(
            hidden_size=tiny_config.vision.width,
            intermediate_size=4 * tiny_config.vision.width,
            num_hidden_layers=tiny_config.vision.layers,
            num_attention_heads=tiny_config.vision.heads,
            image_size=tiny_config.vision.image_size,
            patch_size=tiny_config.vision.patch_size,
            hidden_act="quick_gelu",
        ),
    )
    torch.manual_seed(0)
    hf_model = HFCLIPModel(hf_config).eval()
    state_dict = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    params = clip_params_from_torch(state_dict, tiny_config)
    return hf_model, params


def test_param_tree_matches_model_init(tiny_config, hf_pair):
    model = CLIPModel(tiny_config)
    init_params = model.init(jax.random.PRNGKey(0))
    _, converted = hf_pair
    init_flat = jax.tree_util.tree_leaves_with_path(init_params)
    conv_flat = jax.tree_util.tree_leaves_with_path(converted)
    init_shapes = {jax.tree_util.keystr(p): l.shape for p, l in init_flat}
    conv_shapes = {jax.tree_util.keystr(p): l.shape for p, l in conv_flat}
    assert init_shapes == conv_shapes


def test_image_tower_matches_hf(tiny_config, hf_pair):
    import torch

    hf_model, params = hf_pair
    rng = np.random.default_rng(0)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)

    with torch.no_grad():
        expected = hf_model.get_image_features(
            pixel_values=torch.from_numpy(images.transpose(0, 3, 1, 2))).numpy()

    model = CLIPModel(tiny_config)
    actual = np.asarray(model.encode_image(params, jnp.asarray(images)))
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)
    assert float(np.abs(actual - expected).max()) < 1e-4


def test_text_tower_matches_hf(tiny_config, hf_pair):
    import torch

    hf_model, params = hf_pair
    rng = np.random.default_rng(1)
    # EOT pooling is argmax(ids): give each row a unique maximal token.
    ids = rng.integers(1, 60, size=(4, 16))
    ids[:, 10] = 63
    ids = ids.astype(np.int64)

    with torch.no_grad():
        expected = hf_model.get_text_features(input_ids=torch.from_numpy(ids)).numpy()

    model = CLIPModel(tiny_config)
    actual = np.asarray(model.encode_text(params, jnp.asarray(ids, dtype=jnp.int32)))
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)
    assert float(np.abs(actual - expected).max()) < 1e-4


def test_fold_pixel_normalization(tiny_config, hf_pair):
    from fitclip_tpu.models.clip.model import fold_pixel_normalization

    _, params = hf_pair
    mean = (0.48145466, 0.4578275, 0.40821073)
    std = (0.26862954, 0.26130258, 0.27577711)
    rng = np.random.default_rng(2)
    uint8_images = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    normalized = ((uint8_images / 255.0) - np.array(mean)) / np.array(std)

    model = CLIPModel(tiny_config)
    reference = model.encode_image(params, jnp.asarray(normalized, jnp.float32))
    folded = fold_pixel_normalization(params, mean, std)
    fast = model.encode_image(folded, jnp.asarray(uint8_images, jnp.float32))
    np.testing.assert_allclose(np.asarray(fast), np.asarray(reference), atol=2e-4)


def test_bf16_jit_smoke(tiny_config):
    model = CLIPModel(tiny_config, dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0))

    @jax.jit
    def forward(p, images, ids):
        return model.encode_image(p, images), model.encode_text(p, ids)

    img_emb, txt_emb = forward(params, jnp.ones((2, 32, 32, 3)),
                               jnp.ones((2, 16), jnp.int32))
    assert img_emb.shape == (2, tiny_config.embed_dim)
    assert txt_emb.shape == (2, tiny_config.embed_dim)
    assert np.isfinite(np.asarray(img_emb, dtype=np.float32)).all()


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gradient_equals_plain_gradient(tiny_config, remat):
    """jax.checkpoint around the scanned block changes memory, not math."""
    plain = CLIPModel(tiny_config)
    rematted = CLIPModel(tiny_config, remat=remat)
    params = plain.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    images = jnp.asarray(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    ids = jnp.asarray(rng.integers(1, 60, size=(2, 16)).astype(np.int32))

    def loss(model):
        return lambda p: (model.encode_image(p, images).sum()
                          + model.encode_text(p, ids).sum())

    want = jax.jit(jax.grad(loss(plain)))(params)
    got = jax.jit(jax.grad(loss(rematted)))(params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        # Recomputation reorders fp32 sums: agree to ~1e-6 of each leaf's scale.
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-6 * scale, rtol=1e-5)


def test_calibration_tree_covers_every_quantized_dense(tiny_config):
    """The observed abs-max tree mirrors the int8 params: every act_scale
    leaf gets a calibrated value, stacked along the layers."""
    from fitclip_tpu.ops.quant import apply_act_scales, quantize_clip_params

    model = CLIPModel(tiny_config)
    qparams = quantize_clip_params(model.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(4)
    observed = dict(model.image_act_amax(
        qparams, jnp.asarray(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))))
    observed.update(model.text_act_amax(
        qparams, jnp.asarray(rng.integers(1, 60, size=(2, 16)).astype(np.int32))))
    calibrated = apply_act_scales(qparams, observed)
    scales = [leaf for path, leaf in jax.tree_util.tree_leaves_with_path(calibrated)
              if "act_scale" in jax.tree_util.keystr(path)]
    assert len(scales) == 8  # 4 denses x 2 towers
    for leaf in scales:
        assert leaf.shape == (tiny_config.vision.layers, 1)
        assert np.all(np.asarray(leaf) != 1.0)
