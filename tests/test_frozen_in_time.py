"""Frozen-in-Time parity: SpaceTimeTransformer vs the reference torch
implementation, DistilBERT vs HF torch, WordPiece vs HF BertTokenizer."""

import sys
import types

import numpy as np
import pytest

from tests.reference_oracle import _stub_module, install_reference, reference_available


def _install_timm_layers_stub():
    if "timm.models.layers" in sys.modules:
        return
    import torch

    layers = _stub_module("timm.models.layers")

    class DropPath(torch.nn.Module):
        def __init__(self, *a, **k):
            super().__init__()

        def forward(self, x):
            return x

    layers.DropPath = DropPath
    layers.to_2tuple = lambda v: v if isinstance(v, tuple) else (v, v)
    layers.trunc_normal_ = lambda tensor, std=1.0: tensor.data.normal_(0, std)
    if "timm" not in sys.modules:
        timm = _stub_module("timm")
        timm.models = _stub_module("timm.models")
        sys.modules["timm"] = timm
        sys.modules["timm.models"] = timm.models
    sys.modules["timm"].models.layers = layers
    sys.modules["timm.models.layers"] = layers


@pytest.mark.skipif(not reference_available(), reason="reference tree not mounted")
def test_space_time_transformer_matches_reference():
    install_reference()
    _install_timm_layers_stub()
    import torch

    from aligner.encoder.video_transformer import SpaceTimeTransformer as RefSTT

    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, frozen_in_time_params_from_torch)
    from fitclip_tpu.models.frozen_in_time.video_transformer import SpaceTimeTransformer

    torch.manual_seed(0)
    reference = RefSTT(img_size=32, patch_size=16, num_classes=0, embed_dim=48,
                       depth=2, num_heads=4, num_frames=2, time_init="zeros").eval()
    with torch.no_grad():
        for parameter in reference.parameters():
            parameter.data.normal_(0, 0.05)

    rng = np.random.default_rng(0)
    video = rng.normal(size=(2, 2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        expected = reference(torch.from_numpy(video)).numpy()

    config = FrozenInTimeConfig.tiny_test()
    state_dict = {f"video_model.{k}": v.numpy() for k, v in reference.state_dict().items()}
    # Converter needs proj keys too; provide dummies and use only the video part.
    state_dict.update({
        "vid_proj.0.weight": np.zeros((16, 48), np.float32),
        "vid_proj.0.bias": np.zeros(16, np.float32),
        "txt_proj.1.weight": np.zeros((16, 32), np.float32),
        "txt_proj.1.bias": np.zeros(16, np.float32),
    })
    import torch as _t

    from transformers import DistilBertConfig as HFDBC, DistilBertModel as HFDB

    hf = HFDB(HFDBC(vocab_size=100, dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                    max_position_embeddings=32))
    state_dict.update({f"text_model.{k}": v.numpy() for k, v in hf.state_dict().items()})

    params = frozen_in_time_params_from_torch(state_dict, config)

    import jax.numpy as jnp

    model = SpaceTimeTransformer(embed_dim=48, depth=2, num_heads=4,
                                 patch_size=16, img_size=32, num_frames=2)
    actual = np.asarray(model.apply({"params": params["video"]},
                                    jnp.asarray(video.transpose(0, 1, 3, 4, 2))))
    np.testing.assert_allclose(actual, expected, atol=1e-4, rtol=1e-4)


def test_distilbert_matches_hf():
    import torch

    from transformers import DistilBertConfig as HFDBC, DistilBertModel as HFDB

    from fitclip_tpu.models.frozen_in_time.distilbert import (
        DistilBertConfig, DistilBertModel, distilbert_params_from_torch)

    torch.manual_seed(0)
    hf = HFDB(HFDBC(vocab_size=100, dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                    max_position_embeddings=32)).eval()
    config = DistilBertConfig.tiny_test(vocab_size=100)
    params = distilbert_params_from_torch(
        {k: v.numpy() for k, v in hf.state_dict().items()}, config)

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 100, size=(3, 10))
    mask = np.ones_like(ids)
    mask[0, 7:] = 0
    ids[0, 7:] = 0
    with torch.no_grad():
        expected = hf(input_ids=torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()

    import jax.numpy as jnp

    actual = np.asarray(DistilBertModel(config).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)))
    # Masked positions can differ (HF computes them); compare valid positions.
    np.testing.assert_allclose(actual[mask.astype(bool)], expected[mask.astype(bool)],
                               atol=1e-4, rtol=1e-4)


TINY_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "video",
              "of", "the", "##s", "##ing", "play", "dog", "un", "##know", "##n",
              ",", ".", "!", "person"]


@pytest.fixture()
def vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(TINY_VOCAB))
    return str(path)


@pytest.mark.parametrize("text", [
    "a cat video", "the cats playing!", "unknown", "A CAT, of the video.",
    "completely oov words", "",
])
def test_wordpiece_matches_hf_bert_tokenizer(vocab_file, text):
    from transformers import BertTokenizer

    from fitclip_tpu.text.wordpiece import WordPieceTokenizer

    hf = BertTokenizer(vocab_file=vocab_file, do_lower_case=True)
    mine = WordPieceTokenizer(vocab_path=vocab_file, max_tokens=16)
    expected = hf(text, padding="max_length", truncation=True, max_length=16)
    actual = mine([text])
    np.testing.assert_array_equal(actual["input_ids"][0], expected["input_ids"])
    np.testing.assert_array_equal(actual["attention_mask"][0], expected["attention_mask"])


def test_frozen_in_time_encoder_api(vocab_file):
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, FrozenInTimeVideoTextEncoder)
    from fitclip_tpu.text.wordpiece import WordPieceTokenizer

    config = FrozenInTimeConfig.tiny_test(vocab_size=len(TINY_VOCAB))
    inner = WordPieceTokenizer(vocab_path=vocab_file, max_tokens=12)
    tokenizer = lambda texts: inner(texts)["input_ids"]  # noqa: E731
    tokenizer.inner = inner
    encoder = FrozenInTimeVideoTextEncoder(config, num_frames=2, max_tokens=12,
                                           tokenizer=tokenizer)
    params = encoder.init_params(jax.random.PRNGKey(0))
    video = np.random.default_rng(0).integers(0, 255, (2, 2, 32, 32, 3), dtype=np.uint8)
    ids = tokenizer(["a cat video", "playing dogs"])
    emb_v = encoder.encode_video(params, jnp.asarray(video))
    emb_t = encoder.encode_text(params, jnp.asarray(ids))
    assert emb_v.shape == (2, 16)
    assert emb_t.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(emb_t), axis=1), 1.0,
                               atol=1e-5)


def test_temporal_embed_inflation():
    from fitclip_tpu.models.frozen_in_time.encoder import inflate_temporal_embed

    embed = np.arange(8, dtype=np.float32).reshape(4, 2)
    zeros = inflate_temporal_embed(embed, 6, "zeros")
    assert zeros.shape == (6, 2)
    assert zeros[4:].sum() == 0
    interp = inflate_temporal_embed(embed, 7, "interp")
    assert interp.shape == (7, 2)
    np.testing.assert_allclose(interp[0], embed[0])
    np.testing.assert_allclose(interp[-1], embed[-1])
    assert inflate_temporal_embed(embed, 2, "zeros").shape == (2, 2)


def test_bf16_eval_config_close_to_fp32():
    """++encoder.dtype=bfloat16 (the throughput eval configuration) must stay
    embedding-equivalent to the fp32 parity configuration: same params, both
    dtypes, cosine > 0.999 on video AND text."""
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, FrozenInTimeVideoTextEncoder)

    config = FrozenInTimeConfig.tiny_test()
    fp32 = FrozenInTimeVideoTextEncoder(config, num_frames=2)
    bf16 = FrozenInTimeVideoTextEncoder(config, num_frames=2, dtype="bfloat16")
    params = fp32.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.integers(0, 255, (3, 2, 32, 32, 3), dtype=np.uint8))
    ids = jnp.asarray(rng.integers(1, 90, (3, 8)).astype(np.int32))

    def cosine(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                         * np.linalg.norm(b, axis=-1))).min())

    assert cosine(bf16.encode_video(params, video),
                  fp32.encode_video(params, video)) > 0.999
    assert cosine(bf16.encode_text(params, ids),
                  fp32.encode_text(params, ids)) > 0.999


def test_int8_eval_config_close_to_fp32():
    """++encoder.dtype=int8 (W8A8 video-tower denses, ops/quant.py) must stay
    embedding-equivalent to the fp32 parity configuration after multi-batch
    calibration: cosine > 0.99 on video, and text numerically equal to the
    bf16 path (the DistilBERT tower is not quantized)."""
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, FrozenInTimeVideoTextEncoder,
        quantize_fit_video_params)
    from fitclip_tpu.ops.quant import apply_act_scales, merge_act_amax

    config = FrozenInTimeConfig.tiny_test()
    fp32 = FrozenInTimeVideoTextEncoder(config, num_frames=2)
    params = fp32.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    video_a = jnp.asarray(rng.integers(0, 255, (2, 2, 32, 32, 3), dtype=np.uint8))
    video_b = jnp.asarray(rng.integers(0, 255, (2, 2, 32, 32, 3), dtype=np.uint8))
    ids = jnp.asarray(rng.integers(1, 90, (3, 8)).astype(np.int32))

    def cosine(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                         * np.linalg.norm(b, axis=-1))).min())

    enc = FrozenInTimeVideoTextEncoder(config, num_frames=2, dtype="int8")
    assert enc.quantized
    qparams = dict(params, video=quantize_fit_video_params(params["video"]))
    # Running-abs-max calibration over two batches (the runners' policy),
    # then eval on a batch the scales were NOT solely calibrated on.
    amax = merge_act_amax(enc.collect_act_amax(qparams, video_a),
                          enc.collect_act_amax(qparams, video_b))
    qparams = apply_act_scales(qparams, amax)
    assert cosine(enc.encode_video(qparams, video_b),
                  fp32.encode_video(params, video_b)) > 0.99
    np.testing.assert_allclose(
        np.asarray(enc.encode_text(qparams, ids), np.float32),
        np.asarray(FrozenInTimeVideoTextEncoder(
            config, num_frames=2, dtype="bfloat16").encode_text(params, ids),
            np.float32), atol=1e-6)
