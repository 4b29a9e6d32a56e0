"""VideoCLIP parity: BERT tower vs HF torch BertModel; MMBert video path
pooling math vs a hand-rolled torch equivalent; encoder API smoke."""

import numpy as np
import pytest


def _tiny_hf_bert(vocab_size=100):
    import torch

    from transformers import BertConfig as HFBertConfig, BertModel as HFBert

    torch.manual_seed(0)
    config = HFBertConfig(vocab_size=vocab_size, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64,
                          hidden_act="gelu")
    return HFBert(config).eval()


def test_bert_tower_matches_hf():
    import jax.numpy as jnp
    import torch

    from fitclip_tpu.models.videoclip import BertConfig, BertEncoderModel, _bert_tower_params

    hf = _tiny_hf_bert()
    config = BertConfig.tiny_test()
    sd = {f"text_encoder.{k}": v.numpy() for k, v in hf.state_dict().items()}
    params = _bert_tower_params(sd, "text_encoder", config.num_layers)
    word = sd["text_encoder.embeddings.word_embeddings.weight"]

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 100, size=(2, 12))
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    with torch.no_grad():
        expected = hf(input_ids=torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()

    embeds = jnp.asarray(word[ids])
    positions = jnp.arange(12)[None, :]
    token_type = jnp.zeros((2, 12), jnp.int32)
    actual = np.asarray(BertEncoderModel(config).apply(
        {"params": params}, embeds, positions, token_type,
        jnp.asarray(mask, jnp.int32)))
    np.testing.assert_allclose(actual[mask.astype(bool)], expected[mask.astype(bool)],
                               atol=1e-4, rtol=1e-4)


def test_forward_text_drops_prefix_sep_and_pools():
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.videoclip import BertConfig, VideoClipModel

    config = BertConfig.tiny_test()
    model = VideoClipModel(config, num_video_layers=1, max_video_len=4)
    ids = np.array([[2, 3, 7, 8, 3, 0, 0, 0]], np.int32)  # [CLS][SEP] a b [SEP] pad
    mask = (ids != 0).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
                        method=VideoClipModel.forward_text)["params"]
    out = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                      method=VideoClipModel.forward_text)
    assert out.shape == (1, config.hidden_size)
    assert np.isfinite(np.asarray(out)).all()


def test_forward_video_position_scheme():
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.videoclip import BertConfig, VideoClipModel

    config = BertConfig.tiny_test()
    model = VideoClipModel(config, num_video_layers=1, max_video_len=8,
                           video_feature_dim=16)
    vfeats = jnp.asarray(np.random.default_rng(0).normal(size=(2, 3, 16)),
                         jnp.float32)
    vmasks = jnp.ones((2, 3), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), vfeats, vmasks, 2, 3,
                        method=VideoClipModel.forward_video)["params"]
    out = model.apply({"params": params}, vfeats, vmasks, 2, 3,
                      method=VideoClipModel.forward_video)
    assert out.shape == (2, config.hidden_size)
    assert np.isfinite(np.asarray(out)).all()


def test_videoclip_encoder_api(tmp_path):
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.videoclip import BertConfig, VideoClipVideoTextEncoder
    from fitclip_tpu.text.wordpiece import WordPieceTokenizer

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "video"]
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(vocab))
    inner = WordPieceTokenizer(vocab_path=str(vocab_file), max_tokens=10)
    tokenizer = lambda texts: inner(texts, prefix_sep=True)["input_ids"]  # noqa: E731
    tokenizer.inner = inner

    encoder = VideoClipVideoTextEncoder(BertConfig.tiny_test(vocab_size=len(vocab)),
                                        num_frames=16, frames_per_clip=8,
                                        tokenizer=tokenizer)
    params = encoder.init_params(jax.random.PRNGKey(0))
    video = np.random.default_rng(0).integers(0, 255, (1, 16, 64, 64, 3),
                                              dtype=np.uint8)
    ids = tokenizer(["a cat video"])
    assert ids[0, 0] == 2 and ids[0, 1] == 3  # [CLS] [SEP] prefix
    emb_v = encoder.encode_video(params, jnp.asarray(video))
    emb_t = encoder.encode_text(params, jnp.asarray(ids))
    assert emb_v.shape == (1, encoder.config.hidden_size)
    assert emb_t.shape == (1, encoder.config.hidden_size)
    assert not encoder.preprocess.should_pad_batch


def test_bf16_s3dg_tower_close_to_fp32():
    """++encoder.dtype=bfloat16 runs the S3DG feature tower in bf16; the
    fused video embedding must stay cosine > 0.999 vs the fp32 path."""
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.videoclip import BertConfig, VideoClipVideoTextEncoder

    config = BertConfig.tiny_test(vocab_size=30)
    fp32 = VideoClipVideoTextEncoder(config, num_frames=16, frames_per_clip=8)
    bf16 = VideoClipVideoTextEncoder(config, num_frames=16, frames_per_clip=8,
                                     dtype="bfloat16")
    params = fp32.init_params(jax.random.PRNGKey(0))
    video = jnp.asarray(np.random.default_rng(0).integers(
        0, 255, (2, 16, 64, 64, 3), dtype=np.uint8))
    a = np.asarray(fp32.encode_video(params, video), np.float32)
    b = np.asarray(bf16.encode_video(params, video), np.float32)
    cos = ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))).min()
    assert cos > 0.999, cos


def test_bf16_fusion_tower_close_to_fp32_text():
    """The MMBert fusion matmuls follow ++encoder.dtype=bfloat16. The text
    path runs ONLY the fusion tower, so this gates the fusion numerics
    directly (the video gate above covers S3DG+fusion combined)."""
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.videoclip import BertConfig, VideoClipVideoTextEncoder

    config = BertConfig.tiny_test(vocab_size=30)
    fp32 = VideoClipVideoTextEncoder(config, num_frames=16, frames_per_clip=8)
    bf16 = VideoClipVideoTextEncoder(config, num_frames=16, frames_per_clip=8,
                                     dtype="bfloat16")
    assert bf16.model.dtype == jnp.bfloat16 and fp32.model.dtype == jnp.float32
    params = fp32.init_params(jax.random.PRNGKey(0))
    ids = jnp.asarray(np.random.default_rng(1).integers(
        4, 30, (3, 12), dtype=np.int64))
    a = np.asarray(fp32.encode_text(params, ids), np.float32)
    b = np.asarray(bf16.encode_text(params, ids), np.float32)
    cos = ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))).min()
    assert cos > 0.999, cos
