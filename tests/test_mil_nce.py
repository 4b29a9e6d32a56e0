"""MIL-NCE/S3DG numeric parity vs the reference torch implementation."""

import numpy as np
import pytest

from tests.reference_oracle import install_reference, reference_available

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference tree not mounted")


@pytest.fixture(scope="module")
def torch_s3dg():
    install_reference()
    import torch

    from aligner.encoder.s3dg import S3DG as TorchS3DG

    torch.manual_seed(0)
    model = TorchS3DG(init="kaiming_normal").eval()
    # Randomize BN stats so the affine parity is actually exercised.
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm3d):
                module.running_mean.normal_(0, 0.05)
                module.running_var.uniform_(0.5, 1.5)
                module.weight.normal_(1, 0.05)
                module.bias.normal_(0, 0.05)
    return model


def test_s3dg_matches_reference(torch_s3dg):
    import torch

    from fitclip_tpu.models.mil_nce import _torch_tree_to_flax
    from fitclip_tpu.models.s3dg import S3DG

    state_dict = {k: v.numpy() for k, v in torch_s3dg.state_dict().items()}
    params = _torch_tree_to_flax(state_dict)

    rng = np.random.default_rng(0)
    # (B, C, T, H, W) for torch, (B, T, H, W, C) for flax — even dims for
    # space-to-depth.
    video = rng.uniform(0, 1, size=(1, 3, 16, 64, 64)).astype(np.float32)
    with torch.no_grad():
        expected = torch_s3dg(torch.from_numpy(video)).numpy()

    import jax.numpy as jnp

    actual = np.asarray(S3DG().apply({"params": params},
                                     jnp.asarray(video.transpose(0, 2, 3, 4, 1))))
    np.testing.assert_allclose(actual, expected, atol=2e-3, rtol=1e-3)


def test_text_encoder_matches_reference():
    install_reference()
    import torch

    from aligner.encoder.mil_nce_video_text_encoder import MilNceTextEncoder as TorchText

    from fitclip_tpu.models.mil_nce import _torch_tree_to_flax
    from fitclip_tpu.models.s3dg import MilNceTextEncoder

    torch.manual_seed(1)
    torch_text = TorchText(vocab_size=100).eval()
    params = _torch_tree_to_flax({k: v.numpy() for k, v in torch_text.state_dict().items()})

    ids = np.random.default_rng(1).integers(0, 100, size=(3, 20))
    with torch.no_grad():
        expected = torch_text(torch.from_numpy(ids)).numpy()

    import jax.numpy as jnp

    actual = np.asarray(MilNceTextEncoder(vocab_size=100).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(actual, expected, atol=1e-4)


def test_tokenizer_matches_reference():
    install_reference()

    from aligner.encoder.mil_nce_video_text_encoder import MilNceTokenizer as TorchTok

    from fitclip_tpu.models.mil_nce import MilNceTokenizer

    vocab = {"a": 1, "cat": 2, "sits": 3, "on": 4, "the": 5, "mat": 6, "don't": 7}
    reference = TorchTok(vocab, max_tokens=6)
    mine = MilNceTokenizer(vocab, max_tokens=6)
    for text in ["A cat sits on the mat today", "Don't the CAT!", "", "unknown words only"]:
        expected = reference(text)["input_ids"].numpy()
        np.testing.assert_array_equal(mine([text])[0], expected)


def test_mil_nce_encoder_api():
    import jax

    from fitclip_tpu.models.mil_nce import MilNceTokenizer, MilNceVideoTextEncoder

    tokenizer = MilNceTokenizer({"a": 1, "cat": 2}, max_tokens=5)
    encoder = MilNceVideoTextEncoder(tokenizer=tokenizer, vocab_size=50)
    params = encoder.init_params(jax.random.PRNGKey(0))
    video = np.random.default_rng(0).integers(0, 255, (2, 16, 64, 64, 3), dtype=np.uint8)
    import jax.numpy as jnp

    emb_v = encoder.encode_video(params, jnp.asarray(video))
    emb_t = encoder.encode_text(params, jnp.asarray(tokenizer(["a cat", "cat"])))
    assert emb_v.shape == (2, 512)
    assert emb_t.shape == (2, 512)
    assert not encoder.preprocess.should_pad_batch


def test_bf16_s3dg_close_to_fp32():
    """++encoder.dtype=bfloat16 (the throughput eval configuration) must stay
    embedding-equivalent to the fp32 parity configuration: same params, both
    dtypes, cosine > 0.999 on the S3DG video tower."""
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.mil_nce import MilNceTokenizer, MilNceVideoTextEncoder

    tokenizer = MilNceTokenizer({"a": 1, "cat": 2}, max_tokens=5)
    fp32 = MilNceVideoTextEncoder(tokenizer=tokenizer, vocab_size=50)
    bf16 = MilNceVideoTextEncoder(tokenizer=tokenizer, vocab_size=50,
                                  dtype="bfloat16")
    params = fp32.init_params(jax.random.PRNGKey(0))
    video = jnp.asarray(np.random.default_rng(0).integers(
        0, 255, (2, 16, 64, 64, 3), dtype=np.uint8))
    a = np.asarray(fp32.encode_video(params, video), np.float32)
    b = np.asarray(bf16.encode_video(params, video), np.float32)
    cos = ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))).min()
    assert cos > 0.999, cos
