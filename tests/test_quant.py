"""int8 W8A8 inference path: quality gates vs the float path.

VERDICT round-2 item #3: embedding cosine >= 0.999 vs the float model on the
HF-oracle-convertible tiny CLIP, and identical retrieval ranks on a synthetic
fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.models.clip import CLIPConfig, CLIPModel
from fitclip_tpu.ops.quant import int8_dense, quantize_clip_params, quantize_weight


def test_quantize_weight_roundtrip_error():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(64, 32)).astype(np.float32) * 0.05
    q = quantize_weight(kernel)
    assert q["kernel_q"].dtype == np.int8
    assert q["scale"].shape == (32,)
    restored = q["kernel_q"].astype(np.float32) * q["scale"]
    # Symmetric per-channel int8: max error is half a quantization step.
    step = q["scale"]
    assert np.all(np.abs(restored - kernel) <= step / 2 + 1e-7)


def test_quantize_weight_preserves_scan_axis():
    rng = np.random.default_rng(1)
    kernel = rng.normal(size=(3, 16, 8)).astype(np.float32)  # (layers, in, out)
    q = quantize_weight(kernel)
    assert q["kernel_q"].shape == (3, 16, 8)
    assert q["scale"].shape == (3, 8)
    # Per-layer scales must match quantizing each layer independently.
    for layer in range(3):
        single = quantize_weight(kernel[layer])
        np.testing.assert_array_equal(q["kernel_q"][layer], single["kernel_q"])
        np.testing.assert_allclose(q["scale"][layer], single["scale"])


def test_int8_dense_close_to_float():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(4, 7, 64)).astype(np.float32))
    kernel = rng.normal(size=(64, 32)).astype(np.float32) * 0.05
    bias = rng.normal(size=(32,)).astype(np.float32) * 0.01
    q = quantize_weight(kernel)
    actual = np.asarray(int8_dense(x, jnp.asarray(q["kernel_q"]),
                                   jnp.asarray(q["scale"]), jnp.asarray(bias)))
    expected = np.asarray(x) @ kernel + bias
    # W8A8 with per-token/per-channel scales: ~1% relative error at this scale.
    scale = np.abs(expected).max()
    assert np.abs(actual - expected).max() / scale < 0.02


@pytest.fixture(scope="module")
def float_and_quant():
    from fitclip_tpu.ops.quant import apply_act_scales

    config = CLIPConfig.tiny_test()
    model = CLIPModel(config)
    params = model.init(jax.random.PRNGKey(0))
    # The int8 tree runs through the same model: its leaves pick the path.
    qmodel = CLIPModel(config)
    qparams = quantize_clip_params(params)
    # PTQ calibration: dynamic-quant forward on sample data -> act scales.
    rng = np.random.default_rng(9)
    images = jnp.asarray(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    ids = jnp.asarray(rng.integers(1, 60, size=(8, 16)).astype(np.int32))
    inter = dict(qmodel.image_act_amax(qparams, images))
    inter.update(qmodel.text_act_amax(qparams, ids))
    qparams = apply_act_scales(qparams, inter)
    return model, params, qmodel, qparams


def _both(model, params, images, ids):
    return model.encode_image(params, images), model.encode_text(params, ids)


def _cosine(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_model_cosine_gate(float_and_quant):
    model, params, qmodel, qparams = float_and_quant
    rng = np.random.default_rng(3)
    images = jnp.asarray(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    ids = jnp.asarray(rng.integers(1, 60, size=(4, 16)).astype(np.int32))
    img_f, txt_f = _both(model, params, images, ids)
    img_q, txt_q = _both(qmodel, qparams, images, ids)
    assert _cosine(img_f, img_q).min() >= 0.999
    assert _cosine(txt_f, txt_q).min() >= 0.999


def test_retrieval_ranks_identical(float_and_quant):
    """Full-matrix retrieval ranks must not move under quantization on a
    well-separated synthetic fixture."""
    from fitclip_tpu.evaluation.retrieval import RetrievalEvaluator

    model, params, qmodel, qparams = float_and_quant
    rng = np.random.default_rng(4)
    images = jnp.asarray(rng.normal(size=(12, 32, 32, 3)).astype(np.float32))
    ids = jnp.asarray(rng.integers(1, 60, size=(12, 16)).astype(np.int32))

    def metrics_for(m, p):
        img, txt = _both(m, p, images, ids)
        img = img / jnp.linalg.norm(img, axis=-1, keepdims=True)
        txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
        evaluator = RetrievalEvaluator()
        evaluator.update(img[:, None, :].mean(axis=1), txt)
        return evaluator.compute()

    float_metrics = metrics_for(model, params)
    quant_metrics = metrics_for(qmodel, qparams)
    assert float_metrics == quant_metrics


def test_encoder_int8_path(tmp_path):
    """encoder-level gate: quantized ClipVideoTextEncoder vs float encoder."""
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder

    config = CLIPConfig.tiny_test()
    float_enc = ClipVideoTextEncoder(config, num_frames=2)
    params = float_enc.init_params(jax.random.PRNGKey(0))
    quant_enc = ClipVideoTextEncoder(config, num_frames=2, dtype=jnp.bfloat16,
                                     quantized=True)
    qparams = quantize_clip_params(params)

    rng = np.random.default_rng(5)
    video = rng.integers(0, 256, size=(3, 2, 32, 32, 3)).astype(np.uint8)
    text = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    qparams = quant_enc.calibrate(qparams, jnp.asarray(video), jnp.asarray(text))
    emb_f = float_enc.encode_video(params, jnp.asarray(video))
    emb_q = quant_enc.encode_video(qparams, jnp.asarray(video))
    assert _cosine(emb_f, emb_q).min() >= 0.999
    txt_f = float_enc.encode_text(params, jnp.asarray(text))
    txt_q = quant_enc.encode_text(qparams, jnp.asarray(text))
    assert _cosine(txt_f, txt_q).min() >= 0.999


def test_cli_evaluate_int8(tmp_path, capsys, monkeypatch):
    """encoder.dtype=int8 through the real CLI: loads, calibrates on the
    first eval batch, and produces sane retrieval metrics."""
    import json as json_module
    import os

    from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR, run
    from fitclip_tpu.config_engine import compose
    from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab

    from tests.test_datasets import _write_video

    root = tmp_path / "msrvtt"
    videos = root / "videos" / "all"
    for i in range(4):
        _write_video(str(videos / f"video{i}.avi"))
    (root / "structured-symlinks").mkdir(parents=True)
    (root / "structured-symlinks" / "val_list_jsfusion.txt").write_text(
        "\n".join(f"video{i}" for i in range(4)))
    (root / "structured-symlinks" / "train_list_jsfusion.txt").write_text("video0\n")
    (root / "annotation").mkdir()
    (root / "annotation" / "MSR_VTT.json").write_text(json_module.dumps({
        "annotations": [{"image_id": f"video{i}", "caption": f"a cat video {i}"}
                        for i in range(4)]}))
    merges, _ = write_tiny_test_vocab(str(tmp_path), ["a", "cat", "video"] * 3)
    monkeypatch.setenv("MSRVTT_PATH", str(root))
    monkeypatch.setenv("FITCLIP_BPE_PATH", merges)

    scales_path = str(tmp_path / "scales.npz")
    cfg = compose(DEFAULT_CONFIG_DIR, "trainer",
                  ["command=evaluate", "encoder=clip_vit_b_16", "data=msrvtt",
                   "++encoder.dtype=int8", "data.eval_batch_size=2",
                   "+data.num_threads=2",
                   "++quant.calibration_batches=2",
                   f"++quant.scales_path={scales_path}"])
    run(cfg)
    printed = capsys.readouterr().out
    metrics = json_module.loads(printed[printed.index("{"):])
    assert set(metrics) == {"r1", "r5", "r10", "mr"}
    assert 1 <= metrics["mr"] <= 4
    assert os.path.exists(scales_path)

    # Second run restores the persisted scales (no recalibration) and
    # reproduces the metrics exactly.
    run(cfg)
    printed = capsys.readouterr().out
    metrics2 = json_module.loads(printed[printed.index("{"):])
    assert metrics2 == metrics


def test_multibatch_calibration_insensitive_to_batch_choice():
    """Scales from a running abs-max over K batches: calibrating on batches A
    then evaluating on a held-out batch B keeps the cosine gate, and ranks
    stay identical to float (the VERDICT r2 'skewed first batch' weakness)."""
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.ops.quant import apply_act_scales, merge_act_amax

    config = CLIPConfig.tiny_test()
    float_enc = ClipVideoTextEncoder(config, num_frames=2)
    params = float_enc.init_params(jax.random.PRNGKey(0))
    quant_enc = ClipVideoTextEncoder(config, num_frames=2, dtype=jnp.bfloat16,
                                     quantized=True)
    qparams = quantize_clip_params(params)

    rng = np.random.default_rng(7)

    def batch(loc):
        video = np.clip(rng.normal(loc=loc, scale=60, size=(3, 2, 32, 32, 3)),
                        0, 255).astype(np.uint8)
        text = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
        return jnp.asarray(video), jnp.asarray(text)

    # Calibration set A includes a dark near-constant batch (the skew case);
    # the running max across K batches absorbs it.
    dark = (jnp.zeros((3, 2, 32, 32, 3), jnp.uint8),
            jnp.asarray(rng.integers(1, 60, size=(3, 16)).astype(np.int32)))
    amax = None
    for video, text in [dark, batch(128), batch(100)]:
        amax = merge_act_amax(amax,
                              quant_enc.collect_act_amax(qparams, video, text))
    calibrated = apply_act_scales(qparams, amax)

    held_out_video, held_out_text = batch(140)
    emb_f = float_enc.encode_video(params, held_out_video)
    emb_q = quant_enc.encode_video(calibrated, held_out_video)
    assert _cosine(emb_f, emb_q).min() >= 0.999
    txt_f = float_enc.encode_text(params, held_out_text)
    txt_q = quant_enc.encode_text(calibrated, held_out_text)
    assert _cosine(txt_f, txt_q).min() >= 0.999
    scores_f = np.asarray(emb_f, np.float32) @ np.asarray(txt_f, np.float32).T
    scores_q = np.asarray(emb_q, np.float32) @ np.asarray(txt_q, np.float32).T
    np.testing.assert_array_equal(np.argsort(-scores_f, axis=-1),
                                  np.argsort(-scores_q, axis=-1))


def test_act_scale_persistence_roundtrip(tmp_path):
    """save_act_scales/load_act_scales: a fresh quantized tree with restored
    scales produces BIT-identical embeddings to the calibrated tree."""
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.ops.quant import load_act_scales, save_act_scales

    config = CLIPConfig.tiny_test()
    float_enc = ClipVideoTextEncoder(config, num_frames=2)
    params = float_enc.init_params(jax.random.PRNGKey(0))
    quant_enc = ClipVideoTextEncoder(config, num_frames=2, dtype=jnp.bfloat16,
                                     quantized=True)

    rng = np.random.default_rng(8)
    video = jnp.asarray(rng.integers(0, 256, size=(3, 2, 32, 32, 3))
                        .astype(np.uint8))
    text = jnp.asarray(rng.integers(1, 60, size=(3, 16)).astype(np.int32))
    calibrated = quant_enc.calibrate(quantize_clip_params(params), video, text)

    path = str(tmp_path / "scales.npz")
    save_act_scales(path, calibrated)
    restored = load_act_scales(path, quantize_clip_params(params))

    np.testing.assert_array_equal(
        np.asarray(quant_enc.encode_video(calibrated, video), np.float32),
        np.asarray(quant_enc.encode_video(restored, video), np.float32))
    np.testing.assert_array_equal(
        np.asarray(quant_enc.encode_text(calibrated, text), np.float32),
        np.asarray(quant_enc.encode_text(restored, text), np.float32))




def _int8_pair(family):
    """(float encoder, int8 encoder, image size, text length, vocab)."""
    if family == "clip":
        from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder

        cfg = CLIPConfig.tiny_test()
        return (ClipVideoTextEncoder(cfg, num_frames=2, dtype=jnp.bfloat16),
                ClipVideoTextEncoder(cfg, num_frames=2, dtype=jnp.bfloat16,
                                     quantized=True), 32, 16, 60)
    if family == "slip":
        from fitclip_tpu.models.slip import SlipConfig, SlipVideoTextEncoder

        cfg = SlipConfig.tiny_test()
        return (SlipVideoTextEncoder(cfg, num_frames=2, dtype=jnp.bfloat16),
                SlipVideoTextEncoder(cfg, num_frames=2, dtype=jnp.bfloat16,
                                     quantized=True), 32, 16, 60)
    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, FrozenInTimeVideoTextEncoder)

    cfg = FrozenInTimeConfig.tiny_test()
    return (FrozenInTimeVideoTextEncoder(cfg, num_frames=2, dtype="bfloat16"),
            FrozenInTimeVideoTextEncoder(cfg, num_frames=2, dtype="int8"),
            32, 8, 90)


@pytest.mark.parametrize("family,tower", [("clip", "video"), ("clip", "text"),
                                          ("slip", "video"), ("slip", "text"),
                                          ("frozen_in_time", "video")])
def test_int8_xla_path_matches_bf16_per_family(family, tower):
    """int8 W8A8 through XLA's int8 dot (ops/quant.py) against bf16 on the
    same float weights after calibration on two batches. The bar is 0.998
    here: at these test widths (32-48) each dense sums over few inputs, so
    the relative quantization noise is larger than at the published widths,
    where chip_smoke.py holds ViT-B/16 int8 to 0.999 on the card."""
    from fitclip_tpu.ops.quant import apply_act_scales, merge_act_amax

    float_enc, int8_enc, size, length, vocab = _int8_pair(family)
    params = float_enc.init_params(jax.random.PRNGKey(0))
    qparams = int8_enc.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)

    def batch():
        video = rng.integers(0, 256, size=(3, 2, size, size, 3)).astype(np.uint8)
        text = rng.integers(1, vocab, size=(3, length)).astype(np.int32)
        return jnp.asarray(video), jnp.asarray(text)

    amax = None
    for video, text in (batch(), batch()):
        amax = merge_act_amax(amax, int8_enc.collect_act_amax(qparams, video, text))
    qparams = apply_act_scales(qparams, amax)
    video, text = batch()
    if tower == "video":
        got, want = int8_enc.encode_video(qparams, video), float_enc.encode_video(params, video)
    else:
        got, want = int8_enc.encode_text(qparams, text), float_enc.encode_text(params, text)
    assert _cosine(got, want).min() >= 0.998
