"""Parity of the restructured fast-eval S3DG forward (models/s3dg_fast.py)
against the Flax module: folded BN + merged branch convs + single gating
multiply must not change the math (reference semantics:
aligner/encoder/s3dg.py:11-218)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.models.s3dg import S3DG
from fitclip_tpu.models.s3dg_fast import s3dg_fast_apply


def _params_with_real_stats(model, rng_seed=0):
    params = model.init(jax.random.PRNGKey(rng_seed),
                        jnp.zeros((1, 16, 32, 32, 3)))["params"]
    rng = np.random.default_rng(rng_seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        name = getattr(path[-1], "key", "")
        if name == "running_mean":
            leaf = jnp.asarray((rng.normal(size=leaf.shape) * 0.1).astype(np.float32))
        elif name == "running_var":
            leaf = jnp.asarray((1.0 + rng.random(leaf.shape) * 0.5).astype(np.float32))
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-4), (jnp.bfloat16, 0.05)])
def test_fast_matches_flax(dtype, atol):
    model = S3DG(dtype=dtype)
    params = _params_with_real_stats(model)
    rng = np.random.default_rng(1)
    video = jnp.asarray(rng.random(size=(2, 16, 32, 32, 3)).astype(np.float32))

    ref = np.asarray(
        jax.jit(lambda p, v: model.apply({"params": p}, v))(params, video),
        np.float32)
    fast = np.asarray(
        jax.jit(lambda p, v: s3dg_fast_apply(p, v, dtype=dtype))(params, video),
        np.float32)
    # Identical contraction sets; only fusion boundaries and the fp32 BN
    # fold rounding differ.
    np.testing.assert_allclose(fast, ref, atol=atol * np.abs(ref).max(), rtol=0)
    cos = ((ref * fast).sum(-1) /
           (np.linalg.norm(ref, axis=-1) * np.linalg.norm(fast, axis=-1)))
    assert cos.min() > 0.999


def test_fast_path_wired_into_mil_nce_bf16():
    from fitclip_tpu.models.mil_nce import MilNceVideoTextEncoder

    fast_enc = MilNceVideoTextEncoder(dtype=jnp.bfloat16)
    assert fast_enc.fast  # bf16 eval defaults to the restructured forward
    slow_enc = MilNceVideoTextEncoder(dtype=jnp.bfloat16, fast=False)
    assert not slow_enc.fast
    assert not MilNceVideoTextEncoder(dtype=jnp.float32).fast

    params = fast_enc.init_params(jax.random.PRNGKey(0))
    video = jnp.asarray(
        np.random.default_rng(2).random((2, 16, 32, 32, 3)).astype(np.float32))
    a = np.asarray(fast_enc.encode_video(params, video), np.float32)
    b = np.asarray(slow_enc.encode_video(params, video), np.float32)
    cos = ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1)))
    assert cos.min() > 0.999


def test_fast_path_wired_into_videoclip_bf16():
    from fitclip_tpu.models.videoclip import VideoClipVideoTextEncoder

    fast_enc = VideoClipVideoTextEncoder(dtype=jnp.bfloat16, num_frames=32)
    slow_enc = VideoClipVideoTextEncoder(dtype=jnp.bfloat16, num_frames=32,
                                         fast=False)
    assert fast_enc.fast and not slow_enc.fast
    params = fast_enc.init_params(jax.random.PRNGKey(0))
    video = jnp.asarray(
        np.random.default_rng(3).random((1, 32, 32, 32, 3)).astype(np.float32))
    a = np.asarray(fast_enc.encode_video(params, video), np.float32)
    b = np.asarray(slow_enc.encode_video(params, video), np.float32)
    cos = ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1)))
    assert cos.min() > 0.999


def test_int8_sites_calibrate_and_match_bf16():
    """Round-4 W8A8 path: quantize_s3dg_fast + K-batch calibration through
    the generic ops/quant machinery must stay cosine > 0.99 vs the bf16
    fast forward, and the scales must roundtrip through save/load."""
    from fitclip_tpu.models.s3dg_fast import quantize_s3dg_fast
    from fitclip_tpu.ops.quant import (apply_act_scales, merge_act_amax,
                                       load_act_scales, save_act_scales)

    model = S3DG(dtype=jnp.bfloat16)
    params = _params_with_real_stats(model)
    rng = np.random.default_rng(2)
    video = jnp.asarray(rng.random(size=(2, 16, 32, 32, 3)).astype(np.float32))

    qparams = quantize_s3dg_fast(params, from_block=None)  # every site: the ablation arm
    # Uncalibrated scales are the all-ones sentinel.
    assert float(np.ptp(qparams["int8"]["mixed_3b"]["merged"]["act_scale"])) == 0.0

    amax = None
    for seed in (3, 4):
        batch = jnp.asarray(np.random.default_rng(seed).random(
            size=(1, 16, 32, 32, 3)).astype(np.float32))
        collect: dict = {}
        s3dg_fast_apply(qparams, batch, dtype=jnp.bfloat16, int8=True,
                        collect=collect)
        amax = merge_act_amax(amax, {"int8": collect})
    qparams = apply_act_scales(qparams, amax)
    assert float(np.ptp(np.concatenate(
        [np.ravel(n["act_scale"]) for _, n in
         [(p, q) for p, q in _walk_scales(qparams["int8"])]]))) > 0.0

    bf16 = np.asarray(
        jax.jit(lambda p, v: s3dg_fast_apply(p, v, dtype=jnp.bfloat16))(
            params, video), np.float32)
    int8 = np.asarray(
        jax.jit(lambda p, v: s3dg_fast_apply(p, v, dtype=jnp.bfloat16,
                                             int8=True))(qparams, video),
        np.float32)
    cos = ((bf16 * int8).sum(-1) /
           (np.linalg.norm(bf16, axis=-1) * np.linalg.norm(int8, axis=-1)))
    assert cos.min() > 0.99, cos

    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scales.npz")
        save_act_scales(path, qparams)
        fresh = quantize_s3dg_fast(params, from_block=None)
        fresh = load_act_scales(path, fresh)
        np.testing.assert_array_equal(
            fresh["int8"]["mixed_5c"]["b3"]["act_scale"],
            qparams["int8"]["mixed_5c"]["b3"]["act_scale"])


def _walk_scales(node, prefix=""):
    for key, value in node.items():
        if isinstance(value, dict):
            if "act_scale" in value:
                yield f"{prefix}{key}", value
            else:
                yield from _walk_scales(value, f"{prefix}{key}/")


def test_int8_wired_into_encoders():
    """++encoder.dtype=int8 flags the MIL-NCE / VideoCLIP encoders quantized
    (bf16 compute elsewhere) and their collect_act_amax trees mirror params."""
    from fitclip_tpu.models.mil_nce import MilNceVideoTextEncoder
    from fitclip_tpu.models.videoclip import BertConfig, VideoClipVideoTextEncoder

    enc = MilNceVideoTextEncoder(dtype="int8")
    assert enc.quantized and enc.fast and enc.dtype == jnp.bfloat16
    params = enc.quantize_params(enc.init_params(jax.random.PRNGKey(0)))
    video = jnp.asarray(np.random.default_rng(5).random(
        size=(1, 16, 32, 32, 3)).astype(np.float32))
    amax = enc.collect_act_amax(params, video)
    assert "fc" in amax["video"]["int8"]
    assert "mixed_3b" not in amax["video"]["int8"]  # early stages stay bf16 by default
    emb = enc.encode_video(params, video)
    assert emb.shape == (1, 512)

    vc = VideoClipVideoTextEncoder(BertConfig.tiny_test(vocab_size=30),
                                   num_frames=16, frames_per_clip=8,
                                   dtype="int8")
    assert vc.quantized and vc.model.dtype == jnp.bfloat16
    vparams = vc.quantize_params(vc.init_params(jax.random.PRNGKey(1)))
    vamax = vc.collect_act_amax(vparams, video)
    assert "mixed_4b" in vamax["s3dg"]["int8"]  # default from_block skips early stages
    vemb = vc.encode_video(vparams, video)
    assert vemb.shape == (1, vc.config.hidden_size)
