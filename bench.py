"""Headline benchmark: CLIP ViT-B/16 eval encode and train step on the GPU.

    python bench.py [--clips 64] [--train-clips 32] [--steps 20]

Eval encode: uint8 frames in device memory -> pixel-normalization-folded
CLIP ViT-B/16 -> L2-normalized frame-mean clip embeddings; 4 uniform frames
per clip at 224x224 (the reference eval configuration,
aligner/encoder/clip_video_text_encoder.py:69,106-133). Timed in bf16, in
calibrated int8 (W8A8 XLA denses, ops/quant.py) and in fp32. The int8 cell
is gated: its embeddings must reach cosine >= 0.999 against bf16.

Train step: the contrastive step (forward, backward, fused AdamW) at
``--train-clips`` clips of 4 frames with 77-token captions, bf16 compute.

Each cell is timed with warm-up calls, then calls that end in
``block_until_ready`` (utils/benchmarking.py), and reports
``compiled.memory_analysis()``. Prints one JSON line per cell, each naming
the device; fails when JAX finds no accelerator.
"""

import argparse
import json

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=64)
    parser.add_argument("--train-clips", type=int, default=32)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.models.clip.model import fold_pixel_normalization
    from fitclip_tpu.ops.quant import quantize_clip_params
    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.training.state import init_train_state, make_optimizer
    from fitclip_tpu.training.steps import make_contrastive_train_step
    from fitclip_tpu.utils.benchmarking import (device_summary, memory_summary,
                                                time_calls)

    device = device_summary()
    enable_compilation_cache()
    cfg = CLIPConfig.vit_b_16()
    rng = np.random.default_rng(0)

    def emit(**row):
        print(json.dumps({**row, "device": device}), flush=True)

    def cosine_min(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                         * np.linalg.norm(b, axis=-1))).min())

    video = jnp.asarray(rng.integers(0, 256, (args.clips, 4, 224, 224, 3), np.uint8))
    ids = np.zeros((32, 77), np.int32)
    ids[:, 0], ids[:, 1:20], ids[:, 20] = 49406, rng.integers(1, 49406, (32, 19)), 49407
    calib_text = jnp.asarray(ids)

    float_encoder = ClipVideoTextEncoder(cfg, pixel_normalization_folded=True)
    params = fold_pixel_normalization(
        float_encoder.init_params(jax.random.PRNGKey(0)),
        float_encoder.preprocess.mean, float_encoder.preprocess.std)
    cells = {}
    for dtype in ("bfloat16", "int8", "float32"):
        quantized = dtype == "int8"
        encoder = ClipVideoTextEncoder(
            cfg, dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16,
            pixel_normalization_folded=True, quantized=quantized)
        cell_params = params
        if quantized:
            cell_params = encoder.calibrate(quantize_clip_params(params),
                                            video[:8], calib_text)
        cell_params = jax.device_put(cell_params)
        encode = jax.jit(encoder.encode_video)
        cells[dtype] = np.asarray(encode(cell_params, video[:8]))
        extra = {}
        if quantized:
            extra["cosine_vs_bf16"] = cosine_min(cells["int8"], cells["bfloat16"])
            if extra["cosine_vs_bf16"] < 0.999:
                raise AssertionError(f"int8 vs bf16 cosine {extra['cosine_vs_bf16']}")
        t = time_calls(lambda: encode(cell_params, video), warmup=3, steps=args.steps)
        memory = memory_summary(encode.lower(cell_params, video).compile())
        emit(bench="clip_vit_b16_encode", dtype=dtype, clips=args.clips,
             ms=t["median_s"] * 1e3, min_ms=t["min_s"] * 1e3,
             clips_per_s=args.clips / t["median_s"],
             first_call_s=t["first_call_s"], memory=memory, **extra)

    encoder = ClipVideoTextEncoder(cfg, dtype=jnp.bfloat16)
    train_params = encoder.init_params(jax.random.PRNGKey(0))
    optimizer = make_optimizer(3e-6, fused=True)
    state = jax.device_put(init_train_state(train_params, optimizer))
    ids = np.zeros((args.train_clips, 77), np.int32)
    ids[:, 0], ids[:, 1:20], ids[:, 20] = 49406, 100, 49407
    batch = jax.device_put({
        "video": rng.integers(0, 256, (args.train_clips, 4, 224, 224, 3), np.uint8),
        "text": ids})
    step = jax.jit(make_contrastive_train_step(encoder, optimizer))
    t = time_calls(lambda: step(state, batch)[1]["loss/train"], warmup=3,
                   steps=args.steps)
    memory = memory_summary(step.lower(state, batch).compile())
    emit(bench="clip_vit_b16_train_step", dtype="bfloat16", clips=args.train_clips,
         ms=t["median_s"] * 1e3, min_ms=t["min_s"] * 1e3,
         clips_per_s=args.train_clips / t["median_s"],
         first_call_s=t["first_call_s"], memory=memory,
         peak_bytes_in_use=jax.devices()[0].memory_stats().get("peak_bytes_in_use"))


if __name__ == "__main__":
    main()
