#!/usr/bin/env python
"""Zero-shot video-eval throughput for EVERY encoder family on one card.

bench.py measures the flagship (CLIP ViT-B/16); this accounts for the rest
of the zoo — the eval paths the reference runs through torch CUDA (SURVEY
§2.4): CLIP RN50, SLIP ViT-B/16, Frozen-in-Time, MIL-NCE S3DG, VideoCLIP.
Random-init weights (throughput is weight-agnostic); each family is fed its
OWN eval geometry from its PreprocessSpec, so clips/s numbers are comparable
to a real `command=evaluate` run.

Timed with warm-up calls, then calls ending in ``block_until_ready``
(fitclip_tpu/utils/benchmarking.py). Prints one JSON line per family, each
naming the device.

Usage: python scripts/bench_families.py [family ...]  (default: all)
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _families():
    import jax.numpy as jnp

    from fitclip_tpu.models.clip.resnet_clip import (RESNET_PRESETS,
                                                     ResNetClipVideoTextEncoder)
    from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeVideoTextEncoder
    from fitclip_tpu.models.mil_nce import MilNceVideoTextEncoder
    from fitclip_tpu.models.slip import SlipVideoTextEncoder
    from fitclip_tpu.models.videoclip import VideoClipVideoTextEncoder

    # name -> (builder, default batch, float-twin builder for int8 gates,
    # text vocab size). Batches sized to each family's eval frame count so
    # the video tensor + activations stay comfortably inside device memory.
    return {
        "clip_rn50": (lambda: ResNetClipVideoTextEncoder(
            RESNET_PRESETS["RN50"], num_frames=4, dtype=jnp.bfloat16),
            32, None, 49408),
        "slip_vit_b16": (lambda: SlipVideoTextEncoder(
            num_frames=4, dtype=jnp.bfloat16), 32, None, 49408),
        # int8 W8A8 denses on the SLIP towers (ops/quant.py) — calibrated +
        # cosine-gated against the bf16 path in main().
        "slip_vit_b16_int8": (lambda: SlipVideoTextEncoder(
            num_frames=4, dtype=jnp.bfloat16, quantized=True), 128,
            lambda: SlipVideoTextEncoder(num_frames=4, dtype=jnp.bfloat16), 49408),
        "frozen_in_time": (lambda: FrozenInTimeVideoTextEncoder(
            num_frames=4, dtype=jnp.bfloat16), 32, None, 30522),
        # int8 W8A8 on the SpaceTimeTransformer's qkv/proj/mlp denses (the
        # DistilBERT text tower stays bf16); calibrated + cosine-gated
        # against the bf16 path like the other int8 rows.
        "frozen_in_time_int8": (lambda: FrozenInTimeVideoTextEncoder(
            num_frames=4, dtype="int8"), 32,
            lambda: FrozenInTimeVideoTextEncoder(
                num_frames=4, dtype=jnp.bfloat16), 30522),
        "mil_nce_s3dg": (lambda: MilNceVideoTextEncoder(dtype=jnp.bfloat16),
                         16, None, 66250),
        "videoclip": (lambda: VideoClipVideoTextEncoder(dtype=jnp.bfloat16),
                      8, None, 30522),
        # W8A8 on the S3DG tower's matmul-shaped convs (merged
        # branch stems / b3 / conv_2b / FC — models/s3dg_fast.py); gated
        # int8-vs-bf16 like the other int8 rows.
        "mil_nce_s3dg_int8": (lambda: MilNceVideoTextEncoder(dtype="int8"),
                              16,
                              lambda: MilNceVideoTextEncoder(dtype=jnp.bfloat16),
                              66250),
        "videoclip_int8": (lambda: VideoClipVideoTextEncoder(dtype="int8"),
                           8,
                           lambda: VideoClipVideoTextEncoder(dtype=jnp.bfloat16),
                           30522),
    }


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.utils.benchmarking import device_summary, time_calls

    selected = sys.argv[1:] or None
    if selected:
        unknown = set(selected) - set(_families())
        if unknown:
            sys.exit(f"unknown families {sorted(unknown)}; "
                     f"choose from {sorted(_families())}")
    device = device_summary()
    enable_compilation_cache()
    rng = np.random.default_rng(0)

    for name, (build, default_batch, float_build, vocab) in _families().items():
        if selected and name not in selected:
            continue
        batch_clips = int(os.environ.get("BENCH_CLIPS", default_batch))
        encoder = build()
        spec = encoder.preprocess
        frames = spec.pad_to_min_frames or spec.num_frames
        size = spec.image_size
        params = jax.device_put(encoder.init_params(jax.random.PRNGKey(0)))
        video = jnp.asarray(rng.normal(
            size=(batch_clips, frames, size, size, 3)).astype(np.float32))

        if getattr(encoder, "quantized", False):
            # Calibrate the activation scales on a bench-batch slice plus a
            # synthetic text batch, then gate int8-vs-bf16 embedding cosine
            # on the card before timing (same policy as bench.py).
            # The float twin shares the init PRNG key, so its float weights
            # are exactly the pre-quantization ones.
            ids = rng.integers(1, vocab, size=(8, 77)).astype(np.int32)
            text = jnp.asarray(ids)
            params = jax.device_put(
                encoder.calibrate(jax.device_get(params), video[:8], text))
            float_enc = float_build()
            fparams = jax.device_put(float_enc.init_params(jax.random.PRNGKey(0)))

            def _cos_gate(a, b):
                a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
                return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                                                 np.linalg.norm(b, axis=-1))).min())

            gate = _cos_gate(jax.jit(encoder.encode_video)(params, video[:4]),
                             jax.jit(float_enc.encode_video)(fparams, video[:4]))
            assert gate > 0.999, f"{name} int8-vs-bf16 mismatch: {gate}"
            gate_t = _cos_gate(jax.jit(encoder.encode_text)(params, text),
                               jax.jit(float_enc.encode_text)(fparams, text))
            assert gate_t > 0.999, f"{name} int8-vs-bf16 text mismatch: {gate_t}"

        encode = jax.jit(encoder.encode_video)
        t = time_calls(lambda p=params, v=video: encode(p, v), warmup=3, steps=10)
        print(json.dumps({
            "metric": f"{name}_eval_throughput",
            "value": batch_clips / t["median_s"],
            "unit": "clips/s",
            "frames_per_clip": int(frames),
            "image_size": int(size),
            "batch_clips": batch_clips,
            "device": device,
        }), flush=True)


if __name__ == "__main__":
    main()
