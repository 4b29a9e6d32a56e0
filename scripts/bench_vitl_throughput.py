#!/usr/bin/env python
"""CLIP ViT-L/14 int8 eval throughput on one card — the scaling companion to
bench.py's ViT-B/16 headline, with the same int8-vs-bf16 cosine gate.

    BENCH_CLIPS=32 BENCH_IMAGE_SIZE=224|336 python scripts/bench_vitl_throughput.py

BENCH_IMAGE_SIZE=336 is the clip_vit_l_14_336px config: L=577 tokens.
Prints one JSON line naming the device."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.ops.quant import quantize_clip_params
    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.utils.benchmarking import device_summary, time_calls

    device = device_summary()
    enable_compilation_cache()
    batch_clips = int(os.environ.get("BENCH_CLIPS", "32"))
    image_size = int(os.environ.get("BENCH_IMAGE_SIZE", "224"))
    config = CLIPConfig.vit_l_14(image_size=image_size)
    bf16 = ClipVideoTextEncoder(config, num_frames=4, dtype=jnp.bfloat16)
    params = bf16.init_params(jax.random.PRNGKey(0))
    encoder = ClipVideoTextEncoder(config, num_frames=4, dtype=jnp.bfloat16,
                                   quantized=True)
    qp = quantize_clip_params(params)
    rng = np.random.default_rng(0)
    video = jnp.asarray(
        rng.integers(0, 256, size=(batch_clips, 4, image_size, image_size, 3),
                     dtype=np.uint8))
    calib_ids = jnp.asarray(rng.integers(1, 49408, size=(8, 77)).astype(np.int32))
    qp = jax.device_put(encoder.calibrate(qp, video[:2], calib_ids))

    encode = jax.jit(encoder.encode_video)
    emb_q = np.asarray(encode(qp, video[:2]), np.float32)
    emb_b = np.asarray(jax.jit(bf16.encode_video)(params, video[:2]), np.float32)
    cos = float(((emb_q * emb_b).sum(-1)
                 / (np.linalg.norm(emb_q, axis=-1)
                    * np.linalg.norm(emb_b, axis=-1))).min())
    assert cos > 0.999, f"int8-vs-bf16 cosine gate failed: {cos}"

    t = time_calls(lambda: encode(qp, video), warmup=3, steps=10)
    print(json.dumps({"metric": f"clip_vit_l14_{image_size}px_eval_throughput",
                      "value": batch_clips / t["median_s"],
                      "unit": "clips/s",
                      "cosine_gate": cos,
                      "batch_clips": batch_clips,
                      "device": device}))


if __name__ == "__main__":
    main()
