#!/usr/bin/env python
"""Device-trace the CLIP ViT-B/16 eval encode at production shape and
aggregate per-op time.

    python scripts/profile_eval.py [--clips 128] [--dtype bfloat16|int8|float32]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _trace_util import print_aggregate, trace_and_aggregate


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=128)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "int8", "float32"))
    parser.add_argument("--out", default=os.path.join("chiprun_out", "eval_trace"))
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.ops.quant import quantize_clip_params

    quantized = args.dtype == "int8"
    encoder = ClipVideoTextEncoder(
        CLIPConfig.vit_b_16(), num_frames=4, quantized=quantized,
        dtype=jnp.float32 if args.dtype == "float32" else jnp.bfloat16)
    params = encoder.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.integers(0, 256, size=(args.clips, 4, 224, 224, 3),
                                     dtype=np.uint8))
    if quantized:
        params = encoder.calibrate(quantize_clip_params(params), video[:8])
    params = jax.device_put(params)
    encode = jax.jit(encoder.encode_video)
    per_op, calls = trace_and_aggregate(lambda: encode(params, video), args.out)
    print_aggregate(per_op, calls, args.clips)


if __name__ == "__main__":
    main()
