#!/usr/bin/env python
"""Device-trace the CLIP RN50 eval forward and aggregate per-op time;
trace plumbing in _trace_util.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _trace_util import print_aggregate, trace_and_aggregate


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip.resnet_clip import (RESNET_PRESETS,
                                                     ResNetClipVideoTextEncoder)

    batch = int(os.environ.get("BENCH_CLIPS", "32"))
    encoder = ResNetClipVideoTextEncoder(RESNET_PRESETS["RN50"], num_frames=4,
                                         dtype=jnp.bfloat16)
    params = jax.device_put(encoder.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.normal(size=(batch, 4, 224, 224, 3)).astype(np.float32))

    encode = jax.jit(encoder.encode_video)
    per_op, calls = trace_and_aggregate(
        lambda: encode(params, video), os.path.join("chiprun_out", "rn50_trace"))
    print_aggregate(per_op, calls, batch)


if __name__ == "__main__":
    main()
