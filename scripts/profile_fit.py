#!/usr/bin/env python
"""Device-trace the Frozen-in-Time bf16 eval forward and aggregate per-op
time; plumbing in _trace_util.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _trace_util import print_aggregate, trace_and_aggregate


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeVideoTextEncoder

    batch = int(os.environ.get("BENCH_CLIPS", "32"))
    # BENCH_DTYPE=int8 traces the W8A8 video-tower path.
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    encoder = FrozenInTimeVideoTextEncoder(
        num_frames=4, dtype=jnp.bfloat16 if dtype == "bfloat16" else dtype)
    params = jax.device_put(encoder.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.normal(size=(batch, 4, 224, 224, 3)).astype(np.float32))
    if getattr(encoder, "quantized", False):
        params = jax.device_put(
            encoder.calibrate(jax.device_get(params), video[:8]))

    encode = jax.jit(encoder.encode_video)
    per_op, calls = trace_and_aggregate(
        lambda: encode(params, video), os.path.join("chiprun_out", "fit_trace"))
    print_aggregate(per_op, calls, batch)


if __name__ == "__main__":
    main()
