#!/usr/bin/env python
"""Device-trace the MIL-NCE S3DG bf16 eval forward and aggregate per-op
time. Drives the S3DG/VideoCLIP optimization work (the S3DG tower dominates
both families' eval cost). Plumbing in _trace_util.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _trace_util import aggregate_by_category, print_aggregate, trace_and_aggregate


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.mil_nce import MilNceVideoTextEncoder

    batch = int(os.environ.get("BENCH_CLIPS", "16"))
    # S3DG_DTYPE=int8 traces the W8A8 matmul-conv path (calibrated on a
    # slice of the bench batch first, mirroring bench_families).
    dtype = os.environ.get("S3DG_DTYPE", "bfloat16")
    encoder = MilNceVideoTextEncoder(dtype=dtype if dtype == "int8"
                                     else jnp.dtype(dtype))
    params = jax.device_put(encoder.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    video = jnp.asarray(
        rng.normal(size=(batch, 16, 224, 224, 3)).astype(np.float32))
    if getattr(encoder, "quantized", False):
        params = jax.device_put(
            encoder.calibrate(jax.device_get(params), video[:8]))

    encode = jax.jit(encoder.encode_video)
    per_op, calls = trace_and_aggregate(
        lambda: encode(params, video), os.path.join("chiprun_out", "s3dg_trace"))
    print_aggregate(per_op, calls, batch)
    cat = aggregate_by_category(per_op, calls)
    import json
    for name, ms in sorted(cat.items(), key=lambda kv: -kv[1])[:12]:
        print(json.dumps({"category": name, "ms_per_call": round(ms, 3)}),
              flush=True)


if __name__ == "__main__":
    main()
