#!/usr/bin/env python
"""Trace-decompose the contrastive CLIP ViT-B/16 train step on the GPU.

    python scripts/profile_train.py [--batch 16] [--remat] [--steps 3]

Traces a few steps with jax.profiler and aggregates the GPU kernel time by
category: matmuls (cuBLAS) and their fusions, cuDNN attention, copies and
relayouts, collectives and other fusions. Prints a JSON summary, then the
top-20 ops by total time.
"""

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _trace_util import trace_and_aggregate


def categorize(name: str) -> str:
    lower = name.lower()
    if "cudnn" in lower or "custom-call" in lower:
        return "cudnn_attention"
    if "fusion" in lower and ("conv" in lower or "dot" in lower or "gemm" in lower):
        return "matmul_fusion"
    # cuBLAS kernels on Hopper are named nvjet_* / *gemm* / cutlass*.
    if (lower.startswith(("dot", "nvjet")) or "gemm" in lower
            or "cutlass" in lower or "convolution" in lower):
        return "matmul"
    if ("transpose" in lower or "copy" in lower or "memcpy" in lower
            or "bitcast" in lower):
        return "relayout"
    if "all-reduce" in lower or "all-gather" in lower:
        return "collective"
    if "fusion" in lower:
        return "fusion_other"
    return "other"


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.training.state import init_train_state, make_optimizer
    from fitclip_tpu.training.steps import make_contrastive_train_step

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=os.path.join("chiprun_out", "train_trace"))
    args = parser.parse_args()

    encoder = ClipVideoTextEncoder(CLIPConfig.vit_b_16(), num_frames=4,
                                   dtype=jnp.bfloat16, remat=args.remat)
    optimizer = make_optimizer(3e-6, fused=True)
    state = jax.device_put(init_train_state(
        encoder.init_params(jax.random.PRNGKey(0)), optimizer))
    step = jax.jit(make_contrastive_train_step(encoder, optimizer))
    rng = np.random.default_rng(0)
    ids = np.zeros((args.batch, 77), np.int32)
    ids[:, 0], ids[:, 1:20], ids[:, 20] = 49406, 100, 49407
    batch = jax.device_put({
        "video": rng.integers(0, 256, (args.batch, 4, 224, 224, 3), np.uint8),
        "text": ids})

    per_op, steps = trace_and_aggregate(
        lambda: step(state, batch)[1]["loss/train"], args.out, calls=args.steps)
    per_cat = defaultdict(float)
    for name, ms in per_op.items():
        per_cat[categorize(name)] += ms
    total = sum(per_cat.values())
    print(json.dumps({
        "config": {"batch": args.batch, "remat": args.remat, "steps": steps},
        "total_device_ms": round(total, 2),
        "ms_per_step": round(total / steps, 2),
        "by_category_ms": {k: round(v, 2) for k, v in
                           sorted(per_cat.items(), key=lambda kv: -kv[1])},
    }), flush=True)
    for name, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[:20]:
        print(json.dumps({"op": name[:120], "ms": round(ms, 3),
                          "ms_per_step": round(ms / steps, 3)}), flush=True)


if __name__ == "__main__":
    main()
