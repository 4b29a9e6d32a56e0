"""Time the attention routes at CLIP ViT-B/16 shapes on the GPU.

    python scripts/bench_attention.py [--clips 64] [--train-clips 32]

Routes, all with bf16 inputs:
- ``xla``: ``jax.nn.dot_product_attention(implementation="xla")``;
- ``cudnn``: cuDNN fused attention (ops/attention.py pads odd lengths by one);
- ``pallas_triton``: JAX's library Pallas-Triton flash attention
  (``jax.experimental.pallas.ops.gpu.attention.mha``). Its blocks are powers
  of two, so the sequence is padded to a multiple of 64 with keys masked by
  segment ids; the padding is part of its time.

Two levels: the attention op alone at the vision (frames, 197, 12, 64) and
causal text (captions, 77, 8, 64) shapes, forward (encode) and forward +
backward (train); then the whole eval encode step and contrastive train step
with the model's attention set to ``xla`` or ``cudnn``. Prints one JSON line
per measurement, each naming the device.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pallas_mha(q, k, v, causal: bool):
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.gpu.attention import BlockSizes, mha

    b, length, _, d = q.shape
    padded = -(-length // 64) * 64
    pad = ((0, 0), (0, padded - length), (0, 0), (0, 0))
    q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
    segments = jnp.broadcast_to((jnp.arange(padded) < length).astype(jnp.int32),
                                (b, padded))
    blocks = BlockSizes(block_q=64, block_k=64, block_q_dkv=64, block_kv_dkv=64,
                        block_q_dq=64, block_kv_dq=64)
    out = mha(q, k, v, segments, sm_scale=d ** -0.5, causal=causal,
              block_sizes=blocks)
    return out[:, :length]


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
    from fitclip_tpu.ops.attention import attention
    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.training.state import init_train_state, make_optimizer
    from fitclip_tpu.training.steps import make_contrastive_train_step
    from fitclip_tpu.utils.benchmarking import device_summary, time_calls

    device = device_summary()
    enable_compilation_cache()

    def emit(**row):
        print(json.dumps({**row, "device": device}), flush=True)

    frames = 4 * args.clips
    routes = {
        "xla": lambda q, k, v, c: attention(q, k, v, causal=c, implementation="xla"),
        "cudnn": lambda q, k, v, c: attention(q, k, v, causal=c, implementation="cudnn"),
        "pallas_triton": pallas_mha,
    }
    for name, shape, causal in (("vision", (frames, 197, 12, 64), False),
                                ("text", (args.clips, 77, 8, 64), True)):
        keys = jax.random.split(jax.random.PRNGKey(0), 4)
        q, k, v, g = (jax.random.normal(kk, shape, jnp.bfloat16) for kk in keys)
        ref = None
        for route, fn in routes.items():
            fwd = jax.jit(lambda q, k, v, g, fn=fn: fn(q, k, v, causal))
            bwd = jax.jit(lambda q, k, v, g, fn=fn: jax.vjp(
                lambda q, k, v: fn(q, k, v, causal), q, k, v)[1](g))
            try:
                out = np.asarray(fwd(q, k, v, g), np.float32)
            except Exception as error:  # a route that does not lower is a result
                emit(bench="attention_op", shape=name, route=route,
                     error=f"{type(error).__name__}: {error}"[:300])
                continue
            if ref is None:
                ref = out
            err = float(np.abs(out - ref).max())
            for phase, f in (("fwd", fwd), ("fwd+bwd", bwd)):
                t = time_calls(lambda f=f: f(q, k, v, g), warmup=3, steps=args.steps)
                emit(bench="attention_op", shape=name, dims=list(shape),
                     causal=causal, route=route, phase=phase,
                     ms=t["median_s"] * 1e3, min_ms=t["min_s"] * 1e3,
                     max_abs_vs_xla=err)

    cfg = CLIPConfig.vit_b_16()
    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.integers(0, 256, (args.clips, 4, 224, 224, 3), np.uint8))
    tv = jnp.asarray(rng.integers(0, 256, (args.train_clips, 4, 224, 224, 3), np.uint8))
    ids = np.zeros((args.train_clips, 77), np.int32)
    ids[:, 0], ids[:, 1:20], ids[:, 20] = 49406, 100, 49407
    batch = {"video": tv, "text": jnp.asarray(ids)}
    for route in ("xla", "cudnn"):
        encoder = ClipVideoTextEncoder(cfg, dtype=jnp.bfloat16)
        encoder.model = dataclasses.replace(encoder.model, attention_impl=route)
        params = jax.device_put(encoder.init_params(jax.random.PRNGKey(0)))
        encode = jax.jit(encoder.encode_video)
        t = time_calls(lambda: encode(params, video), warmup=3, steps=args.steps)
        emit(bench="encode_step", route=route, dtype="bfloat16", clips=args.clips,
             ms=t["median_s"] * 1e3, clips_per_s=args.clips / t["median_s"])
        optimizer = make_optimizer(3e-6, fused=True)
        state = init_train_state(params, optimizer)
        step = jax.jit(make_contrastive_train_step(encoder, optimizer))
        t = time_calls(lambda: step(state, batch)[1]["loss/train"], warmup=3,
                       steps=args.steps)
        emit(bench="train_step", route=route, dtype="bfloat16", clips=args.train_clips,
             ms=t["median_s"] * 1e3, clips_per_s=args.train_clips / t["median_s"])


if __name__ == "__main__":
    main()
