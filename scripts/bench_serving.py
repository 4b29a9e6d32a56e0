#!/usr/bin/env python
"""Served eval throughput: concurrent clients through the dynamic batcher
(fitclip_tpu/serving) over the calibrated int8 CLIP ViT-B/16 — the
online-serving counterpart of bench.py's offline number.

Measured end-to-end: submit -> coalesce -> bucket-pad -> device call -> ONE
whole-batch host fetch -> future fan-out. Wall-clock over all requests is
the throughput; per-request latency is reported at p50/p95. The result
names the device.

Env: BENCH_CLIENTS (default 64), BENCH_REQUESTS total (default 512),
BENCH_BUCKET (default 32 — single bucket, one compile),
BENCH_WAIT_MS (default 5), BENCH_FETCH_WORKERS (default 2).
"""
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.models.clip.model import fold_pixel_normalization
    from fitclip_tpu.ops.quant import quantize_clip_params
    from fitclip_tpu.serving import BatchServer
    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.utils.benchmarking import device_summary

    device = device_summary()
    enable_compilation_cache()
    clients = int(os.environ.get("BENCH_CLIENTS", "64"))
    total = int(os.environ.get("BENCH_REQUESTS", "512"))
    bucket = int(os.environ.get("BENCH_BUCKET", "32"))
    wait_ms = float(os.environ.get("BENCH_WAIT_MS", "5"))

    encoder = ClipVideoTextEncoder(CLIPConfig.vit_b_16(), num_frames=4,
                                   dtype=jnp.bfloat16,
                                   pixel_normalization_folded=True,
                                   quantized=True)
    params = ClipVideoTextEncoder(
        CLIPConfig.vit_b_16(), num_frames=4,
        dtype=jnp.bfloat16).init_params(jax.random.PRNGKey(0))
    params = fold_pixel_normalization(params, encoder.preprocess.mean,
                                      encoder.preprocess.std)
    rng = np.random.default_rng(0)
    calib_video = jnp.asarray(rng.integers(
        0, 256, size=(8, 4, 224, 224, 3), dtype=np.uint8))
    calib_text = jnp.asarray(
        rng.integers(1, 49408, size=(32, 77)).astype(np.int32))
    qparams = encoder.calibrate(quantize_clip_params(params),
                                calib_video, calib_text)
    qparams = jax.device_put(qparams)

    encode_jit = jax.jit(encoder.encode_video)
    server = BatchServer(lambda v: encode_jit(qparams, v),
                         item_shape=(4, 224, 224, 3), dtype=np.uint8,
                         bucket_sizes=(bucket,), max_wait_ms=wait_ms,
                         queue_size=4 * total,
                         fetch_workers=int(
                             os.environ.get("BENCH_FETCH_WORKERS", "2")))
    server.start()  # one bucket -> one warmup compile

    base = rng.integers(0, 250, size=(4, 224, 224, 3), dtype=np.uint8)
    latencies = []
    lat_lock = threading.Lock()
    counter = iter(range(total))
    counter_lock = threading.Lock()

    def client() -> None:
        while True:
            with counter_lock:
                i = next(counter, None)
            if i is None:
                return
            t0 = time.monotonic()
            server.submit(base).result(timeout=600)
            with lat_lock:
                latencies.append(time.monotonic() - t0)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    server.stop()

    lat_ms = np.sort(np.asarray(latencies)) * 1e3
    print(json.dumps({
        "metric": "served_eval_throughput",
        "value": total / wall,
        "unit": "clips/s",
        "clients": clients, "requests": total, "bucket": bucket,
        "mean_batch_fill": round(server.stats.mean_batch_fill, 4),
        "batches": server.stats.batches,
        "latency_p50_ms": round(float(lat_ms[len(lat_ms) // 2]), 1),
        "latency_p95_ms": round(float(lat_ms[int(len(lat_ms) * 0.95)]), 1),
        "device": device,
    }))


if __name__ == "__main__":
    main()
