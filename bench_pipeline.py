"""End-to-end input-pipeline benchmark: sustained clips/sec through
native-decode -> frame-sample -> transform -> device_put -> encode with the
threaded prefetching loader (SURVEY §7 "hard parts" #1: at target throughput
the decoder, not the model, is the suspected bottleneck — this measures it).

Writes synthetic videos to a temp dir (once), then times the REAL eval loop:
DataLoader (native FFmpeg decoder when built, OpenCV otherwise) feeding the
jitted encoder, prefetch depth hiding decode under device compute. Prints ONE
JSON line naming the device; `pipeline_fraction` is pipeline clips/s divided
by the model-only clips/s measured in the same process — 1.0 means decode
fully hides.

Env knobs: BENCH_CLIPS (videos, default 256), BENCH_BATCH (default 64),
BENCH_THREADS (default cpu_count), BENCH_DTYPE (int8|bf16, default int8),
BENCH_VIDEO_DIR (reuse an existing directory of videos), BENCH_SHORT_SIDE
(decode-time swscale downscale, e.g. 224 — the production
++data.decode_short_side knob), BENCH_RES (source video size WxH,
default 320x240).
"""

import json
import os
import tempfile
import time

import numpy as np


def _write_videos(directory: str, count: int, seconds: float = 4.0,
                  fps: float = 25.0, size=(320, 240)) -> None:
    import cv2

    width, height = size
    xs = np.linspace(0, 2 * np.pi, width, dtype=np.float32)[None, :]
    ys = np.linspace(0, 2 * np.pi, height, dtype=np.float32)[:, None]
    for index in range(count):
        path = os.path.join(directory, f"clip{index:05d}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
        assert writer.isOpened()
        phase = 2 * np.pi * index / count
        for frame_index in range(int(seconds * fps)):
            t = frame_index / fps
            frame = np.stack([
                127.5 + 127.5 * np.cos(xs + phase + t)[0:1].repeat(height, 0),
                127.5 + 127.5 * np.sin(ys + 2 * phase + 0.5 * t).repeat(width, 1),
                np.full((height, width), 64 + (index * 7) % 128, np.float32),
            ], axis=2).astype(np.uint8)
            writer.write(frame)
        writer.release()


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.data.data_module import build_pipeline
    from fitclip_tpu.data.loader import DataLoader
    from fitclip_tpu.data.video_dataset import Collator, VideoDataset
    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.models.clip.model import fold_pixel_normalization
    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.utils.benchmarking import device_summary, time_calls

    device = device_summary()
    enable_compilation_cache()

    num_clips = int(os.environ.get("BENCH_CLIPS", "256"))
    batch_size = int(os.environ.get("BENCH_BATCH", "64"))
    num_threads = int(os.environ.get("BENCH_THREADS", str(os.cpu_count() or 8)))
    bench_dtype = os.environ.get("BENCH_DTYPE", "int8")
    short_side = int(os.environ.get("BENCH_SHORT_SIDE", "0")) or None
    frame_cache = os.environ.get("BENCH_FRAME_CACHE") or None
    res = os.environ.get("BENCH_RES", "320x240")
    size = tuple(int(v) for v in res.split("x"))

    video_dir = os.environ.get("BENCH_VIDEO_DIR")
    if video_dir and os.path.isdir(video_dir) and os.listdir(video_dir):
        pass
    else:
        video_dir = os.path.join(tempfile.gettempdir(),
                                 f"fitclip_bench_videos_{num_clips}_{res}")
        os.makedirs(video_dir, exist_ok=True)
        if len(os.listdir(video_dir)) < num_clips:
            _write_videos(video_dir, num_clips, size=size)

    quantized = bench_dtype == "int8"
    encoder = ClipVideoTextEncoder(CLIPConfig.vit_b_16(), num_frames=4,
                                   dtype=jnp.bfloat16,
                                   pixel_normalization_folded=True,
                                   quantized=quantized)
    float_params = ClipVideoTextEncoder(
        CLIPConfig.vit_b_16(), num_frames=4, dtype=jnp.bfloat16,
        pixel_normalization_folded=True).init_params(jax.random.PRNGKey(0))
    float_params = fold_pixel_normalization(float_params, encoder.preprocess.mean,
                                            encoder.preprocess.std)
    rng = np.random.default_rng(0)
    if quantized:
        from fitclip_tpu.ops.quant import quantize_clip_params

        params = quantize_clip_params(float_params)
        calib = jnp.asarray(rng.integers(0, 256, size=(8, 4, 224, 224, 3),
                                         dtype=np.uint8))
        params = encoder.calibrate(params, calib)
    else:
        params = float_params
    params = jax.device_put(params)

    @jax.jit
    def encode(params, video):
        return encoder.encode_video(params, video)

    class BenchDataset(VideoDataset):
        def _get_target(self, video_idx):
            return 0

    paths = sorted(os.path.join(video_dir, f) for f in os.listdir(video_dir))[:num_clips]
    dataset = BenchDataset(paths, pipelines=build_pipeline(encoder, train=False),
                           decode_short_side=short_side,
                           frame_cache_dir=frame_cache)
    if os.environ.get("BENCH_TS"):
        # Teacher-student mode: the MixedBatchLoader (labeled + unlabeled
        # sources, fixed per-batch composition) with its thread-pool prefetch
        # — the teacher-student feed. Mixed batches are consumed as one
        # concatenated encode, mirroring the distillation student forward.
        from fitclip_tpu.data.data_module_group import MixedBatchLoader

        half = max(1, batch_size // 2)
        collate = Collator(tokenizers=None, pad_batch=True)
        sub_loaders = {
            name: DataLoader(BenchDataset(
                paths, pipelines=build_pipeline(encoder, train=False),
                decode_short_side=short_side), batch_size=half, collate=collate)
            for name in ("labeled", "unlabeled")}
        loader = MixedBatchLoader(sub_loaders,
                                  {"labeled": half, "unlabeled": half},
                                  num_threads=num_threads, prefetch_batches=4)

        def batch_video(batch):
            return np.concatenate([batch["labeled"]["video"],
                                   batch["unlabeled"]["video"]])
    else:
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                            drop_last=True, num_threads=num_threads,
                            prefetch_batches=4,
                            collate=Collator(tokenizers=None, pad_batch=True))

        def batch_video(batch):
            return batch["video"]

    # Warm-up epoch: compile + OS page cache for the video files.
    outputs = []
    for batch in loader:
        outputs.append(encode(params, jnp.asarray(batch_video(batch))))
    jax.block_until_ready(outputs)

    # Timed epochs of the REAL pipeline (decode -> transform -> device -> encode).
    best_pipeline = 0.0
    for _ in range(2):
        start = time.perf_counter()
        outputs = []
        clips = 0
        for batch in loader:
            video = jnp.asarray(batch_video(batch))
            clips += video.shape[0]
            outputs.append(encode(params, video))
        jax.block_until_ready(outputs)
        elapsed = time.perf_counter() - start
        best_pipeline = max(best_pipeline, clips / elapsed)

    # Model-only reference in the same process/config.
    reference_video = jnp.asarray(rng.integers(
        0, 256, size=(batch_size, 4, 224, 224, 3), dtype=np.uint8))
    t = time_calls(lambda: encode(params, reference_video), warmup=3, steps=10)
    model_only = batch_size / t["median_s"]

    print(json.dumps({
        "metric": ("pipeline_ts_train_feed" if os.environ.get("BENCH_TS")
                   else "pipeline_eval_throughput"),
        "value": best_pipeline,
        "unit": "clips/s",
        "model_only_clips_per_sec": model_only,
        "pipeline_fraction": round(best_pipeline / model_only, 3),
        "num_threads": num_threads,
        "host_cpus": os.cpu_count(),
        "short_side": short_side,
        "frame_cache": bool(frame_cache),
        "source_res": res,
        "device": device,
    }))


if __name__ == "__main__":
    main()
