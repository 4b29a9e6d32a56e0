#!/usr/bin/env python
"""Per-core host decode cost model (SURVEY §7 hard-part
#1). Pure host benchmark — no accelerator.

Measures, per clip (4 uniform frames, the eval geometry):
  open      vd_open (demux + frame-index build)
  decode    4-frame indexed decode at NATIVE resolution
  decode224 4-frame indexed decode with swscale short-side 224 during decode
  transform short-side resize + center crop on the native-res frames
  e2e       open + decode + transform (the per-clip pipeline cost, native)
  e2e224    open + decode224 + (crop-only transform)

Env: BENCH_RES (default 320x240), BENCH_CLIPS (default 32), BENCH_CODEC
(default MJPG; mp4v exercises inter-frame codecs).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def write_videos(directory, count, size, codec, seconds=4.0, fps=25.0):
    import cv2

    width, height = size
    os.makedirs(directory, exist_ok=True)
    if len(os.listdir(directory)) >= count:
        return
    xs = np.linspace(0, 2 * np.pi, width, dtype=np.float32)[None, :]
    ys = np.linspace(0, 2 * np.pi, height, dtype=np.float32)[:, None]
    ext = "avi" if codec == "MJPG" else "mp4"
    for index in range(count):
        path = os.path.join(directory, f"clip{index:05d}.{ext}")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps,
                                 size)
        assert writer.isOpened()
        for frame_index in range(int(seconds * fps)):
            t = frame_index / fps
            frame = np.stack([
                127.5 + 127.5 * np.cos(xs + t)[0:1].repeat(height, 0),
                127.5 + 127.5 * np.sin(ys + 0.5 * t).repeat(width, 1),
                np.full((height, width), (index * 7) % 255, np.float32),
            ], axis=2).astype(np.uint8)
            writer.write(frame)
        writer.release()


def main() -> None:
    from fitclip_tpu.data.native import NativeVideoReader
    from fitclip_tpu.data.transforms import center_crop, eval_transform

    res = os.environ.get("BENCH_RES", "320x240")
    codec = os.environ.get("BENCH_CODEC", "MJPG")
    count = int(os.environ.get("BENCH_CLIPS", "32"))
    size = tuple(int(v) for v in res.split("x"))
    directory = os.path.join("/tmp", f"fitclip_decode_bench_{res}_{codec}")
    write_videos(directory, count, size, codec)
    paths = sorted(os.path.join(directory, f) for f in os.listdir(directory))

    def per_clip(fn, repeats=2):
        best = float("inf")
        for _ in range(repeats):
            start = time.perf_counter()
            for path in paths:
                fn(path)
            best = min(best, (time.perf_counter() - start) / len(paths))
        return best * 1e3

    def indices_for(reader):
        n = len(reader)
        return np.linspace(0, n - 1, 4).astype(np.int64).tolist()

    open_ms = per_clip(lambda p: NativeVideoReader(p))

    def decode_native(p):
        r = NativeVideoReader(p)
        return r(indices_for(r))

    def decode_224(p):
        r = NativeVideoReader(p, short_side=224)
        return r(indices_for(r))

    # per_clip(decode_*) includes the open; subtract to isolate decode.
    decode_ms = max(0.0, per_clip(decode_native) - open_ms)
    decode224_ms = max(0.0, per_clip(decode_224) - open_ms)

    frames = decode_native(paths[0])
    start = time.perf_counter()
    for _ in range(50):
        eval_transform(frames, 224)
    transform_ms = (time.perf_counter() - start) / 50 * 1e3

    small = decode_224(paths[0])
    start = time.perf_counter()
    for _ in range(50):
        center_crop(small, 224)
    crop_ms = (time.perf_counter() - start) / 50 * 1e3

    # Levers: threaded intra decode (BENCH_THREADS; a LATENCY lever
    # for multi-core hosts — on a 1-core box expect neutral/negative), and
    # the GOP analysis for the record (keyframe spacing bounds the catch-up
    # decode work per sampled frame).
    threads = int(os.environ.get("BENCH_THREADS", "0"))
    threaded_ms = None
    if threads > 1:
        def decode_224_threaded(p):
            r = NativeVideoReader(p, short_side=224, decode_threads=threads)
            return r(indices_for(r))
        threaded_ms = max(0.0, per_clip(decode_224_threaded) - open_ms)

    reader = NativeVideoReader(paths[0])
    n_frames = len(reader)
    keyframes = int(reader.keyframe_flags().sum())

    result = {
        "res": res, "codec": codec,
        "open_ms_per_clip": round(open_ms, 2),
        "decode_native_ms_per_clip": round(decode_ms, 2),
        "decode_short224_ms_per_clip": round(decode224_ms, 2),
        "transform_native_ms_per_clip": round(transform_ms, 2),
        "crop_only_ms_per_clip": round(crop_ms, 2),
        "e2e_native_ms_per_clip": round(open_ms + decode_ms + transform_ms, 2),
        "e2e_short224_ms_per_clip": round(open_ms + decode224_ms + crop_ms, 2),
        "frames": n_frames, "keyframes": keyframes,
        "mean_gop": round(n_frames / max(keyframes, 1), 1),
    }
    if threaded_ms is not None:
        result["decode_short224_threads%d_ms_per_clip" % threads] = \
            round(threaded_ms, 2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
