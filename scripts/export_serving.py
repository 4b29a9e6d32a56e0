#!/usr/bin/env python
"""AOT-export a config-named encoder's serving programs as jax.export
artifacts — one StableHLO file per (tower, batch bucket).

The artifact set pins the EXACT programs a deployment serves (auditable,
diffable, reloadable by any same-or-newer jax via
fitclip_tpu.serving.export.load_exported, or by a non-Python PJRT runtime
through the jax.export calling convention). Pair with
EMBED_COMPILE_CACHE for compile-free restarts.

Usage:
  python scripts/export_serving.py <encoder-config> <out-dir> \
      [--buckets 1,2,4,8,16,32] [--checkpoint ckpt] [--scales scales.npz] \
      [--platform cpu]

Example:
  python scripts/export_serving.py clip_vit_b_32 /tmp/export --buckets 1,8
  -> /tmp/export/text_b1.jaxexp ... /tmp/export/video_b8.jaxexp
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("encoder", help="config/encoder/<name>.yaml")
    parser.add_argument("out_dir")
    parser.add_argument("--buckets", default="1,2,4,8,16,32")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--scales", default=None,
                        help="calibrated activation scales .npz (int8 encoders)")
    parser.add_argument("--platform", default=None,
                        help="pin the jax backend before touching devices")
    args = parser.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from demo.embed_service import prepare_quantized_params
    from fitclip_tpu.cli.main import (DEFAULT_CONFIG_DIR, _maybe_load_checkpoint,
                                      instantiate_encoder_slot)
    from fitclip_tpu.config_engine import compose
    from fitclip_tpu.serving.export import export_encode_fn

    config_dir = os.environ.get("FITCLIP_CONFIG_DIR", DEFAULT_CONFIG_DIR)
    cfg = compose(config_dir, "trainer",
                  ["command=evaluate", f"encoder={args.encoder}", "data=msrvtt"])
    loaded = instantiate_encoder_slot(cfg["encoder"])
    if isinstance(loaded, dict):
        raise SystemExit(f"{args.encoder} is a {{student,teacher}} slot — "
                         "export one tower's encoder config instead")
    loaded = _maybe_load_checkpoint(loaded, args.checkpoint)
    params = prepare_quantized_params(loaded.encoder, loaded.params, args.scales)
    encoder = loaded.encoder

    buckets = [int(b) for b in args.buckets.split(",")]
    spec = encoder.preprocess
    tokenizer = encoder.get_tokenizer()
    text_item = np.asarray(tokenizer(["warmup"]))[0]
    frames = spec.pad_to_min_frames or spec.num_frames
    # uint8 raw pixels: the serving pipeline submits decoded frames and
    # encode_video owns the normalization (same as the offline eval path).
    video_item = np.zeros((frames, spec.image_size, spec.image_size, 3),
                          np.uint8)

    written = {}
    written["text"] = export_encode_fn(
        encoder.encode_text, params, text_item, buckets, args.out_dir, "text")
    written["video"] = export_encode_fn(
        encoder.encode_video, params, video_item, buckets, args.out_dir, "video")
    print(json.dumps({tower: {str(b): p for b, p in paths.items()}
                      for tower, paths in written.items()}, indent=2))


if __name__ == "__main__":
    main()
