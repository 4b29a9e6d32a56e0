#!/usr/bin/env python
"""Training-step throughput on one card: contrastive fine-tune and
teacher-student distillation steps (forward + backward + AdamW + temperature
clamp) at CLIP ViT-B/16 scale, bf16 compute.

    python scripts/bench_train.py [--batch 32] [--cases contrastive,...] [--remat]

Cases: contrastive, contrastive_bf16m (bf16-stored AdamW moments),
rn50_contrastive (CLIP RN50 with live batch-stats BN), teacher_student,
teacher_student_int8_teacher (calibrated int8 frozen teacher). Each step is
timed with warm-up calls, then calls ending in ``block_until_ready``
(utils/benchmarking.py). One JSON line per case, each naming the device.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.serving.export import enable_compilation_cache
    from fitclip_tpu.training.state import init_train_state, make_optimizer
    from fitclip_tpu.training.steps import (make_contrastive_train_step,
                                            make_teacher_student_train_step)
    from fitclip_tpu.utils.benchmarking import device_summary, time_calls

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--cases", default="contrastive,teacher_student")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--remat-policy", choices=["full", "dots"],
                        default="full",
                        help="dots = save matmul outputs, recompute eltwise")
    parser.add_argument("--optax-adamw", action="store_true",
                        help="two-pass optax chain instead of FusedAdamW")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()

    device = device_summary()
    enable_compilation_cache()
    remat = ("dots" if args.remat and args.remat_policy == "dots"
             else args.remat)
    encoder = ClipVideoTextEncoder(CLIPConfig.vit_b_16(), num_frames=4,
                                   dtype=jnp.bfloat16, remat=remat)
    params = encoder.init_params(jax.random.PRNGKey(0))
    optimizer = make_optimizer(3e-6, fused=not args.optax_adamw)
    rng = np.random.default_rng(0)
    size = encoder.preprocess.image_size

    def video_batch(n):
        return jnp.asarray(rng.integers(0, 256, (n, 4, size, size, 3), np.uint8))

    def text_batch(n):
        ids = np.zeros((n, 77), np.int32)
        ids[:, 0], ids[:, 1:20], ids[:, 20] = 49406, rng.integers(1, 49406, (n, 19)), 49407
        return jnp.asarray(ids)

    for case in args.cases.split(","):
        if case in ("contrastive", "rn50_contrastive", "contrastive_bf16m"):
            case_optimizer = (make_optimizer(3e-6, fused=True,
                                             moment_dtype="bfloat16")
                              if case == "contrastive_bf16m" else optimizer)
            if case == "rn50_contrastive":
                from fitclip_tpu.models.clip.resnet_clip import (
                    RESNET_PRESETS, ResNetClipVideoTextEncoder)

                case_encoder = ResNetClipVideoTextEncoder(
                    RESNET_PRESETS["RN50"], num_frames=4, dtype=jnp.bfloat16)
                case_params = case_encoder.init_params(jax.random.PRNGKey(0))
            else:
                case_encoder, case_params = encoder, params
            state = jax.device_put(init_train_state(case_params, case_optimizer))
            step = jax.jit(make_contrastive_train_step(case_encoder, case_optimizer))
            batch = {"video": video_batch(args.batch), "text": text_batch(args.batch)}
            clips_per_step = args.batch

            def run(step=step, state=state, batch=batch):
                return step(state, batch)[1]["loss/train"]
        elif case in ("teacher_student", "teacher_student_int8_teacher"):
            if case == "teacher_student_int8_teacher":
                # The frozen tower never receives gradients (stop_gradient
                # in the step), so it may run int8 — the config run_train
                # accepts for the teacher slot (cli/train_runner.py).
                from fitclip_tpu.ops.quant import quantize_clip_params

                teacher_encoder = ClipVideoTextEncoder(
                    CLIPConfig.vit_b_16(), num_frames=4, dtype=jnp.bfloat16,
                    quantized=True)
                teacher_params = teacher_encoder.calibrate(
                    quantize_clip_params(jax.device_get(params)), video_batch(4),
                    text_batch(4))
            else:
                teacher_encoder = encoder
                teacher_params = encoder.init_params(jax.random.PRNGKey(1))
            teacher_params = jax.device_put(teacher_params)
            state = jax.device_put(init_train_state(
                params, optimizer, with_teacher_student_scale=True))
            step = jax.jit(make_teacher_student_train_step(
                encoder, teacher_encoder, optimizer, labeled_loss_share=0.9999))
            half = max(1, args.batch // 4)  # dual views double the video work
            sub = lambda: {  # noqa: E731
                "video_student": video_batch(half), "text_student": text_batch(half),
                "video_teacher": video_batch(half), "text_teacher": text_batch(half)}
            batch = {"labeled": sub(), "unlabeled": sub()}
            clips_per_step = 2 * half

            def run(step=step, state=state, teacher_params=teacher_params,
                    batch=batch):
                return step(state, teacher_params, batch)[1]["loss/train"]
        else:
            raise SystemExit(f"unknown case {case!r}")

        t = time_calls(run, warmup=3, steps=args.steps)
        print(json.dumps({
            "metric": f"train_step_{case}",
            "value": clips_per_step / t["median_s"],
            "unit": "clips/s",
            "ms_per_step": t["median_s"] * 1e3,
            "batch_clips": clips_per_step,
            "remat": remat,
            "device": device,
        }), flush=True)


if __name__ == "__main__":
    main()
