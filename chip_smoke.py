#!/usr/bin/env python3
"""Smoke run of fitclip's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--four-cards]

With no option it runs, in one process on one card, CLIP ViT-B/16 at its
published width (224x224, patch 16, width 768, 12 layers and heads; a
77-token text tower of width 512; 4 frames per clip) with weights drawn
from ``--seed``:

1. device: fails unless JAX's first device is a GPU; prints the card's
   name and power limit.
2. attention: each GPU attention route at the ViT-B/16 vision and text
   shapes, forward and gradient, against the fp32 XLA reference.
3. parity: GPU fp32 against a CPU fp32 reference (both at HIGHEST matmul
   precision), GPU bf16 against GPU fp32, calibrated GPU int8 against GPU
   bf16, on 2 clips and 4 captions.
4. evaluate: ``command=evaluate encoder=clip_vit_b_16 data=msrvtt`` through
   the CLI in fp32, bf16 and int8 over a synthetic MSR-VTT-shaped tree that
   this script writes from the seed, with a BPE merges file; finite
   r1/r5/r10/mr.
5. train: ``command=train`` for 3 steps at 16 clips per step; the losses
   are finite and the parameters change.
6. gpu tests: the repository's ``gpu``-marked tests, in this process.

``--four-cards`` runs only the data-parallel phase on four cards: the
contrastive train step on a data=4 mesh against one card on the same global
batch (fp32, HIGHEST), and data-sharded retrieval ranks against one card.

Every phase runs; any failure prints its traceback and makes the exit code
nonzero. The last line of a successful run is one JSON object naming the
device. The synthetic data lives under ``.chip_smoke/`` in the checkout and
is removed at the end.
"""

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")
WORDS = ("person", "dog", "car", "kitchen", "guitar", "river", "cooking",
         "playing", "running", "football", "street", "cat", "piano", "beach")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def cosine_rows(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def check(name: str, ok: bool, detail: str) -> None:
    print(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def random_captions(rng, count: int):
    return [f"a {WORDS[rng.integers(len(WORDS))]} {WORDS[rng.integers(len(WORDS))]} "
            f"video of {WORDS[rng.integers(len(WORDS))]}" for _ in range(count)]


def random_ids(rng, count: int, length: int = 77, vocab: int = 49408):
    """Token rows with the EOT (largest id) after a random-length body."""
    ids = np.zeros((count, length), np.int32)
    for row in range(count):
        n = int(rng.integers(5, length - 2))
        ids[row, 0] = vocab - 2
        ids[row, 1:n] = rng.integers(1, vocab - 2, n - 1)
        ids[row, n] = vocab - 1
    return ids


# ---------------------------------------------------------------- phases


def phase_attention(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.ops.attention import ROUTES, attention

    route = ROUTES["gpu"]
    key = jax.random.PRNGKey(seed)
    # (batch, length, heads, head_dim, causal): 16 frames of the vision
    # tower and 16 captions of the text tower.
    for name, shape, causal in (("vision", (16, 197, 12, 64), False),
                                ("text", (16, 77, 8, 64), True)):
        keys = jax.random.split(key, 4)
        q, k, v, g = (jax.random.normal(kk, shape, jnp.float32) for kk in keys)

        def run(q, k, v, g, impl, dtype, causal=causal):
            def f(q, k, v):
                return attention(q.astype(dtype), k.astype(dtype), v.astype(dtype),
                                 causal=causal, implementation=impl).astype(jnp.float32)
            out, vjp = jax.vjp(f, q, k, v)
            return (out,) + vjp(g)

        run = jax.jit(run, static_argnums=(4, 5))
        got = run(q, k, v, g, route, jnp.bfloat16)
        ref = run(q, k, v, g, "xla", jnp.float32)
        for label, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            # One cosine over the whole tensor: causal row 0 has dq == 0.
            cos = cosine_rows(np.asarray(a).reshape(1, -1),
                              np.asarray(b).reshape(1, -1))[0]
            check(f"attention {name} {route} bf16 {label} vs xla fp32",
                  bool(np.isfinite(np.asarray(a)).all()) and cos >= 0.999,
                  f"cosine {cos:.6f} (>= 0.999)")


def phase_parity(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.ops.quant import quantize_clip_params

    cfg = CLIPConfig.vit_b_16()
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, size=(2, 4, 224, 224, 3), dtype=np.uint8)
    text = random_ids(rng, 4)

    fp32 = ClipVideoTextEncoder(cfg, dtype=jnp.float32)
    bf16 = ClipVideoTextEncoder(cfg, dtype=jnp.bfloat16)
    int8 = ClipVideoTextEncoder(cfg, dtype=jnp.bfloat16, quantized=True)
    with jax.default_device(cpu):
        params = jax.device_get(fp32.init_params(jax.random.PRNGKey(seed)))

    def encode(encoder, p, device):
        p, v, t = jax.device_put((p, video, text), device)
        step = jax.jit(lambda p, v, t: (encoder.encode_video(p, v).astype(jnp.float32),
                                        encoder.encode_text(p, t).astype(jnp.float32)))
        return [np.asarray(x) for x in step(p, v, t)]

    gpu = jax.devices()[0]
    with jax.default_matmul_precision("highest"):
        gpu32 = encode(fp32, params, gpu)
        cpu32 = encode(fp32, params, cpu)
    for tower, a, b in zip(("video", "text"), gpu32, cpu32):
        cos = cosine_rows(a, b).min()
        err = float(np.abs(a - b).max())
        check(f"parity {tower} gpu fp32 vs cpu fp32", cos >= 0.9999 and err <= 1e-3,
              f"min cosine {cos:.7f} (>= 0.9999), max abs {err:.2e} (<= 1e-3)")

    gpu16 = encode(bf16, params, gpu)
    for tower, a, b in zip(("video", "text"), gpu16, gpu32):
        cos = cosine_rows(a, b).min()
        check(f"parity {tower} gpu bf16 vs gpu fp32", cos >= 0.999,
              f"min cosine {cos:.6f} (>= 0.999)")

    qparams = int8.calibrate(jax.device_put(quantize_clip_params(params)),
                             jnp.asarray(video), jnp.asarray(text))
    gpu8 = encode(int8, qparams, gpu)
    for tower, a, b in zip(("video", "text"), gpu8, gpu16):
        cos = cosine_rows(a, b).min()
        check(f"parity {tower} gpu int8 vs gpu bf16", cos >= 0.999,
              f"min cosine {cos:.6f} (>= 0.999)")


def write_msrvtt_tree(root: str, seed: int, num_videos: int, num_val: int) -> str:
    """An MSR-VTT-shaped tree (videos/all, structured-symlinks split lists,
    annotation/MSR_VTT.json) of seeded noise videos; returns the BPE merges
    path written beside it."""
    import cv2

    from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab

    rng = np.random.default_rng(seed)
    videos = os.path.join(root, "videos", "all")
    os.makedirs(videos)
    annotations = []
    for i in range(num_videos):
        writer = cv2.VideoWriter(os.path.join(videos, f"video{i}.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 8.0, (320, 240))
        if not writer.isOpened():
            raise RuntimeError("cv2 cannot write MJPG video")
        base = rng.integers(0, 256, size=(240, 320, 3), dtype=np.uint8)
        for t in range(12):
            writer.write(np.roll(base, 8 * t, axis=1))
        writer.release()
        annotations += [{"image_id": f"video{i}", "caption": c}
                        for c in random_captions(rng, 2)]
    lists = os.path.join(root, "structured-symlinks")
    os.makedirs(lists)
    with open(os.path.join(lists, "val_list_jsfusion.txt"), "w") as f:
        f.write("\n".join(f"video{i}" for i in range(num_val)))
    with open(os.path.join(lists, "train_list_jsfusion.txt"), "w") as f:
        f.write("\n".join(f"video{i}" for i in range(num_videos)))
    os.makedirs(os.path.join(root, "annotation"))
    with open(os.path.join(root, "annotation", "MSR_VTT.json"), "w") as f:
        json.dump({"annotations": annotations}, f)
    vocab_dir = os.path.join(root, "bpe")
    os.makedirs(vocab_dir)
    merges, _ = write_tiny_test_vocab(vocab_dir, list(WORDS) * 3 + ["a", "video", "of"])
    return merges


def cli_config(command: str, data_root: str, merges: str, seed: int, *extra):
    from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR
    from fitclip_tpu.config_engine import compose

    return compose(DEFAULT_CONFIG_DIR, "trainer", [
        f"command={command}", "encoder=clip_vit_b_16", "data=msrvtt",
        f"++data.base_path={data_root}", f"++encoder.bpe_path={merges}",
        f"++encoder.seed={seed}", "+data.num_threads=8", *extra])


def phase_evaluate(seed: int, data_root: str, merges: str) -> None:
    from fitclip_tpu.cli.main import execute

    for dtype in ("float32", "bfloat16", "int8"):
        cfg = cli_config("evaluate", data_root, merges, seed,
                         "data.eval_batch_size=16", f"++encoder.dtype={dtype}")
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = execute(cfg)["metrics"]
        seconds = time.perf_counter() - start
        values = {k: metrics.get(k) for k in ("r1", "r5", "r10", "mr")}
        finite = all(v is not None and math.isfinite(v) for v in values.values())
        check(f"evaluate clip_vit_b_16 {dtype}", finite,
              f"{json.dumps(values)} in {seconds:.1f} s (compile included)")


def read_losses(log_dir: str):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [row["loss/train"] for row in rows if "loss/train" in row]


def phase_train(seed: int, data_root: str, merges: str) -> None:
    import jax

    from fitclip_tpu.cli.main import execute, instantiate_encoder_slot

    log_dir = os.path.join(WORK, "train_logs")
    cfg = cli_config("train", data_root, merges, seed,
                     "+data.batch_size=16", "++encoder.dtype=bfloat16",
                     "++trainer.max_steps=3", "trainer.log_every_n_steps=1",
                     f"++log_dir={log_dir}", "~trainer.callbacks.checkpoint")
    start = time.perf_counter()
    state = execute(cfg)["state"]
    seconds = time.perf_counter() - start
    losses = read_losses(log_dir)
    check("train losses", len(losses) == 3 and all(map(math.isfinite, losses)),
          f"{losses} in {seconds:.1f} s (compile included)")
    initial = instantiate_encoder_slot(cfg["encoder"]).params
    deltas = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)).max()),
        jax.device_get(state.params["encoder"]), initial))
    changed = sum(d > 0 for d in deltas)
    check("train params change", changed == len(deltas),
          f"{changed}/{len(deltas)} leaves changed, max |delta| {max(deltas):.3e}")


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "--device=gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    check("gpu-marked tests", rc == 0, f"pytest exit code {int(rc)}")


def phase_four_cards(seed: int, data_root: str, merges: str) -> None:
    import jax
    import jax.numpy as jnp

    from fitclip_tpu.cli.main import instantiate_data_module, instantiate_encoder_slot
    from fitclip_tpu.cli.train_runner import run_train
    from fitclip_tpu.evaluation.retrieval import _retrieval_ranks
    from fitclip_tpu.parallel import create_mesh, replicated, sharded_along

    devices = jax.devices()
    check("four cards", len(devices) == 4, f"{len(devices)} devices")
    one, four = create_mesh(devices[:1]), create_mesh(devices)

    losses = {}
    for name, mesh in (("1 card", one), ("data=4", four)):
        log_dir = os.path.join(WORK, f"logs_{mesh.devices.size}")
        cfg = cli_config("train", data_root, merges, seed,
                         "+data.batch_size=16", "++encoder.dtype=float32",
                         "++trainer.max_steps=1", "trainer.log_every_n_steps=1",
                         "~trainer.callbacks.checkpoint")
        encoder = instantiate_encoder_slot(cfg["encoder"])
        data_module = instantiate_data_module(cfg["data"], encoder)
        with jax.default_matmul_precision("highest"):
            run_train(encoder, data_module, model_cfg=cfg["model"],
                      trainer_cfg=cfg["trainer"], optimizer_cfg=cfg["optimizer"],
                      callbacks_cfg=cfg["trainer"].get("callbacks"), mesh=mesh,
                      log_dir=log_dir)
        losses[name] = read_losses(log_dir)[0]
    rel = abs(losses["data=4"] - losses["1 card"]) / abs(losses["1 card"])
    check("first-step loss data=4 vs 1 card", rel <= 1e-4,
          f"{losses['data=4']:.7f} vs {losses['1 card']:.7f}, relative {rel:.2e} (<= 1e-4)")

    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, size=(16, 4, 224, 224, 3), dtype=np.uint8)
    text = random_ids(rng, 16)
    for dtype in ("float32", "bfloat16"):
        cfg = cli_config("evaluate", data_root, merges, seed, f"++encoder.dtype={dtype}")
        loaded = instantiate_encoder_slot(cfg["encoder"])
        enc = loaded.encoder

        def step(p, v, t, enc=enc):
            return (enc.encode_video(p, v).astype(jnp.float32),
                    enc.encode_text(p, t).astype(jnp.float32))

        outs = {}
        for name, mesh in (("1 card", one), ("data=4", four)):
            params = jax.device_put(loaded.params, replicated(mesh))
            v, t = jax.device_put((video, text), sharded_along(mesh))
            with jax.default_matmul_precision("highest"):
                emb_v, emb_t = jax.jit(step)(params, v, t)
                ranks = jax.jit(_retrieval_ranks)(emb_t, emb_v)
            outs[name] = (np.asarray(emb_v), np.asarray(emb_t), np.asarray(ranks))
        cos = min(cosine_rows(outs["data=4"][0], outs["1 card"][0]).min(),
                  cosine_rows(outs["data=4"][1], outs["1 card"][1]).min())
        same = bool((outs["data=4"][2] == outs["1 card"][2]).all())
        if dtype == "float32":
            check("sharded eval ranks data=4 vs 1 card (fp32)", same and cos >= 0.9999,
                  f"ranks equal: {same}, min embedding cosine {cos:.7f}")
        else:
            check("sharded eval embeddings data=4 vs 1 card (bf16)", cos >= 0.999,
                  f"min embedding cosine {cos:.6f} (>= 0.999), ranks equal: {same}")


# ---------------------------------------------------------------- driver


def run_phase(name: str, fn, failures) -> None:
    print(f"PHASE {name}", flush=True)
    start = time.perf_counter()
    try:
        fn()
    except Exception:  # report every phase; the exit code carries the failure
        traceback.print_exc()
        failures.append(name)
        print(f"PHASE {name} FAILED after {time.perf_counter() - start:.1f} s", flush=True)
        return
    print(f"PHASE {name} ok in {time.perf_counter() - start:.1f} s", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the data-parallel phase on four cards")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    from fitclip_tpu.serving.export import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}")
    print(f"jax {jax.__version__}; devices: {devices}")
    card = card_line()
    print(f"card: {card}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    failures = []
    try:
        data_root = os.path.join(WORK, "msrvtt")
        merges = write_msrvtt_tree(data_root, args.seed, num_videos=48, num_val=32)
        if args.four_cards:
            run_phase("four cards", lambda: phase_four_cards(args.seed, data_root, merges),
                      failures)
        else:
            run_phase("attention", lambda: phase_attention(args.seed), failures)
            run_phase("parity", lambda: phase_parity(args.seed), failures)
            run_phase("evaluate", lambda: phase_evaluate(args.seed, data_root, merges),
                      failures)
            run_phase("train", lambda: phase_train(args.seed, data_root, merges),
                      failures)
            run_phase("gpu tests", phase_gpu_tests, failures)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": devices[0].platform,
                                             "kind": devices[0].device_kind,
                                             "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
