"""AOT serving artifacts (fitclip_tpu/serving/export.py): jax.export
roundtrip parity, bucket routing, and the persistent compilation cache."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.serving.export import export_encode_fn, load_exported


@pytest.fixture()
def tiny_encoder(tmp_path):
    from fitclip_tpu.models.clip.load import load_tiny_test_encoder
    from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab

    vocab_dir = tmp_path / "vocab"
    vocab_dir.mkdir()
    merges, vocab = write_tiny_test_vocab(str(vocab_dir), ["a", "cat", "video"])
    return load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab)


def test_export_roundtrip_matches_direct_call(tiny_encoder, tmp_path):
    loaded = tiny_encoder
    tokenizer = loaded.encoder.get_tokenizer()
    item = np.asarray(tokenizer(["a cat video"]))[0]
    encode = loaded.encoder.encode_text

    paths = export_encode_fn(encode, loaded.params, item, (1, 4),
                             str(tmp_path), "text")
    assert sorted(paths) == [1, 4]
    assert all(os.path.exists(p) for p in paths.values())
    # Weights live ONCE per directory, not inside each bucket artifact.
    assert os.path.exists(os.path.join(str(tmp_path), "params.msgpack"))
    params_bytes = os.path.getsize(os.path.join(str(tmp_path), "params.msgpack"))
    assert all(os.path.getsize(p) < params_bytes for p in paths.values())

    encode_fn, per_bucket = load_exported(str(tmp_path), "text")
    assert sorted(per_bucket) == [1, 4]

    batch = np.stack([item] * 4)
    direct = np.asarray(
        jax.jit(encode)(loaded.params, jnp.asarray(batch)), np.float32)
    exported = np.asarray(encode_fn(jnp.asarray(batch)), np.float32)
    np.testing.assert_allclose(exported, direct, atol=1e-6)

    one = np.asarray(encode_fn(jnp.asarray(batch[:1])), np.float32)
    np.testing.assert_allclose(one, direct[:1], atol=1e-6)


def test_export_unknown_bucket_raises(tiny_encoder, tmp_path):
    loaded = tiny_encoder
    item = np.asarray(loaded.encoder.get_tokenizer()(["a"]))[0]
    export_encode_fn(loaded.encoder.encode_text, loaded.params,
                     item, (2,), str(tmp_path), "text")
    encode_fn, _ = load_exported(str(tmp_path), "text")
    with pytest.raises(ValueError, match="batch size 3"):
        encode_fn(jnp.asarray(np.stack([item] * 3)))


def test_load_exported_missing_artifacts(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_exported(str(tmp_path), "video")


def test_text_service_serves_from_exported_artifacts(tiny_encoder, tmp_path,
                                                     monkeypatch):
    loaded = tiny_encoder
    tokenizer = loaded.encoder.get_tokenizer()
    item = np.asarray(tokenizer(["warmup"]))[0]
    export_encode_fn(loaded.encoder.encode_text, loaded.params, item,
                     (1, 2, 4), str(tmp_path), "text")

    import demo.embed_service as es

    monkeypatch.setenv("EMBED_EXPORT_DIR", str(tmp_path))
    monkeypatch.setattr(es, "_LOADED", loaded)
    service = es.build_service()
    try:
        assert service.server._buckets == (1, 2, 4)
        texts = ["a cat", "a video", "cat video"]
        served = service.embed_texts(texts)
        ids = jnp.asarray(np.asarray(tokenizer(texts), np.int32))
        direct = np.asarray(
            jax.jit(loaded.encoder.encode_text)(loaded.params, ids), np.float32)
        np.testing.assert_allclose(served.astype(np.float32), direct, atol=1e-6)
    finally:
        service.stop()


# The two persistent-cache tests run their bodies in a SUBPROCESS: flipping
# XLA's process-level cache singleton inside the long-lived suite process is
# exactly the kind of global compile-state mutation implicated in the
# order-dependent late-suite compile crash (see tests/conftest.py's
# clear-caches fixture note and serving/export.py's disable docstring). A
# throwaway interpreter exercises the real enable/jit/populate path with
# zero residue.


def _run_in_subprocess(body: str, env=None) -> None:
    """Run ``body`` in a fresh CPU interpreter; ``env`` entries override the
    environment (None removes a variable). Every program is cached, however
    quick its compile."""
    import subprocess
    import sys

    script = ("import jax\n"
              "jax.config.update('jax_platforms', 'cpu')\n"
              "import os\n"
              "import numpy as np\n"
              "import jax.numpy as jnp\n" + body)
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full_env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    for key, value in (env or {}).items():
        if value is None:
            full_env.pop(key, None)
        else:
            full_env[key] = value
    env = full_env
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"subprocess failed:\n{proc.stdout}\n{proc.stderr}"


def _cache_script(body: str) -> str:
    return ("from fitclip_tpu.serving.export import enable_compilation_cache\n"
            + body + "\n"
            "np.asarray(jax.jit(lambda a: (a @ a.T).sum(axis=0) * 3.0)("
            "jnp.arange(64, dtype=jnp.float32).reshape(8, 8)))\n")


def test_compilation_cache_populates(tmp_path):
    """A configured directory (no JAX_COMPILATION_CACHE_DIR) gets the entries."""
    cache_dir = str(tmp_path / "xla_cache")
    _run_in_subprocess(_cache_script(
        f"assert enable_compilation_cache({cache_dir!r}) == {cache_dir!r}") + f"""
assert os.listdir({cache_dir!r}), "persistent compilation cache wrote no entries"
""", env={"JAX_COMPILATION_CACHE_DIR": None})


def test_compilation_cache_env_wins_over_config(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lands there only: the
    configured directory is neither created nor written."""
    env_dir, configured = str(tmp_path / "env_cache"), str(tmp_path / "cfg_cache")
    _run_in_subprocess(_cache_script(
        f"assert enable_compilation_cache({configured!r}) == {env_dir!r}") + f"""
assert os.listdir({env_dir!r})
assert not os.path.exists({configured!r})
""", env={"JAX_COMPILATION_CACHE_DIR": env_dir})


def test_compilation_cache_defaults_to_checkout_dir():
    """Neither the environment nor the caller names a directory: a fixed
    <checkout>/.jax_cache, never a tmp name, pid or time."""
    from fitclip_tpu.serving import export

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert export.DEFAULT_CACHE_DIR == os.path.join(checkout, ".jax_cache")
    previous = os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    try:
        assert export.compilation_cache_dir() == export.DEFAULT_CACHE_DIR
        assert export.compilation_cache_dir("/x") == "/x"
        os.environ["JAX_COMPILATION_CACHE_DIR"] = "/env"
        assert export.compilation_cache_dir("/x") == "/env"
        assert export.compilation_cache_dir() == "/env"
    finally:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        if previous is not None:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = previous


def test_cli_compilation_cache_knob(tmp_path):
    """++compilation_cache_dir wires the persistent cache through run()."""
    cache_dir = str(tmp_path / "cli_cache")
    _run_in_subprocess(f"""
from fitclip_tpu.cli.main import run
cache_dir = {cache_dir!r}
# Unknown command still exits early — but AFTER the cache config is applied,
# which is all this knob test needs; a jit afterwards lands in the directory.
try:
    run({{"command": "bogus", "compilation_cache_dir": cache_dir}})
    raise AssertionError("expected SystemExit")
except SystemExit:
    pass
np.asarray(jax.jit(lambda a: a * 2 + 1)(jnp.arange(256.0).reshape(16, 16)))
assert os.listdir(cache_dir)
""", env={"JAX_COMPILATION_CACHE_DIR": None})


def test_export_serves_non_clip_family_fit_int8(tmp_path):
    """Serving breadth beyond CLIP: a Frozen-in-Time int8 video tower with
    calibrated persisted scales exports through the same jax.export artifact
    path and the reloaded program matches the live encoder."""
    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, FrozenInTimeVideoTextEncoder,
        quantize_fit_video_params)
    from fitclip_tpu.ops.quant import (load_act_scales, require_calibrated,
                                       save_act_scales)

    cfg = FrozenInTimeConfig.tiny_test()
    fp32 = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames)
    params = fp32.init_params(jax.random.PRNGKey(0))
    encoder = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames,
                                           dtype="int8")
    qparams = dict(params, video=quantize_fit_video_params(params["video"]))
    rng = np.random.default_rng(7)
    video = rng.integers(0, 256, size=(2, cfg.num_frames, cfg.img_size,
                                       cfg.img_size, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="uncalibrated"):
        require_calibrated(qparams, context="test")
    qparams = encoder.calibrate(qparams, jnp.asarray(video))

    # The persisted-scales serving flow: save -> fresh quantize -> load.
    scales = tmp_path / "scales.npz"
    save_act_scales(str(scales), qparams)
    served_params = load_act_scales(
        str(scales), dict(params, video=quantize_fit_video_params(params["video"])))
    require_calibrated(served_params, context="test")

    paths = export_encode_fn(encoder.encode_video, served_params, video[0],
                             (2,), str(tmp_path), "video")
    assert sorted(paths) == [2]
    encode_fn, _ = load_exported(str(tmp_path), "video")
    direct = np.asarray(
        jax.jit(encoder.encode_video)(served_params, jnp.asarray(video)),
        np.float32)
    served = np.asarray(encode_fn(jnp.asarray(video)), np.float32)
    np.testing.assert_allclose(served, direct, atol=1e-5, rtol=1e-5)
