"""Data-sharded eval on the 8-device CPU mesh equals one device.

The encode step runs under plain jit with the batch sharded over the "data"
axis (GSPMD partitions it); the retrieval ranks over the sharded embeddings
must equal the single-device ranks — the reference's gathered eval
semantics (text_video_retrieval.py:61-83).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.evaluation.retrieval import _retrieval_ranks
from fitclip_tpu.parallel import create_mesh, replicated, sharded_along


def _clip(quantized):
    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder

    encoder = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=2,
                                   quantized=quantized)
    return encoder, 32, 16, 60


def _slip():
    from fitclip_tpu.models.slip import SlipConfig, SlipVideoTextEncoder

    return SlipVideoTextEncoder(SlipConfig.tiny_test(), num_frames=2), 32, 16, 60


def _fit():
    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig, FrozenInTimeVideoTextEncoder)

    cfg = FrozenInTimeConfig.tiny_test()
    encoder = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames,
                                           max_tokens=12)
    return encoder, cfg.img_size, 12, 90


FAMILIES = {"clip": lambda: _clip(False), "clip_int8": lambda: _clip(True),
            "slip": _slip, "frozen_in_time": _fit}


def _batch(rng, n, frames, size, length, vocab):
    video = rng.integers(0, 256, size=(n, frames, size, size, 3)).astype(np.uint8)
    text = rng.integers(1, vocab, size=(n, length)).astype(np.int32)
    return video, text


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_ranks_equal_single_device(family):
    encoder, size, length, vocab = FAMILIES[family]()
    params = encoder.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    video, text = _batch(rng, 16, encoder.num_frames, size, length, vocab)
    if getattr(encoder, "quantized", False):
        params = encoder.calibrate(params, jnp.asarray(video[:4]),
                                   jnp.asarray(text[:4]))

    def step(p, v, t):
        return (encoder.encode_video(p, v).astype(jnp.float32),
                encoder.encode_text(p, t).astype(jnp.float32))

    mesh = create_mesh()
    assert mesh.devices.size == 8
    v_sh, t_sh = jax.jit(step)(jax.device_put(params, replicated(mesh)),
                               jax.device_put(video, sharded_along(mesh)),
                               jax.device_put(text, sharded_along(mesh)))
    assert len(v_sh.sharding.device_set) == 8
    sharded_ranks = jax.jit(_retrieval_ranks)(t_sh, v_sh)
    v_ref, t_ref = jax.jit(step)(params, video, text)
    np.testing.assert_allclose(np.asarray(v_sh), np.asarray(v_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(np.asarray(sharded_ranks),
                                  np.asarray(_retrieval_ranks(t_ref, v_ref)))


class _FakeDataModule:
    """Two fixed eval batches (the second ragged: 5 rows on 8 devices)."""

    def __init__(self, batches):
        self.batches = batches

    def val_dataloader(self):
        return tuple(self.batches)


def test_run_retrieval_eval_sharded_equals_single_device():
    from fitclip_tpu.cli.runners import run_retrieval_eval
    from fitclip_tpu.models.clip.load import LoadedEncoder

    encoder, size, length, vocab = _clip(False)
    loaded = LoadedEncoder(encoder, encoder.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    batches = []
    for n in (8, 5):
        video, text = _batch(rng, n, 2, size, length, vocab)
        batches.append({"video": video, "text": text})
    data = _FakeDataModule(batches)
    sharded = run_retrieval_eval(loaded, data, mesh=create_mesh())
    single = run_retrieval_eval(loaded, data, mesh=create_mesh(jax.devices()[:1]))
    assert set(sharded) == {"r1", "r5", "r10", "mr"}
    assert sharded == single
