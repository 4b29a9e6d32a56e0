"""Converter round-trip + checkpoint-surgery script tests."""

import subprocess
import sys

import jax
import numpy as np
import pytest

from fitclip_tpu.convert.flax_to_torch import clip_torch_state_dict_from_params
from fitclip_tpu.convert.torch_state_dict import (clip_params_from_torch,
                                                  config_from_openai_state_dict)
from fitclip_tpu.models.clip import CLIPConfig, CLIPModel


@pytest.fixture(scope="module")
def tiny_params():
    config = CLIPConfig.tiny_test()
    params = CLIPModel(config).init(jax.random.PRNGKey(0))
    return config, params


def test_flax_torch_flax_roundtrip(tiny_params):
    config, params = tiny_params
    state_dict = clip_torch_state_dict_from_params(params)
    inferred = config_from_openai_state_dict(state_dict)
    assert inferred.vision.width == config.vision.width
    assert inferred.text.context_length == config.text.context_length
    restored = clip_params_from_torch(state_dict, config)

    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict((jax.tree_util.keystr(p), l) for p, l in
                  jax.tree_util.tree_leaves_with_path(restored))
    for path, leaf in flat_a:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_b[key]),
                                   atol=1e-6, err_msg=key)


def test_config_inference_from_openai_schema(tiny_params):
    config, params = tiny_params
    sd = clip_torch_state_dict_from_params(params)
    inferred = config_from_openai_state_dict(sd)
    assert inferred.vision.layers == config.vision.layers
    assert inferred.text.vocab_size == config.text.vocab_size
    assert inferred.embed_dim == config.embed_dim


def _save_torch(sd, path):
    import torch

    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)


def test_apply_wise_ft_script(tiny_params, tmp_path):
    import torch

    config, params = tiny_params
    sd1 = clip_torch_state_dict_from_params(params)
    sd2 = {k: v + 1.0 for k, v in sd1.items()}
    _save_torch(sd1, tmp_path / "a.pt")
    _save_torch(sd2, tmp_path / "b.pt")
    result = subprocess.run(
        [sys.executable, "scripts/apply_wise_ft.py", str(tmp_path / "a.pt"),
         str(tmp_path / "b.pt"), str(tmp_path / "merged.pt"),
         "--weight-for-2", "0.4"],
        capture_output=True, text=True)
    assert result.returncode == 0, result.stderr
    merged = torch.load(tmp_path / "merged.pt", weights_only=False)
    key = "visual.class_embedding"
    np.testing.assert_allclose(merged[key].numpy(), sd1[key] + 0.4, atol=1e-6)
    assert np.isnan(merged["logit_scale"].item())


def test_prepare_checkpoint_script(tiny_params, tmp_path):
    import torch

    _, params = tiny_params
    sd = clip_torch_state_dict_from_params(params)
    # Simulate a Lightning-style training checkpoint with prefixed keys.
    prefixed = {"state_dict": {f"encoder.model.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}
    torch.save(prefixed, tmp_path / "train.ckpt")
    result = subprocess.run(
        [sys.executable, "scripts/prepare_trained_clip_checkpoint_for_evaluation.py",
         str(tmp_path / "train.ckpt"), str(tmp_path / "eval.pt")],
        capture_output=True, text=True)
    assert result.returncode == 0, result.stderr
    out = torch.load(tmp_path / "eval.pt", weights_only=False)
    assert "visual.proj" in out
    assert np.isnan(out["logit_scale"].item())


def test_prepare_generic_checkpoint_script(tiny_params, tmp_path):
    """The generic (non-CLIP) variant: prefix strip only, no logit_scale
    surgery (reference scripts/prepare_trained_checkpoint_for_evaluation.py)."""
    import torch

    _, params = tiny_params
    sd = clip_torch_state_dict_from_params(params)
    prefixed = {"state_dict": {f"encoder.model.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}
    torch.save(prefixed, tmp_path / "train.ckpt")
    result = subprocess.run(
        [sys.executable, "scripts/prepare_trained_checkpoint_for_evaluation.py",
         str(tmp_path / "train.ckpt"), str(tmp_path / "eval.pt")],
        capture_output=True, text=True)
    assert result.returncode == 0, result.stderr
    out = torch.load(tmp_path / "eval.pt", weights_only=False)
    assert "visual.proj" in out
    assert "logit_scale" not in out  # no CLIP-specific NaN re-injection
    assert set(out) == set(sd)
