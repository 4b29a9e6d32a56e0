"""Trainable batch-stats BatchNorm for the CLIP ResNets.

Covers the VERDICT round-1 weak item "CLIP ResNets are eval-only": train-mode
BN matches torch.nn.BatchNorm2d.train() (output + running-stat EMA), the
contrastive train step routes gradients to convs/BN affines while running
statistics update by EMA (never by the optimizer), and eval mode is untouched.
Reference behavior being matched: PyTorch-Lightning runs encoders in
model.train() during fit, so reference RN towers train with live batch stats
(aligner/video_text_module.py via PL internals).
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def tiny_rn_config():
    from fitclip_tpu.models.clip.resnet_clip import ResNetCLIPConfig
    from fitclip_tpu.models.clip.resnet import ModifiedResNetConfig
    from fitclip_tpu.models.clip.model import TextConfig

    return ResNetCLIPConfig(
        embed_dim=16,
        vision=ModifiedResNetConfig(layers=(1, 1, 1, 1), width=8,
                                    output_dim=16, input_resolution=32,
                                    heads=4),
        text=TextConfig(context_length=8, vocab_size=64, width=16, heads=2,
                        layers=2))


def test_train_mode_bn_matches_torch():
    import torch

    import jax
    import jax.numpy as jnp
    from fitclip_tpu.models.clip.resnet import BatchNorm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 5, 3)).astype(np.float32)
    weight = rng.normal(size=3).astype(np.float32)
    bias = rng.normal(size=3).astype(np.float32)
    running_mean = rng.normal(size=3).astype(np.float32)
    running_var = rng.uniform(0.5, 2.0, size=3).astype(np.float32)

    module = BatchNorm(3, use_batch_stats=True)
    params = {"weight": weight, "bias": bias,
              "running_mean": running_mean, "running_var": running_var}
    out, mutated = module.apply({"params": params}, jnp.asarray(x),
                                mutable=["bn_stats"])

    t_bn = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        t_bn.weight.copy_(torch.from_numpy(weight))
        t_bn.bias.copy_(torch.from_numpy(bias))
        t_bn.running_mean.copy_(torch.from_numpy(running_mean))
        t_bn.running_var.copy_(torch.from_numpy(running_var))
    t_bn.train()
    t_out = t_bn(torch.from_numpy(x).permute(0, 3, 1, 2))

    np.testing.assert_allclose(np.asarray(out),
                               t_out.detach().permute(0, 2, 3, 1).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(mutated["bn_stats"]["mean"][0]),
                               t_bn.running_mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(mutated["bn_stats"]["var"][0]),
                               t_bn.running_var.numpy(), atol=1e-6)


def test_eval_mode_unchanged_by_train_flag():
    import jax.numpy as jnp
    from fitclip_tpu.models.clip.resnet import BatchNorm

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 4, 4, 3)).astype(np.float32))
    params = {"weight": np.ones(3, np.float32), "bias": np.zeros(3, np.float32),
              "running_mean": rng.normal(size=3).astype(np.float32),
              "running_var": rng.uniform(0.5, 2, size=3).astype(np.float32)}
    eval_out = BatchNorm(3).apply({"params": params}, x)
    inv = 1.0 / np.sqrt(params["running_var"] + 1e-5)
    expect = (np.asarray(x) - params["running_mean"]) * inv
    np.testing.assert_allclose(np.asarray(eval_out), expect, atol=1e-5)


def test_contrastive_train_step_updates_rn(tiny_rn_config):
    import jax
    import jax.numpy as jnp
    from fitclip_tpu.models.clip.resnet_clip import ResNetClipVideoTextEncoder
    from fitclip_tpu.training.state import init_train_state, make_optimizer
    from fitclip_tpu.training.steps import make_contrastive_train_step

    encoder = ResNetClipVideoTextEncoder(tiny_rn_config, num_frames=2)
    params = encoder.init_params(jax.random.PRNGKey(0))

    template = {"encoder": params, "logit_scale": np.zeros((1,), np.float32)}
    optimizer = make_optimizer(1e-3, freeze_patterns=list(
        encoder.bn_freeze_patterns), params_example=template)
    state = init_train_state(params, optimizer)

    rng = np.random.default_rng(0)
    batch = {
        "video": jnp.asarray(rng.integers(0, 256, size=(4, 2, 32, 32, 3),
                                          dtype=np.uint8)),
        "text": jnp.asarray(rng.integers(1, 63, size=(4, 8)).astype(np.int32)),
    }
    step = jax.jit(make_contrastive_train_step(encoder, optimizer))
    new_state, metrics = step(state, batch)

    assert np.isfinite(float(metrics["loss/train"]))
    old = state.params["encoder"]["visual"]
    new = new_state.params["encoder"]["visual"]
    # Conv + BN affine moved by the optimizer.
    assert not np.allclose(np.asarray(old["conv1"]["kernel"]),
                           np.asarray(new["conv1"]["kernel"]))
    assert not np.allclose(np.asarray(old["bn1"]["weight"]),
                           np.asarray(new["bn1"]["weight"]))
    # Running stats moved — but by the EMA merge, not the optimizer:
    # new = 0.9 * old + 0.1 * batch_stat exactly.
    emb_frames, _, _ = encoder._frames(batch["video"])
    _, bn_updates = encoder.encode_video_train(state.params["encoder"],
                                               batch["video"])
    expected_mean = np.asarray(bn_updates["visual"]["bn1"]["mean"][0])
    np.testing.assert_allclose(np.asarray(new["bn1"]["running_mean"]),
                               expected_mean, atol=1e-6)
    assert not np.allclose(expected_mean,
                           np.asarray(old["bn1"]["running_mean"]))

    # A second step keeps compiling/running (merged tree has same structure).
    new_state2, _ = step(new_state, batch)
    assert int(new_state2.step) == 2


def test_teacher_student_step_uses_combined_batch_bn(tiny_rn_config):
    """The teacher-student step runs the student ONCE over the concatenated
    labeled+unlabeled batch (reference teacher_student.py:95), so a BN
    student's running stats after the step equal one combined-batch EMA
    update — not two sequential half-batch updates."""
    import jax
    import jax.numpy as jnp
    from fitclip_tpu.models.clip.resnet_clip import ResNetClipVideoTextEncoder
    from fitclip_tpu.training.state import init_train_state, make_optimizer
    from fitclip_tpu.training.steps import make_teacher_student_train_step

    encoder = ResNetClipVideoTextEncoder(tiny_rn_config, num_frames=2)
    params = encoder.init_params(jax.random.PRNGKey(0))
    teacher_params = encoder.init_params(jax.random.PRNGKey(1))

    template = {"encoder": params, "logit_scale": np.zeros((1,), np.float32),
                "ts_logit_scale": np.zeros((1,), np.float32)}
    optimizer = make_optimizer(1e-3, freeze_patterns=list(
        encoder.bn_freeze_patterns), params_example=template)
    state = init_train_state(params, optimizer, with_teacher_student_scale=True)

    rng = np.random.default_rng(3)

    def sub(loc):
        return {
            "video_student": jnp.asarray(rng.integers(
                0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)),
            "text_student": jnp.asarray(rng.integers(1, 63, size=(2, 8))
                                        .astype(np.int32)),
            "video_teacher": jnp.asarray(rng.integers(
                0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)),
            "text_teacher": jnp.asarray(rng.integers(1, 63, size=(2, 8))
                                        .astype(np.int32)),
        }

    batch = {"labeled": sub(0), "unlabeled": sub(1)}
    step = jax.jit(make_teacher_student_train_step(encoder, encoder, optimizer))
    new_state, metrics = step(state, teacher_params, batch)
    assert np.isfinite(float(metrics["loss/train"]))

    combined = np.concatenate([batch["labeled"]["video_student"],
                               batch["unlabeled"]["video_student"]], axis=0)
    _, bn_updates = encoder.encode_video_train(params, jnp.asarray(combined))
    expected = encoder.apply_bn_updates(params, bn_updates)
    np.testing.assert_allclose(
        np.asarray(new_state.params["encoder"]["visual"]["bn1"]["running_mean"]),
        np.asarray(expected["visual"]["bn1"]["running_mean"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(new_state.params["encoder"]["visual"]["bn1"]["running_var"]),
        np.asarray(expected["visual"]["bn1"]["running_var"]), atol=1e-6)


def test_fused_block_teacher_allowed_for_training(tiny_rn_config):
    """A frozen teacher never receives gradients, so an inference-form
    (int8) teacher must pass the train-runner guard; an int8 STUDENT must
    still be refused."""
    import pytest as _pytest

    from fitclip_tpu.cli.train_runner import run_train
    from fitclip_tpu.models.clip import CLIPConfig
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder

    class Loaded:
        def __init__(self, encoder):
            self.encoder = encoder
            self.params = {}

    int8 = Loaded(ClipVideoTextEncoder(CLIPConfig.tiny_test(), quantized=True))
    plain = Loaded(ClipVideoTextEncoder(CLIPConfig.tiny_test()))

    # int8 student -> refused.
    with _pytest.raises(ValueError, match="evaluation-only"):
        run_train({"student": int8, "teacher": plain}, data_module=None,
                  model_cfg={}, trainer_cfg={}, optimizer_cfg={})
    # int8 teacher -> passes the guard (fails later only on the None data
    # module, which is enough to show the guard admitted it).
    with _pytest.raises(AttributeError):
        run_train({"student": plain, "teacher": int8}, data_module=None,
                  model_cfg={}, trainer_cfg={}, optimizer_cfg={})


def test_eval_embeddings_identical_before_after_flag(tiny_rn_config):
    """The trainable path must not perturb the zero-shot eval form."""
    import jax
    import jax.numpy as jnp
    from fitclip_tpu.models.clip.resnet_clip import ResNetClipVideoTextEncoder

    encoder = ResNetClipVideoTextEncoder(tiny_rn_config, num_frames=2)
    params = encoder.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    video = jnp.asarray(rng.integers(0, 256, size=(2, 2, 32, 32, 3),
                                     dtype=np.uint8))
    eval_emb = encoder.encode_video(params, video)
    train_emb, updates = encoder.encode_video_train(params, video)
    assert np.all(np.isfinite(np.asarray(train_emb)))
    # Different normalization (batch vs running stats) => different values,
    # same shapes; eval output itself is deterministic.
    assert eval_emb.shape == train_emb.shape
    np.testing.assert_allclose(np.asarray(eval_emb),
                               np.asarray(encoder.encode_video(params, video)),
                               atol=0)
    # apply_bn_updates only touches running stats.
    merged = encoder.apply_bn_updates(params, updates)
    changed = []

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif not np.allclose(np.asarray(a), np.asarray(b)):
            changed.append(path)

    walk(params, merged)
    assert changed and all("running_" in c for c in changed)
