"""Command runners: the device-loop side of each CLI command.

Each runner owns one jitted step + a host loop over a data loader, with
batches padded to mesh divisibility and sharded on the leading axis over
"data". Metrics come back as plain dicts, suffixed per dataset for grouped
eval (text_video_retrieval.py:30-37 naming: r1_{dataset} etc.).
"""

import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fitclip_tpu.evaluation.classification import (ClassificationEvaluator,
                                                   encode_label_bank,
                                                   tokenize_label_bank)
from fitclip_tpu.evaluation.retrieval import RetrievalEvaluator
from fitclip_tpu.models.clip.load import LoadedEncoder
from fitclip_tpu.parallel import create_mesh, replicated, sharded_along
from fitclip_tpu.parallel.mesh import pad_batch_to_divisible
from fitclip_tpu.parallel.multihost import host_array

LOGGER = logging.getLogger(__name__)

DEVICE_KEY_PREFIXES = ("video", "text", "label")


def split_device_batch(batch: Mapping[str, Any]):
    """Separate array keys bound for the device from host-side metadata."""
    device = {k: v for k, v in batch.items()
              if k.split("_")[0] in ("video", "text", "label") and
              isinstance(v, np.ndarray)}
    host = {k: v for k, v in batch.items() if k not in device}
    return device, host


def shard_eval_batch(device_batch, mesh):
    num = mesh.devices.size
    padded, valid = pad_batch_to_divisible(device_batch, num)
    if jax.process_count() > 1:
        # Every process decoded the full batch (eval loaders are unsliced);
        # carve this process's row block and assemble global arrays.
        from fitclip_tpu.parallel.multihost import (global_batch_from_local,
                                                    process_local_rows)

        rows = jax.tree_util.tree_leaves(padded)[0].shape[0]
        block = process_local_rows(rows)
        local = jax.tree_util.tree_map(lambda x: np.asarray(x)[block], padded)
        return global_batch_from_local(mesh, local, rows), valid
    sharding = sharded_along(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), padded), valid


def _loaders_with_names(data_module, split: str = "val") -> List:
    loaders = (data_module.test_dataloader() if split == "test"
               else data_module.val_dataloader())
    if isinstance(loaders, list):
        names = getattr(data_module, "names", [str(i) for i in range(len(loaders))])
        return list(zip(names, loaders))
    return [(None, loaders)]


def _load_persisted_scales(encoder, params, quant_cfg) -> Tuple[Any, bool]:
    """If quant.scales_path exists, restore persisted activation scales and
    skip calibration. Returns (params, calibrated)."""
    scales_path = (quant_cfg or {}).get("scales_path")
    if scales_path and os.path.exists(scales_path):
        from fitclip_tpu.ops.quant import load_act_scales

        LOGGER.info("Loading persisted int8 activation scales from %s", scales_path)
        return load_act_scales(scales_path, jax.device_get(params)), True
    return params, False


def _calibrate_on_batches(encoder, params, observations, quant_cfg):
    """Post-training quantization over K eval batches: running abs-max across
    all observations (each an (video, text) pair), one scale write. A single
    skewed batch does not own the scales."""
    from fitclip_tpu.ops.quant import apply_act_scales, merge_act_amax, save_act_scales

    amax = None
    for video, text in observations:
        amax = merge_act_amax(amax,
                              encoder.collect_act_amax(params, video, text))
    host_params = apply_act_scales(jax.device_get(params), amax)
    scales_path = (quant_cfg or {}).get("scales_path")
    if scales_path:
        save_act_scales(scales_path, host_params)
        LOGGER.info("Persisted int8 activation scales to %s", scales_path)
    LOGGER.info("Calibrated int8 activation scales on %d batch(es)",
                len(observations))
    return host_params


def run_retrieval_eval(loaded: LoadedEncoder, data_module,
                       mesh=None, split: str = "val",
                       quant_cfg: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, float]:
    """Zero-shot text->video retrieval (command=evaluate/validate/test;
    command=test routes to the test split, reference __main__.py:64-69)."""
    import itertools

    mesh = mesh or create_mesh()
    encoder = loaded.encoder
    calibrated = not getattr(encoder, "quantized", False)
    host_params = loaded.params
    if not calibrated:
        host_params, calibrated = _load_persisted_scales(encoder, host_params,
                                                         quant_cfg)
    params = jax.device_put(host_params, replicated(mesh))

    def _eval_step(params, video, text):
        v = encoder.encode_video(params, video).astype(jnp.float32)
        t = encoder.encode_text(params, text).astype(jnp.float32)
        return v, t

    eval_step = jax.jit(_eval_step)

    def video_text(batch):
        device_batch, valid = split_device_batch(batch)
        sharded, valid = shard_eval_batch(device_batch, mesh)
        # Dual-preprocessed (teacher-student) batches: evaluate the
        # student view (reference validates on the student tower,
        # teacher_student.py:142-173).
        return (sharded.get("video", sharded.get("video_student")),
                sharded.get("text", sharded.get("text_student")), valid)

    results: Dict[str, float] = {}
    for name, loader in _loaders_with_names(data_module, split):
        evaluator = RetrievalEvaluator()
        batch_iter = ((video_text(b)) for b in loader)
        if not calibrated:
            k = max(1, int((quant_cfg or {}).get("calibration_batches", 4)))
            # Head batches are padded/sharded ONCE — calibration reads them,
            # then the eval loop consumes the same device arrays.
            head = list(itertools.islice(batch_iter, k))
            params = jax.device_put(
                _calibrate_on_batches(encoder, params,
                                      [(video, text) for video, text, _ in head],
                                      quant_cfg),
                replicated(mesh))
            calibrated = True
            batch_iter = itertools.chain(head, batch_iter)
        for video, text, valid in batch_iter:
            v, t = eval_step(params, video, text)
            evaluator.update(host_array(v), host_array(t), valid=valid)
        metrics = evaluator.compute()
        suffix = f"_{name}" if name else ""
        results.update({f"{key}{suffix}": value for key, value in metrics.items()})
    return results


def run_classification_eval(loaded: LoadedEncoder, data_module, mesh=None,
                            per_class: bool = False,
                            split: str = "val",
                            quant_cfg: Optional[Mapping[str, Any]] = None
                            ) -> Dict[str, float]:
    """Zero-shot classification (video_text_classification.py semantics)."""
    import itertools

    mesh = mesh or create_mesh()
    encoder = loaded.encoder
    calibrated = not getattr(encoder, "quantized", False)
    host_params = loaded.params
    if not calibrated:
        host_params, calibrated = _load_persisted_scales(encoder, host_params,
                                                         quant_cfg)
    params = jax.device_put(host_params, replicated(mesh))

    categories = data_module.categories
    labels = [name for name, _ in sorted(categories.items(), key=lambda kv: kv[1])]
    templates = data_module.templates
    tokenized = tokenize_label_bank(encoder, labels, templates)

    loader = (data_module.test_dataloader() if split == "test"
              else data_module.val_dataloader())
    batches = iter(loader)
    head: List[Any] = []
    if not calibrated:
        k = max(1, int((quant_cfg or {}).get("calibration_batches", 4)))
        head = list(itertools.islice(batches, k))
        observations = []
        for i, batch in enumerate(head):
            batch_video, _ = split_device_batch(batch)
            # The text tower calibrates on a slice of the real label bank.
            observations.append((jnp.asarray(batch_video["video"]),
                                 jnp.asarray(tokenized[i * 32:(i + 1) * 32])
                                 if i * 32 < len(tokenized) else None))
        if observations:
            params = jax.device_put(
                _calibrate_on_batches(encoder, params, observations, quant_cfg),
                replicated(mesh))
        calibrated = True

    label_bank = encode_label_bank(encoder, params, tokenized, num_labels=len(labels))

    encode_video = jax.jit(
        lambda params, video: encoder.encode_video(params, video).astype(jnp.float32))

    evaluator = ClassificationEvaluator(label_bank=label_bank, per_class=per_class)

    for batch in itertools.chain(head, batches):
        device_batch, _ = split_device_batch(batch)
        sharded, valid = shard_eval_batch(device_batch, mesh)
        v = encode_video(params, sharded["video"])
        evaluator.update(host_array(v), host_array(sharded["label"]),
                         valid=valid)
    return evaluator.compute()


def run_predict(loaded: LoadedEncoder, data_module, mesh=None,
                output_path: str = "predictions.pt") -> Dict[str, Any]:
    """command=predict: dump embeddings + video ids (reference saves
    predictions.pt via torch.save, __main__.py:80-91). Classification data
    modules get the argmax-prediction variant
    (video_text_classification.py:135-140)."""
    from fitclip_tpu.data.data_module import VideoClassificationDataModule

    if isinstance(data_module, VideoClassificationDataModule):
        return _run_predict_classification(loaded, data_module, mesh, output_path)
    mesh = mesh or create_mesh()
    encoder = loaded.encoder
    params = jax.device_put(loaded.params, replicated(mesh))

    eval_step = jax.jit(
        lambda params, video, text: (
            encoder.encode_video(params, video).astype(jnp.float32),
            encoder.encode_text(params, text).astype(jnp.float32)))

    encoded_videos, encoded_texts, video_ids = [], [], []
    loaders = data_module.predict_dataloader()
    if not isinstance(loaders, list):
        loaders = [loaders]
    for loader in loaders:
        for batch in loader:
            device_batch, host = split_device_batch(batch)
            sharded, valid = shard_eval_batch(device_batch, mesh)
            v, t = eval_step(params, sharded["video"], sharded["text"])
            encoded_videos.append(host_array(v)[:valid])
            encoded_texts.append(host_array(t)[:valid])
            video_ids.extend(host.get("video_id", []))

    predictions = {
        "encoded_videos": np.concatenate(encoded_videos),
        "encoded_texts": np.concatenate(encoded_texts),
        "video_ids": video_ids,
    }
    return _save_predictions(predictions, output_path)


def _run_predict_classification(loaded, data_module, mesh, output_path):
    mesh = mesh or create_mesh()
    encoder = loaded.encoder
    params = jax.device_put(loaded.params, replicated(mesh))
    categories = data_module.categories
    labels = [name for name, _ in sorted(categories.items(), key=lambda kv: kv[1])]
    tokenized = tokenize_label_bank(encoder, labels, data_module.templates)
    label_bank = encode_label_bank(encoder, params, tokenized, num_labels=len(labels))

    def _predict_step(params, video):
        emb = encoder.encode_video(params, video).astype(jnp.float32)
        scores = jnp.matmul(emb, label_bank.astype(jnp.float32).T)
        return jnp.argmax(scores, axis=-1)

    predict_step = jax.jit(_predict_step)

    predictions_list, labels_list, video_ids = [], [], []
    loaders = data_module.predict_dataloader()
    if not isinstance(loaders, list):
        loaders = [loaders]
    for loader in loaders:
        for batch in loader:
            device_batch, host = split_device_batch(batch)
            sharded, valid = shard_eval_batch(device_batch, mesh)
            predicted = host_array(predict_step(params, sharded["video"]))
            predictions_list.append(predicted[:valid])
            labels_list.append(np.asarray(batch["label"])[:valid])
            video_ids.extend(host.get("video_id", []))

    predictions = {
        "predictions": np.concatenate(predictions_list),
        "labels": np.concatenate(labels_list),
        "video_ids": video_ids,
    }
    return _save_predictions(predictions, output_path)


def _save_predictions(predictions, output_path):
    if output_path:
        try:
            import torch

            torch.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                        for k, v in predictions.items()}, output_path)
        except ImportError:
            # Keep string lists (video_ids) too — they become unicode
            # arrays; the retrieval index (demo/embed_service.py) needs them.
            np.savez(output_path.replace(".pt", ".npz"), **{
                k: (v if isinstance(v, np.ndarray) else np.asarray(v))
                for k, v in predictions.items()})
        LOGGER.info("Saved predictions to %s", output_path)
    return predictions
