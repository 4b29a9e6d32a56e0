"""command=train: contrastive fine-tuning or teacher-student distillation.

Wires config -> optimizer/state/steps/trainer. The encoder slot decides the
mode: a single encoder trains contrastively (VideoTextLightningModule
semantics); a {"student", "teacher"} map runs the FitCLIP distillation
(teacher_student.py semantics) over mixed structured batches.
"""

import logging
from typing import Any, Dict, Mapping, Optional

import jax
import numpy as np

from fitclip_tpu.cli.runners import run_retrieval_eval, shard_eval_batch, split_device_batch
from fitclip_tpu.models.clip.load import LoadedEncoder
from fitclip_tpu.parallel import create_mesh, replicated, sharded_along
from fitclip_tpu.training.state import init_train_state, make_optimizer
from fitclip_tpu.training.steps import (make_contrastive_train_step,
                                        make_teacher_student_train_step)
from fitclip_tpu.training.trainer import (CheckpointConfig, EarlyStoppingConfig,
                                          Trainer, TrainerConfig)
from fitclip_tpu.utils.logging import MetricsLogger

LOGGER = logging.getLogger(__name__)


def _trainer_config(trainer_cfg: Mapping[str, Any],
                    callbacks_cfg: Optional[Mapping[str, Any]]) -> TrainerConfig:
    callbacks_cfg = callbacks_cfg or {}
    early = None
    if "early_stopping" in callbacks_cfg:
        early = EarlyStoppingConfig(**callbacks_cfg["early_stopping"])
    ckpt = None
    if "checkpoint" in callbacks_cfg:
        ckpt = CheckpointConfig(**callbacks_cfg["checkpoint"])
    return TrainerConfig(
        max_epochs=int(trainer_cfg.get("max_epochs", 1)),
        val_check_interval=float(trainer_cfg.get("val_check_interval", 1.0)),
        log_every_n_steps=int(trainer_cfg.get("log_every_n_steps", 10)),
        max_steps=trainer_cfg.get("max_steps"),
        early_stopping=early,
        checkpoint=ckpt,
    )


def _make_batch_preparer(mesh):
    sharding = sharded_along(mesh)

    replicated_sharding = replicated(mesh)
    num_devices = mesh.devices.size

    if jax.process_count() > 1:
        from fitclip_tpu.parallel.multihost import global_batch_from_local

        def prepare_multihost(batch):
            # Loaders already delivered only this process's row block; glue
            # the blocks into global arrays over the full mesh.
            def convert(node):
                if isinstance(node, Mapping):
                    return {k: convert(v) for k, v in node.items()
                            if isinstance(v, (Mapping, np.ndarray))}
                return global_batch_from_local(mesh, node)
            return convert(batch)

        return prepare_multihost

    def prepare(batch):
        def convert(node):
            if isinstance(node, Mapping):
                return {k: convert(v) for k, v in node.items()
                        if isinstance(v, (Mapping, np.ndarray))}
            # Batches smaller than the mesh (tiny test configs) replicate
            # instead of shard; production batch sizes are mesh-divisible.
            target = sharding if node.shape[0] % num_devices == 0 else replicated_sharding
            return jax.device_put(node, target)
        return convert(batch)

    return prepare


def _load_prompts(prompts_path: Optional[str], student: LoadedEncoder,
                  teacher: LoadedEncoder):
    if not prompts_path:
        return None, None
    with open(prompts_path) as file:
        prompts = [line.strip() for line in file if line.strip()]
    return (np.asarray(student.get_tokenizer()(prompts)),
            np.asarray(teacher.get_tokenizer()(prompts)))


def run_train(encoder_slot, data_module, model_cfg: Mapping[str, Any],
              trainer_cfg: Mapping[str, Any],
              optimizer_cfg: Mapping[str, Any],
              callbacks_cfg: Optional[Mapping[str, Any]] = None,
              prompts_path: Optional[str] = None,
              mesh=None, log_dir: Optional[str] = None,
              checkpoint_path: Optional[str] = None) -> Dict[str, Any]:
    mesh = mesh or create_mesh()
    is_teacher_student = isinstance(encoder_slot, Mapping)

    # Eval-only encoders (SLIP family, int8-quantized towers) refuse to train
    # with a clear error. Encoders with normalization state (batch-stats BN
    # CLIP ResNets) train, but their running statistics update by EMA through
    # the step, not by gradient — freeze them from the optimizer.
    bn_freeze_patterns = []
    slots = (encoder_slot.items() if is_teacher_student
             else [("encoder", encoder_slot)])
    for slot_name, loaded in slots:
        enc = loaded.encoder
        # The frozen teacher never receives gradients (steps.py wraps its
        # outputs in stop_gradient), so an int8 teacher is valid; only
        # gradient-carrying slots must have a differentiable path.
        if slot_name == "teacher":
            continue
        if getattr(enc, "trainable", True) is False or getattr(enc, "quantized", False):
            raise ValueError(
                f"{type(enc).__name__} is evaluation-only (eval-form weights/int8); "
                "fine-tune a ViT CLIP encoder instead (e.g. encoder=clip_vit_b_16)")
        bn_freeze_patterns.extend(getattr(enc, "bn_freeze_patterns", ()))

    init_temperature = float(model_cfg.get("init_temperature", 0.05))
    min_temperature = float(model_cfg.get("min_temperature", 0.001))
    fit_temperature = bool(model_cfg.get("fit_temperature", True))

    if is_teacher_student:
        student, teacher = encoder_slot["student"], encoder_slot["teacher"]
    else:
        student, teacher = encoder_slot, None

    params_template = {"encoder": student.params,
                       "logit_scale": np.zeros((1,), np.float32)}
    if is_teacher_student:
        params_template["ts_logit_scale"] = np.zeros((1,), np.float32)

    optimizer = make_optimizer(
        learning_rate=float(optimizer_cfg.get("lr", 3e-6)),
        weight_decay=float(optimizer_cfg.get("weight_decay", 0.01)),
        eps=float(optimizer_cfg.get("eps", 1e-8)),
        betas=tuple(optimizer_cfg.get("betas", (0.9, 0.999))),
        freeze_patterns=(list((callbacks_cfg or {}).get("param_freeze_patterns")
                              or []) + bn_freeze_patterns) or None,
        fit_temperature=fit_temperature,
        gradient_clip_val=trainer_cfg.get("gradient_clip_val"),
        params_example=params_template,
        # Single-HBM-pass AdamW (see FusedAdamW). Same math as the optax
        # chain (tests/test_fused_optimizer.py); the opt_state layout differs,
        # so a checkpoint saved under one setting resumes under the same one.
        fused=bool(optimizer_cfg.get("fused", True)),
        # ++optimizer.moment_dtype=bfloat16 stores m/v reduced (update math
        # stays fp32); loss-trajectory parity gated in
        # tests/test_fused_optimizer.py. Checkpoints carry the dtype, so
        # resume under the same setting.
        moment_dtype=optimizer_cfg.get("moment_dtype"),
    )
    state = init_train_state(student.params, optimizer,
                             init_temperature=init_temperature,
                             min_temperature=min_temperature,
                             with_teacher_student_scale=is_teacher_student)

    # Full mid-training resume (reference trainer.fit(ckpt_path=...),
    # aligner/cli.py:148): restore the ENTIRE TrainState — params, optimizer
    # moments, step, temperatures — into the freshly built template, plus
    # callback state from the JSON sidecar. The teacher tower (frozen, never
    # optimized) always comes from the encoder config.
    resume_trainer_state = None
    if checkpoint_path:
        from fitclip_tpu.training.checkpointing import (load_trainer_state,
                                                        restore_checkpoint)

        state = restore_checkpoint(checkpoint_path, template=jax.device_get(state))
        resume_trainer_state = load_trainer_state(checkpoint_path)
        LOGGER.info("Resumed full TrainState at step %d from %s",
                    int(state.step), checkpoint_path)
    if bool(trainer_cfg.get("fsdp", False)) and mesh.shape.get("data", 1) > 1:
        # ZeRO-3/FSDP: params + AdamW moments sharded over the data axis;
        # GSPMD inserts the per-use all-gathers (parallel/sharding_rules.py).
        from fitclip_tpu.parallel.sharding_rules import fsdp_shardings

        state = jax.device_put(state, fsdp_shardings(state, mesh))
        LOGGER.info("FSDP: TrainState sharded over data=%d", mesh.shape["data"])
    else:
        if bool(trainer_cfg.get("fsdp", False)):
            LOGGER.warning(
                "++trainer.fsdp=true has no effect on a %d-device data mesh; "
                "the TrainState is fully replicated.", mesh.shape.get("data", 1))
        state = jax.device_put(state, replicated(mesh))

    teacher_params = None
    if is_teacher_student:
        teacher_params = jax.device_put(teacher.params, replicated(mesh))
        student_prompts, teacher_prompts = _load_prompts(prompts_path, student, teacher)
        step = make_teacher_student_train_step(
            student.encoder, teacher.encoder, optimizer,
            labeled_loss_share=float(model_cfg.get("labeled_dataset_loss_share", 0.5)),
            student_prompt_ids=student_prompts,
            teacher_prompt_ids=teacher_prompts)
    else:
        step = make_contrastive_train_step(student.encoder, optimizer)

    def validate(current_state) -> Dict[str, float]:
        eval_encoder = LoadedEncoder(encoder=student.encoder,
                                     params=current_state.params["encoder"])
        try:
            metrics = run_retrieval_eval(eval_encoder, data_module, mesh=mesh)
        except NotImplementedError:
            return {}
        # Alias retrieval loss-style monitors for callbacks expecting loss/val.
        return metrics

    # Pluggable experiment-tracker sink (the reference's NeptuneLogger slot,
    # drift_eval_trainer.yaml:25-27): trainer.logger={_target_: ...} gets
    # instantiated and receives every log(metrics, step) call.
    sinks = []
    if trainer_cfg.get("logger"):
        from fitclip_tpu.config_engine import instantiate

        sinks.append(instantiate(trainer_cfg["logger"]))

    trainer = Trainer(_trainer_config(trainer_cfg, callbacks_cfg),
                      logger=MetricsLogger(log_dir=log_dir, sinks=sinks),
                      prepare_batch=_make_batch_preparer(mesh))
    final_state = trainer.fit(state, step, data_module.train_dataloader(),
                              validate=validate if _has_val(data_module) else None,
                              teacher_params=teacher_params,
                              resume_trainer_state=resume_trainer_state)
    return {"state": final_state,
            "metrics": getattr(trainer, "_last_val_metrics", {})}


def _has_val(data_module) -> bool:
    # Only "no val split defined" disables validation; a val loader that
    # CRASHES must propagate — swallowing it would silently disable
    # best-checkpointing and early stopping too.
    try:
        data_module.val_dataloader()
        return True
    except NotImplementedError:
        return False
