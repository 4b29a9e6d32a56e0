"""The ``aligner`` CLI: ``python -m aligner command=... encoder=... data=...``.

Preserves the reference's Hydra surface (aligner/__main__.py + aligner/cli.py)
on top of the in-tree config engine: config groups, overrides, ``--multirun``,
``--config-name``. Commands: train, evaluate, validate, test, predict, tune.

Decisions vs reference quirks (SURVEY §2.1): resume reads ``checkpoint_path``
directly (the reference gated on a vestigial ``path`` key, cli.py:148) — a
full-TrainState dir resumes training completely (params + optimizer + step,
trainer.fit(ckpt_path=...) semantics); bare-params checkpoints swap encoder
weights (the student tower for {student, teacher} slots). Everything else
keeps the same shape, including the classification auto-switch
(cli.py:110-115) and prediction concatenation to predictions.pt
(__main__.py:70-91).
"""

import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

LOGGER = logging.getLogger(__name__)

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "config")

GROUP_DATA_MODULE_TARGETS = {
    "fitclip_tpu.data.data_module_group.EvalDataModuleGroup",
    "fitclip_tpu.data.data_module_group.DataModuleStructuredGroup",
    "fitclip_tpu.data.data_module_group.MixedBatchDataModule",
    "fitclip_tpu.data.data_module_group.TrainAndEvalDataModules",
}


def parse_args(argv: List[str]) -> Tuple[str, str, bool, List[str]]:
    config_name = "trainer"
    config_dir = os.environ.get("FITCLIP_CONFIG_DIR", DEFAULT_CONFIG_DIR)
    multirun = False
    overrides: List[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--config-name", "-cn"):
            config_name = argv[i + 1]
            i += 2
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
            i += 1
        elif arg in ("--config-dir", "--config-path", "-cd", "-cp"):
            config_dir = argv[i + 1]
            i += 2
        elif arg in ("--multirun", "-m"):
            multirun = True
            i += 1
        elif arg in ("--help", "-h"):
            print(__doc__)
            sys.exit(0)
        else:
            overrides.append(arg)
            i += 1
    if config_name.endswith(".yaml"):
        config_name = config_name[: -len(".yaml")]
    return config_name, config_dir, multirun, overrides


def seed_everything(seed: int) -> None:
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed)


def instantiate_encoder_slot(node: Mapping[str, Any]):
    from fitclip_tpu.config_engine import instantiate

    if "_target_" in node:
        return instantiate(node)
    return {key: instantiate(value) for key, value in node.items()}


def instantiate_data_module(node: Mapping[str, Any], encoder_slot):
    """Recursive group-aware instantiation (reference cli.py:53-78)."""
    from fitclip_tpu.config_engine import instantiate

    target = node.get("_target_", "")
    if target in GROUP_DATA_MODULE_TARGETS:
        kwargs = {k: v for k, v in node.items() if k != "_target_"}
        if "data_modules" in kwargs:
            kwargs["data_modules"] = {
                name: instantiate_data_module(sub, encoder_slot)
                for name, sub in kwargs["data_modules"].items()}
        for key in ("train_data_module", "eval_data_module"):
            if key in kwargs:
                kwargs[key] = instantiate_data_module(kwargs[key], encoder_slot)
        module = __import__(target.rsplit(".", 1)[0], fromlist=["_"])
        cls = getattr(module, target.rsplit(".", 1)[1])
        return cls(**{k: instantiate(v) if isinstance(v, Mapping) and "_target_" in v
                      else v for k, v in kwargs.items()})
    return instantiate(node, encoder=encoder_slot)


def _is_classification(data_module) -> bool:
    from fitclip_tpu.data.data_module import VideoClassificationDataModule

    return isinstance(data_module, VideoClassificationDataModule)


def _maybe_load_checkpoint(loaded, checkpoint_path: Optional[str]):
    """Load an orbax train-state dir or a torch .pt into the encoder params."""
    if not checkpoint_path:
        return loaded
    from fitclip_tpu.models.clip.load import LoadedEncoder

    if os.path.isdir(checkpoint_path):
        from fitclip_tpu.training.checkpointing import restore_checkpoint

        restored = restore_checkpoint(checkpoint_path)
        params = restored["params"]["encoder"] if "params" in restored else restored
        return LoadedEncoder(encoder=loaded.encoder, params=params)
    from fitclip_tpu.convert.torch_state_dict import (clip_params_from_torch,
                                                      config_from_openai_state_dict,
                                                      load_torch_state_dict)

    state_dict = load_torch_state_dict(checkpoint_path)
    config = config_from_openai_state_dict(state_dict)
    params = clip_params_from_torch(state_dict, config)
    return LoadedEncoder(encoder=loaded.encoder, params=params)


def run(cfg: Dict[str, Any]) -> Optional[float]:
    """Run one composed config; returns the optimized metric, if named."""
    metrics = execute(cfg)["metrics"]
    optimized_metric_name = cfg.get("optimized_metric_name")
    if optimized_metric_name:
        return metrics.get(optimized_metric_name)
    return None


def execute(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Run one composed config. Returns {"metrics": the command's metrics,
    "state": the final TrainState for command=train, else None}."""
    from fitclip_tpu.cli.runners import (run_classification_eval, run_predict,
                                         run_retrieval_eval)
    from fitclip_tpu.cli.train_runner import run_train

    # Multi-host entry: bring up the multi-process runtime BEFORE anything
    # touches the backend (++distributed.coordinator_address=... or
    # JAX_COORDINATOR_ADDRESS env).
    from fitclip_tpu.parallel.multihost import maybe_initialize_distributed

    maybe_initialize_distributed(cfg)

    # XLA's persistent executable cache: re-running the same command with
    # identical shapes loads compiled binaries instead of re-compiling.
    # ++compilation_cache_dir=<dir> names the directory unless
    # JAX_COMPILATION_CACHE_DIR is set (serving/export.compilation_cache_dir).
    from fitclip_tpu.serving.export import enable_compilation_cache

    cache_dir = cfg.get("compilation_cache_dir")
    enable_compilation_cache(str(cache_dir) if cache_dir else None)

    seed_everything(int(cfg.get("seed", 42)))
    command = cfg["command"]
    known = ("train", "evaluate", "validate", "test", "predict", "tune")
    if command not in known:
        # Validate before the (expensive) encoder/data instantiation.
        raise SystemExit(f"Unknown command: {command!r} — expected one of "
                         f"{', '.join(known)}")

    if not cfg.get("encoder"):
        raise SystemExit("No encoder selected — pass encoder=<name> "
                         "(e.g. encoder=clip_vit_b_16; see config/encoder/)")
    if not cfg.get("data"):
        raise SystemExit("No dataset selected — pass data=<name> "
                         "(e.g. data=msrvtt; see config/data/)")
    encoder_slot = instantiate_encoder_slot(cfg["encoder"])
    data_module = instantiate_data_module(cfg["data"], encoder_slot)

    checkpoint_path = cfg.get("checkpoint_path")
    resume_path = None
    if checkpoint_path:
        from fitclip_tpu.training.checkpointing import is_full_train_state

        if command == "train" and os.path.isdir(checkpoint_path) \
                and is_full_train_state(checkpoint_path):
            # Full mid-training resume: the whole TrainState (params +
            # optimizer + step) restores inside run_train, matching the
            # reference's trainer.fit(ckpt_path=...) (aligner/cli.py:148).
            resume_path = checkpoint_path
        elif isinstance(encoder_slot, Mapping):
            # Bare-params checkpoint on a {student, teacher} slot loads into
            # the gradient-carrying student tower.
            encoder_slot = dict(encoder_slot)
            encoder_slot["student"] = _maybe_load_checkpoint(
                encoder_slot["student"], checkpoint_path)
        else:
            encoder_slot = _maybe_load_checkpoint(encoder_slot, checkpoint_path)

    metrics: Dict[str, float] = {}
    state = None

    if command == "train":
        result = run_train(
            encoder_slot, data_module,
            model_cfg=cfg.get("model", {}),
            trainer_cfg=cfg.get("trainer", {}),
            optimizer_cfg=cfg.get("optimizer", {}),
            callbacks_cfg=cfg.get("trainer", {}).get("callbacks"),
            prompts_path=cfg.get("prompts"),
            log_dir=cfg.get("log_dir", "logs"),
            checkpoint_path=resume_path)
        metrics, state = result["metrics"], result["state"]
    elif command in ("evaluate", "validate", "test"):
        split = "test" if command == "test" else "val"
        # quant: {calibration_batches: K, scales_path: file.npz} — int8
        # post-training calibration over K batches, optionally persisted.
        quant_cfg = cfg.get("quant")
        eval_single = (lambda enc, dm: run_classification_eval(
                           enc, dm, split=split, quant_cfg=quant_cfg)
                       if _is_classification(dm)
                       else run_retrieval_eval(enc, dm, split=split,
                                               quant_cfg=quant_cfg))
        metrics = eval_single(encoder_slot, data_module)
        print(json.dumps(metrics, indent=2))
    elif command == "predict":
        run_predict(encoder_slot, data_module,
                    output_path=cfg.get("output_path", "predictions.pt"))
    elif command == "tune":
        from fitclip_tpu.cli.tune import run_tune

        # Reference asserts tune never runs from a resume checkpoint
        # (__main__.py:55-59).
        assert not checkpoint_path, "checkpoint_path can't be tuned from"
        suggestions = run_tune(encoder_slot, data_module,
                               trainer_cfg=cfg.get("trainer", {}),
                               tune_cfg=cfg.get("tune"))
        print(json.dumps(suggestions, indent=2))
        metrics = dict(suggestions)
    else:
        raise ValueError(f"Unknown command: {command}")
    return {"metrics": metrics, "state": state}


def main(argv: Optional[List[str]] = None) -> None:
    from fitclip_tpu.config_engine import compose, expand_multirun

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    config_name, config_dir, multirun, overrides = parse_args(argv)

    # Stable sweep dir across multirun trials (reference __main__.py:21-24).
    os.environ.setdefault("SWEEP_DIR",
                          os.path.join("multirun", time.strftime("%Y-%m-%d_%H-%M-%S")))

    runs = expand_multirun(overrides) if multirun else [overrides]
    results = []
    for i, run_overrides in enumerate(runs):
        if multirun:
            LOGGER.info("=== multirun job %d/%d: %s ===", i + 1, len(runs),
                        " ".join(run_overrides))
        cfg = compose(config_dir, config_name, run_overrides)
        if cfg.get("silent"):
            logging.getLogger().setLevel(logging.WARNING)
        if cfg.get("hparam_search"):
            from fitclip_tpu.cli.sweep import run_sweep

            best_value, _ = run_sweep(cfg, run)
            results.append(best_value)
        else:
            results.append(run(cfg))
    if len(results) == 1 and results[0] is not None:
        print(results[0])


if __name__ == "__main__":
    main()
