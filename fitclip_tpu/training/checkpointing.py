"""Checkpoint save/restore built on Orbax (the reference's PL ModelCheckpoint
-> SURVEY §5.4). State is a pytree (TrainState or bare params).

Full mid-training resume (the reference's ``trainer.fit(ckpt_path=...)``,
aligner/cli.py:148 + __main__.py:51): a Trainer checkpoint holds the ENTIRE
TrainState (params, optimizer moments, step, temperature clamps) plus a JSON
sidecar with callback state (best-monitor value, early-stopping counters), so
``command=train checkpoint_path=<dir>`` continues bit-identically.

Orbax is imported on first use: a run without checkpoints (evaluate, or
train without the checkpoint callback) does not need it installed."""

import json
import os
from typing import Any, Dict, Optional

_ASYNC_CHECKPOINTER = None


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def save_checkpoint(path: str, state: Any, force: bool = True,
                    wait: bool = True) -> None:
    """wait=False starts the Orbax write in the background and returns —
    the trainer keeps stepping while the previous checkpoint flushes (the
    caller must pass a HOST snapshot: the train step donates device buffers,
    so device arrays would be overwritten under an in-flight save). At most
    one save is in flight; a new save first drains the previous one. Call
    wait_for_checkpoints() before reading a freshly written checkpoint or
    exiting."""
    global _ASYNC_CHECKPOINTER
    path = os.path.abspath(path)
    if _ASYNC_CHECKPOINTER is None:
        _ASYNC_CHECKPOINTER = _checkpointer()
    _ASYNC_CHECKPOINTER.wait_until_finished()
    _ASYNC_CHECKPOINTER.save(path, state, force=force)
    if wait:
        _ASYNC_CHECKPOINTER.wait_until_finished()


def wait_for_checkpoints() -> None:
    """Drain any in-flight async checkpoint write."""
    if _ASYNC_CHECKPOINTER is not None:
        _ASYNC_CHECKPOINTER.wait_until_finished()


def restore_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    path = os.path.abspath(path)
    checkpointer = _checkpointer()
    if template is not None:
        return checkpointer.restore(path, template)
    return checkpointer.restore(path)


def checkpoint_top_level_keys(path: str) -> set:
    """Top-level pytree keys of a checkpoint, from metadata only (no tensor
    reads)."""
    metadata = _checkpointer().metadata(os.path.abspath(path))
    tree = getattr(metadata, "item_metadata", metadata).tree
    return set(tree.keys())


def is_full_train_state(path: str) -> bool:
    """True when the checkpoint was written from a TrainState (full resume is
    possible), False for bare-params checkpoints or unreadable paths."""
    try:
        keys = checkpoint_top_level_keys(path)
    except Exception:
        return False
    return {"step", "params", "opt_state"} <= keys


def _trainer_state_path(checkpoint_path: str) -> str:
    # Sidecar NEXT TO the orbax dir — orbax owns the dir's contents.
    return os.path.abspath(checkpoint_path).rstrip(os.sep) + ".trainer.json"


def save_trainer_state(checkpoint_path: str, data: Dict[str, Any]) -> None:
    with open(_trainer_state_path(checkpoint_path), "w") as file:
        json.dump(data, file)


def load_trainer_state(checkpoint_path: str) -> Optional[Dict[str, Any]]:
    path = _trainer_state_path(checkpoint_path)
    if not os.path.exists(path):
        return None
    with open(path) as file:
        return json.load(file)
