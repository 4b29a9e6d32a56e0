"""Train state: trainable pytree + optimizer + learnable temperature(s).

Reference semantics re-expressed functionally:
- ``logit_scale`` starts at -log(init_temperature) and is clamped to
  -log(min_temperature) after every optimizer step
  (aligner/video_text_module.py:26-35,93-97).
- The teacher-student variant carries a second scale with the same clamp
  (aligner/teacher_student.py:70-73,190-194).
- Parameter freezing by regex over parameter paths replaces the ParamFreezer
  callback (aligner/param_freezer.py:12-42) with an optax mask: frozen leaves
  get zero updates, so they also never allocate optimizer moments.
"""

import dataclasses
import math
import re
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax

Params = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Params  # {"encoder": ..., "logit_scale": (1,), ["ts_logit_scale": (1,)]}
    opt_state: Any
    max_logit_scale: jnp.ndarray  # static clamp bound, kept with the state

    def temperature(self) -> jnp.ndarray:
        return 1.0 / jnp.exp(self.params["logit_scale"])

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def param_path_strings(params: Params) -> Sequence[str]:
    flat = jax.tree_util.tree_leaves_with_path(params)
    return ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]


def freeze_mask(params: Params, patterns: Sequence[str]) -> Params:
    """True = trainable, False = frozen. Patterns are regexes matched with
    `re.search` against slash-joined parameter paths."""
    compiled = [re.compile(p) for p in patterns]
    unused = set(range(len(compiled)))

    def decide(path, _):
        path_str = "/".join(str(getattr(k, "key", k)) for k in path)
        for i, pattern in enumerate(compiled):
            if pattern.search(path_str):
                unused.discard(i)
                return False
        return True

    mask = jax.tree_util.tree_map_with_path(decide, params)
    for i in sorted(unused):
        import logging
        logging.getLogger(__name__).warning(
            "Freeze pattern %r matched no parameters", patterns[i])
    return mask


class FusedAdamW(tuple):
    """Drop-in optimizer with optax's (init, update) surface plus a
    single-pass ``fused_apply``.

    optax splits each step into update() (materializes an updates tree) and
    apply_updates() (re-reads params) — nominally 2 extra device-memory
    passes over the full fp32 parameter set per step. ``fused_apply``
    computes new (p, m, v) per leaf in ONE expression, so XLA emits one loop
    fusion per leaf: 4 reads + 3 writes, nothing materialized between. XLA
    already fuses most of the optax chain inside the jitted step; what this
    removes is the updates-tree materialization.
    The math term-for-term matches optax.adamw (bias correction on count+1,
    eps outside the sqrt, decoupled weight decay, -lr last), asserted by
    tests/test_fused_optimizer.py. Frozen leaves are skipped at trace time
    and carry scalar moment placeholders instead of zero trees.
    """
    __slots__ = ()

    def __new__(cls, init, update, fused_apply):
        return tuple.__new__(cls, (init, update, fused_apply))

    @property
    def init(self):
        return self[0]

    @property
    def update(self):
        return self[1]

    @property
    def fused_apply(self):
        return self[2]


def make_fused_adamw(learning_rate, weight_decay: float, betas, eps: float,
                     mask: Optional[Params],
                     gradient_clip_val: Optional[float],
                     moment_dtype=None) -> FusedAdamW:
    """moment_dtype (e.g. jnp.bfloat16) stores the m/v moment trees reduced —
    the AdamW pass is memory-bound, so halving the moment bytes targets that
    directly. The update math always runs fp32 (moments are
    upcast per leaf inside the same fusion); only the stored state narrows.
    None keeps full fp32 moments (the default and the numeric reference)."""
    b1, b2 = betas

    def trainable_mask(params):
        return (mask if mask is not None
                else jax.tree_util.tree_map(lambda _: True, params))

    def init(params):
        def moment(p, trainable):
            # Frozen leaves carry a scalar placeholder, not a full zero tree
            # ((0,)-sized arrays would be smaller still, but Orbax refuses to
            # serialize zero-size arrays, breaking checkpoint save/resume).
            if not trainable:
                return jnp.zeros((), jnp.float32)
            return jnp.zeros_like(p, dtype=moment_dtype or p.dtype)
        m = jax.tree_util.tree_map(moment, params, trainable_mask(params))
        v = jax.tree_util.tree_map(moment, params, trainable_mask(params))
        return {"count": jnp.zeros((), jnp.int32), "mu": m, "nu": v}

    def fused_apply(params, grads, opt_state):
        count_inc = opt_state["count"] + 1
        lr = (learning_rate(opt_state["count"]) if callable(learning_rate)
              else learning_rate)
        bc1 = 1.0 - b1 ** count_inc.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count_inc.astype(jnp.float32)

        live = trainable_mask(params)
        if gradient_clip_val:
            # Like the optax chain, the norm spans trainable leaves only
            # (multi_transform routes frozen leaves around the clip+adam).
            norm = optax.global_norm([
                g for g, t in zip(jax.tree_util.tree_leaves(grads),
                                  jax.tree_util.tree_leaves(live)) if t])
            clip_scale = jnp.minimum(1.0, gradient_clip_val / jnp.maximum(
                norm, 1e-16))
        else:
            clip_scale = None

        def leaf(p, g, m, v, trainable):
            if not trainable:
                return p, m, v
            if clip_scale is not None:
                g = g * clip_scale
            g32 = g.astype(jnp.float32)
            new_m = b1 * m.astype(jnp.float32) + (1.0 - b1) * g32
            new_v = b2 * v.astype(jnp.float32) + (1.0 - b2) * (g32 * g32)
            adam = (new_m / bc1) / (jnp.sqrt(new_v / bc2) + eps)
            new_p = p - lr * (adam + weight_decay * p)
            return new_p, new_m.astype(m.dtype), new_v.astype(v.dtype)

        out = jax.tree_util.tree_map(leaf, params, grads, opt_state["mu"],
                                     opt_state["nu"], live)
        pick = lambda i: jax.tree_util.tree_map(  # noqa: E731
            lambda t: t[i], out, is_leaf=lambda x: isinstance(x, tuple))
        return pick(0), {"count": count_inc, "mu": pick(1), "nu": pick(2)}

    def update(grads, opt_state, params=None):
        """optax-compatible two-pass fallback (generic consumers only — the
        train steps all go through fused_apply)."""
        if params is None:
            raise ValueError("FusedAdamW.update requires params")
        new_params, new_state = fused_apply(params, grads, opt_state)
        updates = jax.tree_util.tree_map(lambda n, p: n - p, new_params, params)
        return updates, new_state

    return FusedAdamW(init, update, fused_apply)


def make_optimizer(learning_rate, weight_decay: float = 0.01,
                   betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                   freeze_patterns: Optional[Sequence[str]] = None,
                   fit_temperature: bool = True,
                   gradient_clip_val: Optional[float] = None,
                   params_example: Optional[Params] = None,
                   fused: bool = False,
                   moment_dtype: Optional[str] = None):
    """AdamW matching the reference default optimizer (config/trainer.yaml:
    torch.optim.AdamW, lr 3e-6), with optional global-norm clipping (the
    reference sweeps trainer.gradient_clip_val). ``fused=True`` returns the
    single-HBM-pass update (see FusedAdamW); math is identical.
    ``moment_dtype`` ("bfloat16") stores the fused optimizer's moments
    reduced — fused-only (the optax chain keeps fp32 moments)."""
    if fused:
        patterns = list(freeze_patterns or [])
        if not fit_temperature:
            patterns.append(r"^(ts_)?logit_scale$")
        mask = None
        if patterns:
            if params_example is None:
                raise ValueError(
                    "freeze_patterns requires params_example to build the mask")
            mask = freeze_mask(params_example, patterns)
        return make_fused_adamw(learning_rate, weight_decay, betas, eps,
                                mask, gradient_clip_val,
                                moment_dtype=(jnp.dtype(moment_dtype)
                                              if moment_dtype else None))
    if moment_dtype:
        raise ValueError("moment_dtype requires the fused optimizer")
    chain = []
    if gradient_clip_val:
        chain.append(optax.clip_by_global_norm(gradient_clip_val))
    chain.append(optax.adamw(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
                             weight_decay=weight_decay))
    optimizer = optax.chain(*chain)

    patterns = list(freeze_patterns or [])
    if not fit_temperature:
        patterns.append(r"^(ts_)?logit_scale$")
    if patterns:
        if params_example is None:
            raise ValueError("freeze_patterns requires params_example to build the mask")
        mask = freeze_mask(params_example, patterns)
        labels = jax.tree_util.tree_map(lambda trainable: "train" if trainable else "freeze", mask)
        # NOT optax.masked: masked passes untouched leaves' raw gradients
        # through as updates; frozen leaves need hard zeros.
        optimizer = optax.multi_transform({"train": optimizer, "freeze": optax.set_to_zero()},
                                          labels)
    return optimizer


def init_train_state(encoder_params: Params, optimizer: optax.GradientTransformation,
                     init_temperature: float = 0.05, min_temperature: float = 0.001,
                     with_teacher_student_scale: bool = False) -> TrainState:
    params = {
        "encoder": encoder_params,
        "logit_scale": jnp.full((1,), -math.log(init_temperature), jnp.float32),
    }
    if with_teacher_student_scale:
        params["ts_logit_scale"] = jnp.full((1,), -math.log(init_temperature), jnp.float32)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=optimizer.init(params),
        max_logit_scale=jnp.full((1,), -math.log(min_temperature), jnp.float32),
    )


def apply_updates_with_clamp(state: TrainState, grads: Params,
                             optimizer) -> TrainState:
    if isinstance(optimizer, FusedAdamW):
        new_params, new_opt_state = optimizer.fused_apply(
            state.params, grads, state.opt_state)
    else:
        updates, new_opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
        new_params = optax.apply_updates(state.params, updates)
    # Temperature clamp: logit_scale <= max_logit_scale, applied post-step
    # exactly like the reference optimizer_step override.
    new_params["logit_scale"] = jnp.minimum(new_params["logit_scale"], state.max_logit_scale)
    if "ts_logit_scale" in new_params:
        new_params["ts_logit_scale"] = jnp.minimum(new_params["ts_logit_scale"],
                                                   state.max_logit_scale)
    return state.replace(step=state.step + 1, params=new_params, opt_state=new_opt_state)
