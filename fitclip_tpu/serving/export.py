"""Deployment artifacts for the serving stack: AOT-exported encode
programs + the persistent compilation cache.

Two complementary mechanisms, both aimed at the serving cold-start (a
fresh server process re-compiles every bucket program):

- **Persistent compilation cache** (`enable_compilation_cache`): XLA's
  on-disk executable cache keyed by program hash. A restarted server (or
  a re-run CLI eval with identical shapes) loads compiled binaries
  instead of re-compiling.
- **`jax.export` artifacts** (`export_encode_fn` / `load_exported`):
  version-stable serialized StableHLO of the exact jitted encode program,
  one per batch bucket. The artifact pins the program a deployment ships
  (auditable, diffable, loadable by any PJRT runtime — including a C++
  server via the JAX export calling convention) and skips
  trace+lowering on load; backend compilation still happens once per
  process (then hits the persistent cache above).

The reference's serving story is TorchScript-free (a Flask app over
precomputed embeddings, demo/app.py); both mechanisms here are additions
on top of reference capability.
"""

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# The cache directory when neither the environment nor the caller names
# one: fixed inside the checkout, because the path is part of what makes a
# later run find its entries again.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compilation_cache_dir(configured: Optional[str] = None) -> str:
    """Where the persistent cache lives: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else the configured directory, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR") or configured
            or DEFAULT_CACHE_DIR)


def enable_compilation_cache(configured: Optional[str] = None) -> str:
    """Turn on XLA's persistent executable cache; returns its directory.

    The one place that decides the directory (``compilation_cache_dir``).
    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and this
    sets no other directory. Safe to call more than once."""
    import jax

    cache_dir = compilation_cache_dir(configured)
    if cache_dir != os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        _reset_cache_singleton()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


def disable_compilation_cache() -> None:
    """Turn the persistent cache back off AND drop the singleton.

    Clearing only ``jax_compilation_cache_dir`` is not enough: the cache
    object lives on pinned to its original directory, and on some jax
    versions later compiles still consult it — reading from a directory
    that may since have been deleted (observed as a segfault inside
    ``compilation_cache.get_executable_and_time`` mid-test-suite)."""
    import jax

    jax.config.update("jax_compilation_cache_dir", None)
    _reset_cache_singleton()


def _reset_cache_singleton() -> None:
    # The persistent cache is a process-level singleton pinned to the first
    # directory it initialized with; drop it so a redirect (tests, a server
    # reconfiguring at startup) actually takes effect.
    try:
        from jax.experimental.compilation_cache import compilation_cache
        compilation_cache.reset_cache()
    except (ImportError, AttributeError):
        pass


PARAMS_FILE = "params.msgpack"


def export_encode_fn(encode_fn: Callable, params, example_item: np.ndarray,
                     bucket_sizes: Sequence[int],
                     directory: str, name: str) -> Dict[int, str]:
    """Serialize ``jit(encode_fn)`` at every bucket batch size.

    encode_fn: ``(params, (batch,) + item_shape) -> (batch, ...)`` device
        function. Params enter the program as ARGUMENTS, so the StableHLO
        artifacts stay weight-free (KBs-MBs each) and the weight tree is
        written ONCE per directory as ``params.msgpack`` — shared by every
        tower/bucket exported into it.
    example_item: one input row (no batch dim) fixing shape and dtype.
    Returns {bucket_size: artifact_path}; artifacts are
    ``{name}_b{size}.jaxexp`` files under ``directory``.
    """
    import jax
    from flax import serialization
    from jax import export as jax_export

    os.makedirs(directory, exist_ok=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    with open(os.path.join(directory, PARAMS_FILE), "wb") as f:
        f.write(serialization.msgpack_serialize(params))
    params_spec = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    paths: Dict[int, str] = {}
    for size in bucket_sizes:
        spec = jax.ShapeDtypeStruct((int(size),) + tuple(example_item.shape),
                                    example_item.dtype)
        exported = jax_export.export(jax.jit(encode_fn))(params_spec, spec)
        path = os.path.join(directory, f"{name}_b{int(size)}.jaxexp")
        with open(path, "wb") as f:
            f.write(exported.serialize())
        paths[int(size)] = path
    return paths


def load_exported(directory: str, name: str) -> Tuple[Callable, Dict[int, Callable]]:
    """Load ``params.msgpack`` + every ``{name}_b*.jaxexp`` artifact.

    Returns (encode_fn, per_bucket): ``per_bucket[size]`` is the deserialized
    program for that batch size (params already bound); ``encode_fn(batch)``
    routes to the exact bucket program for ``batch.shape[0]`` (the serving
    batcher always calls at bucket sizes). Raises FileNotFoundError when no
    artifact matches.
    """
    import jax
    from flax import serialization
    from jax import export as jax_export

    with open(os.path.join(directory, PARAMS_FILE), "rb") as f:
        params = serialization.msgpack_restore(f.read())
    # On-device once: host-resident params would re-transfer the whole
    # weight tree on EVERY bucket call.
    params = jax.device_put(params)

    prefix = f"{name}_b"
    per_bucket: Dict[int, Callable] = {}
    for fname in sorted(os.listdir(directory)):
        if not (fname.startswith(prefix) and fname.endswith(".jaxexp")):
            continue
        size = int(fname[len(prefix):-len(".jaxexp")])
        with open(os.path.join(directory, fname), "rb") as f:
            call = jax_export.deserialize(f.read()).call
            per_bucket[size] = (lambda batch, call=call: call(params, batch))
    if not per_bucket:
        raise FileNotFoundError(f"no {prefix}*.jaxexp artifacts in {directory}")

    def encode_fn(batch):
        try:
            return per_bucket[int(batch.shape[0])](batch)
        except KeyError:
            raise ValueError(
                f"no exported program for batch size {batch.shape[0]}; "
                f"available buckets: {sorted(per_bucket)}") from None

    return encode_fn, per_bucket
