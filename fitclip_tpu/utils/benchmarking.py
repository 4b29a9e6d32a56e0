"""Timing on an accelerator: warm-up calls, then timed calls that each end
in ``block_until_ready``, on the host clock.

JAX dispatches asynchronously, so a timed call waits for its own result
before the clock stops; the warm-up calls compile every shape first, and
their first call's time is reported apart as compile time. Every result
names the device it ran on (``device_summary``), and a measurement that
finds no accelerator fails instead of timing the CPU.
"""

import statistics
import time
from typing import Any, Callable, Dict

import jax


def device_summary(require_accelerator: bool = True) -> Dict[str, Any]:
    """{"platform", "kind", "count"} of the default backend's devices.
    Raises when ``require_accelerator`` and the devices are CPUs."""
    devices = jax.devices()
    summary = {"platform": devices[0].platform,
               "kind": devices[0].device_kind, "count": len(devices)}
    if require_accelerator and summary["platform"] == "cpu":
        raise RuntimeError("no accelerator: a timing on the CPU is not a "
                           "device measurement")
    return summary


def time_calls(fn: Callable[[], Any], warmup: int = 2,
               steps: int = 10) -> Dict[str, float]:
    """Call ``fn()`` ``warmup`` times, then ``steps`` timed times, each
    ending in ``jax.block_until_ready``. Returns the median, min and max
    seconds per call and the first warm-up call's seconds (compile
    included)."""
    if warmup < 1 or steps < 1:
        raise ValueError("time_calls needs at least one warm-up and one step")
    start = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - start
    for _ in range(warmup - 1):
        jax.block_until_ready(fn())
    times = []
    for _ in range(steps):
        start = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - start)
    return {"median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times), "first_call_s": first, "steps": steps}


def memory_summary(compiled) -> Dict[str, int]:
    """The byte counts of ``compiled.memory_analysis()`` (a
    ``jax.stages.Compiled``): arguments, outputs, temporaries, code."""
    analysis = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return {name: int(getattr(analysis, name)) for name in fields
            if hasattr(analysis, name)}
