"""Shared device-trace plumbing for the profile_* scripts.

Traces ``calls`` calls of ``run_fn()`` with ``jax.profiler`` (compiled
beforehand, outside the trace) and reads the ``.xplane.pb`` it writes with
``jax.profiler.ProfileData``. Only the GPU device planes (``/device:GPU:N``)
count; a trace without one is an error, not a fallback. Per plane, the
"Stream #N(...)" lines hold the kernels the card ran, named by kernel (an
"XLA Ops" line, where a trace has one, names HLO ops instead and is
preferred); the busy time is the union of those intervals over the traced
window.
"""

import glob
import json
import os
import re
from collections import defaultdict


def gpu_planes(profile):
    planes = [p for p in profile.planes if p.name.startswith("/device:GPU:")]
    if not planes:
        raise RuntimeError("trace has no GPU device plane: planes are "
                           f"{[p.name for p in profile.planes]}")
    return planes


def _op_lines(plane):
    lines = list(plane.lines)
    ops = [line for line in lines if line.name == "XLA Ops"]
    ops = ops or [line for line in lines if line.name.startswith("Stream")]
    if not ops:
        raise RuntimeError(f"{plane.name} has no 'XLA Ops' or stream line: "
                           f"{[line.name for line in lines]}")
    return ops


def op_times(profile):
    """(per-op ms summed over GPU planes, busy ms, window ms) of a trace."""
    per_op = defaultdict(float)
    intervals = []
    for plane in gpu_planes(profile):
        for event in (e for line in _op_lines(plane) for e in line.events):
            per_op[event.name] += event.duration_ns / 1e6
            intervals.append((event.start_ns, event.start_ns + event.duration_ns))
    intervals.sort()
    busy, end = 0.0, None
    for start, stop in intervals:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    return dict(per_op), busy / 1e6, window / 1e6


def trace_and_aggregate(run_fn, trace_dir: str, calls: int = 3):
    """run_fn() -> device value. Returns (per_op_ms, calls); prints the
    device busy share of the traced window."""
    import jax

    jax.block_until_ready(run_fn())  # compile outside the trace
    jax.profiler.start_trace(trace_dir)
    for _ in range(calls):
        jax.block_until_ready(run_fn())
    jax.profiler.stop_trace()

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"no .xplane.pb written under {trace_dir}")
    per_op, busy_ms, window_ms = op_times(
        jax.profiler.ProfileData.from_file(paths[-1]))
    print(json.dumps({"device_busy_ms": round(busy_ms, 3),
                      "window_ms": round(window_ms, 3),
                      "busy_share": round(busy_ms / window_ms, 4) if window_ms else None}),
          flush=True)
    return per_op, calls


def print_aggregate(per_op, calls: int, clips: int, top: int = 30) -> None:
    """The profile_* scripts' standard output: one total line then the top
    ops."""
    total = sum(per_op.values())
    print(json.dumps({"total_ms_%dcalls" % calls: round(total, 2),
                      "ms_per_call": round(total / calls, 2),
                      "clips_per_call": clips}), flush=True)
    for name, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        print(json.dumps({"op": name[:110],
                          "ms_per_call": round(ms / calls, 3)}), flush=True)


def aggregate_by_category(per_op, calls: int):
    """Group op names by their category prefix (fusion.12 -> fusion)."""
    cat = defaultdict(float)
    for name, ms in per_op.items():
        cat[re.sub(r"[.\d]+$", "", name)] += ms / calls
    return dict(cat)
