"""What the main path needs from its machine: no flax on the CLIP ViT path,
orbax only when a checkpoint is written, a flax-free TrainState, the smoke
script's refusal to run without a GPU, and the measurement helpers'
refusal to time the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str, cwd: str = ROOT, env=None):
    full_env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    full_env.update(env or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=600)


# Blocks an import the way a machine without the package would.
_BLOCK = ("import sys\n"
          "class _Block:\n"
          "    def find_spec(self, name, path=None, target=None):\n"
          "        if name.split('.')[0] in {blocked!r}:\n"
          "            raise ModuleNotFoundError(f'No module named {{name!r}}', name=name)\n"
          "sys.meta_path.insert(0, _Block())\n")


def test_clip_main_path_runs_without_flax_or_orbax():
    code = _BLOCK.format(blocked=("flax", "orbax")) + """
import jax, jax.numpy as jnp, numpy as np
from fitclip_tpu.cli.main import execute
from fitclip_tpu.cli.train_runner import run_train
from fitclip_tpu.models.clip import CLIPConfig
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
from fitclip_tpu.training.state import init_train_state, make_optimizer
from fitclip_tpu.training.steps import make_contrastive_train_step
enc = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=2)
opt = make_optimizer(1e-3, fused=True)
state = init_train_state(enc.init_params(jax.random.PRNGKey(0)), opt)
batch = {"video": jnp.zeros((2, 2, 32, 32, 3), jnp.uint8),
         "text": jnp.ones((2, 16), jnp.int32)}
state, metrics = jax.jit(make_contrastive_train_step(enc, opt))(state, batch)
assert np.isfinite(float(metrics["loss/train"]))
assert not any(m.split(".")[0] in ("flax", "orbax") for m in sys.modules)
print("OK")
"""
    proc = _python(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def test_flax_families_fail_naming_flax_when_it_is_missing():
    code = _BLOCK.format(blocked=("flax",)) + """
try:
    import fitclip_tpu.models.frozen_in_time.encoder
except ImportError as error:
    assert "flax" in str(error), error
    print("OK")
"""
    proc = _python(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def test_checkpointing_imports_orbax_only_to_write():
    proc = _python("import sys\n"
                   "import fitclip_tpu.training.checkpointing\n"
                   "import fitclip_tpu.training.trainer\n"
                   "assert 'orbax' not in sys.modules\n"
                   "print('OK')")
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


def test_train_state_is_a_pytree_with_replace():
    from fitclip_tpu.training.state import TrainState, init_train_state, make_optimizer

    state = init_train_state({"w": jnp.ones((3,))}, make_optimizer(1e-3, fused=True))
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(rebuilt, TrainState)
    bumped = jax.jit(lambda s: s.replace(step=s.step + 1))(state)
    assert int(bumped.step) == 1 and int(state.step) == 0
    paths = {jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(state)}
    assert any(p.startswith(".params") for p in paths)


def test_chip_smoke_exits_nonzero_without_a_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


def test_chip_smoke_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=dict(env, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_device_summary_refuses_the_cpu():
    from fitclip_tpu.utils.benchmarking import device_summary

    with pytest.raises(RuntimeError, match="no accelerator"):
        device_summary()
    summary = device_summary(require_accelerator=False)
    assert summary["platform"] == "cpu" and summary["count"] == len(jax.devices())


def test_time_calls_waits_for_each_call():
    from fitclip_tpu.utils.benchmarking import time_calls

    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(4) * len(calls)

    result = time_calls(fn, warmup=2, steps=3)
    assert len(calls) == 5 and result["steps"] == 3
    assert 0 <= result["min_s"] <= result["median_s"] <= result["max_s"]
    with pytest.raises(ValueError):
        time_calls(fn, warmup=0, steps=1)


def test_memory_summary_reads_compiled_analysis():
    from fitclip_tpu.utils.benchmarking import memory_summary

    compiled = jax.jit(lambda x: x @ x.T).lower(jnp.ones((8, 8))).compile()
    summary = memory_summary(compiled)
    assert summary["argument_size_in_bytes"] == 8 * 8 * 4
    assert summary["output_size_in_bytes"] == 8 * 8 * 4


class _Event:
    def __init__(self, name, start, duration):
        self.name, self.start_ns, self.duration_ns = name, start, duration


class _Line:
    def __init__(self, name, events):
        self.name, self.events = name, events


class _Plane:
    def __init__(self, name, lines):
        self.name, self.lines = name, lines


class _Profile:
    def __init__(self, planes):
        self.planes = planes


def _trace_util():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import _trace_util
    finally:
        sys.path.pop(0)
    return _trace_util


def test_trace_reduction_sums_gpu_ops_and_busy_union():
    util = _trace_util()
    ops = _Line("XLA Ops", [_Event("fusion.1", 0, 10), _Event("gemm", 5, 10),
                            _Event("fusion.1", 30, 10)])
    profile = _Profile([_Plane("/host:CPU", [_Line("XLA Ops", [_Event("x", 0, 99)])]),
                        _Plane("/device:GPU:0", [ops])])
    per_op, busy, window = util.op_times(profile)
    assert per_op == {"fusion.1": 20 / 1e6, "gemm": 10 / 1e6}
    assert busy == pytest.approx(25 / 1e6) and window == pytest.approx(40 / 1e6)
    assert util.aggregate_by_category(per_op, 1) == {"fusion": 20 / 1e6, "gemm": 10 / 1e6}


def test_trace_reduction_reads_stream_lines_without_an_ops_line():
    util = _trace_util()
    streams = [_Line("Stream #13(Compute)", [_Event("gemm_kernel", 0, 8)]),
               _Line("Stream #14(MemcpyD2D)", [_Event("copy", 4, 8)])]
    per_op, busy, window = util.op_times(
        _Profile([_Plane("/device:GPU:0", streams)]))
    assert per_op == {"gemm_kernel": 8 / 1e6, "copy": 8 / 1e6}
    assert busy == pytest.approx(12 / 1e6) and window == pytest.approx(12 / 1e6)


def test_trace_reduction_fails_without_a_gpu_plane():
    util = _trace_util()
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        util.op_times(_Profile([_Plane("/host:CPU", [])]))
    with pytest.raises(RuntimeError, match="no 'XLA Ops' or stream line"):
        util.op_times(_Profile([_Plane("/device:GPU:0", [_Line("Launch", [])])]))
