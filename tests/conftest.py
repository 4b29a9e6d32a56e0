"""Test configuration.

By default the tests run on the CPU with 8 virtual devices
(``xla_force_host_platform_device_count``), so the sharding logic is
exercised on a multi-device mesh without any accelerator.

``--device=gpu`` leaves JAX's platform alone: that is how the ``gpu``-marked
tests run on an NVIDIA card (``python -m pytest tests/test_gpu.py -m gpu
--device=gpu``, or ``chip_smoke.py``). A ``gpu``-marked test decides inside
a fixture whether a card is present and skips without one.
"""

import os

import pytest


def pytest_addoption(parser):
    parser.addoption("--device", default="cpu", choices=("cpu", "gpu"),
                     help="cpu (default): force JAX onto 8 virtual CPU "
                          "devices; gpu: use the default backend")


def pytest_configure(config):
    if config.getoption("--device") != "cpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    # Through the live config too: jax may be imported before this hook.
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_a_card(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with --device=gpu on the card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop jit caches after every test module: bounds the compile state a
    long single-process run accumulates (each module recompiles its own
    programs anyway)."""
    yield
    import jax

    jax.clear_caches()
