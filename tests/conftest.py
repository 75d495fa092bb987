"""Test config: run on CPU with 8 virtual devices so multi-device sharding
tests execute anywhere (SURVEY.md §4: multi-device tests via
xla_force_host_platform_device_count).

Tests marked ``gpu`` need an NVIDIA GPU. They run only with
NERF_TEST_GPU=1 on a GPU host (``NERF_TEST_GPU=1 python -m pytest -m gpu
tests/``), which leaves JAX its default platforms; the ``gpu_device``
fixture skips them everywhere else."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if os.environ.get("NERF_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if os.environ.get("NERF_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

from nerf_rs_tpu.utils import enable_compile_cache  # noqa: E402

# Persistent compilation cache: repeated suite runs skip recompiles of the
# (static-shape, cfg-keyed) render/train programs — minutes per run.
enable_compile_cache()

import json
import pathlib

import numpy as np
import pytest

from nerf_rs_tpu.io.weights import find_lego_assets, load_nerf_params

# --- quick/slow test tiers ----------------------------------------------
# tests/slow_tests.json is a measured manifest (test id -> seconds, one
# full-suite run with --durations); every test recorded at >= ~10 s gets
# the `slow` marker automatically, so `pytest -m "not slow"` is a CI-style
# quick pass (~147 tests) and the bare run stays the full suite. Renamed
# tests simply drop out of the manifest (they run in both tiers) —
# regenerate with:  pytest -q --durations=60  and rebuild the JSON.
_SLOW_MANIFEST = pathlib.Path(__file__).parent / "slow_tests.json"
try:
    _SLOW = set(json.loads(_SLOW_MANIFEST.read_text()))
except (OSError, ValueError):
    _SLOW = set()


def pytest_collection_modifyitems(config, items):
    for item in items:
        if f"tests/{item.fspath.basename}::{item.name}" in _SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip — decided here, at test time, never while
    a module is imported (xdist workers must all collect the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (NERF_TEST_GPU=1 on a GPU host)")


@pytest.fixture(scope="session")
def assets_dir():
    path = find_lego_assets()
    if path is None:
        pytest.skip("lego_rust pretrained assets not available")
    return path


@pytest.fixture(scope="session")
def lego_params(assets_dir):
    return {
        "coarse": load_nerf_params(assets_dir / "coarse"),
        "fine": load_nerf_params(assets_dir / "fine"),
    }


@pytest.fixture(scope="session")
def golden(assets_dir):
    from nerf_rs_tpu.io.golden import load_golden

    return load_golden(assets_dir / "tf_reference_samples.json")
