"""Checks that need the card (marker ``gpu``): f32 paths on the GPU, where
an f32 matmul without an explicit precision may run in TF32. Run them on
a GPU host with ``NERF_TEST_GPU=1 python -m pytest -m gpu tests/``; they
skip everywhere else (conftest.gpu_device)."""

import jax
import numpy as np
import pytest

from nerf_rs_tpu.config import HashGridConfig, RenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden, golden_examples
from nerf_rs_tpu.models.mlp import nerf_mlp

pytestmark = pytest.mark.gpu


def test_golden_samples_on_the_card(gpu_device, lego_params, golden):
    """The TF golden samples within the reference's 1e-2, with the f32 MLP
    running on the GPU."""
    mlp = jax.jit(nerf_mlp)
    for net in ("coarse", "fine"):
        p = jax.device_put(lego_params[net], gpu_device)
        for ex in golden_examples(golden):
            pts = ex["ray_o"][None] + ex["ray_d"][None] * ex["z_vals"][:, None]
            dirs = np.broadcast_to(ex["viewdir_unit"], pts.shape)
            rgb, sigma = mlp(p, jax.device_put(pts, gpu_device),
                             jax.device_put(dirs, gpu_device))
            np.testing.assert_allclose(np.asarray(sigma), ex[f"{net}_sigma"], atol=1e-2)
            np.testing.assert_allclose(np.asarray(rgb), ex[f"{net}_rgb"], atol=1e-2)


def test_exact_render_matches_committed_golden(gpu_device, lego_params, golden):
    """The f32 exact-mode frame on the card vs the committed 64x64 golden
    render (the same bar as the CPU test in test_render.py)."""
    import os

    from nerf_rs_tpu.io.image import load_ppm
    from nerf_rs_tpu.render import render_image

    path = os.path.join(os.path.dirname(__file__), "goldens",
                        "lego_64x64_16c32f_key0.ppm")
    with jax.default_device(gpu_device):
        img = np.asarray(render_image(
            jax.device_put(lego_params["coarse"], gpu_device),
            jax.device_put(lego_params["fine"], gpu_device),
            camera_from_golden(golden), 64, 64, jax.random.key(0),
            RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)))
    mse = float(np.mean((img - load_ppm(path)) ** 2))
    assert -10.0 * np.log10(mse) > 45.0


def test_hashgrid_f32_mlp_on_the_card_matches_host(gpu_device):
    """The hash-grid family's f32 MLP layers ask for HIGHEST precision, so
    the card agrees with the host CPU to f32 rounding, not TF32's."""
    from nerf_rs_tpu.models.hashgrid import hashgrid_mlp, init_hashgrid_params

    cfg = HashGridConfig(levels=4, table_log2=12, res_max=64)
    params = init_hashgrid_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    dirs = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (4096, 1))
    fn = jax.jit(lambda p, x, d: hashgrid_mlp(p, x, d, cfg=cfg))
    cpu = jax.devices("cpu")[0]
    out_g = fn(jax.device_put(params, gpu_device), jax.device_put(pts, gpu_device),
               jax.device_put(dirs, gpu_device))
    out_c = fn(jax.device_put(params, cpu), jax.device_put(pts, cpu),
               jax.device_put(dirs, cpu))
    for g, c in zip(out_g, out_c):
        np.testing.assert_allclose(np.asarray(g), np.asarray(c), rtol=1e-5, atol=1e-6)
