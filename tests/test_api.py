"""Embedder API (the reference's wasm surface, lib.rs:679-726): cached
networks, validated dims, RGBA A=255 — plus the accel serving mode."""

import jax
import numpy as np
import pytest

from nerf_rs_tpu import api
from nerf_rs_tpu.config import RenderConfig

SMALL = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=256)


@pytest.fixture(autouse=True)
def fresh_state():
    api._state.clear()
    yield
    api._state.clear()


def test_rgba_contract(assets_dir):
    api.init_renderer(cfg=SMALL)
    buf = api.render_image_rgba(16, 16, seed=0)
    assert buf.shape == (16 * 16 * 4,) and buf.dtype == np.uint8
    rgba = buf.reshape(16, 16, 4)
    assert (rgba[..., 3] == 255).all()
    # matches the underlying render + the reference's quantization formula
    from nerf_rs_tpu.io.image import pixels_to_rgba
    from nerf_rs_tpu.render import render_image

    img = render_image(api._state["params"]["coarse"],
                       api._state["params"]["fine"], api._state["camera"],
                       16, 16, jax.random.key(0), SMALL)
    np.testing.assert_array_equal(buf, pixels_to_rgba(np.asarray(img)))


def test_invalid_dims_rejected(assets_dir):
    api.init_renderer(cfg=SMALL)
    with pytest.raises(ValueError):
        api.render_image_rgba(0, 16)


def test_accel_mode_serves_close_images(assets_dir):
    """accel=True bakes a grid once, calibrates per size, and serves
    images close to the exact path."""
    from nerf_rs_tpu.models.mlp import nerf_mlp

    api.init_renderer(cfg=SMALL)
    exact = api.render_image_rgba(16, 16, seed=0).astype(np.float32)

    api._state.clear()
    # CPU: build the small grid through the f32 MLP (faster on CPU than
    # the default bf16 sweep).
    import nerf_rs_tpu.accel as accel_mod

    orig = accel_mod.build_occupancy_grid

    def fast_build(params, **kw):
        kw.setdefault("mlp_fn", lambda p, x, d: nerf_mlp(p, x, d))
        kw.setdefault("chunk", 32 ** 3)
        return orig(params, **kw)

    accel_mod.build_occupancy_grid = fast_build
    try:
        api.init_renderer(cfg=SMALL, accel=True, accel_res=32)
        fast = api.render_image_rgba(16, 16, seed=0).astype(np.float32)
        # Mask-only culling (the default) has no capacities: no per-size
        # calibration entry is (or needs to be) recorded.
        assert (16, 16) not in api._state["size_cfgs"]
        # A compaction-mode cfg still calibrates per size.
        api.init_renderer(cfg=SMALL.replace(accel_compact="scatter"),
                          accel=True, accel_res=32)
        api.render_image_rgba(16, 16, seed=0)
        assert (16, 16) in api._state["size_cfgs"]
        api.init_renderer(cfg=SMALL, accel=True, accel_res=32)
    finally:
        accel_mod.build_occupancy_grid = orig

    mse = float(np.mean((exact - fast) ** 2))  # u8 scale
    psnr = 20 * np.log10(255.0) - 10 * np.log10(max(mse, 1e-12))
    assert psnr > 40.0, f"accel-served image deviates: {psnr:.1f} dB"

    # accel=None keeps the current mode (docstring contract): a cfg-only
    # re-init must neither drop nor rebake the grid.
    baked = api._state["grid"]
    api.init_renderer(cfg=SMALL.replace(ray_chunk=128))
    assert api._state["grid"] is baked
    # Explicit disable still works.
    api.init_renderer(accel=False)
    assert api._state["grid"] is None


def test_init_from_npz_bundle(assets_dir, tmp_path):
    """A packed .npz bundle (cli pack) initializes the renderer identically
    to the directory assets — the self-contained-artifact property of the
    reference's wasm build (weights.rs:1-100)."""
    import json

    from nerf_rs_tpu.io.weights import load_scene_assets, save_bundle

    params, golden = load_scene_assets(assets_dir, device_put=False)
    bundle = tmp_path / "scene.npz"
    save_bundle(bundle, params["coarse"], params["fine"], json.dumps(golden))

    api.init_renderer(assets_dir=bundle, cfg=SMALL)
    from_bundle = api.render_image_rgba(8, 8, seed=0)
    api._state.clear()
    api.init_renderer(assets_dir=assets_dir, cfg=SMALL)
    from_dir = api.render_image_rgba(8, 8, seed=0)
    np.testing.assert_array_equal(from_bundle, from_dir)


def test_serve_trained_checkpoint(assets_dir, tmp_path):
    """init_renderer(checkpoint=...) serves a cli-train checkpoint of any
    family — here a hashgrid one (model.json sidecar resolves the
    hyper-parameters) — and switching back to assets restores the MLP."""
    from nerf_rs_tpu.cli import main

    ck = str(tmp_path / "ck")
    assert main(["train", "--model", "hashgrid", "--hash-levels", "2",
                 "--hash-table-log2", "10", "--hash-res-max", "16",
                 "--coarse-samples", "4", "--fine-samples", "8",
                 "--ray-chunk", "64", "--batch-rays", "64", "--steps", "1",
                 "--checkpoint-dir", ck, "--log-every", "1"]) == 0
    from nerf_rs_tpu.io.checkpoint import latest_checkpoint

    ckpt = str(latest_checkpoint(ck))
    api.init_renderer(cfg=SMALL, checkpoint=ckpt)
    assert api._state["cfg"].model == "hashgrid"
    rgba = api.render_image_rgba(8, 8, seed=0)
    assert rgba.shape == (8 * 8 * 4,) and rgba.dtype == np.uint8
    assert bool((rgba[3::4] == 255).all())
    # idempotent re-init with the same checkpoint keeps state
    grid_obj = api._state["params"]
    api.init_renderer(checkpoint=ckpt)
    assert api._state["params"] is grid_obj
    # dropping the checkpoint restores the pretrained MLP serving path
    api.init_renderer(cfg=SMALL, checkpoint=None)
    assert api._state["cfg"].model == "mlp"
    rgba2 = api.render_image_rgba(8, 8, seed=0)
    assert rgba2.shape == (8 * 8 * 4,)


def test_failed_checkpoint_init_preserves_renderer(assets_dir, tmp_path):
    """A failed init_renderer(checkpoint=...) must leave the previous
    renderer fully intact — a half-committed _state would make later bare
    init_renderer() calls claim the new checkpoint is being served while
    rendering the old weights."""
    api.init_renderer(cfg=SMALL)
    before = api.render_image_rgba(8, 8, seed=0)
    with pytest.raises(Exception):
        api.init_renderer(checkpoint=str(tmp_path / "nonexistent"))
    assert api._state.get("checkpoint") is None       # not poisoned
    after = api.render_image_rgba(8, 8, seed=0)
    np.testing.assert_array_equal(before, after)
