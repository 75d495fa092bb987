"""Dataset tests: a synthetic on-disk blender scene and the distillation
fallback (SURVEY.md §7 step 6 — the reference ships no dataset)."""

import json

import jax
import numpy as np
import pytest

from nerf_rs_tpu.config import RenderConfig
from nerf_rs_tpu.data import BlenderDataset, DistillationDataset
from nerf_rs_tpu.models.mlp import init_nerf_params


@pytest.fixture()
def blender_scene(tmp_path):
    """Write a minimal 2-frame nerf_synthetic-style scene."""
    from nerf_rs_tpu.io.image import encode_png

    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        img = (rng.uniform(0, 1, (8, 8, 4)) * 255).astype(np.uint8)
        (tmp_path / f"r_{i}.png").write_bytes(encode_png(img))
        theta = i * 0.7
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [4 * np.sin(theta), -4 * np.cos(theta), 1.0]
        fwd = -c2w[:3, 3] / np.linalg.norm(c2w[:3, 3])
        c2w[:3, 2] = -fwd  # -z forward
        up = np.asarray([0, 0, 1.0], np.float32)
        right = np.cross(fwd, up); right /= np.linalg.norm(right)
        c2w[:3, 0] = right
        c2w[:3, 1] = np.cross(right, fwd)
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    meta = {"camera_angle_x": 0.69, "frames": frames}
    (tmp_path / "transforms_train.json").write_text(json.dumps(meta))
    return tmp_path


def test_blender_dataset_batches(blender_scene):
    ds = BlenderDataset(blender_scene)
    assert len(ds) == 2 * 8 * 8
    batch = next(ds.batches(16))
    assert batch["origins"].shape == (16, 3)
    assert batch["dirs"].shape == (16, 3)
    assert batch["rgb"].shape == (16, 3)
    # dirs are unit
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(batch["dirs"]), axis=-1), 1.0, atol=1e-5
    )
    # white-background compositing applied to RGBA
    assert float(batch["rgb"].max()) <= 1.0


def test_distillation_dataset_smoke():
    params = {"coarse": init_nerf_params(jax.random.key(0)),
              "fine": init_nerf_params(jax.random.key(1))}
    ds = DistillationDataset(params, cfg=RenderConfig(n_coarse=4, n_fine=8, ray_chunk=32))
    it = ds.batches(32)
    b1, b2 = next(it), next(it)
    assert b1["rgb"].shape == (32, 3)
    assert np.isfinite(np.asarray(b1["rgb"])).all()
    # successive batches differ (viewpoints resampled)
    assert not np.allclose(np.asarray(b1["dirs"]), np.asarray(b2["dirs"]))
